"""PyTorch port: the HGT model family against the JAX package.

One cohort (600 patients; hidden 32, 4 heads, heads (16, 8), dropout 0),
numbered the same way in both packages, so the port's graph is the JAX
bundle's graph.  A JAX-initialised ``HeteroGT`` is bridged into the port's
with no unmatched key, then:

* each ``HGTLayer`` tier against the JAX layer on the same params and inputs
  (the dense and segment tiers against JAX's own; the flash tier, plain
  kernel versions on the CPU, against the JAX flash tier in Pallas interpret
  mode) within ``rtol=atol=1e-5``;
* ``predict_lab_values`` and ``compute_node_state`` with the port's flash
  tier against the JAX segment tier's ``compute_node_state`` and
  ``predict_pairs_cached`` within 1e-4 (two layers of f32 sums in another
  order), and the served answers of that state;
* one train step with dropout 0: the loss to ``rtol=1e-5``, every gradient
  to ``rtol=1e-4`` plus ``1e-6`` of the step's largest gradient, and the
  parameters after Adam to ``atol=4e-4`` (``tests/test_torch_training.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.graph.attn_plan import build_attn_plans as jax_build_attn_plans
from multi_modal_gnn_tpu.models import hgt as jax_hgt
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import init_model_variables
from multi_modal_gnn_tpu.models.losses import weighted_regression_loss
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
from multi_modal_gnn_tpu_torch.models import HeteroGT, HGTLayer, build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.models.hgt import gelu
from multi_modal_gnn_tpu_torch.ops import attention_kernels
from multi_modal_gnn_tpu_torch.serving import build_serving_fn, compute_node_state, predict_patient
from multi_modal_gnn_tpu_torch.training import EdgeMasker, Trainer

H, HEADS = 32, 4
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

SPEC = SyntheticSpec(
    num_patients=600, num_labs=40, num_diagnoses=30, num_medications=20,
    mean_labs_per_patient=8.0, mean_diagnoses_per_patient=2.0,
    mean_medications_per_patient=2.0, latent_dim=4, seed=1,
)


def _jax_config(use_pallas=False, dense_bytes=0):
    cfg = JaxConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, architecture="HGT", hidden_dim=H, num_heads=HEADS, dropout=0.0,
            use_pallas=use_pallas,
            edge_head=dataclasses.replace(cfg.model.edge_head, hidden_dims=(16, 8)),
        ),
        graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=dense_bytes),
    )


def _port(jcfg, **model):
    cfg = Config.from_dict(jcfg.to_dict())
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


@pytest.fixture(scope="module")
def cohort():
    jcfg = _jax_config()
    bundle = make_synthetic_bundle(JaxSpec(**dataclasses.asdict(SPEC)), jcfg)
    cfg = _port(jcfg, use_pallas=True)
    graph = ensure_attn_plans(make_synthetic_graph(SPEC, cfg, device="cpu"), cfg)
    variables = init_model_variables(jax_build_model(jcfg, bundle.graph), bundle.graph, jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, bundle=bundle, cfg=cfg, graph=graph, variables=variables)


def _bridged(cohort, cfg=None):
    model = build_model(cfg or cohort["cfg"], cohort["graph"], device="cpu")
    result = model.load_state_dict(state_dict_from_flax(cohort["variables"]), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return model


def test_bridge_loads_an_hgt_tree_strict(cohort):
    model = _bridged(cohort)
    assert isinstance(model, HeteroGT)
    n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(cohort["variables"]))
    assert sum(v.numel() for v in model.state_dict().values()) == n_flax
    assert "batch_stats" not in cohort["variables"]


def test_gelu_is_flax_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=1e-6, atol=1e-6)  # f32 rounding at |x| <= 6
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4  # torch's default (erf) is another function


@pytest.mark.parametrize("tier", ["dense", "segment", "flash"])
def test_hgt_layer_tiers_match_jax(cohort, tier):
    bundle = cohort["bundle"]
    jax_graph = bundle.graph
    graph = cohort["graph"]
    dense_bytes = 268_435_456 if tier == "dense" else 0
    if tier == "dense":
        jcfg = _jax_config(dense_bytes=dense_bytes)
        jax_graph = make_synthetic_bundle(JaxSpec(**dataclasses.asdict(SPEC)), jcfg).graph
        graph = make_synthetic_graph(SPEC, _port(jcfg), device="cpu")
    elif tier == "flash":
        jax_graph = jax_graph.replace(attn_plans=jax_build_attn_plans(jax_graph, bundle.host_edges))
    else:
        graph = dataclasses.replace(graph, attn_plans=None)
    impl = "pallas" if tier == "flash" else "xla"
    counts = graph.node_count_map
    rng = np.random.default_rng(5)
    x = {nt: rng.normal(size=(n, H)).astype(np.float32) for nt, n in counts.items()}
    params = cohort["variables"]["params"]["hgt_0"]
    jax_layer = jax_hgt.HGTLayer(
        edge_types=jax_graph.edge_types, node_types=jax_graph.node_types, hidden_dim=H,
        num_heads=HEADS, impl=impl,
    )
    want = jax.jit(lambda p, xs: jax_layer.apply({"params": p}, xs, jax_graph))(
        params, {k: jnp.asarray(v) for k, v in x.items()}
    )
    layer = HGTLayer(graph.edge_types, graph.node_types, H, HEADS, impl=impl)
    sd = {k[len("hgt_0."):]: v for k, v in state_dict_from_flax(cohort["variables"]).items() if k.startswith("hgt_0.")}
    layer.load_state_dict(sd, strict=True)
    assert {layer.tier(graph, nt) for nt in layer.groups()} == {tier}
    with torch.no_grad():
        got = layer({k: torch.from_numpy(v) for k, v in x.items()}, graph)
    for nt in counts:
        np.testing.assert_allclose(got[nt].numpy(), np.asarray(want[nt]), **LAYER_TOL, err_msg=nt)
    # the read-only last layer computes the patient and lab groups alone
    with torch.no_grad():
        some = layer({k: torch.from_numpy(v) for k, v in x.items()}, graph, ("patient", "lab"))
    np.testing.assert_array_equal(some["diagnosis"].numpy(), x["diagnosis"])
    np.testing.assert_array_equal(some["patient"].numpy(), got["patient"].numpy())


def test_hgt_forward_and_serving_match_jax(cohort):
    jcfg, bundle = cohort["jcfg"], cohort["bundle"]
    jax_model = jax_build_model(jcfg, bundle.graph)
    model = _bridged(cohort)
    rng = np.random.default_rng(3)
    p_idx = rng.integers(0, SPEC.num_patients, 500)
    l_idx = rng.integers(0, cohort["graph"].num_nodes("lab"), 500)
    want_state = jax.jit(
        lambda v, g: jax_model.apply(v, g, method=jax_model.compute_node_state)
    )(cohort["variables"], bundle.graph)
    heads = jax.jit(
        lambda v, st, p, l: jax_model.apply(v, st, p, l, method=jax_model.predict_pairs_cached)
    )
    want = heads(cohort["variables"], want_state, jnp.asarray(p_idx), jnp.asarray(l_idx))
    model.eval()
    attention_kernels.reset_launch_counts()
    with torch.no_grad():
        got = model.predict_lab_values(cohort["graph"], torch.from_numpy(p_idx), torch.from_numpy(l_idx))
    assert not any(attention_kernels.launch_counts.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    state = compute_node_state(model, cohort["graph"])
    assert set(state) == {"final_p", "final_l"}
    for key in state:
        np.testing.assert_allclose(state[key].numpy(), np.asarray(want_state[key]), **MODEL_TOL, err_msg=key)
    fn, _ = build_serving_fn(model, cohort["graph"], state)
    np.testing.assert_allclose(fn(p_idx, l_idx).numpy(), np.asarray(want), **MODEL_TOL)
    patient = predict_patient(fn, 7, cohort["graph"].num_nodes("lab"))
    want_patient = heads(cohort["variables"], want_state, jnp.full(40, 7), jnp.arange(40))
    np.testing.assert_allclose(patient.numpy(), np.asarray(want_patient), **MODEL_TOL)


def test_hgt_train_step_matches_jax(cohort):
    jcfg, bundle = cohort["jcfg"], cohort["bundle"]
    jax_graph = bundle.graph
    jmodel = jax_build_model(jcfg, jax_graph)
    jtrainer = JaxTrainer(jmodel, jax_graph, JaxEdgeMasker(jax_graph, seed=4), jcfg, variables=cohort["variables"])
    model = _bridged(cohort)
    trainer = Trainer(model, cohort["graph"], EdgeMasker(cohort["graph"], seed=4), cohort["cfg"], device="cpu")
    assert {model.hgt_0.tier(trainer.graph, nt) for nt in model.hgt_0.groups()} == {"flash"}

    jbatch, batch = jtrainer._get_batch("train"), trainer.get_batch("train")
    np.testing.assert_array_equal(batch.patient_idx.numpy(), np.asarray(jbatch.patient_idx))
    rng = np.random.default_rng(0)
    sup = (rng.random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()

    def loss_fn(params):
        preds, _ = jtrainer._apply_train(params, {}, jax_graph, jbatch, jax.random.key(7))
        w = jtrainer.lab_weights[jbatch.lab_idx]
        return weighted_regression_loss(preds, jbatch.values, w, jnp.asarray(sup), loss_type="mae")

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtrainer.state.params)
    copy = lambda s: jax.tree_util.tree_map(jnp.array, s)  # noqa: E731 (donation)
    jstate, jloss_step = jtrainer._train_step(
        copy(jtrainer.state), jax_graph, jbatch, jtrainer.lab_weights, jnp.asarray(sup), jax.random.key(7),
    )
    loss = trainer.train_step(batch, torch.from_numpy(sup), 0)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(jloss_step), float(jloss), rtol=1e-6)

    want_grads = state_dict_from_flax({"params": jgrads})
    floor = 1e-6 * max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want_grads[name].numpy(), rtol=1e-4, atol=floor, err_msg=name)
    # the last layer's groups into diagnosis and medication feed nothing
    assert float(model.hgt_1.out_diagnosis.weight.grad.abs().max()) == 0.0
    want = state_dict_from_flax({"params": jstate.params})
    got = model.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=4e-4, err_msg=key)
