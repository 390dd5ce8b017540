"""PyTorch port: Cluster-GCN mini-batch training in bfloat16 against the JAX
package, on the CPU.

One bfloat16 cluster step (the cluster with base > 0 of K = 3) on
``test_torch_minibatch``'s 600-patient cohort, on the kernel path (JAX's
Pallas kernels in interpret mode sum in float32, as the port's do), from the
port's seeded weights (``test_torch_value_context.flax_variables``) and one
supervision mask, dropout 0, against JAX
``MiniBatchTrainer._train_step_impl`` on the same partition, bfloat16 op by
op and float32 compiled (``tests/test_torch_bf16_slice.py``): the loss and
Adam's first moment (the step's gradient) within ``test_torch_bf16.RATIO``
of JAX's bfloat16 - float32 effect, the parameters within ``2e-3``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.training import minibatch as jax_minibatch
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.training import EdgeMasker, MiniBatchTrainer
from test_torch_bf16 import RATIO, _adam_first_moments, _feeds_batch_norm, _ratio
from test_torch_minibatch import _bundles
from test_torch_minibatch import _config_dict as cluster_config
from test_torch_value_context import flax_variables

BF = "bfloat16"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bf16_cluster_step_matches_jax():
    """The module docstring's step."""
    d = cluster_config(dropout=0.0)
    d["model"]["use_pallas"] = True
    jbundle, bundle = _bundles(600, d)
    k = 1
    cfg = Config.from_dict({**d, "model": {**d["model"], "compute_dtype": BF}})
    model = build_model(cfg, bundle.graph, device="cpu", generator=torch.Generator().manual_seed(3))
    variables = flax_variables(model)
    trainer = MiniBatchTrainer(model, bundle, EdgeMasker(bundle.graph, seed=0), cfg, num_clusters=3, device="cpu")
    cd = trainer._ensure_clusters()
    assert cd.bases[k] > 0
    batch, graph = cd.batches["train"][k][0], cd.subgraphs[k]
    sup = (np.random.default_rng(k).random(batch.valid.shape[0]) < 0.4).astype(np.float32) * batch.valid.numpy()
    results = {}
    for dtype in (BF, "float32"):
        jcfg = JaxConfig.from_dict({**d, "model": {**d["model"], "compute_dtype": dtype}})
        jtrainer = jax_minibatch.MiniBatchTrainer(
            jax_build_model(jcfg, jbundle.graph), jbundle,
            JaxEdgeMasker(jbundle.graph, seed=0, host_edges=jbundle.patient_lab_host()), jcfg,
            num_clusters=3, variables=jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), variables),
        )
        jcd = jtrainer._ensure_clusters()
        args = (jtrainer.state, jcd.subgraphs[k], jcd.batches["train"][k][0], jtrainer.lab_weights,
                jnp.asarray(sup), jax.random.key(7))
        jstate, jloss = jtrainer._train_step_impl(*args) if dtype == BF else jtrainer._train_step(*args)
        jax.block_until_ready(jstate)
        results[dtype] = (float(jloss), state_dict_from_flax({"params": jstate.params}),
                          state_dict_from_flax({"params": _adam_first_moments(jstate.opt_state)}))
    loss = trainer.train_step(batch, torch.from_numpy(sup), 0, graph=graph)
    (lb, pb, mb), (lf, _, mf) = results[BF], results["float32"]
    assert _ratio(np.float32(loss), lb, lf) <= RATIO
    # a tensor's bound also allows 1e-4 of the step's largest gradient: on a
    # cluster some relations' weights get gradients 1e-4 of the largest,
    # which hold only rounding noise on both sides
    largest = 100 * max(np.linalg.norm(m.numpy()) for m in mb.values())
    ratios = {}
    for name, value in model.named_parameters():
        got = trainer.optimizer.state[value]["exp_avg"].numpy()
        if _feeds_batch_norm(name):
            assert np.linalg.norm(got) <= 2 * np.linalg.norm(mb[name].numpy()) + 1e-6 * largest, name
            continue
        diff, effect = np.linalg.norm(got - mb[name].numpy()), np.linalg.norm(mb[name].numpy() - mf[name].numpy())
        assert diff <= RATIO * effect + 1e-6 * largest, (name, diff, effect)
        if effect > 1e-6 * largest:
            ratios[name] = diff / effect
        np.testing.assert_allclose(value.detach().numpy(), pb[name].numpy(), atol=2e-3, err_msg=name)
    print("\nbf16 cluster step: largest gradient ratios", sorted(ratios.items(), key=lambda kv: -kv[1])[:5])
