"""PyTorch port: reading the JAX package's checkpoints without flax or msgpack.

* ``utils/msgpack.unpackb`` decodes what ``msgpack.packb`` writes as
  ``msgpack.unpackb`` does, on a seeded set of nested values: every integer
  width, float32 and float64, str and bin of each length class, nil and
  booleans, every extension length class, maps and arrays of each length
  class.  ``flax_restore`` equals
  ``flax.serialization.msgpack_restore``.
* ``load_flax_checkpoint`` on a checkpoint that JAX ``Trainer.fit`` wrote
  from a tiny model gives exactly the parameters, BatchNorm statistics and
  Adam moments (through the weight bridge, kernels transposed) that
  ``flax.serialization`` reads, and the port's ``Trainer.restore`` takes it
  and trains on.
"""

import dataclasses

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.training.masker import masker_from_config as jax_masker_from_config
from multi_modal_gnn_tpu.training.trainer import Trainer as JaxTrainer
from multi_modal_gnn_tpu_torch.config import Config
from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
from multi_modal_gnn_tpu_torch.models import build_model, state_dict_from_flax
from multi_modal_gnn_tpu_torch.training import Trainer, load_flax_checkpoint, masker_from_config
from multi_modal_gnn_tpu_torch.utils import msgpack as port_msgpack


def _values(rng: np.random.Generator, depth: int = 0):
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)]
    leaves = [
        ints[int(rng.integers(len(ints)))],
        float(rng.standard_normal()),
        "s" * int(rng.choice([0, 5, 31, 32, 255, 256, 70000])),
        "ü" * int(rng.integers(1, 40)),
        bytes(rng.integers(0, 256, int(rng.choice([0, 7, 255, 256, 70000])), dtype=np.uint8)),
        None, True, False,
        msgpack.ExtType(int(rng.integers(0, 128)), b"x" * int(rng.choice([1, 2, 3, 4, 8, 16, 17, 300, 70000]))),
    ]
    if depth >= 3:
        return leaves[int(rng.integers(len(leaves)))]
    n = int(rng.choice([0, 3, 15, 16, 17]))
    if rng.random() < 0.5:
        return [_values(rng, depth + 1) for _ in range(n)]
    return {f"k{i}": _values(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(6))
def test_msgpack_decoder_matches_msgpack(seed):
    rng = np.random.default_rng(seed)
    tree = _values(rng)
    if seed == 0:  # array 32 and map 32, decoded once: they hold no float, bytes or ext
        big = msgpack.packb([list(range(65536)), {str(i): i for i in range(65536)}])
        assert port_msgpack.unpackb(big) == msgpack.unpackb(big, raw=False)
    for single_float in (False, True):
        blob = msgpack.packb(tree, use_bin_type=True, use_single_float=single_float)
        assert port_msgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False)
        assert port_msgpack.unpackb(blob, raw=True) == msgpack.unpackb(blob, raw=True)
        hook = lambda code, data: (code, len(data), data[:3])  # noqa: E731
        assert port_msgpack.unpackb(blob, ext_hook=hook) == msgpack.unpackb(blob, raw=False, ext_hook=hook)
    with pytest.raises(ValueError):
        port_msgpack.unpackb(msgpack.packb([1, 2, 3])[:-1])


def test_flax_restore_matches_flax():
    rng = np.random.default_rng(0)
    tree = {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": {"c": np.int32(7), "d": rng.integers(0, 9, (4,)).astype(np.int64), "e": (1, 2.5)},
        "f": np.zeros((0, 2), np.float64),
        "g": {},
    }
    want = serialization.msgpack_restore(serialization.to_bytes(tree))
    got = port_msgpack.flax_restore(serialization.to_bytes(tree))

    def check(g, w):
        assert type(g) is type(w) or isinstance(w, np.generic)
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                check(g[k], w[k])
        elif isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w

    check(got, want)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A tiny JAX Trainer fitted for 3 epochs with a checkpoint each epoch."""
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, hidden_dim=16, dropout=0.0),
        train=dataclasses.replace(jcfg.train, epochs=3),
        logging=dataclasses.replace(jcfg.logging, checkpoint_interval=1),
    )
    bundle = make_synthetic_bundle(JaxSpec.tiny(), jcfg)
    trainer = JaxTrainer(jax_build_model(jcfg, bundle.graph), bundle.graph,
                         jax_masker_from_config(jcfg, bundle), jcfg)
    out = tmp_path_factory.mktemp("jax_run")
    trainer.fit(output_dir=out)
    return jcfg, trainer, out


def _flax_moments(tree, key):
    inner = tree["opt_state"]["inner_state"]["1"]["0"]  # add_decayed_weights, then adam
    return inner[key]


@pytest.mark.parametrize("name", ["checkpoint_epoch_2.ckpt", "best_model.ckpt"])
def test_flax_checkpoint_reads_as_flax_does(jax_run, name):
    _, _, out = jax_run
    blob = (out / name).read_bytes()
    want = serialization.msgpack_restore(blob)
    payload, meta = load_flax_checkpoint(out / name)

    for key, tree in (("model", want["state"]), ("best_model", want["best_state"])):
        ref = state_dict_from_flax({"params": tree["params"], "batch_stats": tree["batch_stats"]})
        assert set(payload[key]) == set(ref)
        for k, v in ref.items():
            assert torch.equal(payload[key][k], v), (key, k)
    mu = state_dict_from_flax({"params": _flax_moments(want["state"], "mu")})
    nu = state_dict_from_flax({"params": _flax_moments(want["state"], "nu")})
    count = float(_flax_moments(want["state"], "count"))
    assert count == meta["epoch"] > 0
    names = {k for k in mu if not k.endswith("num_batches_tracked")}
    assert set(payload["adam"]) == names
    for k in names:
        assert torch.equal(payload["adam"][k]["exp_avg"], mu[k]), k
        assert torch.equal(payload["adam"][k]["exp_avg_sq"], nu[k]), k
        assert float(payload["adam"][k]["step"]) == count
    # a kernel's moments are transposed as its weight is
    kernel = want["state"]["params"]["edge_predictor"]["dense_0"]["kernel"]
    moment = _flax_moments(want["state"], "mu")["edge_predictor"]["dense_0"]["kernel"]
    assert payload["adam"]["edge_predictor.dense_0.weight"]["exp_avg"].shape == kernel.T.shape
    np.testing.assert_array_equal(payload["adam"]["edge_predictor.dense_0.weight"]["exp_avg"].numpy(), moment.T)
    assert meta["model_hash"] == Config.from_dict(meta["config"]).model_hash()


def test_trainer_restores_a_jax_checkpoint(jax_run):
    jcfg, jtrainer, out = jax_run
    cfg = Config.from_dict(jcfg.to_dict())
    graph = make_synthetic_graph(SyntheticSpec.tiny(), cfg, device="cpu")
    model = build_model(cfg, graph, device="cpu")
    trainer = Trainer(model, graph, masker_from_config(cfg, graph), cfg, device="cpu")
    trainer.restore(out / "checkpoint_epoch_3.ckpt")
    assert (trainer.epoch, trainer.best_val_loss) == (3, jtrainer.best_val_loss)
    assert trainer.history["val_loss"] == jtrainer.history["val_loss"]
    want = state_dict_from_flax({"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats})
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
    # the JAX eval step and the port's agree on the restored weights
    np.testing.assert_allclose(trainer.validate("val"), jtrainer.validate("val"), rtol=1e-5)
    loss = trainer.train_epoch()
    assert np.isfinite(loss) and trainer.optimizer.state[next(model.parameters())]["step"] == 4
