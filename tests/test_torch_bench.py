"""PyTorch port: ``tools/bench.py`` against the repo root's ``bench.py``.

* ``--help`` lists the JAX bench's flags.
* ``run_bench(epochs=2, device="cpu")`` at ``eicu_demo`` returns the JAX
  bench's key set (plus ``kernel_launches``), and its ``params`` and
  ``train_edges`` equal JAX ``count_parameters`` and the JAX masker's train
  size for the same configuration.
* ``--clusters`` below 1, ``--bf16`` and ``--lab-tile-mode block`` raise
  ``ConfigError``; without a card the bench raises, and its command line
  exits non-zero with no JSON line (no CPU fallback).  ``--clusters 2``
  runs in ``tests/test_torch_minibatch.py``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from multi_modal_gnn_tpu.config import Config as JaxConfig
from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec as JaxSpec
from multi_modal_gnn_tpu.data.synthetic import make_synthetic_bundle
from multi_modal_gnn_tpu.models.factory import build_model as jax_build_model
from multi_modal_gnn_tpu.models.factory import count_parameters, init_model_variables
from multi_modal_gnn_tpu.training.masker import EdgeMasker as JaxEdgeMasker
from multi_modal_gnn_tpu_torch.config import ConfigError
from multi_modal_gnn_tpu_torch.tools import bench

REPO = Path(__file__).resolve().parent.parent
# the keys of the JAX bench's JSON line (bench.py run_bench) on one device
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "config", "arch", "aggregation_impl",
    "compute_dtype", "lab_tile_rows", "device", "train_edges", "timed_epochs",
    "epoch_time_ms", "warmup_s", "graph_build_s", "params", "final_train_loss",
}


def _flags(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", help_text.split("options:")[1]))


def test_help_lists_the_jax_flags(capsys):
    jax_help = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--help"], capture_output=True, text=True, timeout=120,
    )
    assert jax_help.returncode == 0
    with pytest.raises(SystemExit) as exit_info:
        bench.main(["--help"])
    assert exit_info.value.code == 0
    ours = _flags(capsys.readouterr().out)
    assert ours == _flags(jax_help.stdout) and "--no-dense" in ours and "--lab-tile-rows" in ours
    args = bench.parse_args(["--scale", "--no-dense", "--arch", "hgt", "--lab-tile-rows", "0"])
    assert (args.scale, args.dense, args.arch, args.lab_tile_rows) == (True, False, "hgt", 0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the suite runs in several worker processes at once: torch's intra-op
    # threads in each would oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def eicu_bundle():
    return make_synthetic_bundle(JaxSpec.eicu_demo(), JaxConfig())


def test_cpu_run_prints_the_jax_keys_and_counts(eicu_bundle):
    result = bench.run_bench(epochs=2, device="cpu")
    assert set(result) == JAX_KEYS | {"kernel_launches"}
    json.dumps(result)
    assert result["device"] == "cpu" and result["arch"] == "RGCN" and result["config"] == "eicu_demo_synthetic"
    assert result["timed_epochs"] == 2 and result["value"] > 0 and result["final_train_loss"] > 0
    assert result["kernel_launches"] == {}  # CPU tensors take the plain versions

    jcfg = JaxConfig()
    graph = eicu_bundle.graph
    variables = init_model_variables(jax_build_model(jcfg, graph), graph, jax.random.PRNGKey(0))
    assert result["params"] == count_parameters(variables["params"])
    tc = jcfg.train
    masker = JaxEdgeMasker(
        graph, train_split=tc.train_split, val_split=tc.val_split, test_split=tc.test_split,
        mask_fraction=tc.mask_fraction, seed=tc.seed, host_edges=eicu_bundle.patient_lab_host(),
    )
    assert result["train_edges"] == masker.split_sizes()["train"]


@pytest.mark.parametrize(
    "kwargs", [{"clusters": 0}, {"bf16": True}, {"lab_tile_mode": "block", "lab_tile_rows": 256}]
)
def test_what_the_port_does_not_run_is_refused(kwargs):
    with pytest.raises(ConfigError):
        bench.run_bench(epochs=1, device="cpu", **kwargs)


def test_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(epochs=1)
    proc = subprocess.run(
        [sys.executable, "-m", "multi_modal_gnn_tpu_torch.tools.bench", "--epochs", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "train_patient_lab_edges_per_sec" not in proc.stdout
