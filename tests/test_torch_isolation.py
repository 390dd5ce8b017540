"""PyTorch port: the package runs where the JAX stack is absent.

The card's machine has no jax, flax, pandas or yaml.  A subprocess makes
them (and the JAX package) unimportable, then imports every module of the
port, builds a tiny graph from the port's generator and serves a request on
the CPU with the RGCN and with the HGT on its flash-attention tier.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "pandas", "yaml", "multi_modal_gnn_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import: {name}")
            return None

    for name in list(sys.modules):
        if blocked(name):
            del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import multi_modal_gnn_tpu_torch as pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)

    import torch
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, make_synthetic_graph
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.serving import build_serving_fn, predict_patient

    config = Config.from_dict({"model": {"hidden_dim": 16, "use_pallas": True}})
    graph = make_synthetic_graph(SyntheticSpec.tiny(), config, device="cpu")
    model = build_model(config, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    fn, _ = build_serving_fn(model, graph)
    out = predict_patient(fn, 0, graph.num_nodes("lab"))
    assert out.shape == (graph.num_nodes("lab"),) and bool(torch.isfinite(out).all())

    from multi_modal_gnn_tpu_torch.graph.attn_plan import ensure_attn_plans
    hgt = Config.from_dict({"model": {
        "architecture": "HGT", "hidden_dim": 16, "use_pallas": True,
        "extras": {"hgt_dense_attn_bytes": 0},
    }})
    graph = ensure_attn_plans(graph, hgt)
    model = build_model(hgt, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    assert {model.hgt_0.tier(graph, nt) for nt in model.hgt_0.groups()} == {"flash"}
    fn, _ = build_serving_fn(model, graph)
    out = predict_patient(fn, 0, graph.num_nodes("lab"))
    assert out.shape == (graph.num_nodes("lab"),) and bool(torch.isfinite(out).all())
    assert not any(blocked(name) for name in sys.modules), sorted(sys.modules)
    print("ISOLATED-OK")
    """
)


def test_port_runs_without_the_jax_stack():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


def test_no_source_file_names_the_jax_stack():
    import ast

    blocked = ("jax", "jaxlib", "flax", "optax", "pandas", "yaml", "multi_modal_gnn_tpu")
    files = sorted((REPO / "multi_modal_gnn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in blocked, f"{path.name} imports {name}"
