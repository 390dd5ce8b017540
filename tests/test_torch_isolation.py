"""PyTorch port: the package runs where the JAX stack is absent.

The card's machine has no jax, flax, pandas or yaml.  A subprocess makes
them (and the JAX package) unimportable, then imports every module of the
port, builds a tiny graph from the port's generator and serves a request on
the CPU with the RGCN and with the HGT on its flash-attention tier, runs the
RGCN's dual heads (``dual_head_fusion: on``) on a slot-major batch, the
gather probe's plain versions and command line, and the trainer's lifecycle:
``train_pipeline`` for 2 epochs into a temporary directory (checkpoints,
resume from them) and ``evaluate_model`` on its best state; and the
pipeline command line (``python -m multi_modal_gnn_tpu_torch.pipeline
--device cpu``) on a tiny synthetic config written by ``save_config``:
preprocess, graph build, train, evaluate, audit, inference and the serving
export, whose artifact ``ServingModel`` then loads and serves; and the
raw-data ingest: small MIMIC-III and eICU raw directories through
``preprocess_pipeline`` and the graph build.  matplotlib, sklearn,
networkx and umap are blocked too, as on the card: the command line's
visualize step writes ``per_lab_calibration.csv``, names each figure it
left out and the run exits 0.  Those four libraries are imported only
inside the functions that draw.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "pandas", "yaml", "msgpack", "multi_modal_gnn_tpu",
               "matplotlib", "sklearn", "networkx", "umap")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    # torch.export's partitioner imports networkx at module level in some
    # torch releases: load it before the block, as a torch without that
    # import would not need networkx at all
    import torch._functorch.partitioners  # noqa: F401

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import: {name}")
            return None

    for name in list(sys.modules):
        if blocked(name):
            del sys.modules[name]
    # as where they are not installed: imports fail, importlib.util.find_spec
    # (which torch._dynamo calls on them) returns None
    for name in BLOCKED:
        sys.modules[name] = None
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

    from multi_modal_gnn_tpu_torch.ops import gather_probe, pairhead_kernels
    from multi_modal_gnn_tpu_torch.tools import bench_gather
    from multi_modal_gnn_tpu_torch.training import EdgeMasker
    dual = Config.from_dict({"model": {
        "hidden_dim": 16, "use_pallas": True,
        "extras": {"head_style": "factored", "dual_head_fusion": "on"},
    }})
    graph = make_synthetic_graph(SyntheticSpec.tiny(), dual, device="cpu")
    model = build_model(dual, graph, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = EdgeMasker(graph, slot_major_train=True, slot_major_min_rows=0).get_split("train")
    preds = model.predict_lab_values(
        graph, batch.patient_idx, batch.lab_idx, patient_plan=batch.patient_plan,
        degrees=graph.patient_lab_degree[batch.patient_idx.long()],
    )
    assert bool(torch.isfinite(preds).all())
    args = bench_gather.parse_args(["--tiles", "1", "--rows", "32", "--h", "16"])
    idx, table, padded = (torch.from_numpy(a) for a in bench_gather.make_inputs(args))
    sums = [gather_probe.gather_probe_indicator(idx, table),
            gather_probe.gather_probe_padded(idx, padded, 16),
            gather_probe.gather_probe_direct(idx, table)]
    assert all(torch.allclose(s, sums[0], atol=1e-5) for s in sums)
    assert not any(gather_probe.launch_counts.values()) and not any(pairhead_kernels.launch_counts.values())

    import json, tempfile
    from pathlib import Path
    from multi_modal_gnn_tpu_torch.evaluation import evaluate_model
    from multi_modal_gnn_tpu_torch.training import Trainer, train_pipeline
    life = Config.from_dict({
        "model": {"hidden_dim": 16, "use_pallas": True}, "train": {"epochs": 2},
        "logging": {"checkpoint_interval": 1},
        "evaluation": {"baselines": ["global_mean", "per_lab_mean", "als"]},
    })
    graph = make_synthetic_graph(SyntheticSpec.tiny(), life, device="cpu")
    with tempfile.TemporaryDirectory() as out:
        trainer, results = train_pipeline(life, graph, out, device="cpu")
        assert results["num_epochs"] == 2 and Trainer.latest_checkpoint(out).name == "checkpoint_epoch_2.ckpt"
        trainer.restore(Path(out) / "checkpoint_epoch_1.ckpt")
        assert trainer.epoch == 1
        res = evaluate_model(trainer, graph, life, output_dir=out)
        saved = json.loads((Path(out) / "evaluation_results.json").read_text())
        assert set(saved["baselines"]) == {"global_mean", "per_lab_mean", "als_matrix_factorization"}
        assert (Path(out) / "per_lab_metrics.csv").exists() and (Path(out) / "conformal.json").exists()
        assert res["overall_metrics"]["mae"] > 0
    from multi_modal_gnn_tpu_torch import pipeline
    from multi_modal_gnn_tpu_torch.config import load_config, save_config
    with tempfile.TemporaryDirectory() as out:
        cli = Config.from_dict({
            "data": {"dataset": "synthetic", "interim_dir": f"{out}/interim", "output_dir": f"{out}/out",
                     "synthetic": {"preset": "tiny", "seed": 2}},
            "model": {"hidden_dim": 16}, "train": {"epochs": 2},
            "evaluation": {"baselines": ["global_mean"]},
            "logging": {"log_file": f"{out}/out/training.log"},
        })
        path = save_config(cli, Path(out) / "config.yaml")
        assert load_config(path) == cli
        assert pipeline.main(["--config", str(path), "--no-confirm", "--device", "cpu"]) == 0
        names = {p.name for p in (Path(out) / "out").iterdir()}
        assert {"graph.npz", "best_model.ckpt", "evaluation_results.json", "audit_report.json",
                "inference_examples.json", "serving"} <= names, names
        # step 6 without matplotlib: the calibration table, no figure, each one named
        assert (Path(out) / "out" / "advanced_visualizations" / "per_lab_calibration.csv").exists()
        assert not list((Path(out) / "out").rglob("*.png"))
        log = (Path(out) / "out" / "training.log").read_text()
        assert "matplotlib is not installed: left out" in log and "parity_plot.png" in log, log[-2000:]
        from multi_modal_gnn_tpu_torch.serving import ServingModel
        served = ServingModel.load(Path(out) / "out" / "serving", device="cpu")
        report = served.predict_patient(0, denormalize=True)
        assert len(report) == served.manifest["num_labs"] and len(served.predict_cold_start({0: 0.5})) == len(report)
    # the raw-data ingest: MIMIC-III (the graph core's scan) and eICU CSVs to
    # interim tables and a graph, with no pandas
    from multi_modal_gnn_tpu_torch.data.preprocess import preprocess_pipeline
    from multi_modal_gnn_tpu_torch.graph.build import build_graph_from_preprocessed
    from multi_modal_gnn_tpu_torch.tools import bench_etl
    with tempfile.TemporaryDirectory() as out:
        out = Path(out)
        bench_etl.emit_raw_mimic(out / "mimic", 300, 6000, num_labs=40, num_dx=30, num_rx=20)
        raw_cfgs = (
            bench_etl.etl_config(out / "mimic", out / "mi", out / "mo"),
            bench_etl.eicu_config(bench_etl.emit_raw_eicu(out / "eicu", num_stays=200, labs_per_stay=8), out / "e"),
        )
        for raw_cfg in raw_cfgs:
            tables = preprocess_pipeline(raw_cfg, interim_dir=raw_cfg.data.interim_dir)
            assert len(tables["normalizer"]["lab_id"]) and len(tables["labs_normalized"]["VALUE_NORMALIZED"])
            assert build_graph_from_preprocessed(raw_cfg.data.interim_dir, raw_cfg).graph.num_nodes("lab") > 0
    assert not any(blocked(name) and sys.modules[name] is not None for name in sys.modules), sorted(sys.modules)
    print("ISOLATED-OK")
    """
)


def test_port_runs_without_the_jax_stack():
    # one CPU thread, as the suite's other CPU training tests pin theirs: the
    # suite runs several workers at once, and tiny models gain nothing from more
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


def test_no_source_file_names_the_jax_stack():
    import ast

    blocked = ("jax", "jaxlib", "flax", "optax", "pandas", "yaml", "msgpack", "multi_modal_gnn_tpu")
    drawing = ("matplotlib", "sklearn", "networkx", "umap")  # only inside the functions that draw
    files = sorted((REPO / "multi_modal_gnn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        in_functions = {
            id(inner) for fn in ast.walk(tree) if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            for inner in ast.walk(fn)
        }
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)) and id(node) not in in_functions:
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in drawing for n in names), f"{path.name} imports {names} at module level"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in blocked, f"{path.name} imports {name}"
