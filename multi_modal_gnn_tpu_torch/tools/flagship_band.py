"""The flagship config's quality band: run the port's pipeline command line
on ``conf/eicu_real.yaml`` once per train seed and report each run's guarded
(±3σ-winsorized) test R² and MAE beside its ``per_lab_mean`` baseline.

    python -m multi_modal_gnn_tpu_torch.tools.flagship_band [--seeds 42,43,44]
        [--device cuda | cpu] [--config conf/eicu_real.yaml]
        [--dtype float32 | bfloat16] [--repeats N] [--draws card | cpu]

Each seed gets a copy of the config (written by ``save_config``) with
``train.seed`` set and ``data.interim_dir``, ``data.output_dir`` and
``logging.log_file`` inside a temporary directory, so nothing is written to
the repo.  Each run is ``python -m multi_modal_gnn_tpu_torch.pipeline``
(steps 1-8) on ``--device``; with ``--draws cpu`` it is
``python -m multi_modal_gnn_tpu_torch.tools.cpu_draws`` with the same
arguments, which takes the dropout and supervision draws from the CPU's
generators, as a CPU run of the seed draws them.  The data seed stays the
config's.
A warm-start band runs ``--config`` on the file that
:func:`warm_start_config` derives; ``--dtype`` runs the config with
``model.compute_dtype`` set (:func:`dtype_config`).  ``--repeats`` runs
each seed that many times, to show how far runs of one seed spread on the
card.  Prints one JSON line.  The JAX package's band at the same seeds comes from
``scripts/flagship_band_jax.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = (
    "graph.npz", "graph.meta.json", "best_model.ckpt", "training_history.json", "test_results.json",
    "evaluation_results.json", "per_lab_metrics.csv", "conformal.json", "audit_report.json",
    "inference_examples.json", "advanced_visualizations/per_lab_calibration.csv", "serving/serving.json",
    "serving/weights.npz", "serving/pairs_b256.pt2", "serving/pairs_b4096.pt2", "serving/coldstart.npz",
    "serving/conformal.json", "serving/conformal_cold.json",
)


def seed_config(config_path, seed: int, workdir: Path, **sections):
    """The config at ``config_path`` with ``train.seed`` and its directories
    set inside ``workdir``, each of ``sections`` (a section name: a dict of
    field replacements; an ``extras`` dict is merged into the section's
    own) applied, written to ``workdir/config.yaml``."""
    from multi_modal_gnn_tpu_torch.config import load_config, save_config

    cfg = load_config(config_path)
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, interim_dir=str(workdir / "interim"), output_dir=str(workdir / "out")
        ),
        logging=dataclasses.replace(cfg.logging, log_file=str(workdir / "out" / "training.log")),
        train=dataclasses.replace(cfg.train, seed=int(seed)),
    )
    for name, fields in sections.items():
        section = getattr(cfg, name)
        if "extras" in fields:
            fields = {**fields, "extras": {**section.extras, **fields["extras"]}}
        cfg = cfg.replace(**{name: dataclasses.replace(section, **fields)})
    save_config(cfg, workdir / "config.yaml")
    return cfg


def warm_start_config(config_path, out_path, warm_start: str = "sideinfo") -> Path:
    """Write the config at ``config_path`` with ``train.extras.warm_start``
    set and the bilinear channel it plants into written out
    (``training.warmstart.wire_warm_start``: ``bilinear_rank`` 17 for
    ``sideinfo`` at the default ranks 8 and 8, ``bilinear_source:
    embedding``) to ``out_path``, by ``save_config``.  Written out, every
    pipeline step builds the model the train step trained: a config that
    leaves the wiring to ``train_pipeline`` trains a model whose checkpoint
    the later steps refuse (its model hash differs), in both packages."""
    from multi_modal_gnn_tpu_torch.config import load_config, save_config
    from multi_modal_gnn_tpu_torch.training.warmstart import wire_warm_start

    cfg = load_config(config_path)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, extras={**cfg.train.extras, "warm_start": warm_start}))
    return save_config(wire_warm_start(cfg), out_path)


def dtype_config(config_path, out_path, dtype: str = "bfloat16") -> Path:
    """Write the config at ``config_path`` with ``model.compute_dtype`` set
    to ``dtype`` to ``out_path`` (the flagship in bfloat16: ``python
    scripts/flagship_band_jax.py --config <out_path>`` runs JAX's side)."""
    from multi_modal_gnn_tpu_torch.config import load_config, save_config

    cfg = load_config(config_path)
    return save_config(cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype)), out_path)


def parallel_config(config_path, out_path) -> Path:
    """Write the config at ``config_path`` with ``train.extras.parallel:
    dp`` to ``out_path``: the flagship trained edge-sharded
    over the ranks of a ``torch.distributed.run`` launch
    (:func:`run_seed` with ``ranks``)."""
    from multi_modal_gnn_tpu_torch.config import load_config, save_config

    cfg = load_config(config_path)
    train = dataclasses.replace(cfg.train, extras={**cfg.train.extras, "parallel": "dp"})
    return save_config(cfg.replace(train=train), out_path)


def read_result(out_dir: Path) -> Dict:
    """Guarded R² / MAE, the per_lab_mean baseline's R², the epochs trained
    and the best validation loss, the audit's leak flags and the missing
    artifacts of one run's output directory."""
    results = json.loads((out_dir / "evaluation_results.json").read_text())
    trained = json.loads((out_dir / "test_results.json").read_text())
    audit = json.loads((out_dir / "audit_report.json").read_text())
    visibility = audit["masked_value_visibility"]
    return {
        "r2": results["overall_metrics"]["r2"],
        "mae": results["overall_metrics"]["mae"],
        "per_lab_mean_r2": results["baselines"]["per_lab_mean"]["r2"],
        "epochs": trained["num_epochs"],
        "best_val_loss": trained["best_val_loss"],
        "leak": bool(
            visibility["supervision_leak"] or visibility["masked_values_in_other_edges"]
            or visibility["masked_values_in_node_features"] or not visibility["splits_exhaustive"]
            or not visibility["train_only_supervision"]
        ),
        "missing": [name for name in ARTIFACTS if not (out_dir / name).exists()],
    }


def run_seed(config_path, seed: int, workdir: Path, device: str = "cuda", steps: Optional[str] = None,
             draws: str = "card", ranks: int = 1) -> Dict:
    """One pipeline run (see the module docstring): :func:`read_result`
    plus each step's wall seconds.  ``steps`` is the command line's
    ``--step`` (all eight steps when None); ``draws="cpu"`` runs it
    through :mod:`~multi_modal_gnn_tpu_torch.tools.cpu_draws`; ``ranks >
    1`` launches it over that many ranks with ``python -m
    torch.distributed.run --standalone --nproc-per-node ranks`` (a config
    with ``train.extras.parallel: dp``, :func:`parallel_config`)."""
    workdir.mkdir(parents=True, exist_ok=True)
    seed_config(config_path, seed, workdir)
    module = {"card": "multi_modal_gnn_tpu_torch.pipeline", "cpu": "multi_modal_gnn_tpu_torch.tools.cpu_draws"}[draws]
    launcher = [sys.executable]
    if ranks > 1:
        launcher += ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks)]
    command = [*launcher, "-m", module, "--config",
               str(workdir / "config.yaml"), "--no-confirm", "--device", device]
    if steps is not None:
        command += ["--step", steps]
    proc = subprocess.run(command, cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(command)} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
        )
    step_seconds = json.loads(proc.stdout.strip().splitlines()[-1])["step_seconds"]
    return {**read_result(workdir / "out"), "step_seconds": step_seconds}


def run_band(config_path, seeds: Sequence[int], device: str, repeats: int = 1,
             steps: Optional[str] = None, draws: str = "card") -> Dict:
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            seed: [run_seed(config_path, seed, Path(tmp) / f"seed{seed}_{r}", device, steps, draws)
                   for r in range(repeats)]
            for seed in seeds
        }
    firsts = [seed_runs[0] for seed_runs in runs.values()]
    return {
        "impl": "torch",
        "config": str(config_path),
        "seeds": {seed: seed_runs[0] if repeats == 1 else seed_runs for seed, seed_runs in runs.items()},
        "mean_r2": statistics.fmean(r["r2"] for r in firsts),
        "mean_mae": statistics.fmean(r["mae"] for r in firsts),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seeds", default="42,43,44")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--config", default=str(REPO / "conf" / "eicu_real.yaml"))
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                        help="set model.compute_dtype (default: the config's)")
    parser.add_argument("--repeats", type=int, default=1, help="runs of each seed")
    parser.add_argument("--draws", choices=("card", "cpu"), default="card",
                        help="cpu: dropout and supervision draws from the CPU's generators (tools/cpu_draws.py)")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        config = args.config if args.dtype is None else dtype_config(
            args.config, Path(tmp) / f"config_{args.dtype}.yaml", args.dtype)
        print(json.dumps(run_band(config, seeds, args.device, args.repeats, draws=args.draws)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
