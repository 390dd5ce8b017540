"""The flagship config's quality band: run the port's pipeline command line
on ``conf/eicu_real.yaml`` once per train seed and report each run's guarded
(±3σ-winsorized) test R² and MAE beside its ``per_lab_mean`` baseline.

    python -m multi_modal_gnn_tpu_torch.tools.flagship_band [--seeds 42,43,44]
        [--device cuda | cpu] [--config conf/eicu_real.yaml]

Each seed gets a copy of the config (written by ``save_config``) with
``train.seed`` set and ``data.interim_dir``, ``data.output_dir`` and
``logging.log_file`` inside a temporary directory, so nothing is written to
the repo.  Each run is ``python -m multi_modal_gnn_tpu_torch.pipeline``
(steps 1-5 and 7) on ``--device``.  The data seed stays the config's.
Prints one JSON line.  The JAX package's band at the same seeds comes from
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
from typing import Dict, Sequence

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = (
    "graph.npz", "graph.meta.json", "best_model.ckpt", "training_history.json", "test_results.json",
    "evaluation_results.json", "per_lab_metrics.csv", "conformal.json", "audit_report.json",
    "inference_examples.json",
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


def run_seed(config_path, seed: int, workdir: Path, device: str = "cuda") -> Dict:
    """One pipeline run (see the module docstring): :func:`read_result`
    plus each step's wall seconds."""
    workdir.mkdir(parents=True, exist_ok=True)
    seed_config(config_path, seed, workdir)
    command = [sys.executable, "-m", "multi_modal_gnn_tpu_torch.pipeline", "--config",
               str(workdir / "config.yaml"), "--no-confirm", "--device", device]
    proc = subprocess.run(command, cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(command)} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
        )
    step_seconds = json.loads(proc.stdout.strip().splitlines()[-1])["step_seconds"]
    return {**read_result(workdir / "out"), "step_seconds": step_seconds}


def run_band(config_path, seeds: Sequence[int], device: str) -> Dict:
    with tempfile.TemporaryDirectory() as tmp:
        runs = {seed: run_seed(config_path, seed, Path(tmp) / f"seed{seed}", device) for seed in seeds}
    return {
        "impl": "torch",
        "config": str(config_path),
        "seeds": runs,
        "mean_r2": statistics.fmean(r["r2"] for r in runs.values()),
        "mean_mae": statistics.fmean(r["mae"] for r in runs.values()),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seeds", default="42,43,44")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--config", default=str(REPO / "conf" / "eicu_real.yaml"))
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(json.dumps(run_band(args.config, seeds, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
