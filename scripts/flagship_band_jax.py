"""The JAX package's quality band on the flagship config: ``run_pipeline.py``
(steps 1-5, then 7) on ``conf/eicu_real.yaml`` on the CPU, once per train
seed, each run's guarded (±3σ-winsorized) test R² and MAE beside its
``per_lab_mean`` baseline.  The PyTorch port is held to this band
(``chip_smoke.py`` phase 21, ``JAX_CPU_BAND``; its own runs come from
``python -m multi_modal_gnn_tpu_torch.tools.flagship_band``).

Usage:
    python scripts/flagship_band_jax.py [--seeds 42,43,44] [--config conf/eicu_real.yaml]

Each seed's config is the port's ``flagship_band.seed_config`` (the same
YAML the port's runs read, with every directory in a temporary one), so
both sides run the same settings.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from multi_modal_gnn_tpu_torch.tools.flagship_band import read_result, seed_config  # noqa: E402


def run_seed(config_path, seed: int, workdir: Path) -> dict:
    workdir.mkdir(parents=True, exist_ok=True)
    seed_config(config_path, seed, workdir)
    env = dict(os.environ, MMGNN_FORCE_CPU="1", JAX_PLATFORMS="cpu")
    for steps in ("1-5", "7"):
        command = [sys.executable, "run_pipeline.py", "--config", str(workdir / "config.yaml"),
                   "--no-confirm", "--step", steps]
        proc = subprocess.run(command, cwd=REPO, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(command)} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
            )
    return read_result(workdir / "out")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seeds", default="42,43,44")
    parser.add_argument("--config", default=str(REPO / "conf" / "eicu_real.yaml"))
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {seed: run_seed(args.config, seed, Path(tmp) / f"seed{seed}") for seed in seeds}
    print(json.dumps({
        "impl": "jax",
        "config": str(args.config),
        "seeds": runs,
        "mean_r2": statistics.fmean(r["r2"] for r in runs.values()),
        "mean_mae": statistics.fmean(r["mae"] for r in runs.values()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
