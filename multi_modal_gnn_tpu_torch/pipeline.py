"""The pipeline command line of the PyTorch package (``run_pipeline.py``):

    python -m multi_modal_gnn_tpu_torch --config conf/eicu_real.yaml --no-confirm
    python -m multi_modal_gnn_tpu_torch.pipeline ...   (the same)

Steps, numbered as in ``run_pipeline.py``; each runs in this process and
hands over to the next only through the artifacts on disk
(``data.interim_dir``, ``data.output_dir``), so any step can be run alone
against existing artifacts:

  1 preprocess      raw eICU / MIMIC-III tables (data.raw_dir) or the synthetic
                    cohort -> interim tables (<name>.npz, normalizer.npz)
  2 build-graph     interim tables -> graph.npz + graph.meta.json
  3 train           graph -> best_model.ckpt, checkpoints, training_history.json,
                    test_results.json
  4 evaluate        best_model.ckpt -> evaluation_results.json, per_lab_metrics.csv,
                    conformal.json
  5 audit           split hygiene + robust metrics -> audit_report.json
  6 visualize       graph structure, training curves, advanced and uncertainty
                    figures (graph_visualizations/, visualizations/,
                    advanced_visualizations/ with per_lab_calibration.csv,
                    uncertainty_visualizations/); a figure whose library
                    (matplotlib, sklearn, networkx) is missing is left out and
                    named, the CSV is written either way
  7 inference       per-patient reports -> inference_examples.json
  8 export-serving  best_model.ckpt -> serving/ (weights.npz, pairs_b{256,4096}.pt2,
                    serving.json, coldstart.npz, conformal.json, conformal_cold.json)

Without ``--step`` all eight steps run.  The steps run on the card and the
command raises without one, unless ``--device cpu`` is given.  A failed
step ends the run with exit code 1.  The last line of standard output is a
JSON object with each step's wall seconds.

Over N ranks (a config with ``train.extras.parallel: dp``, or ``2d`` with
``model_parallel`` M dividing N)::

    python -m torch.distributed.run --nproc-per-node N -m multi_modal_gnn_tpu_torch.pipeline \
        --config ... --no-confirm [--device cpu]

every rank runs the train step, edge-sharded (``parallel/dp.py``; each rank
on card ``LOCAL_RANK % device_count``, NCCL when each has its own, else
gloo); rank 0 alone runs the other steps, writes, and prints the step
lines and the last line.  With ``WORLD_SIZE`` unset a ``parallel: dp``
config trains on one rank.  A ``2d`` run's ``best_model.ckpt`` is JAX's
sharded format (a ``.procNNN.npz`` file a rank), which the later steps
read whole.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch
import torch.distributed

logger = logging.getLogger("multi_modal_gnn_tpu_torch.pipeline")

BOLD, GREEN, RED, YELLOW, CYAN, RESET = (
    "\033[1m", "\033[92m", "\033[91m", "\033[93m", "\033[96m", "\033[0m"
)


@dataclass
class RunOptions:
    device: torch.device
    force: bool = False  # restore checkpoints whose model hash differs
    patient_id: Optional[int] = None
    num_examples: int = 5
    detailed: bool = False


def _load_bundle(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.graph.serialize import load_bundle

    return load_bundle(Path(config.data.output_dir) / "graph", device=opts.device)


def _load_trainer(config, bundle, opts: RunOptions, require_checkpoint: bool = False):
    """The model and masker of ``config`` with ``best_model.ckpt`` restored
    as the live and the best state (a 2-D run's sharded files too); the
    steps after train never train."""
    from multi_modal_gnn_tpu_torch.models.factory import build_model
    from multi_modal_gnn_tpu_torch.training.checkpoint import proc_files
    from multi_modal_gnn_tpu_torch.training.masker import masker_from_config
    from multi_modal_gnn_tpu_torch.training.trainer import Trainer

    masker = masker_from_config(config, bundle.graph)
    model = build_model(config, bundle.graph, device=opts.device)
    trainer = Trainer(model, bundle.graph, masker, config, device=opts.device)
    ckpt = Path(config.data.output_dir) / "best_model.ckpt"
    if ckpt.exists() or proc_files(ckpt):
        trainer.restore(ckpt, force=opts.force)
        trainer.best_state = copy.deepcopy(trainer.model.state_dict())
    elif require_checkpoint:
        raise FileNotFoundError(f"No trained checkpoint at {ckpt}: run the train step first")
    return trainer


def step_preprocess(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.data.preprocess import preprocess_pipeline

    preprocess_pipeline(config, interim_dir=config.data.interim_dir)


def step_build_graph(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.graph.build import build_graph_from_preprocessed

    out = Path(config.data.output_dir)
    build_graph_from_preprocessed(config.data.interim_dir, config, output_path=out / "graph")


def step_train(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.training.trainer import train_pipeline

    bundle = _load_bundle(config, opts)
    resume = "auto" if config.train.extras.get("auto_resume") else None
    train_pipeline(config, bundle, config.data.output_dir, resume_from=resume, device=opts.device)


def step_evaluate(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.evaluation.evaluate import evaluate_model

    bundle = _load_bundle(config, opts)
    trainer = _load_trainer(config, bundle, opts)
    evaluate_model(trainer, bundle.graph, config, output_dir=config.data.output_dir)


def step_audit(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.audit import run_full_audit

    bundle = _load_bundle(config, opts)
    trainer = _load_trainer(config, bundle, opts)
    run_full_audit(config, bundle, trainer, output_dir=config.data.output_dir)


def step_visualize(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.utils.io import load_json
    from multi_modal_gnn_tpu_torch.viz import visualize

    bundle = _load_bundle(config, opts)
    trainer = _load_trainer(config, bundle, opts)
    out = config.data.output_dir
    history_path = Path(out) / "training_history.json"
    history = load_json(history_path) if history_path.exists() else None
    summary = visualize(config, bundle, trainer, history=history, output_dir=out)
    left_out = sorted(Path(p).name for p in summary["left_out"])
    print(
        f"visualize: wrote {[Path(p).name for p in summary['written']]}, drew "
        f"{len(summary['drawn'])} figure(s), left out {len(left_out)}"
        + (f" ({', '.join(sorted(set(summary['left_out'].values())))}): {left_out}" if left_out else "")
    )


def step_inference(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.data.preprocess import load_table
    from multi_modal_gnn_tpu_torch.inference import run_inference

    bundle = _load_bundle(config, opts)
    trainer = _load_trainer(config, bundle, opts)
    cohort_path = Path(config.data.interim_dir) / "cohort.npz"
    run_inference(
        config, bundle, trainer, config.data.output_dir,
        patient_id=opts.patient_id, num_examples=opts.num_examples, detailed=opts.detailed,
        cohort=load_table(cohort_path) if cohort_path.exists() else None,
    )


def step_export_serving(config, opts: RunOptions):
    from multi_modal_gnn_tpu_torch.evaluation.baselines import ALSBaseline
    from multi_modal_gnn_tpu_torch.evaluation.conformal import calibrate_cold_start, calibrate_from_trainer
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT
    from multi_modal_gnn_tpu_torch.serving import export_serving

    bundle = _load_bundle(config, opts)
    trainer = _load_trainer(config, bundle, opts, require_checkpoint=True)
    # cold-start factors: ALS on the train split, so the artifact can fold in
    # patients outside the graph (ServingModel.predict_cold_start)
    p_idx, l_idx, values = trainer.masker.split_arrays("train")
    num_labs = bundle.graph.num_nodes(LAB)
    als = ALSBaseline(bundle.graph.num_nodes(PATIENT), num_labs).fit(values, p_idx, l_idx)
    # conformal radii for predict(return_interval=True), and the fold-in
    # channel's own; skipped when the calibration split is too small
    conformal = conformal_cold = None
    alpha = config.evaluation.extras.get("conformal_alpha", 0.1)
    if alpha:
        try:
            conformal = calibrate_from_trainer(trainer, alpha=float(alpha))
            conformal_cold = calibrate_cold_start(als, trainer.masker, num_labs, alpha=float(alpha))
        except ValueError as e:
            # the point-prediction artifact is still valid: say loudly what it lacks
            logger.warning(
                "Conformal calibration FAILED — serving artifact will have "
                "no prediction intervals (predict(return_interval=True) "
                "will raise): %s", e,
            )
    out = Path(config.data.output_dir) / "serving"
    export_serving(trainer, bundle, out, cold_start=als, conformal=conformal, conformal_cold=conformal_cold)
    print(f"serving artifact: {out} ({sorted(p.name for p in out.iterdir())})")


# (name, description, function)
STEPS = [
    ("preprocess", "Load raw data, select cohort, engineer features", step_preprocess),
    ("build-graph", "Assemble the padded heterogeneous graph", step_build_graph),
    ("train", "Train the GNN with mask-and-recover supervision", step_train),
    ("evaluate", "Winsorized metrics, baselines, stratification", step_evaluate),
    ("audit", "Leakage audit + robust metrics", step_audit),
    ("visualize", "All plot families", step_visualize),
    ("inference", "Per-patient imputation reports", step_inference),
    ("export-serving", "Serving artifact (cached node state)", step_export_serving),
]


def parse_step_range(spec: str, n_steps: int):
    if "-" in spec:
        a, b = spec.split("-", 1)
        lo, hi = int(a), int(b)
    else:
        lo = hi = int(spec)
    if not (1 <= lo <= hi <= n_steps):
        raise ValueError(f"step range {spec} outside 1..{n_steps}")
    return list(range(lo - 1, hi))


def _setup_logging(level: str, log_file: Optional[str]) -> None:
    handlers = [logging.StreamHandler()]
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=getattr(logging, str(level).upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def run_step(index: int, config, opts: RunOptions, confirm: bool, quiet: bool = False) -> Optional[float]:
    """Run step ``index``; its wall seconds, or None when the user skipped
    it.  A failure propagates.  ``quiet``: print no step lines (the ranks
    other than 0)."""
    name, desc, fn = STEPS[index]
    if quiet:
        fn(config, opts)
        return None
    print(f"\n{BOLD}{CYAN}[{index + 1}/{len(STEPS)}] {name}{RESET} — {desc}", flush=True)
    if confirm:
        answer = input("Run this step? [Y/n/q] ").strip().lower()
        if answer == "q":
            sys.exit(0)
        if answer == "n":
            print(f"{YELLOW}skipped{RESET}")
            return None
    t0 = time.perf_counter()
    fn(config, opts)
    seconds = time.perf_counter() - t0
    print(f"{GREEN}done{RESET} in {seconds:.1f}s", flush=True)
    return seconds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multi_modal_gnn_tpu_torch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config", default="conf/config.yaml")
    parser.add_argument("--step", default=None, help="step number N or range A-B (1-based)")
    parser.add_argument("--no-confirm", action="store_true", help="run without prompts")
    parser.add_argument("--list", action="store_true", help="list steps and exit")
    parser.add_argument("--patient-id", type=int, default=None,
                        help="inference: report a specific patient entity id")
    parser.add_argument("--num-examples", type=int, default=5,
                        help="inference: number of example patients")
    parser.add_argument("--detailed", action="store_true",
                        help="inference: include measured/imputed lab listings")
    parser.add_argument("--force", action="store_true",
                        help="restore checkpoints even if their model hash differs")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the card (default; raises without one) or on the CPU")
    args = parser.parse_args(argv)

    if args.list:
        for i, (name, desc, _) in enumerate(STEPS):
            print(f"  {i + 1}. {name:<14} {desc}")
        return 0

    indices = parse_step_range(args.step, len(STEPS)) if args.step else list(range(len(STEPS)))

    from multi_modal_gnn_tpu_torch.config import load_config
    from multi_modal_gnn_tpu_torch.parallel.mesh import world_from_env
    from multi_modal_gnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(None if args.device == "cuda" else "cpu")
    config = load_config(args.config)
    rank, world = world_from_env()
    if world > 1:
        from multi_modal_gnn_tpu_torch.training.trainer import parallel_mode

        if not parallel_mode(config):
            raise SystemExit(
                f"launched over {world} ranks, but {args.config} sets no train.extras.parallel (dp | 2d)"
            )
        if not args.no_confirm:
            raise SystemExit("a launch over several ranks runs with --no-confirm")
    lc = config.logging
    _setup_logging(lc.level, lc.log_file if lc.save_to_file and rank == 0 else None)
    opts = RunOptions(
        device=device, force=args.force, patient_id=args.patient_id,
        num_examples=args.num_examples, detailed=args.detailed,
    )
    axis = None
    if world > 1:
        from multi_modal_gnn_tpu_torch.parallel.mesh import init_axis

        axis = init_axis(device, config.train.num_devices)

    if rank == 0:
        print(f"{BOLD}multi_modal_gnn_tpu_torch pipeline{RESET} — config {args.config}, device {device}"
              + (f", {world} ranks ({axis.backend})" if axis is not None else ""))
    t0 = time.perf_counter()
    seconds = {}
    for i in indices:
        if axis is not None:
            torch.distributed.barrier()  # the step before has written its artifacts
            if rank != 0 and STEPS[i][0] != "train":
                continue
        try:
            took = run_step(i, config, opts, confirm=not args.no_confirm, quiet=rank != 0)
        except Exception:  # noqa: BLE001 - reported, then the run ends non-zero
            traceback.print_exc()
            print(f"{RED}FAILED: pipeline aborted at step {i + 1} ({STEPS[i][0]}) on rank {rank}.{RESET}")
            return 1
        if took is not None:
            seconds[STEPS[i][0]] = took
    if axis is not None:
        from multi_modal_gnn_tpu_torch.parallel.mesh import shutdown

        torch.distributed.barrier()
        shutdown()
    if rank == 0:
        print(f"\n{GREEN}{BOLD}Pipeline complete{RESET} in {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"step_seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
