"""The quality-gap diagnostic (``scripts/diagnose_quality.py``) on the
port: the yardsticks of a flat synthetic cohort, then optionally the GNN
trained with the script's overrides and its test metrics beside them.

    python -m multi_modal_gnn_tpu_torch.tools.diagnose_quality [--spec eicu | mimic | scale]
        [--skip-train] [--epochs 1300] [--als-sweep] [--als-init | --sideinfo]
        [--device cuda | cpu] [--out-dir outputs/diagnostics] [...]

The yardsticks: the Bayes conditional ceiling (oracle loadings, the train
split observed; :func:`~multi_modal_gnn_tpu_torch.evaluation.ceiling.gaussian_conditional_ceiling`),
the combined ceiling of the labs posterior and the dx / rx memberships
(cross-fitted oracle ridge) and ALS (``--als-sweep``: the regularizer
chosen on the val split).  The generator's lab ``j`` is the graph lab
whose ITEMID is ``51000 + j``, its patient ``i`` SUBJECT_ID ``100000 + i``.
The ceilings and training run on ``--device`` (the card by default; it
raises without one), ALS in numpy on the host.  Prints the script's lines,
writes the report to ``<out-dir>/quality_<tag>.json`` and prints it as the
last line (one JSON object).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m multi_modal_gnn_tpu_torch.tools.diagnose_quality")
    ap.add_argument("--epochs", type=int, default=1300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--no-scheduler", action="store_true")
    ap.add_argument("--dropout", type=float, default=None)
    ap.add_argument("--mask-fraction", type=float, default=None)
    ap.add_argument("--no-batch-norm", action="store_true")
    ap.add_argument("--arch", type=str, default=None, choices=["rgcn", "hgt"],
                    help="model.architecture override (default: the config's RGCN)")
    ap.add_argument("--hidden-dim", type=int, default=None)
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--degree-threshold", type=int, default=None)
    ap.add_argument("--bilinear-rank", type=int, default=0)
    ap.add_argument("--bilinear-source", type=str, default="head",
                    choices=["head", "embedding", "context"])
    ap.add_argument("--value-context", action="store_true",
                    help="enable the observed-value channel (model.extras.value_context)")
    ap.add_argument("--als-init", action="store_true",
                    help="warm-start the embedding-bilinear channel at the ALS solution "
                         "(training/warmstart.py); implies bilinear_source=embedding, "
                         "bilinear_rank >= rank + 1")
    ap.add_argument("--sideinfo", action="store_true",
                    help="warm-start with the dx / rx side-information baseline instead of "
                         "plain ALS; implies --als-init with bilinear_rank >= rank + 1 + mem_rank")
    ap.add_argument("--mem-rank", type=int, default=None,
                    help="membership SVD rank for --sideinfo (default: the ALS rank)")
    ap.add_argument("--ridge-reg", type=float, default=30.0,
                    help="per-lab ridge regularizer for --sideinfo")
    ap.add_argument("--weight-decay", type=float, default=None)
    ap.add_argument("--loss", type=str, default=None, choices=["mae", "mse", "huber"])
    ap.add_argument("--embedding-weight-decay", type=float, default=None)
    ap.add_argument("--scan-chunk", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--signal", type=float, default=0.6)
    ap.add_argument("--spec", type=str, default="eicu", choices=["eicu", "mimic", "scale"],
                    help="cohort shape: the eICU demo (default), MIMIC-shaped (46k patients / "
                         "720 labs), or the 100k scale config")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-yardsticks", action="store_true")
    ap.add_argument("--als-rank", type=int, default=None, help="default: latent_dim")
    ap.add_argument("--als-reg", type=float, default=None, help="default: ALSBaseline's")
    ap.add_argument("--als-iters", type=int, default=None)
    ap.add_argument("--als-sweep", action="store_true",
                    help="grid-search the ALS reg on the val split, report best-on-val test metrics")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default; raises without one) or on the CPU")
    ap.add_argument("--out-dir", type=str, default="outputs/diagnostics")
    ap.add_argument("--tag", type=str, default="")
    return ap.parse_args(argv)


def generator_rows(bundle, latents):
    """The latents in the graph's numbering: ``(w [L, k], z [P, k])``, graph
    lab ``g`` reading generator lab ``ITEMID - 51000``, patient ``g``
    generator patient ``SUBJECT_ID - 100000``."""
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT

    labs, patients = bundle.meta.indexers[LAB], bundle.meta.indexers[PATIENT]
    lab_rows = [int(labs.id_of(g)) - 51000 for g in range(bundle.graph.num_nodes(LAB))]
    patient_rows = [int(patients.id_of(g)) - 100000 for g in range(bundle.graph.num_nodes(PATIENT))]
    return latents.w_lab[lab_rows], latents.z[patient_rows]


def flat_graph_loadings(spec, config) -> Tuple[np.ndarray, float]:
    """The flat generator's lab loadings in the numbering of
    ``make_synthetic_graph(spec, config)`` (the JAX package's), without
    building the graph: ``(w [L, k], signal)`` for
    :func:`~multi_modal_gnn_tpu_torch.evaluation.ceiling.gaussian_conditional_ceiling`
    on that graph's splits."""
    from multi_modal_gnn_tpu_torch.data import generate_synthetic_edges
    from multi_modal_gnn_tpu_torch.graph.build import number_nodes
    from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB

    edges, counts, latents = generate_synthetic_edges(spec, return_latents=True)
    gc = config.graph
    numbered = edges
    if gc.cluster_patients_by_degree or gc.cluster_labs_by_frequency:
        numbered, counts = number_nodes(edges, counts, gc.cluster_patients_by_degree, gc.cluster_labs_by_frequency)
    w = np.zeros((counts["lab"], latents.w_lab.shape[1]))
    w[numbered[PATIENT_LAB][1]] = latents.w_lab[edges[PATIENT_LAB][1]]
    return w, latents.signal


def eicu_lmmse_ceiling(spec, split_seed: int = 42, device=None) -> Dict:
    """The LMMSE ceiling of an eicu-phenomenology cohort as
    ``scripts/validate_generator.py`` computes it: the graph of the default
    config, the default splits at ``split_seed``, the generator's effective
    loadings, noise variances and offsets in the graph's numbering, the
    latents' sample covariance; the train split observed, the test split
    queried.  Returns the realized test metrics."""
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import generate_synthetic_tables
    from multi_modal_gnn_tpu_torch.evaluation import lmmse_conditional_ceiling
    from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT
    from multi_modal_gnn_tpu_torch.training import EdgeMasker

    tables, latents = generate_synthetic_tables(spec, return_latents=True)
    bundle = build_heterogeneous_graph(
        labs=tables["labs_normalized"], diagnoses=tables["diagnoses"],
        medications=tables["medications"], cohort=tables["cohort"],
        labitems=tables["labitems"], config=Config(),
    )
    masker = EdgeMasker(bundle.graph, seed=split_seed)
    labs = bundle.meta.indexers[LAB]
    rows = [int(labs.id_of(g)) - 51000 for g in range(bundle.graph.num_nodes(LAB))]
    tr_p, tr_l, tr_v = masker.split_arrays("train")
    te_p, te_l, te_v = masker.split_arrays("test")
    return lmmse_conditional_ceiling(
        latents.w_eff[rows], latents.noise_var[rows], np.cov(latents.z, rowvar=False),
        tr_p, tr_l, tr_v, te_p, te_l, te_v,
        mean_shift=latents.mean_shift[rows], num_patients=bundle.graph.num_nodes(PATIENT), device=device,
    )["realized"]


def _model_config(config, args, spec):
    """The script's model, optimizer and train overrides; ``(config,
    overrides)``."""
    mc, tc = config.model, config.train
    overrides: Dict = {}
    if args.arch is not None:
        overrides["architecture"] = args.arch.upper()
    if args.dropout is not None:
        overrides["dropout"] = args.dropout
    if args.no_batch_norm:
        overrides["use_batch_norm"] = False
    if args.hidden_dim is not None:
        overrides["hidden_dim"] = args.hidden_dim
    if args.num_layers is not None:
        overrides["num_layers"] = args.num_layers
    if args.degree_threshold is not None:
        overrides["degree_threshold"] = args.degree_threshold
    if args.value_context:
        overrides["extras"] = {**mc.extras, "value_context": True}
    if args.sideinfo:
        args.als_init = True
    if args.als_init:
        # the warm start plants into the embedding-bilinear channel
        need = (args.als_rank or spec.latent_dim) + 1
        if args.sideinfo:
            need += args.mem_rank if args.mem_rank is not None else (args.als_rank or spec.latent_dim)
        args.bilinear_rank = max(args.bilinear_rank, need)
        args.bilinear_source = "embedding"
    if args.bilinear_rank:
        overrides["edge_head"] = dataclasses.replace(
            mc.edge_head,
            extras={"bilinear_rank": args.bilinear_rank, "bilinear_source": args.bilinear_source},
        )
    if overrides:
        mc = dataclasses.replace(mc, **overrides)
    opt = dataclasses.replace(
        tc.optimizer,
        lr=args.lr,
        **({"weight_decay": args.weight_decay} if args.weight_decay is not None else {}),
        **({"embedding_weight_decay": args.embedding_weight_decay}
           if args.embedding_weight_decay is not None else {}),
    )
    sched = dataclasses.replace(tc.lr_scheduler, enabled=not args.no_scheduler)
    tc = dataclasses.replace(
        tc,
        epochs=args.epochs,
        early_stopping_patience=10**9,
        optimizer=opt,
        lr_scheduler=sched,
        seed=args.seed,
        scan_chunk=args.scan_chunk,
        **({"mask_fraction": args.mask_fraction} if args.mask_fraction is not None else {}),
        **({"loss": args.loss} if args.loss is not None else {}),
    )
    return config.replace(model=mc, train=tc), overrides


def yardsticks(args, spec, bundle, latents, masker, device) -> Dict:
    """The Bayes conditional ceiling, the combined cross-fitted ceiling and
    ALS (the script's report keys ``ceiling``, ``combined_ceiling``,
    ``als``)."""
    from multi_modal_gnn_tpu_torch.evaluation import (
        ALSBaseline,
        compute_regression_metrics,
        crossfit_oracle_ceiling,
        gaussian_conditional_ceiling,
        gaussian_posterior_means,
    )
    from multi_modal_gnn_tpu_torch.graph.schema import LAB, PATIENT
    from multi_modal_gnn_tpu_torch.training.warmstart import bundle_membership_matrix

    num_patients = bundle.graph.num_nodes(PATIENT)
    num_labs = bundle.graph.num_nodes(LAB)
    w_graph, z_graph = generator_rows(bundle, latents)
    tr_p, tr_l, tr_v = masker.split_arrays("train")
    te_p, te_l, te_v = masker.split_arrays("test")
    report: Dict = {}

    ceil = gaussian_conditional_ceiling(
        w_graph, latents.signal, tr_p, tr_l, tr_v, te_p, te_l, te_v,
        num_patients=num_patients, device=device,
    )
    report["ceiling"] = {k: ceil[k] for k in ("expected", "realized", "unconditional_r2", "mean_posterior_var")}
    print("Conditional ceiling (Bayes, oracle W, train-obs only):")
    print("  expected:", json.dumps(ceil["expected"]))
    print("  realized:", json.dumps(ceil["realized"]))
    print("  unconditional (oracle-z) R^2:", ceil["unconditional_r2"])

    # the combined ceiling: labs posterior + dx / rx membership one-hots
    mu, _ = gaussian_posterior_means(
        w_graph, latents.signal, tr_p, tr_l, tr_v, num_patients=num_patients, device=device
    )
    features = np.hstack([mu.cpu().numpy(), bundle_membership_matrix(bundle)])
    combined = crossfit_oracle_ceiling(
        w_graph, latents.signal, z_graph, features, te_p, te_l, te_v, device=device
    )
    report["combined_ceiling"] = combined
    print("Combined ceiling (labs + dx/rx memberships, cross-fitted oracle ridge):")
    print("  realized:", json.dumps(combined["realized"]))

    va_p, va_l, va_v = masker.split_arrays("val")
    rank = args.als_rank or spec.latent_dim
    als_kwargs = {} if args.als_iters is None else {"iters": args.als_iters}
    t0 = time.perf_counter()
    if args.als_sweep:
        # the regularizer chosen on the val split, the ALS analogue of the
        # trainer's best-val checkpoint
        best = None
        for reg in (1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0, 30.0, 50.0):
            m = ALSBaseline(num_patients, num_labs, rank=rank, reg=reg, **als_kwargs).fit(tr_v, tr_p, tr_l)
            val_r2 = compute_regression_metrics(m.predict(va_p, va_l), va_v)["r2"]
            test_m = compute_regression_metrics(m.predict(te_p, te_l), te_v)
            print(f"  ALS reg={reg}: val r2={val_r2:.4f} test r2={test_m['r2']:.4f}")
            if best is None or val_r2 > best[0]:
                best = (val_r2, reg, test_m)
        als_m = dict(best[2], reg=best[1], val_r2=best[0], rank=rank)
    else:
        if args.als_reg is not None:
            als_kwargs["reg"] = args.als_reg
        als = ALSBaseline(num_patients, num_labs, rank=rank, **als_kwargs).fit(tr_v, tr_p, tr_l)
        als_m = compute_regression_metrics(als.predict(te_p, te_l), te_v)
    report["als"] = als_m
    print(f"ALS (rank {rank}, {time.perf_counter() - t0:.1f}s):", json.dumps(als_m))
    return report


def train_model(args, spec, config, overrides, bundle, masker, device) -> Dict:
    """The GNN trained with the overrides; the script's report keys
    ``sideinfo_baseline``, ``warm_start_epoch0`` and ``model`` (or
    ``train_error``)."""
    from multi_modal_gnn_tpu_torch.evaluation import compute_regression_metrics, winsorize_residuals
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.training import Trainer
    from multi_modal_gnn_tpu_torch.training.warmstart import bundle_membership_matrix, warm_start_trainer

    te_p, te_l, te_v = masker.split_arrays("test")
    report: Dict = {}
    trainer = Trainer(build_model(config, bundle.graph, device=device), bundle.graph, masker, config, device=device)
    if args.als_init:
        als = warm_start_trainer(
            trainer,
            rank=args.als_rank or spec.latent_dim,
            reg=args.als_reg if args.als_reg is not None else 12.0,
            memberships=bundle_membership_matrix(bundle) if args.sideinfo else None,
            mem_rank=args.mem_rank,
            ridge_reg=args.ridge_reg,
        )
        if args.sideinfo:
            si_m = compute_regression_metrics(als.predict(te_p, te_l), te_v)
            print("SideInfoALS baseline test metrics:", json.dumps(si_m))
            report["sideinfo_baseline"] = si_m
        pre = compute_regression_metrics(trainer.predict("test").astype(np.float64), te_v)
        print("Warm-start (epoch 0) test metrics:", json.dumps(pre))
        report["warm_start_epoch0"] = pre
    t0 = time.perf_counter()
    try:
        trainer.fit(scan_chunk=args.scan_chunk)
    except Exception as exc:  # noqa: BLE001 - the yardsticks are kept; the fault is reported
        traceback.print_exc()
        report["train_error"] = f"{type(exc).__name__}: {exc}"
        return report
    train_s = time.perf_counter() - t0
    preds = trainer.predict("test", state=trainer.best_state).astype(np.float64)
    raw = compute_regression_metrics(preds, te_v)
    wins = compute_regression_metrics(winsorize_residuals(preds, te_v, te_l, sigma=3.0)[0], te_v)
    report["model"] = {
        "raw": raw,
        "winsorized": wins,
        "best_val_loss": trainer.best_val_loss,
        "final_train_loss": trainer.history["train_loss"][-1],
        "epochs_run": len(trainer.history["train_loss"]),
        "train_time_s": train_s,
        "overrides": overrides,
        "lr": args.lr,
        "scheduler": not args.no_scheduler,
    }
    print("Model   raw:", json.dumps(raw))
    print("Model  wins:", json.dumps(wins))
    print(f"({len(trainer.history['train_loss'])} epochs in {train_s:.1f}s)")
    return report


def _default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.data import SyntheticSpec, generate_synthetic_tables
    from multi_modal_gnn_tpu_torch.graph import build_heterogeneous_graph
    from multi_modal_gnn_tpu_torch.training import masker_from_config
    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, resolve_device

    device = resolve_device(None if args.device == "cuda" else "cpu")
    disable_tf32()
    base_spec = {
        "eicu": SyntheticSpec.eicu_demo,
        "mimic": SyntheticSpec.mimic_scale,
        "scale": SyntheticSpec.scale_100k,
    }[args.spec]()
    spec = dataclasses.replace(base_spec, seed=args.data_seed, signal_strength=args.signal)
    config, overrides = _model_config(Config(), args, spec)
    tables, latents = generate_synthetic_tables(spec, return_latents=True)
    bundle = build_heterogeneous_graph(
        labs=tables["labs_normalized"],
        diagnoses=tables["diagnoses"],
        medications=tables["medications"],
        cohort=tables["cohort"],
        labitems=tables["labitems"],
        config=config,
    )
    bundle = bundle.replace_graph(bundle.graph.to(device))
    # the script's masker: the train config's splits, mask fraction and seed
    masker = masker_from_config(config, bundle.graph)
    report: Dict = {
        "spec": {"signal": spec.signal_strength, "latent_dim": spec.latent_dim,
                 "num_patients": spec.num_patients, "num_labs": spec.num_labs},
        "splits": masker.split_sizes(),
        "args": vars(args),
    }
    if not args.skip_yardsticks:
        report.update(yardsticks(args, spec, bundle, latents, masker, device))
    if not args.skip_train:
        report.update(train_model(args, spec, config, overrides, bundle, masker, device))

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"quality_{args.tag or time.strftime('%H%M%S')}.json"
    out_path.write_text(json.dumps(report, indent=2, default=_default))
    print("wrote", out_path)
    print(json.dumps(report, default=_default))
    return report


if __name__ == "__main__":
    main()
