"""End-to-end ingest benchmark (``scripts/bench_etl.py``, ported): raw
MIMIC-III-shaped CSVs -> the graph core's LABEVENTS scan -> preprocess ->
graph -> training epochs on the card.

:func:`emit_raw_mimic` writes the raw directory with numpy and ``csv``
(46,000 patients and 5,000,000 LABEVENTS rows by default: the
``mimic_scale`` cohort), drawing from the generator in the JAX script's
order, so one seed gives the same tables.  The stages:

  cohort         MIMICLoader table loads + select_cohort      (data/mimic.py)
  labevents_scan the graph core's cohort-filtered one-pass scan (native.py)
  preprocess     preprocess_pipeline: top-K labs, outliers, aggregation,
                 z-scores, ICD-9 collapse, drug names, the interim tables
  graph_build    build_graph_from_preprocessed (the core's sort and plans)
  train          full-batch RGCN epochs on the card (the first one apart),
                 the kernels' launches, then evaluate_model's test metrics

    python -m multi_modal_gnn_tpu_torch.tools.bench_etl [--patients 46000]
        [--lab-rows 5000000] [--epochs 3] [--dir DIR] [--device cpu] [--keep]

One JSON line per stage, then a summary line.  Without ``--device cpu`` it
runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

_LAB_CHUNK = 500_000  # LABEVENTS rows formatted at a time
TOP_K = 500  # labs kept by preprocess


def _write(path: Path, header: Sequence[str], columns: Sequence[Iterable]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(zip(*columns))


def _floats(values: np.ndarray) -> list:
    """Floats as ``to_csv`` writes them: shortest repr, NaN empty."""
    return ["" if v != v else repr(v) for v in values.tolist()]


def emit_raw_mimic(
    out_dir,
    num_patients: int = 46_000,
    lab_rows: int = 5_000_000,
    num_labs: int = 720,
    num_dx: int = 800,
    num_rx: int = 400,
    seed: int = 0,
) -> dict:
    """Write a MIMIC-III-shaped raw CSV directory: PATIENTS, ADMISSIONS,
    ICUSTAYS (one stay each), LABEVENTS (zipf-like lab popularity, hourly
    chart times over four days, 1 % without a value), D_LABITEMS,
    DIAGNOSES_ICD (6 a patient) and PRESCRIPTIONS (15 a patient)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sid = 10_000 + np.arange(num_patients)
    t0 = time.perf_counter()

    birth_year = rng.integers(2060, 2125, num_patients)
    gender = rng.choice(["M", "F"], num_patients)
    _write(out_dir / "PATIENTS.csv", ["SUBJECT_ID", "GENDER", "DOB"],
           [sid.tolist(), gender.tolist(), [f"{y}-06-15" for y in birth_year.tolist()]])

    hadm = 100_000 + np.arange(num_patients)
    ethnicity = rng.choice(["WHITE", "BLACK", "ASIAN", "OTHER"], num_patients)
    expired = (rng.random(num_patients) < 0.08).astype(int)
    _write(out_dir / "ADMISSIONS.csv", ["SUBJECT_ID", "HADM_ID", "ADMITTIME", "ETHNICITY", "HOSPITAL_EXPIRE_FLAG"],
           [sid.tolist(), hadm.tolist(), ["2150-01-01"] * num_patients, ethnicity.tolist(), expired.tolist()])

    los = np.round(rng.gamma(2.0, 2.0, num_patients) + 0.5, 2)
    _write(out_dir / "ICUSTAYS.csv", ["SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "INTIME", "OUTTIME", "LOS"],
           [sid.tolist(), hadm.tolist(), (200_000 + np.arange(num_patients)).tolist(),
            ["2150-01-01"] * num_patients, ["2150-01-05"] * num_patients, _floats(los)])

    ev_sid = sid[rng.integers(0, num_patients, lab_rows)]
    pop = (1.0 / (np.arange(num_labs) + 1.0)) ** 0.6
    item_ids = 50_000 + np.arange(num_labs)
    ev_item = item_ids[rng.choice(num_labs, lab_rows, p=pop / pop.sum())]
    hour = rng.integers(0, 96, lab_rows)
    vals = np.round(100.0 + 15.0 * rng.standard_normal(lab_rows), 2)
    vals = np.where(rng.random(lab_rows) < 0.01, np.nan, vals)  # the scan's notna filter drops these
    # each field's text looked up from its few distinct values (Python
    # strings: joining numpy strings is several times slower)
    texts = {int(v): str(v) for v in np.concatenate([sid, item_ids]).tolist()}
    times = [f"2150-01-{1 + h // 24:02d} {h % 24:02d}:00:00" for h in range(96)]
    with open(out_dir / "LABEVENTS.csv", "w") as f:
        f.write("SUBJECT_ID,ITEMID,CHARTTIME,VALUENUM\n")
        for a in range(0, lab_rows, _LAB_CHUNK):
            b = min(a + _LAB_CHUNK, lab_rows)
            cols = ([texts[v] for v in ev_sid[a:b].tolist()], [texts[v] for v in ev_item[a:b].tolist()],
                    [times[h] for h in hour[a:b].tolist()], _floats(vals[a:b]))
            f.write("\n".join(map(",".join, zip(*cols))) + "\n")

    _write(out_dir / "D_LABITEMS.csv", ["ITEMID", "LABEL", "FLUID"],
           [item_ids.tolist(), [f"lab_{i:04d}" for i in range(num_labs)], ["Blood"] * num_labs])

    dx_rows = num_patients * 6
    dx_sid = sid[rng.integers(0, num_patients, dx_rows)]
    dx_hadm = hadm[rng.integers(0, num_patients, dx_rows)]
    codes = [f"{c:03d}{s}" for c, s in zip(rng.integers(1, num_dx, dx_rows).tolist(),
                                            rng.integers(0, 10, dx_rows).tolist())]
    _write(out_dir / "DIAGNOSES_ICD.csv", ["SUBJECT_ID", "HADM_ID", "ICD9_CODE"],
           [dx_sid.tolist(), dx_hadm.tolist(), codes])

    rx_rows = num_patients * 15
    drug_names = [f"drug{i:03d} {d}mg tablet" for i, d in zip(range(num_rx), 10 * (1 + np.arange(num_rx) % 9))]
    rx_sid = sid[rng.integers(0, num_patients, rx_rows)]
    rx_hadm = hadm[rng.integers(0, num_patients, rx_rows)]
    drugs = np.asarray(drug_names)[rng.integers(0, num_rx, rx_rows)]
    _write(out_dir / "PRESCRIPTIONS.csv", ["SUBJECT_ID", "HADM_ID", "DRUG"],
           [rx_sid.tolist(), rx_hadm.tolist(), drugs.tolist()])
    return {"emit_s": time.perf_counter() - t0, "lab_rows": lab_rows}


def etl_config(raw, interim, output):
    """The ingest configuration: ``data.dataset: mimic3`` on ``raw``, the
    top 500 labs (``scripts/bench_etl.py``'s), the kernel path
    (``use_pallas``) with no dense tier (the 46,000 x 500 lab relation would
    fit its budget, and no kernel would aggregate it), lab tiles as the
    bench resolves them, the two mean baselines only."""
    from multi_modal_gnn_tpu_torch.config import Config
    from multi_modal_gnn_tpu_torch.training.masker import resolve_lab_tile_rows

    cfg = Config()
    fs = cfg.feature_space
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, dataset="mimic3", raw_dir=str(raw), interim_dir=str(interim),
                                 output_dir=str(output)),
        feature_space=dataclasses.replace(fs, labs=dataclasses.replace(fs.labs, top_k=TOP_K)),
        graph=dataclasses.replace(cfg.graph, dense_adjacency_max_bytes=0),
        model=dataclasses.replace(cfg.model, use_pallas=True),
        train=dataclasses.replace(
            cfg.train, extras={**cfg.train.extras, "lab_tile_rows": resolve_lab_tile_rows(None, TOP_K, True)}
        ),
        evaluation=dataclasses.replace(cfg.evaluation, baselines=("global_mean", "per_lab_mean")),
    )


def _stage(name: str, **fields) -> dict:
    line = {"stage": name, **fields}
    print(json.dumps(line), flush=True)
    return line


def ingest(config, lab_rows: Optional[int] = None):
    """The cohort, scan, preprocess and graph-build stages on the raw MIMIC
    directory ``config.data.raw_dir``: ``(stage lines by name, the graph
    bundle)``."""
    from multi_modal_gnn_tpu_torch import native
    from multi_modal_gnn_tpu_torch.data import mimic
    from multi_modal_gnn_tpu_torch.data.preprocess import preprocess_pipeline
    from multi_modal_gnn_tpu_torch.graph.build import build_graph_from_preprocessed
    from multi_modal_gnn_tpu_torch.graph.schema import PATIENT_LAB

    out = {}
    cc = config.cohort
    t0 = time.perf_counter()
    loader = mimic.MIMICLoader(config.data.raw_dir)
    cohort = mimic.select_cohort(
        loader.load_patients(), loader.load_admissions(), loader.load_icustays(), age_min=cc.age_min,
        age_max=cc.age_max, exclude_deaths=cc.exclude_deaths, min_los_hours=cc.min_los_hours,
    )
    out["cohort"] = _stage("cohort", s=time.perf_counter() - t0, patients=len(cohort["SUBJECT_ID"]))

    before = native.launch_counts["labevents_scan"]
    t0 = time.perf_counter()
    labs = loader.load_labevents_for_cohort(cohort["SUBJECT_ID"])
    t_scan = time.perf_counter() - t0
    out["labevents_scan"] = _stage(
        "labevents_scan", s=t_scan, rows_kept=len(labs["SUBJECT_ID"]),
        native=native.launch_counts["labevents_scan"] - before,
        **({"rows_per_sec": lab_rows / t_scan} if lab_rows else {}),
    )

    t0 = time.perf_counter()
    preprocess_pipeline(config, interim_dir=config.data.interim_dir)
    out["preprocess"] = _stage("preprocess_pipeline", s=time.perf_counter() - t0)

    before = dict(native.launch_counts)
    t0 = time.perf_counter()
    bundle = build_graph_from_preprocessed(config.data.interim_dir, config)
    out["graph_build"] = _stage(
        "graph_build", s=time.perf_counter() - t0, patient_lab_edges=bundle.graph.edges[PATIENT_LAB].num_valid,
        node_counts=dict(bundle.graph.node_counts),
        native_calls={k: v - before[k] for k, v in native.launch_counts.items()},
    )
    return out, bundle


def train(config, bundle, device, epochs: int = 3):
    """``epochs`` full-batch epochs on ``device`` (each timed to a
    synchronize; the first includes the first launches), the kernels'
    launches, then ``evaluate_model``'s test metrics of the live model:
    ``(the stage line, the trainer)``."""
    import torch

    from multi_modal_gnn_tpu_torch.evaluation import evaluate_model
    from multi_modal_gnn_tpu_torch.models import build_model
    from multi_modal_gnn_tpu_torch.ops import pairhead_kernels, segment_kernels
    from multi_modal_gnn_tpu_torch.training import Trainer, masker_from_config
    from multi_modal_gnn_tpu_torch.utils.rng import stream_seed

    counters = (segment_kernels.launch_counts, pairhead_kernels.launch_counts)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    masker = masker_from_config(config, bundle.graph)
    generator = torch.Generator().manual_seed(stream_seed(config.train.seed, "init"))
    model = build_model(config, bundle.graph, device=device, generator=generator)
    trainer = Trainer(model, bundle.graph, masker, config, device=device)
    before = {n: c for counts in counters for n, c in counts.items()}
    losses, seconds = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        loss = trainer.train_epochs(1)[0]
        sync()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss[0]))
    launches = {n: c - before[n] for counts in counters for n, c in counts.items() if c > before[n]}
    t0 = time.perf_counter()
    metrics = evaluate_model(trainer, trainer.graph, config, use_best_state=False)
    line = _stage(
        "train", first_epoch_s=seconds[0], epoch_s=seconds[1:], losses=losses, launches=launches,
        train_edges=masker.split_sizes()["train"], evaluate_s=time.perf_counter() - t0,
        test_r2=float(metrics["overall_metrics"]["r2"]), test_mae=float(metrics["overall_metrics"]["mae"]),
    )
    return line, trainer


def emit_raw_eicu(out_dir, num_stays: int = 2_000, labs_per_stay: int = 30, seed: int = 0) -> Path:
    """A small eICU-shaped raw directory (``patient``, ``lab``,
    ``diagnosis``, ``medication`` as ``.csv.gz``, ``apachePatientResult``):
    two stays for some patients, ages with ``> 89``, 12 lab names,
    hierarchical diagnosis strings with ICD-9 lists."""
    import gzip

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    stay = 1_000_000 + np.arange(num_stays)
    patient = rng.integers(0, int(num_stays * 0.8), num_stays)
    age = [("> 89" if a > 89 else str(a)) for a in rng.integers(15, 95, num_stays).tolist()]

    def write(name, header, columns):
        with gzip.open(out_dir / f"{name}.csv.gz", "wt", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(zip(*columns))

    write("patient", ["patientunitstayid", "patienthealthsystemstayid", "uniquepid", "gender", "age",
                      "unitdischargeoffset", "unitdischargestatus", "unitadmittime24"],
          [stay.tolist(), (2_000_000 + stay).tolist(), [f"P{p:06d}" for p in patient.tolist()],
           rng.choice(["Male", "Female"], num_stays).tolist(), age, rng.integers(60, 10_000, num_stays).tolist(),
           rng.choice(["Alive", "Expired"], num_stays, p=[0.9, 0.1]).tolist(),
           [f"{h:02d}:{m:02d}:00" for h, m in zip(rng.integers(0, 24, num_stays).tolist(),
                                                   rng.integers(0, 60, num_stays).tolist())]])
    names = ["glucose", "sodium", "potassium", "BUN", "creatinine", "Hgb", "WBC x 1000", "platelets x 1000",
             "chloride", "bicarbonate", "lactate", "magnesium"]
    centers = np.linspace(5.0, 140.0, len(names))
    n = num_stays * labs_per_stay
    lab = rng.integers(0, len(names), n)
    write("lab", ["patientunitstayid", "labresultoffset", "labname", "labresult"],
          [stay[rng.integers(0, num_stays, n)].tolist(), rng.integers(-600, 6000, n).tolist(),
           np.asarray(names)[lab].tolist(), _floats(np.round(centers[lab] * (1 + 0.1 * rng.standard_normal(n)), 2))])
    dx_strings = ["cardiovascular|shock / hypotension|sepsis", "pulmonary|respiratory failure|ARDS",
                  "renal|electrolyte imbalance|hyponatremia", "endocrine|glucose metabolism|DKA", "neurologic"]
    dx_codes = ["785.52, 995.92", "518.81", "276.1", "250.13", ""]
    m = num_stays * 3
    pick = rng.integers(0, len(dx_strings), m)
    write("diagnosis", ["patientunitstayid", "diagnosisoffset", "diagnosisstring", "icd9code", "diagnosispriority"],
          [stay[rng.integers(0, num_stays, m)].tolist(), rng.integers(0, 1000, m).tolist(),
           np.asarray(dx_strings)[pick].tolist(), np.asarray(dx_codes)[pick].tolist(),
           rng.choice(["Primary", "Major", "Other"], m).tolist()])
    drugs = ["ASPIRIN 81 MG PO TABS", "Heparin Sodium 5000 units", "insulin, regular", "NOREPINEPHRINE 8 MG",
             "vancomycin 1 g iv", "pantoprazole 40 mg"]
    k = num_stays * 4
    write("medication", ["patientunitstayid", "drugstartoffset", "drugname", "dosage", "routeadmin", "frequency",
                         "prn", "drugivadmixture"],
          [stay[rng.integers(0, num_stays, k)].tolist(), rng.integers(0, 1000, k).tolist(),
           np.asarray(drugs)[rng.integers(0, len(drugs), k)].tolist(), ["1"] * k,
           rng.choice(["PO", "IV", "SC"], k).tolist(), ["Daily"] * k, ["No"] * k, ["No"] * k])
    write("apachePatientResult", ["patientunitstayid", "acutephysiologyscore", "apachescore"],
          [stay.tolist(), rng.integers(10, 120, num_stays).tolist(), rng.integers(10, 150, num_stays).tolist()])
    return out_dir


def eicu_config(raw, root, epochs: int = 3):
    """A pipeline config for the raw eICU directory ``raw`` whose interim
    tables, outputs and log go under ``root``: the kernel path,
    ``epochs`` epochs, labs seen by at least 5 stays."""
    from multi_modal_gnn_tpu_torch.config import Config

    root = Path(root)
    cfg = Config()
    fs = cfg.feature_space
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, dataset="eicu", raw_dir=str(raw), interim_dir=str(root / "interim"),
                                 output_dir=str(root / "out")),
        feature_space=dataclasses.replace(fs, labs=dataclasses.replace(fs.labs, min_patient_count=5)),
        model=dataclasses.replace(cfg.model, use_pallas=True),
        train=dataclasses.replace(cfg.train, epochs=epochs),
        logging=dataclasses.replace(cfg.logging, log_file=str(root / "pipeline.log")),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--patients", type=int, default=46_000)
    ap.add_argument("--lab-rows", type=int, default=5_000_000)
    ap.add_argument("--epochs", type=int, default=3, help="training epochs (0: stop after the graph build)")
    ap.add_argument("--dir", type=str, default=None, help="working directory (default: a temporary one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--keep", action="store_true", help="keep the raw and interim tables")
    args = ap.parse_args(argv)

    from multi_modal_gnn_tpu_torch.utils.device import disable_tf32, gpu_identity, resolve_device

    device = resolve_device(None if args.device == "cuda" else "cpu")
    if device.type == "cuda":
        disable_tf32()
    root = Path(args.dir) if args.dir else Path(tempfile.mkdtemp(prefix="mmgnn_etl_"))
    try:
        raw = root / "raw"
        emitted = emit_raw_mimic(raw, args.patients, args.lab_rows)
        _stage("emit_raw", **emitted)
        config = etl_config(raw, root / "interim", root / "out")
        stages, bundle = ingest(config, lab_rows=args.lab_rows)
        if args.epochs:
            stages["train"] = train(config, bundle, device, epochs=args.epochs)[0]
        summary = {
            "metric": "etl_raw_to_graph_s",
            "value": sum(stages[k]["s"] for k in ("cohort", "labevents_scan", "preprocess", "graph_build")),
            "labevents_rows_per_sec": stages["labevents_scan"]["rows_per_sec"],
            "device": gpu_identity() if device.type == "cuda" else str(device),
            **{f"{k}_s": stages[k]["s"] for k in ("cohort", "labevents_scan", "preprocess", "graph_build")},
        }
        if "train" in stages:
            summary["epoch_s"] = stages["train"]["epoch_s"]
        print(json.dumps(summary))
    finally:
        if not args.keep:
            shutil.rmtree(root if not args.dir else root / "raw", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
