"""The JAX package's LMMSE ceiling of the ``eicu_real`` cohort, computed on
the CPU with ``scripts/validate_generator.py``'s recipe: the generator's
latents at data seed 0, the graph of the default config, the default
splits at seed 42, the effective loadings, noise variances and offsets in
the graph's numbering and the latents' sample covariance; the train split
observed, the test split queried.  The PyTorch port is held to its R² on
the card (``chip_smoke.py`` phase 29 (c), ``JAX_CPU_LMMSE_R2``).

Usage:
    python tests/jax_lmmse_ceiling.py

Prints one JSON line, the realized test metrics.  A script beside the tests
(pytest does not collect it): it imports the JAX package, which the port's
tools may not.  ``tests/test_torch_ceiling.py`` imports
:func:`lmmse_realized` to hold the port's recipe to it on a small cohort.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np


def lmmse_realized(spec, split_seed: int = 42) -> dict:
    from multi_modal_gnn_tpu.config import Config
    from multi_modal_gnn_tpu.data.synthetic import generate_synthetic_tables
    from multi_modal_gnn_tpu.evaluation.ceiling import lmmse_conditional_ceiling
    from multi_modal_gnn_tpu.graph.build import build_heterogeneous_graph
    from multi_modal_gnn_tpu.graph.schema import LAB, PATIENT
    from multi_modal_gnn_tpu.training.masker import EdgeMasker

    tables, latents = generate_synthetic_tables(spec, return_latents=True)
    bundle = build_heterogeneous_graph(
        labs=tables["labs_normalized"], diagnoses=tables["diagnoses"],
        medications=tables["medications"], cohort=tables["cohort"],
        labitems=tables["labitems"], config=Config(),
    )
    masker = EdgeMasker(bundle.graph, seed=split_seed, host_edges=bundle.patient_lab_host())
    labs = bundle.meta.indexers[LAB]
    rows = [int(labs.id_of(g)) - 51000 for g in range(bundle.graph.num_nodes(LAB))]
    tr_p, tr_l, tr_v = masker.split_arrays("train")
    te_p, te_l, te_v = masker.split_arrays("test")
    return lmmse_conditional_ceiling(
        latents.w_eff[rows], latents.noise_var[rows], np.cov(latents.z, rowvar=False),
        tr_p, tr_l, tr_v, te_p, te_l, te_v,
        mean_shift=latents.mean_shift[rows], num_patients=bundle.graph.num_nodes(PATIENT),
    )["realized"]


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from multi_modal_gnn_tpu.data.synthetic import SyntheticSpec
    from multi_modal_gnn_tpu.utils.platform import force_cpu_devices

    force_cpu_devices(1)
    print(json.dumps(lmmse_realized(SyntheticSpec.eicu_real(0))))
