"""The preprocess stage (``multi_modal_gnn_tpu/data/preprocess.py``) on the
synthetic route: generate the cohort that ``data.synthetic`` names and
write its tables to the interim directory, one ``<name>.npz`` a table (its
columns as arrays) in place of the JAX package's parquet files.

The raw eICU and MIMIC-III loaders (``data.dataset: eicu | mimic3``) and
the fitted ``LabNormalizer`` they write are not ported (ROADMAP.md queue 1
item 9): :func:`preprocess_pipeline` refuses those datasets.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from multi_modal_gnn_tpu_torch.config import Config, ConfigError
from multi_modal_gnn_tpu_torch.data.synthetic import generate_synthetic_tables, spec_from_config
from multi_modal_gnn_tpu_torch.graph.build import Table

logger = logging.getLogger(__name__)


def save_table(table: Table, path) -> Path:
    """A table's columns as one ``.npz`` (strings as fixed-width unicode,
    so no pickling is needed to read them back)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    columns = {
        name: np.asarray(col).astype(str) if np.asarray(col).dtype == object else np.asarray(col)
        for name, col in table.items()
    }
    np.savez(path, **columns)
    return path


def load_table(path) -> Table:
    """A table written by :func:`save_table`, columns in their order."""
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def preprocess_pipeline(config: Config, interim_dir=None) -> Dict[str, Table]:
    """Generate the ``data.synthetic`` cohort (JAX ``preprocess_pipeline``,
    synthetic route) and, with ``interim_dir``, write its tables there."""
    dataset = config.data.dataset
    if dataset != "synthetic":
        raise ConfigError(
            f"data.dataset={dataset!r}: the raw eICU / MIMIC-III loaders are not ported to "
            "the PyTorch package yet (ROADMAP.md queue 1 item 9); use dataset: synthetic"
        )
    tables = generate_synthetic_tables(spec_from_config(config))
    if interim_dir is not None:
        interim = Path(interim_dir)
        for name, table in tables.items():
            save_table(table, interim / f"{name}.npz")
        logger.info("Wrote interim tables to %s", interim)
    return tables
