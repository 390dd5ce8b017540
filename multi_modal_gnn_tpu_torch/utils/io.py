"""Host-side artifact I/O: JSON results and CSV tables
(``multi_modal_gnn_tpu/utils/io.py``), with the standard library and numpy
only.  Tables are lists of row dicts written with the ``csv`` module, in
place of the JAX package's pandas DataFrames."""

from __future__ import annotations

import csv
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np


class NumpyJSONEncoder(json.JSONEncoder):
    """JSON encoder that understands numpy scalars and arrays and paths."""

    def default(self, o: Any):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, Path):
            return str(o)
        return super().default(o)


def save_json(obj: Any, path, indent: int = 2) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, cls=NumpyJSONEncoder)
    return path


def load_json(path) -> Any:
    with open(path) as f:
        return json.load(f)


def save_csv(rows: List[Dict[str, Any]], path, columns: Sequence[str]) -> Path:
    """Rows (dicts keyed by ``columns``) as a CSV file with a header line;
    floats are written with ``repr``, so they read back exactly, and NaN as
    an empty field, as pandas writes it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(columns), lineterminator="\n")
        writer.writeheader()
        for row in rows:
            writer.writerow({k: "" if isinstance(v, float) and math.isnan(v) else v for k, v in row.items()})
    return path
