"""Training metrics on disk (``multi_modal_gnn_tpu/utils/profiling.py``)."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsWriter:
    """Append-only JSONL metric records: ``{"step": .., "ts": .., **metrics}``."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def write(self, step: int, **metrics) -> None:
        record = {"step": int(step), "ts": time.time(), **metrics}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
