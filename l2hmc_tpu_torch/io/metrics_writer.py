"""Structured metrics logging (counterpart of
``l2hmc_tpu/io/metrics_writer.py``): a writer that takes a metrics dict and
appends CSV / JSONL rows, and appends lines to text files. No dependencies
beyond the standard library; ``float()`` of a tensor fetches it from the
device, so write once per logging interval, not per step.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Mapping, Optional


class MetricsWriter:
    """Append-only CSV + JSONL metrics sink."""

    def __init__(self, logdir: str, name: str = "metrics"):
        self.logdir = os.path.abspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        self.csv_path = os.path.join(self.logdir, f"{name}.csv")
        self.jsonl_path = os.path.join(self.logdir, f"{name}.jsonl")
        self._fieldnames: Optional[list[str]] = None
        self._t0 = time.time()

    def write(self, step: int, metrics: Mapping[str, Any]) -> None:
        row = {"step": int(step), "wall_time": time.time() - self._t0}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        if self._fieldnames is None:
            self._fieldnames = list(row)
            write_header = not os.path.exists(self.csv_path)
            with open(self.csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                if write_header:
                    w.writeheader()
                w.writerow(row)
        else:
            with open(self.csv_path, "a", newline="") as f:
                w = csv.DictWriter(
                    f, fieldnames=self._fieldnames, extrasaction="ignore"
                )
                w.writerow(row)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def append_text(self, filename: str, line: str) -> None:
        """Text-file append (``eval_vae`` writes ``<split>_ll.txt`` this way)."""
        with open(os.path.join(self.logdir, filename), "a") as f:
            f.write(line.rstrip("\n") + "\n")
