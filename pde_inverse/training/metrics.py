"""Pluggable metric writers.

The reference's system of record is wandb with a host sync every step
(core/trainer.py:112-118).  Here wandb is optional; the default writers
(JSONL / CSV) work offline, and the trainer hands them whole
chunks of stacked step metrics at once.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np


class MetricWriter:
    def log(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_chunk(self, stacked: Dict[str, np.ndarray], first_step: int) -> None:
        """Log a chunk of K consecutive steps (arrays of shape [K])."""
        keys = list(stacked)
        k = len(np.asarray(stacked[keys[0]]))
        for i in range(k):
            self.log({key: float(np.asarray(stacked[key])[i]) for key in keys},
                     first_step + i)

    def log_media(self, path: str, step: int) -> None:
        """Log a rendered plot file (no-op for file writers, which already
        live next to the plot directory; WandbWriter uploads it — parity
        with the reference's wandb.Video plots, utils/plot_utils.py:46,77)."""

    def close(self) -> None:
        pass


class NullWriter(MetricWriter):
    def log(self, metrics, step):
        pass


class JsonlWriter(MetricWriter):
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        # line-buffered so long runs are monitorable with tail -f
        self._f = open(self.path, "a", buffering=1)

    def log(self, metrics, step):
        self._f.write(json.dumps({"step": step, **metrics}) + "\n")

    def close(self):
        self._f.flush()
        self._f.close()


class CsvWriter(MetricWriter):
    def __init__(self, run_dir: str, filename: str = "metrics.csv"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._f = open(self.path, "a", newline="")
        self._writer = None

    def log(self, metrics, step):
        row = {"step": step, **metrics}
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=list(row))
            if self._f.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(row)

    def close(self):
        self._f.flush()
        self._f.close()


class WandbWriter(MetricWriter):
    def __init__(self, project: str, config: Optional[dict] = None):
        import wandb  # optional dependency

        self._wandb = wandb
        self.run = wandb.init(project=project, config=config or {})

    def log(self, metrics, step):
        self._wandb.log(metrics, step=step)

    def log_media(self, path, step):
        key = os.path.splitext(os.path.basename(path))[0]
        media = (
            self._wandb.Video(path)
            if path.endswith((".gif", ".mp4"))
            else self._wandb.Image(path)
        )
        self._wandb.log({key: media}, step=step)

    def close(self):
        self._wandb.finish()


def make_writer(kind: str, run_dir: str, project: str = "", config=None) -> MetricWriter:
    if kind == "none":
        return NullWriter()
    if kind == "jsonl":
        return JsonlWriter(run_dir)
    if kind == "csv":
        return CsvWriter(run_dir)
    if kind == "wandb":
        return WandbWriter(project or "pde-inverse", config)
    raise ValueError(f"unknown metric writer {kind!r}")
