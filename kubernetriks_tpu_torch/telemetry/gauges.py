"""Gauge time series: the per-window gauge samples the engine collects
(`collect_gauges`) and their CSV (reference `kubernetriks_tpu/telemetry/
gauges.py`) in the port's scalar collector's columns
(`metrics/collector.py` GAUGE_CSV_COLUMNS). Host arrays only: the engine reads the samples from
the card once a span and hands them in. A checkpoint keeps the series in
a numpy sidecar (`save_sidecar` / `load_sidecar`, reference gauges.py:
65-86): its length depends on the run, unlike the state's shapes."""

from __future__ import annotations

import csv
import os
from typing import List

import numpy as np

# The scalar collector's schema (reference src/metrics/collector.rs:216-228):
# a timestamp, then the seven columns of step.gauge_snapshot.
from kubernetriks_tpu_torch.metrics.collector import GAUGE_CSV_COLUMNS


class GaugeSeries:
    """Accumulated (window indices, (Wn, C, 7) samples) chunks."""

    def __init__(self) -> None:
        self._windows: List[np.ndarray] = []
        self._samples: List[np.ndarray] = []

    def append(self, windows: np.ndarray, samples: np.ndarray) -> None:
        """One chunk: windows (Wn,) ints, samples (Wn, C, 7) on the host."""
        self._windows.append(np.asarray(windows))
        self._samples.append(np.asarray(samples))

    def series(self, n_clusters: int, interval: float):
        """(times (W,), samples (W, C, 7)); empty arrays before any sample."""
        if not self._samples:
            return np.zeros((0,)), np.zeros((0, n_clusters, 7))
        times = np.concatenate(self._windows).astype(np.float64) * interval
        return times, np.concatenate(self._samples, axis=0)

    def write_csv(self, path: str, cluster: int, n_clusters: int, interval: float) -> None:
        """One cluster's series in the scalar collector's 8-column schema."""
        times, samples = self.series(n_clusters, interval)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(GAUGE_CSV_COLUMNS)
            for i, t in enumerate(times):
                row = samples[i, cluster]
                writer.writerow(
                    [t, int(row[0]), int(row[1]), int(row[2]),
                     float(row[3]), float(row[4]), float(row[5]), float(row[6])]
                )

    def save_sidecar(self, path: str) -> None:
        """Write the series beside a checkpoint (numpy .npz, no pickled
        objects); an empty series removes a stale sidecar, so a previous
        save's gauges never stand in for this run's at a restore."""
        if self._windows:
            np.savez(
                path,
                windows=np.concatenate(self._windows).astype(np.int32),
                samples=np.concatenate(self._samples, axis=0).astype(np.float32),
            )
        elif os.path.exists(path):
            os.remove(path)

    @classmethod
    def load_sidecar(cls, path: str) -> "GaugeSeries":
        """The series a save_sidecar wrote (empty where there is none)."""
        out = cls()
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as data:
                out.append(data["windows"], data["samples"])
        return out
