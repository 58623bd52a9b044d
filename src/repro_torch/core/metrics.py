"""Metrics: per-job byte counters, fps timelines, cluster link accounting.

Feeds every figure/table in the paper reproduction: Figure 3's fps-vs-step
curves, Table 4's bytes-moved/transmission-rate accounting and the link-level
traffic matrix behind the Table 5 up-link analysis.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np


@dataclass
class JobMetrics:
    job_id: str
    counters: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    link_bytes: dict[tuple[int, int], float] = field(default_factory=lambda: defaultdict(float))
    step_stamps: list[float] = field(default_factory=list)
    step_items: list[int] = field(default_factory=list)
    epoch_stamps: list[float] = field(default_factory=list)

    def count(self, key: str, nbytes: float) -> None:
        self.counters[key] += nbytes

    def count_link(self, src: int, dst: int, nbytes: float) -> None:
        self.link_bytes[(src, dst)] += nbytes

    def record_step(self, now: float, items: int) -> None:
        self.step_stamps.append(now)
        self.step_items.append(items)

    def mark_epoch(self, now: float) -> None:
        self.epoch_stamps.append(now)

    # ------------------------------------------------------------- summaries
    def fps_curve(self, smooth: int = 20) -> tuple[np.ndarray, np.ndarray]:
        """(step index, rolling-window frames/s) — Figure 3's y-axis.

        Rate over a trailing window of ``smooth`` steps: robust to the bursty
        completion stamps a deep prefetch queue produces (several steps can
        finish at the same instant; instantaneous rates are meaningless).
        """
        stamps = np.asarray(self.step_stamps)
        items = np.asarray(self.step_items, dtype=np.float64)
        if len(stamps) < 2:
            return np.arange(len(stamps)), np.zeros(len(stamps))
        w = max(1, min(smooth, len(stamps) - 1))
        cum = np.cumsum(items)
        fps = np.zeros(len(stamps))
        for i in range(len(stamps)):
            j = max(0, i - w)
            dt = stamps[i] - stamps[j]
            fps[i] = (cum[i] - cum[j]) / max(dt, 1e-9) if i > j else 0.0
        return np.arange(len(fps)), fps

    def epoch_mean_fps(self) -> list[float]:
        """Average fps per epoch (Figures 4 & 5 report these)."""
        out = []
        stamps = np.asarray(self.step_stamps)
        items = np.asarray(self.step_items, dtype=np.float64)
        start_t = 0.0
        for end_t in self.epoch_stamps:
            mask = (stamps > start_t) & (stamps <= end_t + 1e-9)
            n_items = items[mask].sum()
            dur = end_t - start_t
            out.append(n_items / max(dur, 1e-9))
            start_t = end_t
        return out

    def total_network_bytes(self) -> float:
        return self.counters.get("remote_bytes", 0.0) + self.counters.get("peer_bytes", 0.0)


@dataclass
class ClusterMetrics:
    jobs: dict[str, JobMetrics] = field(default_factory=dict)

    def job(self, job_id: str) -> JobMetrics:
        if job_id not in self.jobs:
            self.jobs[job_id] = JobMetrics(job_id)
        return self.jobs[job_id]

    def total(self, key: str) -> float:
        return sum(j.counters.get(key, 0.0) for j in self.jobs.values())

    def total_matching(self, key: str, prefix: str) -> float:
        """Sum a counter over jobs whose id starts with ``prefix``.

        The workload engine names fill-plane metrics ``fill:<dataset>``, so
        ``total_matching("remote_bytes", "fill:")`` is the cluster-wide
        remote traffic attributable to cache fills (vs job miss paths).
        """
        return sum(
            j.counters.get(key, 0.0)
            for name, j in self.jobs.items()
            if name.startswith(prefix)
        )

    def traffic_matrix(self) -> dict[tuple[int, int], float]:
        out: dict[tuple[int, int], float] = defaultdict(float)
        for j in self.jobs.values():
            for link, b in j.link_bytes.items():
                out[link] += b
        return dict(out)
