"""Fault tolerance: straggler detection, preemption handling, auto-restart.

At thousand-node scale three failure classes dominate; each has a handler:

* **Stragglers** — ``StragglerMonitor`` keeps a robust (median/MAD) model of
  step time and flags outliers; the data plane reacts by re-balancing cache
  reads away from slow nodes (``StripeStore.repair`` + placement re-score),
  the compute plane by alerting the scheduler (in a real fleet: replace the
  host; here: surfaced in metrics + logs).
* **Preemptions** — SIGTERM arrives minutes before eviction on cloud TPUs.
  ``PreemptionGuard`` flips a flag; the train loop checkpoints at the next
  step boundary and exits cleanly (tested by sending the signal in-process).
* **Crashes** — ``run_with_restarts`` wraps the loop: on exception it
  restores the latest committed checkpoint (elastic, so a *smaller* mesh is
  acceptable) and continues, up to a retry budget.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional


class StragglerMonitor:
    """Median/MAD outlier detection over a sliding window of step times."""

    def __init__(self, window: int = 50, threshold: float = 3.0, min_samples: int = 10):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.min_samples = min_samples
        self.flagged: list[tuple[int, float]] = []
        self._step = 0

    def record(self, step_time: float) -> bool:
        """Returns True when this step is a straggler."""
        self._step += 1
        if len(self.times) >= self.min_samples:
            med = self._median(self.times)
            mad = self._median([abs(t - med) for t in self.times]) or med * 0.05 or 1e-9
            is_straggler = step_time > med + self.threshold * 1.4826 * mad
        else:
            is_straggler = False
        self.times.append(step_time)
        if is_straggler:
            self.flagged.append((self._step, step_time))
        return is_straggler

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class PreemptionGuard:
    """SIGTERM/SIGINT -> checkpoint-at-next-boundary flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._old = {}
        self.signals = signals

    def __enter__(self):
        for sig in self.signals:
            self._old[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)
        return False

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self) -> None:    # tests
        self._stop.set()


@dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0


def run_with_restarts(
    loop_fn: Callable[[Optional[int]], int],
    *,
    policy: RestartPolicy = RestartPolicy(),
    on_restart: Optional[Callable[[int, Exception], None]] = None,
) -> int:
    """``loop_fn(resume_step) -> final_step``; restarts from checkpoint on error."""
    attempts = 0
    resume: Optional[int] = None
    while True:
        try:
            return loop_fn(resume)
        except KeyboardInterrupt:
            raise
        except Exception as err:
            attempts += 1
            if attempts > policy.max_restarts:
                raise
            if on_restart:
                on_restart(attempts, err)
            if policy.backoff_s:
                time.sleep(policy.backoff_s * attempts)
            resume = -1      # sentinel: restore latest
