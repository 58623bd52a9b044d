"""Telemetry plane: flow tracing, resource timelines, GPU-stall attribution.

Zero-dependency observability for the fluid-flow simulator.  Attach a
:class:`Telemetry` hub to a :class:`~repro_torch.core.simclock.SimClock` and every
byte movement in the data path becomes a *span*: the clock calls back on flow
start/finish/settle, the :class:`Tracer` records one span per
:class:`~repro_torch.core.simclock.Flow` (tagged with its resource path, owner,
dataset and chunk via :class:`FlowTag`), and the :class:`ResourceSampler`
records per-resource busy/queued-bytes time series at flow-boundary
granularity — no polling, samples are taken exactly when a flow touching the
resource starts or finishes.

Hot-path design (the <5% tracing-overhead gate in benchmarks/telemetry.py
lives downstream of this): the per-boundary hooks do *no* processing — a
flow start stamps its start time on the flow and appends it to a buffer, a
finish appends to a second buffer, and that is all.  Everything else (span
records, dirty-resource marking, timeline rows) happens in one batched
:meth:`Telemetry._drain` at the clock's next time-advancing settle, which is
also the one point where the buffered instant's state is still intact:

* all buffered boundaries share a single timestamp (every boundary settles
  the clock first, and settling drains the buffers), and
* the drain runs *before* ``busy_bytes``/``remaining`` mutate, so
  ``res.busy_bytes``, ``len(res.flows)`` and ``sum(f.remaining)`` still
  describe the buffered instant — a burst of same-instant boundaries is
  sampled exactly once, and queued bytes are exact (no shadow counters).

Three consumers:

* ``Tracer.export_chrome_trace()`` writes Chrome ``trace_event`` JSON
  loadable in Perfetto (https://ui.perfetto.dev) — one process row per span
  owner (job, fill plane, write plane, rebalancer), one thread row per flow
  kind.
* ``ResourceSampler.utilization_curve()`` turns the scalar
  ``Resource.utilization()`` into a timeline (the paper's "GPU utilization
  2x" claim is a *curve*, not a number).
* :func:`rollup_stalls` aggregates per-job ``JobResult.stall_breakdown``
  dicts (seconds per stall class, see :data:`STALL_CLASSES`) into the
  cluster-wide view surfaced by ``ClusterScheduler.stall_rollup()``.

Everything here is deterministic: spans sort by (start time, fid), exports
sort keys, and no wall-clock or hash-seed-dependent iteration is involved —
the trace bytes are identical across ``PYTHONHASHSEED`` values (CI-gated in
``benchmarks/telemetry.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable, Optional

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (simclock is typed only)
    from .simclock import Flow, Resource, SimClock

#: the GPU-idle taxonomy: every second of a job's wall-clock lands in exactly
#: one class (see ``TrainingJob._run`` in loader.py and docs/architecture.md)
STALL_CLASSES = (
    "fill-wait",        # batch blocked on a cache fill in flight (cold epoch)
    "disk-queue",       # batch served from NVMe stripes / local disk queues
    "remote-NIC",       # batch streamed from the remote store (miss/read-through)
    "write-drain",      # checkpoint/write-back flush waits (background lane)
    "admission-block",  # queued for GPUs or cache admission before starting
    "compute",          # the accelerator was busy — not a stall
)


@dataclass(frozen=True)
class FlowTag:
    """Identity of a flow: what kind of movement, for whom, of what."""

    kind: str           # "stripe-read" | "fill" | "read-through" | "write-back" | ...
    owner: str = ""     # "job0" | "fill:imagenet" | "writeplane" | "rebalance" | ""
    dataset: str = ""
    chunk: int = -1


class Tracer:
    """Records one span per flow (plus explicit compute/stall spans).

    Finished flows land in :attr:`_recs` as raw ``(tag, ts, dur, size, path,
    fid)`` tuples (appended by the hub's drain); span dicts are materialised
    lazily by :attr:`spans`, off the simulation's critical path.  Open spans
    are not stored at all — a live flow carries its own start time in
    ``Flow.trace_rec``, so the set of open spans *is* the clock's flow set.
    ``export_chrome_trace`` serialises with sorted keys so the bytes are
    reproducible.
    """

    def __init__(self, clock: "SimClock"):
        self.clock = clock
        # finish-ordered raw tuples for flows, span dicts for add_span()
        self._recs: list = []

    def _drain_hub(self) -> None:
        # flush boundaries buffered by the owning hub (found via the clock:
        # a back-reference would make hub <-> tracer a cycle, deferring the
        # whole dead scenario graph to cyclic GC)
        tel = self.clock.telemetry
        if tel is not None and tel.tracer is self:
            tel.drain_pending()

    # ------------------------------------------------------- explicit spans
    def add_span(
        self,
        name: str,
        *,
        t0: float,
        dur: float,
        kind: str = "",
        owner: str = "",
        dataset: str = "",
        nbytes: float = 0.0,
    ) -> None:
        """Record a non-flow interval (GPU compute, a classified stall, ...)."""
        self._recs.append({
            "name": name,
            "kind": kind or name,
            "owner": owner,
            "dataset": dataset,
            "chunk": -1,
            "bytes": nbytes,
            "path": (),
            "fid": -1,
            "ts": t0,
            "dur": dur,
        })

    # ----------------------------------------------------------- span view
    @property
    def spans(self) -> list[dict]:
        """Span dicts ordered by (start time, fid), finished and open alike."""
        self._drain_hub()
        out = []
        for rec in self._recs:
            if type(rec) is dict:
                out.append(rec)
                continue
            tag, ts, dur, size, path, fid = rec
            out.append({
                "name": tag.kind if tag else "flow",
                "kind": tag.kind if tag else "flow",
                "owner": tag.owner if tag else "",
                "dataset": tag.dataset if tag else "",
                "chunk": tag.chunk if tag else -1,
                "bytes": size,
                "path": path,
                "fid": fid,
                "ts": ts,
                "dur": dur,
            })
        for flow in self.clock._flows:  # still in flight: open span, dur None
            ts = flow.trace_rec
            if ts is None:              # started before the hub attached
                continue
            tag = flow.tag
            out.append({
                "name": tag.kind if tag else "flow",
                "kind": tag.kind if tag else "flow",
                "owner": tag.owner if tag else "",
                "dataset": tag.dataset if tag else "",
                "chunk": tag.chunk if tag else -1,
                "bytes": flow.size,
                "path": flow.path,
                "fid": flow.fid,
                "ts": ts,
                "dur": None,
            })
        # fid is allocation order, so this is start order (add_span rows at
        # the same instant sort first: fid -1); sort is stable + total, so
        # the view is independent of finish order and of PYTHONHASHSEED
        out.sort(key=lambda s: (s["ts"], s["fid"]))
        return out

    # ------------------------------------------------------------- summaries
    def live_flows(self, dataset: Optional[str] = None) -> int:
        """Spans still open (flows in flight), optionally for one dataset."""
        self._drain_hub()
        n = 0
        for flow in self.clock._flows:
            if flow.trace_rec is None:
                continue
            tag = flow.tag
            if dataset is None or (tag.dataset if tag else "") == dataset:
                n += 1
        return n

    def traced_bytes(self, dataset: Optional[str] = None, kind: Optional[str] = None) -> float:
        return sum(
            s["bytes"] for s in self.spans
            if (dataset is None or s["dataset"] == dataset)
            and (kind is None or s["kind"] == kind)
        )

    # ---------------------------------------------------------------- export
    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Chrome ``trace_event`` JSON (Perfetto-loadable); returns the text.

        pid = span owner (first-encounter order), tid = flow kind within the
        owner.  Unfinished spans are closed at the current sim time.  Output
        bytes are deterministic: spans order by (start, fid), pids/tids are
        assigned from that order, and serialisation sorts keys.
        """
        pids: dict[str, int] = {}
        tids: dict[tuple[int, str], int] = {}
        events: list[dict] = []
        meta: list[dict] = []
        for span in self.spans:
            owner = span["owner"] or "fabric"
            if owner not in pids:
                pids[owner] = len(pids) + 1
                meta.append({
                    "ph": "M", "name": "process_name", "pid": pids[owner], "tid": 0,
                    "args": {"name": owner},
                })
            pid = pids[owner]
            lane = span["kind"]
            if (pid, lane) not in tids:
                tids[(pid, lane)] = len(tids) + 1
                meta.append({
                    "ph": "M", "name": "thread_name", "pid": pid, "tid": tids[(pid, lane)],
                    "args": {"name": lane},
                })
            dur = span["dur"]
            if dur is None:  # still in flight: close at the current sim time
                dur = self.clock.now - span["ts"]
            events.append({
                "ph": "X",
                "name": span["name"],
                "cat": span["kind"],
                "pid": pid,
                "tid": tids[(pid, lane)],
                "ts": span["ts"] * 1e6,    # trace_event wants microseconds
                "dur": dur * 1e6,
                "args": {
                    "bytes": span["bytes"],
                    "chunk": span["chunk"],
                    "dataset": span["dataset"],
                    "fid": span["fid"],
                    "path": [r.name for r in span["path"]],
                },
            })
        text = json.dumps(
            {"displayTimeUnit": "ms", "traceEvents": meta + events},
            sort_keys=True, separators=(",", ":"),
        )
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
                fh.write("\n")
        return text


class ResourceSampler:
    """Per-resource busy/queued time series, sampled at flow boundaries.

    One ``(t, busy_bytes, queued_bytes, n_flows)`` row per registered
    resource per instant at which a flow touching it started or finished
    (rows are stamped by the hub's drain, see the module docstring).  No
    polling: between flow boundaries a resource's rate allocation is
    constant, so the series is exact under linear interpolation of
    ``busy_bytes``.
    """

    def __init__(self, clock: "SimClock", resources: Iterable["Resource"] = ()):
        self.clock = clock
        self.resources: list["Resource"] = []
        self._registered: dict[str, "Resource"] = {}
        self._rows: dict[str, list[tuple]] = {}  # name -> [(t, busy, queued, n)]
        # the same row lists keyed by Resource identity, for the drain
        self._recs: dict["Resource", list] = {}
        for res in resources:
            self.register(res)

    def _drain_hub(self) -> None:
        # see Tracer._drain_hub: via the clock, to keep the graph acyclic
        tel = self.clock.telemetry
        if tel is not None and tel.sampler is self:
            tel.drain_pending()

    def register(self, res: "Resource") -> None:
        if res.name in self._registered:
            return
        self._registered[res.name] = res
        self.resources.append(res)
        queued = sum(f.remaining for f in res.flows)
        # seed with the registration-time state so an idle resource still
        # has one row and every later interval has a left endpoint
        rows = [(self.clock.now, res.busy_bytes, queued, len(res.flows))]
        self._rows[res.name] = rows
        self._recs[res] = rows

    # --------------------------------------------------------------- queries
    @property
    def series(self) -> dict[str, dict[str, list[float]]]:
        """``{name: {"t": [...], "busy_bytes": [...], ...}}`` per resource."""
        self._drain_hub()
        return {
            name: {
                "t": [r[0] for r in rows],
                "busy_bytes": [r[1] for r in rows],
                "queued_bytes": [r[2] for r in rows],
                "n_flows": [r[3] for r in rows],
            }
            for name, rows in self._rows.items()
        }

    def n_samples(self) -> int:
        self._drain_hub()
        return sum(len(rows) for rows in self._rows.values())

    def utilization_curve(self, name: str) -> tuple[list[float], list[float]]:
        """(interval-end times, per-interval utilization in [0, 1]).

        Utilization of interval ``(t[i-1], t[i]]`` is the busy-bytes delta
        over what the resource could have moved at full rate — the timeline
        behind the scalar ``Resource.utilization()``.
        """
        self._drain_hub()
        rows = self._rows[name]
        res = self._registered[name]
        out_t: list[float] = []
        out_u: list[float] = []
        for i in range(1, len(rows)):
            dt = rows[i][0] - rows[i - 1][0]
            if dt <= 0:
                continue
            out_t.append(rows[i][0])
            out_u.append(min(1.0, (rows[i][1] - rows[i - 1][1]) / (res.bw * dt)))
        return out_t, out_u

    def mean_utilization(self, name: str, t0: float = 0.0, t1: Optional[float] = None) -> float:
        """Busy fraction of ``[t0, t1]`` (defaults to the sampled range)."""
        self._drain_hub()
        rows = self._rows[name]
        res = self._registered[name]
        if len(rows) < 2:
            return 0.0
        if t1 is None:
            t1 = rows[-1][0]
        if t1 <= t0:
            return 0.0
        # linear interpolation of the cumulative busy_bytes series
        def interp(x: float) -> float:
            if x <= rows[0][0]:
                return rows[0][1]
            if x >= rows[-1][0]:
                return rows[-1][1]
            lo, hi = 0, len(rows) - 1
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if rows[mid][0] <= x:
                    lo = mid
                else:
                    hi = mid
            f = (x - rows[lo][0]) / (rows[hi][0] - rows[lo][0])
            return rows[lo][1] + f * (rows[hi][1] - rows[lo][1])

        moved = interp(t1) - interp(t0)
        return min(1.0, moved / (res.bw * (t1 - t0)))


class Telemetry:
    """The attachable hub: owns a Tracer and/or ResourceSampler.

    ``Telemetry(clock)`` attaches itself (``clock.telemetry = self``); the
    clock's hot paths call the three hooks below only when an instance is
    attached, so an un-instrumented run pays one ``is None`` branch per
    transfer.  ``detach()`` restores that state.

    The hooks are per-instance closures that only buffer (module docstring);
    :meth:`_drain` does all the work, batched per simulated instant.
    """

    def __init__(
        self,
        clock: "SimClock",
        *,
        trace: bool = True,
        sample: Iterable["Resource"] = (),
    ):
        self.clock = clock
        tracer = self.tracer = Tracer(clock) if trace else None
        sampler = self.sampler = ResourceSampler(clock, sample)
        # flow boundaries buffered since the last drain, all at one instant
        sbuf = self._sbuf = []         # started flows
        fbuf = self._fbuf = []         # finished flows
        self._mark_t = clock.now       # the instant the buffered events share
        s_append = sbuf.append
        f_append = fbuf.append

        if tracer is not None:

            def flow_started(flow, now):
                flow.trace_rec = now   # span start; the open-span store
                s_append(flow)
                self._mark_t = now

        else:

            def flow_started(flow, now):
                s_append(flow)
                self._mark_t = now

        def flow_finished(flow, now):
            f_append(flow)
            self._mark_t = now

        def settling():
            # clock hook, fired at the top of every settle: drain once time
            # is about to advance past the buffered instant (while the clock
            # still holds that instant's state — see module docstring)
            if (sbuf or fbuf) and self._mark_t != clock.now:
                self._drain()

        self.flow_started = flow_started
        self.flow_finished = flow_finished
        self.settling = settling
        clock.telemetry = self

    def detach(self) -> None:
        if self.clock.telemetry is self:
            self.drain_pending()  # queries drain via the clock; last chance
            self.clock.telemetry = None

    # ------------------------------------------------------------------ drain
    def drain_pending(self) -> None:
        """Force-process buffered boundaries (query paths call this)."""
        if self._sbuf or self._fbuf:
            self._drain()

    def _drain(self) -> None:
        """Batch-process the buffered instant's flow boundaries.

        Runs before the clock mutates state for a later instant, so
        ``busy_bytes`` / ``remaining`` / the flow sets still describe the
        buffered one.  Iteration orders are list/insertion orders —
        deterministic regardless of PYTHONHASHSEED.
        """
        t = self._mark_t
        sbuf, fbuf = self._sbuf, self._fbuf
        sampler = self.sampler
        if sampler._recs:
            recs_get = sampler._recs.get
            dirty: dict["Resource", list] = {}
            for buf in (sbuf, fbuf):
                for flow in buf:
                    for res in flow.path:
                        rows = recs_get(res)
                        if rows is not None:
                            dirty[res] = rows
            for res, rows in dirty.items():
                queued = 0.0
                for f in res.flows:
                    queued += f.remaining
                busy = res.busy_bytes
                n = len(res.flows)
                if rows[-1][0] == t:  # same-instant re-stamp (mid-burst query)
                    rows[-1] = (t, busy, queued, n)
                else:
                    rows.append((t, busy, queued, n))
        tracer = self.tracer
        if tracer is not None and fbuf:
            t_append = tracer._recs.append
            for flow in fbuf:
                ts = flow.trace_rec
                if ts is not None:  # None: started before the hub attached
                    t_append((flow.tag, ts, t - ts, flow.size, flow.path, flow.fid))
        del sbuf[:]
        del fbuf[:]

    # --------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Live counters for ``HoardFS.statfs`` / ``CacheManager.ls``."""
        out: dict = {
            "spans": 0,
            "live_flows": 0,
            "sampled_resources": [r.name for r in self.sampler.resources],
            "samples": self.sampler.n_samples(),
        }
        if self.tracer is not None:
            out["spans"] = len(self.tracer.spans)
            out["live_flows"] = self.tracer.live_flows()
        return out


# --------------------------------------------------------------------- rollup
def rollup_stalls(breakdowns: Iterable[dict]) -> dict:
    """Aggregate per-job stall breakdowns (seconds per class) cluster-wide.

    Returns ``{"jobs": n, "seconds": {cls: s}, "fractions": {cls: f}}`` with
    fractions over total accounted seconds (they sum to 1 when nonempty).
    """
    seconds: dict[str, float] = {}
    n = 0
    for bd in breakdowns:
        n += 1
        for cls, s in bd.items():
            seconds[cls] = seconds.get(cls, 0.0) + s
    total = sum(seconds.values())
    fractions = (
        {cls: s / total for cls, s in sorted(seconds.items())} if total > 0 else {}
    )
    return {"jobs": n, "seconds": dict(sorted(seconds.items())), "fractions": fractions}
