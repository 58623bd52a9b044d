"""Discrete-event simulation kernel with max-min-fair flow bandwidth sharing.

This is the time engine behind every Hoard performance number.  Cache *logic*
(striping, manifests, eviction, placement) runs for real; only elapsed time is
simulated, by booking every byte movement as a *flow* across a path of shared
:class:`Resource` objects (NIC, NVMe queue, TOR uplink, per-client service
capacity).  Concurrent flows share each resource max-min fairly; rates are
re-solved on every flow arrival/departure (fluid-flow DES, the standard model
for TCP-fair networks).

Processes are Python generators that ``yield`` requests:

    yield clock.sleep(dt)            # advance this process by dt seconds
    yield clock.transfer(path, n)    # move n bytes across resources in path
    yield event                      # wait for an Event set by someone else

Determinism: all continuations are deferred through the event heap; equal-time
events fire in schedule order.

Two interchangeable flow engines solve the max-min fair allocation
(``SimClock(engine=...)``, default ``"vector"``, or ``HOARD_SIM_ENGINE``):

* ``"scalar"`` — the reference implementation: per-flow Python loops over
  :class:`Flow` objects, exactly the pre-vectorization engine.  O(rounds x
  flows x path) Python work per flow arrival/departure, which caps scenarios
  at tens of nodes (ROADMAP item 2).
* ``"vector"`` — the production engine: flow state lives in numpy columns
  (``remaining``/``rate``/``settled_at``) plus a sparse resource x flow
  incidence structure; settlement, water-filling reallocation, queue-depth
  sampling and the next-completion scan are batched array ops.  The
  512-node x 10k-job scenario in ``benchmarks/simscale.py`` is only
  tractable on this engine.

The two engines are *bit-identical*: every float op in the vector path is
ordered to reproduce the scalar path's IEEE arithmetic exactly (sequential
``np.add.at`` accumulation in fid order, first-occurrence ``argmin``
tie-breaks in the scalar engine's capacity-dict encounter order, elementwise
settle/extrapolation).  ``tests/test_vector_engine.py`` cross-checks whole
scenarios on both engines; the committed ``benchmarks/baseline.json`` values
predate the vector engine and are unchanged by it.
"""

from __future__ import annotations

import heapq
import itertools
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Generator, Iterable, Optional

import numpy as np

#: Completion epsilon floor, in flow units (bytes for byte flows).  A flow is
#: complete when ``remaining <= max(size * 1e-9, EPS_BYTES)``: the relative
#: term absorbs float-rounding residue proportional to the flow's own size,
#: the absolute floor guarantees that *no live flow can survive below
#: EPS_BYTES* — without it, a sub-epsilon flow whose ``size`` is tiny could
#: be re-scheduled forever on ever-shrinking completion deltas (the stranding
#: hazard the vectorized engine's forced-completion list closes; the
#: invariant suite asserts the property via ``assert_no_stranded_flows``).
EPS_BYTES = 1e-9

#: Relative completion epsilon (rounding residue proportional to flow size).
_REL_EPS = 1e-9


class Resource:
    """A shared capacity (bytes/second).  Flows crossing it split it fairly."""

    __slots__ = ("name", "bw", "flows", "created_at", "_busy", "_eng", "_idx")

    def __init__(self, name: str, bw: float, *, created_at: float = 0.0):
        if bw <= 0:
            raise ValueError(f"resource {name!r} needs positive bandwidth, got {bw}")
        self.name = name
        self.bw = float(bw)
        # insertion-ordered (dict) so iteration is fid order for free: float
        # sums and max-min tie-breaks are order-sensitive, and set order
        # varies per process (object ids), which the load-aware read
        # scheduler would surface as cross-process metric wobble
        self.flows: dict["Flow", None] = {}
        self.created_at = float(created_at)  # sim time this resource appeared
        self._busy = 0.0  # bytes crossed; authoritative only while unbound
        self._eng = None  # owning _VectorEngine once a vector flow crosses us
        self._idx = -1    # column index in that engine's resource table

    @property
    def busy_bytes(self) -> float:
        """Total bytes that crossed this resource."""
        eng = self._eng
        return self._busy if eng is None else float(eng.busy[self._idx])

    @busy_bytes.setter
    def busy_bytes(self, value: float) -> None:
        eng = self._eng
        if eng is None:
            self._busy = value
        else:
            eng.busy[self._idx] = value

    def utilization(self, horizon: float) -> float:
        """Fraction of capacity used between creation and ``horizon`` seconds.

        The denominator is the resource's *lifetime* within the horizon, not
        the whole horizon — a node added mid-sim by ``scale_event`` that is
        busy from then on reads as 1.0, not as its arrival fraction.
        """
        span = horizon - self.created_at
        if span <= 0:
            return 0.0
        return min(1.0, (self.busy_bytes / self.bw) / span)

    def queued_bytes(self, now: Optional[float] = None) -> float:
        """Bytes still in flight across this resource (its queue depth).

        ``Flow.remaining`` is only settled lazily (on the next arrival or
        departure), so pass ``now`` to extrapolate each flow forward at its
        current rate — the load-aware read scheduler samples queue depth
        *between* settle points when scoring replicas.

        On the vector engine this delegates to one batched incidence pass
        that answers the question for *every* resource at once (memoized on
        ``(now, flow_seq)``); the per-flow loop below is the scalar path and
        the two are bit-identical (sequential fid-order accumulation).
        """
        eng = self._eng
        if eng is not None:
            return eng.resource_queued(self, now)
        total = 0.0
        for f in self.flows:                   # insertion (fid) order: the sum
            rem = f._remaining                 # is bit-reproducible
            if now is not None:
                rem -= f._rate * (now - f._settled_at)
            if rem > 0:
                total += rem
        return total

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Resource({self.name}, {self.bw/1e6:.1f} MB/s, {len(self.flows)} flows)"


class Flow:
    """Handle for one byte movement.  State storage is engine-specific.

    On the scalar engine, ``remaining``/``rate``/``settled_at`` live in the
    underscore slots; on the vector engine the authoritative values live in
    the engine's numpy columns and the properties below read through
    ``(_eng, _row)``.  When a vector flow finishes, its final state is
    copied back into the slots and the handle unbinds, so finished flows
    stay safely readable after their row is recycled.
    """

    __slots__ = (
        "fid", "path", "size", "event", "tag", "trace_rec",
        "_remaining", "_rate", "_settled_at", "_eng", "_row",
    )

    def __init__(
        self,
        fid: int,
        path: tuple[Resource, ...],
        nbytes: float,
        event: "Event",
        now: float,
        tag=None,
    ):
        self.fid = fid
        self.path = path
        self.size = float(nbytes)
        self.event = event
        self.tag = tag  # optional FlowTag (kind/owner/dataset/chunk) for tracing
        self.trace_rec = None  # span start time, set by an attached Telemetry hub
        self._remaining = float(nbytes)
        self._rate = 0.0
        self._settled_at = now  # sim-time up to which `remaining` is accurate
        self._eng = None
        self._row = -1

    @property
    def remaining(self) -> float:
        eng = self._eng
        return self._remaining if eng is None else float(eng.rem[self._row])

    @remaining.setter
    def remaining(self, value: float) -> None:
        eng = self._eng
        if eng is None:
            self._remaining = value
        else:
            eng.rem[self._row] = value

    @property
    def rate(self) -> float:
        eng = self._eng
        return self._rate if eng is None else float(eng.rate[self._row])

    @rate.setter
    def rate(self, value: float) -> None:
        eng = self._eng
        if eng is None:
            self._rate = value
        else:
            eng.rate[self._row] = value

    @property
    def settled_at(self) -> float:
        eng = self._eng
        return self._settled_at if eng is None else float(eng.settled[self._row])

    @settled_at.setter
    def settled_at(self, value: float) -> None:
        eng = self._eng
        if eng is None:
            self._settled_at = value
        else:
            eng.settled[self._row] = value

    @property
    def negligible(self) -> bool:
        # float-rounding residue (relative to the flow's own size) counts as
        # complete; flows are unit-agnostic (bytes, service-seconds, ...).
        # EPS_BYTES is the shared absolute floor (see its definition).
        r = self.remaining
        return r <= self.size * _REL_EPS or r <= EPS_BYTES


class Event:
    """One-shot event; processes can wait on it, values pass through."""

    __slots__ = ("clock", "fired", "value", "_callbacks")

    def __init__(self, clock: "SimClock"):
        self.clock = clock
        self.fired = False
        self.value = None
        self._callbacks: list[Callable] = []

    def set(self, value=None) -> None:
        if self.fired:
            return
        self.fired = True
        self.value = value
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(value)

    def on_fire(self, cb: Callable) -> None:
        """``cb(value)`` runs when the event fires (immediately if it has)."""
        if self.fired:
            cb(self.value)
        else:
            self._callbacks.append(cb)


class AllOf:
    """Join on several events; ``.event`` fires when all inputs have fired."""

    def __init__(self, clock: "SimClock", events: Iterable[Event]):
        self.event = Event(clock)
        events = list(events)
        self._pending = len(events)
        if self._pending == 0:
            self.event.set()
        for ev in events:
            ev.on_fire(self._one)

    def _one(self, _value) -> None:
        self._pending -= 1
        if self._pending == 0:
            self.event.set()


@dataclass(order=True)
class _Scheduled:
    when: float
    seq: int
    fn: Callable = field(compare=False)


class _ScalarEngine:
    """Reference flow engine: per-flow Python loops (pre-vectorization).

    Kept verbatim as the semantics oracle — ``tests/test_vector_engine.py``
    runs whole scenarios on both engines and asserts bit-identical results,
    and ``benchmarks/simscale.py`` measures the vector engine's throughput
    against this one.  State lives directly in each Flow's underscore slots.
    """

    name = "scalar"
    #: the scalar engine never defers rate solves (see _VectorEngine.flush)
    pending = False

    def __init__(self, clock: "SimClock"):
        self.clock = clock
        self._completing: list[Flow] = []

    def flush(self) -> None:
        pass  # reallocate() already ran eagerly

    # lifecycle -----------------------------------------------------------
    def attach(self, flow: Flow) -> None:
        pass  # Flow.__init__ already initialised the slots

    def detach(self, flow: Flow) -> None:
        pass

    # solver --------------------------------------------------------------
    def settle(self) -> None:
        """Advance every in-flight flow's `remaining` to the current time.

        Flows iterate in fid order here and in ``reallocate``: sets order by
        object id, which varies per process, and float accumulation plus
        max-min tie-breaks are order-sensitive — the load-aware read
        scheduler samples both, so cross-process bit-reproducibility needs a
        deterministic order.
        """
        clock = self.clock
        if clock.telemetry is not None:
            # before busy_bytes mutates: lets the sampler record flow marks
            # from an earlier instant lazily — state cannot have changed in
            # between, and same-instant boundary bursts get sampled once
            clock.telemetry.settling()
        now = clock.now
        for flow in clock._flows:
            moved = flow._rate * (now - flow._settled_at)
            if moved > 0:
                flow._remaining = max(0.0, flow._remaining - moved)
                for res in flow.path:
                    res._busy += moved
            flow._settled_at = now

    def reallocate(self) -> None:
        """Max-min fair (water-filling) rates; schedule next completion."""
        clock = self.clock
        done = [f for f in clock._flows if f.negligible]
        for f in done:
            clock._finish(f)
        flows = list(clock._flows)
        if not flows:
            clock._cancel_completion()
            return

        unassigned = dict.fromkeys(flows)     # fid order (float-sum stability)
        capacity: dict[Resource, float] = {}
        load: dict[Resource, int] = {}
        for f in flows:
            for res in f.path:
                capacity[res] = res.bw
                load[res] = load.get(res, 0) + 1

        while unassigned:
            share, bottleneck = None, None
            for res, cap in capacity.items():
                if load.get(res, 0) <= 0:
                    continue
                s = cap / load[res]
                if share is None or s < share:
                    share, bottleneck = s, res
            if bottleneck is None:  # pragma: no cover - all resources drained
                for f in unassigned:
                    f._rate = 0.0
                break
            settled = [f for f in unassigned if bottleneck in f.path]
            for f in settled:
                f._rate = share
                unassigned.pop(f, None)
                for res in f.path:
                    capacity[res] -= share
                    load[res] -= 1
            capacity.pop(bottleneck, None)
            load.pop(bottleneck, None)

        self._schedule_next_completion()

    def _schedule_next_completion(self) -> None:
        clock = self.clock
        clock._cancel_completion()
        best_dt = math.inf
        for f in clock._flows:
            if f._rate > 0:
                best_dt = min(best_dt, f._remaining / f._rate)
        if math.isinf(best_dt):
            return
        # remember which flows this completion is *for*, so float rounding in
        # settle() can never leave them fractionally unfinished
        self._completing = [
            f for f in clock._flows
            if f._rate > 0 and f._remaining / f._rate <= best_dt * (1 + 1e-12)
        ]
        clock._completion_handle = clock.schedule(best_dt, clock._on_completion)

    def on_completion(self) -> None:
        self.settle()
        for f in self._completing:  # see _schedule_next_completion
            f._remaining = 0.0
        self._completing = []
        self.reallocate()


class _VectorEngine:
    """Vectorized flow fabric: numpy columns + sparse incidence structure.

    Layout (see docs/architecture.md, "Vectorized flow fabric"):

    * flow columns ``rem``/``rate``/``settled``/``size``/``thresh`` indexed
      by *row*; rows are allocated in fid order, dead rows are masked by
      ``alive`` and compacted when they outnumber live ones, so ascending
      row order is always ascending fid order;
    * the resource x flow path membership as two parallel append-only arrays
      ``(ei_flow, ei_res)`` — one entry per (flow, resource-on-its-path)
      pair, appended flow-major, i.e. grouped per flow in path order with
      flows in fid order;
    * per-resource columns ``busy``/``res_bw`` indexed by the engine-local
      resource id stamped on each Resource at first use.

    Bit-identity with the scalar engine is load-bearing and every accumulation
    is ordered for it: busy-bytes and water-filling capacity updates go
    through ``np.add.at`` (sequential element-at-a-time adds, fid order),
    bottleneck ``argmin`` ties break on the scalar capacity-dict *encounter
    order* (rebuilt per reallocate from the live incidence), and the
    next-completion scan is the same ``remaining / rate`` arithmetic done
    elementwise.  The indexed min structure replacing the scalar linear scan
    is the ``(rows, dts)`` pair: one vectorized division + ``min`` over the
    live-row index, with the forced-completion set kept as row indices.
    """

    name = "vector"

    def __init__(self, clock: "SimClock"):
        self.clock = clock
        n = 64
        self.rem = np.zeros(n)
        self.rate = np.zeros(n)
        self.settled = np.zeros(n)
        self.size = np.zeros(n)
        self.thresh = np.zeros(n)       # per-flow completion epsilon
        self.alive = np.zeros(n, dtype=bool)
        self.handles: list[Optional[Flow]] = [None] * n
        self.n = 0                      # row high-water mark (dead rows included)
        self.n_dead = 0
        e = 256
        self.ei_flow = np.zeros(e, dtype=np.int64)
        self.ei_res = np.zeros(e, dtype=np.int64)
        self.ne = 0                     # incidence high-water mark
        self.resources: list[Resource] = []
        self.res_bw = np.zeros(0)
        self.busy = np.zeros(0)
        self._live_rows: Optional[np.ndarray] = None
        self._live_entries: Optional[np.ndarray] = None
        self._completing = np.zeros(0, dtype=np.int64)
        self._qkey: Optional[tuple] = None   # queued-bytes snapshot memo
        self._qvec: Optional[np.ndarray] = None
        self.pending = False                 # a rate solve is deferred
        # read-only index scratch, reused across solves (allocation churn in
        # the hot solve path costs more than the arithmetic at this scale)
        self._asc = np.arange(1024)
        self._desc = np.arange(1023, -1, -1)
        self._first = np.zeros(0, dtype=np.int64)

    def _index_scratch(self, size: int) -> None:
        if size > len(self._asc):
            n = 1 << (size - 1).bit_length()
            self._asc = np.arange(n)
            self._desc = np.arange(n - 1, -1, -1)

    # storage -------------------------------------------------------------
    def _grow_rows(self) -> None:
        n = len(self.rem)
        pad = np.zeros(n)
        self.rem = np.concatenate([self.rem, pad])
        self.rate = np.concatenate([self.rate, pad.copy()])
        self.settled = np.concatenate([self.settled, pad.copy()])
        self.size = np.concatenate([self.size, pad.copy()])
        self.thresh = np.concatenate([self.thresh, pad.copy()])
        self.alive = np.concatenate([self.alive, np.zeros(n, dtype=bool)])
        self.handles.extend([None] * n)

    def _grow_entries(self) -> None:
        e = len(self.ei_flow)
        self.ei_flow = np.concatenate([self.ei_flow, np.zeros(e, dtype=np.int64)])
        self.ei_res = np.concatenate([self.ei_res, np.zeros(e, dtype=np.int64)])

    def _bind_resource(self, res: Resource) -> int:
        if res._eng is not None and res._eng is not self:
            # resource migrating between engines (rare: object reuse across
            # clocks in tests) — materialise its accumulated bytes first
            res._busy = res.busy_bytes
        idx = len(self.resources)
        self.resources.append(res)
        if idx >= len(self.busy):
            grow = max(64, len(self.busy))
            self.busy = np.concatenate([self.busy, np.zeros(grow)])
            self.res_bw = np.concatenate([self.res_bw, np.zeros(grow)])
        self.busy[idx] = res._busy
        self.res_bw[idx] = res.bw
        res._eng = self
        res._idx = idx
        return idx

    # lifecycle -----------------------------------------------------------
    def attach(self, flow: Flow) -> None:
        row = self.n
        if row == len(self.rem):
            self._grow_rows()
        self.n = row + 1
        size = flow.size
        self.rem[row] = size
        self.size[row] = size
        self.rate[row] = 0.0
        self.settled[row] = self.clock.now
        self.thresh[row] = max(size * _REL_EPS, EPS_BYTES)
        self.alive[row] = True
        self.handles[row] = flow
        flow._eng = self
        flow._row = row
        path = flow.path
        k = len(path)
        while self.ne + k > len(self.ei_flow):
            self._grow_entries()
        ne = self.ne
        for i, res in enumerate(path):
            self.ei_res[ne + i] = res._idx if res._eng is self else self._bind_resource(res)
            self.ei_flow[ne + i] = row
        self.ne = ne + k
        self._live_rows = None
        self._live_entries = None

    def detach(self, flow: Flow) -> None:
        row = flow._row
        # copy the final state back so the handle survives row recycling
        flow._remaining = float(self.rem[row])
        flow._rate = float(self.rate[row])
        flow._settled_at = float(self.settled[row])
        flow._eng = None
        flow._row = -1
        self.alive[row] = False
        self.handles[row] = None
        self.n_dead += 1
        self._live_rows = None
        self._live_entries = None
        if self.n_dead > 256 and self.n_dead * 2 > self.n:
            self._compact()

    def _compact(self) -> None:
        """Drop dead rows/entries; live order (== fid order) is preserved."""
        lr = np.flatnonzero(self.alive[: self.n])
        le = np.flatnonzero(self.alive[self.ei_flow[: self.ne]])
        rowmap = np.full(self.n, -1, dtype=np.int64)
        n_live = lr.size
        rowmap[lr] = np.arange(n_live)
        new_flow = rowmap[self.ei_flow[le]]
        new_res = self.ei_res[le].copy()
        for name in ("rem", "rate", "settled", "size", "thresh"):
            arr = getattr(self, name)
            arr[:n_live] = arr[lr]
        live_handles = [self.handles[r] for r in lr]
        for i, h in enumerate(live_handles):
            h._row = i
        self.handles[:n_live] = live_handles
        self.handles[n_live: self.n] = [None] * (self.n - n_live)
        self.alive[:n_live] = True
        self.alive[n_live: self.n] = False
        self.n = n_live
        self.n_dead = 0
        ne_live = le.size
        self.ei_flow[:ne_live] = new_flow
        self.ei_res[:ne_live] = new_res
        self.ne = ne_live
        self._live_rows = None
        self._live_entries = None

    def _rows(self) -> np.ndarray:
        if self._live_rows is None:
            self._live_rows = np.flatnonzero(self.alive[: self.n])
        return self._live_rows

    def _entries(self) -> np.ndarray:
        if self._live_entries is None:
            self._live_entries = np.flatnonzero(self.alive[self.ei_flow[: self.ne]])
        return self._live_entries

    # solver --------------------------------------------------------------
    def settle(self) -> None:
        clock = self.clock
        if clock.telemetry is not None:
            clock.telemetry.settling()  # same hook point as the scalar engine
        lr = self._rows()
        if lr.size == 0:
            return
        now = clock.now
        moved = self.rate[lr] * (now - self.settled[lr])
        pos = moved > 0.0
        if pos.any():
            rem = self.rem[lr]
            self.rem[lr] = np.where(pos, np.maximum(0.0, rem - moved), rem)
            # busy accumulation: one add per (flow, resource) incidence entry,
            # in fid-major order — the scalar engine's exact float sequence
            moved_full = np.zeros(self.n)
            moved_full[lr] = moved
            le = self._entries()
            entry_moved = moved_full[self.ei_flow[le]]
            sel = entry_moved > 0.0
            np.add.at(self.busy, self.ei_res[le[sel]], entry_moved[sel])
        self.settled[lr] = now

    def reallocate(self) -> None:
        """Mark the rate solve dirty; it runs once per instant in ``flush``.

        The scalar engine re-solves after *every* same-instant flow change
        (a completion immediately resumes its waiter, whose next ``transfer``
        lands at the same timestamp — two solves per settled flow).  Rates
        computed mid-instant are unobservable: every flow-set change settles
        all flows to ``now`` first, so until the clock advances, ``settle``
        moves zero bytes and ``queued_bytes`` extrapolates over ``dt == 0``.
        The vector engine therefore coalesces all same-instant changes into
        one solve, flushed by :meth:`SimClock.run` before time advances —
        the final rates (and the next completion) are computed from the same
        final flow set, in the same float order, as the scalar engine's last
        same-instant solve.
        """
        self.pending = True

    def flush(self) -> None:
        if not self.pending:
            return
        self.pending = False
        clock = self.clock
        lr = self._rows()
        if lr.size:
            neg = self.rem[lr] <= self.thresh[lr]
            if neg.any():
                # collect handles first: detach may compact and renumber rows
                for f in [self.handles[r] for r in lr[neg]]:
                    clock._finish(f)
                # each finish just scheduled its waiter at this instant —
                # the waiters' own flow changes (the completed job's next
                # transfer) are still queued, so the solve stays deferred;
                # run() re-flushes once the instant has fully drained
                self.pending = True
                return
        self._reallocate_now()

    def _reallocate_now(self) -> None:
        clock = self.clock
        lr = self._rows()
        if lr.size == 0:
            clock._cancel_completion()
            return

        le = self._entries()
        er = self.ei_res[le]
        ef = self.ei_flow[le]
        # local resource ids in the scalar capacity-dict *encounter order*
        # (first occurrence over flows in fid order, path position) — argmin
        # tie-breaks below must pick the same resource the scalar loop does.
        # Reversed-scatter first-occurrence beats np.unique ~20x: last write
        # wins, so writing positions in reverse leaves each resource's first
        n_total = len(self.resources)
        self._index_scratch(er.size)
        if len(self._first) < n_total:
            self._first = np.zeros(max(64, 2 * n_total), dtype=np.int64)
        first = self._first
        first[:n_total] = -1
        first[er[::-1]] = self._desc[len(self._desc) - er.size:]
        present_ids = np.flatnonzero(first[:n_total] >= 0)
        res_ids = present_ids[np.argsort(first[present_ids], kind="stable")]
        n_res = res_ids.size
        g2l = np.empty(n_total, dtype=np.int64)
        g2l[res_ids] = self._asc[:n_res]
        erl = g2l[er]
        if n_res < 32000:
            # int16 keys sort ~8x faster (2-pass radix vs 8-pass)
            erl = erl.astype(np.int16)
        cap = self.res_bw[res_ids].copy()
        counts = np.bincount(erl, minlength=n_res)
        load = counts.astype(np.float64)
        # CSR by resource: entries grouped per local resource, fid order within
        order = np.argsort(erl, kind="stable")
        flows_by_res = ef[order]
        ends = np.cumsum(counts)
        starts = ends - counts
        # flow-major slices: a flow's entries are contiguous in le order, and
        # rows ascend in fid order, so cumsum over per-row entry counts
        # yields each settled flow's (start, end) into erl directly
        flow_counts = np.bincount(ef, minlength=self.n)
        f_ends = np.cumsum(flow_counts)
        f_starts = f_ends - flow_counts
        unassigned = self.alive[: self.n].copy()
        n_un = lr.size
        popped = np.zeros(n_res, dtype=bool)
        share = np.empty(n_res)
        while n_un > 0:
            bad = popped | (load <= 0.0)
            np.divide(cap, load, out=share, where=~bad)
            share[bad] = math.inf
            b = int(np.argmin(share))       # first occurrence == scalar tie-break
            s = float(share[b])
            if math.isinf(s):  # pragma: no cover - all resources drained
                self.rate[np.flatnonzero(unassigned)] = 0.0
                break
            fob = flows_by_res[starts[b]: ends[b]]
            hit = fob[unassigned[fob]]      # fid order (stable grouping)
            self.rate[hit] = s
            unassigned[hit] = False
            n_un -= hit.size
            cnts = flow_counts[hit]
            tot = int(cnts.sum())
            # gather every settled flow's incidence entries ((flow, path-pos)
            # order, flows in fid order — the scalar nested-loop sequence)
            gather = (
                self._asc[:tot]
                - np.repeat(np.cumsum(cnts) - cnts, cnts)
                + np.repeat(f_starts[hit], cnts)
            )
            touched = erl[gather]
            np.add.at(cap, touched, -s)     # repeated `cap -= share`, scalar order
            np.add.at(load, touched, -1.0)
            popped[b] = True

        self._schedule_next_completion()

    def _schedule_next_completion(self) -> None:
        clock = self.clock
        clock._cancel_completion()
        lr = self._rows()
        rates = self.rate[lr]
        m = rates > 0.0
        if not m.any():
            self._completing = np.zeros(0, dtype=np.int64)
            return
        rows = lr[m]
        dts = self.rem[rows] / rates[m]
        best_dt = float(dts.min())
        # remember which flows this completion is *for*, so float rounding in
        # settle() can never leave them fractionally unfinished
        self._completing = rows[dts <= best_dt * (1 + 1e-12)]
        clock._completion_handle = clock.schedule(best_dt, clock._on_completion)

    def on_completion(self) -> None:
        self.settle()
        self.rem[self._completing] = 0.0    # see _schedule_next_completion
        self._completing = np.zeros(0, dtype=np.int64)
        self.reallocate()

    # queue sampling ------------------------------------------------------
    def resource_queued(self, res: Resource, now: Optional[float]) -> float:
        """Queue depth of ``res`` from one batched all-resources pass.

        The snapshot (queued bytes per resource) is memoized on
        ``(clock.now, flow_seq, now)`` — between flow-set changes at one
        instant every resource's answer is constant, so the read scheduler's
        per-node sampling of a 512-node fabric costs one O(incidence) pass.
        """
        clock = self.clock
        key = (clock.now, clock.flow_seq, now)
        if self._qkey != key:
            q = np.zeros(len(self.resources))
            lr = self._rows()
            if lr.size:
                rem = self.rem[lr]
                if now is not None:
                    rem = rem - self.rate[lr] * (now - self.settled[lr])
                rem = np.where(rem > 0.0, rem, 0.0)
                full = np.zeros(self.n)
                full[lr] = rem
                le = self._entries()
                # fid-order sequential adds per resource (bit-reproducible)
                np.add.at(q, self.ei_res[le], full[self.ei_flow[le]])
            self._qkey = key
            self._qvec = q
        return float(self._qvec[res._idx])


_ENGINES = {"scalar": _ScalarEngine, "vector": _VectorEngine}


class SimClock:
    """Deterministic event loop + fluid max-min-fair flow network.

    ``engine`` selects the flow solver (``"vector"`` default, ``"scalar"``
    reference; overridable via the ``HOARD_SIM_ENGINE`` environment
    variable) — see the module docstring.  Everything observable (completion
    times, busy bytes, queue depths, telemetry) is bit-identical between the
    two.
    """

    def __init__(self, engine: Optional[str] = None):
        engine = engine or os.environ.get("HOARD_SIM_ENGINE", "vector")
        if engine not in _ENGINES:
            raise ValueError(f"unknown simclock engine {engine!r} (scalar|vector)")
        self.engine = engine
        self._eng = _ENGINES[engine](self)
        self.now = 0.0
        self._heap: list[_Scheduled] = []
        self._seq = itertools.count()
        self._fid = itertools.count()
        # insertion-ordered (see Resource.flows): iteration is fid order
        self._flows: dict[Flow, None] = {}
        self._completion_handle: Optional[_Scheduled] = None
        # bumped whenever the flow set changes (start/finish); (now, flow_seq)
        # keys queue-depth memoization in the read scheduler — between bumps
        # at one instant, every Resource's queued_bytes(now) is constant
        self.flow_seq = 0
        # cumulative count of completed flows (benchmarks/simscale.py's
        # flows-settled/sec numerator)
        self.flows_settled = 0
        # optional telemetry hub (repro_torch.core.telemetry.Telemetry); when
        # attached, flow start/finish and settle call back into it
        # — an un-instrumented run pays one `is None` branch per hook site
        self.telemetry = None

    @property
    def pending_events(self) -> bool:
        """True while :meth:`run` still has work — queued events, or a
        deferred rate solve that will schedule the next flow completion."""
        return bool(self._heap) or self._eng.pending

    # ------------------------------------------------------------------ events
    def event(self) -> Event:
        return Event(self)

    def all_of(self, events: Iterable[Event]) -> Event:
        return AllOf(self, events).event

    def schedule(self, delay: float, fn: Callable) -> _Scheduled:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        item = _Scheduled(self.now + delay, next(self._seq), fn)
        heapq.heappush(self._heap, item)
        return item

    # --------------------------------------------------------------- processes
    def process(self, gen: Generator) -> Event:
        """Run a generator as a process; returns an Event fired on return."""
        done = Event(self)

        def step(send_value=None):
            try:
                request = gen.send(send_value)
            except StopIteration as stop:
                done.set(getattr(stop, "value", None))
                return
            if isinstance(request, Event):
                # defer through the heap so Event.set never reenters the
                # flow-network solver mid-update
                request.on_fire(lambda v: self.schedule(0.0, lambda: step(v)))
            elif isinstance(request, tuple) and request and request[0] == "sleep":
                self.schedule(request[1], lambda: step(None))
            else:
                raise TypeError(f"process yielded unsupported request {request!r}")

        self.schedule(0.0, step)
        return done

    # ------------------------------------------------------------------- sleep
    @staticmethod
    def sleep(dt: float):
        return ("sleep", float(dt))

    # ---------------------------------------------------------------- transfer
    def transfer(self, path: Iterable[Resource], nbytes: float, tag=None) -> Event:
        """Start a flow of ``nbytes`` across ``path``; returns completion Event.

        ``tag`` (a :class:`~repro_torch.core.telemetry.FlowTag`) identifies the flow
        for the telemetry plane; it is inert when no hub is attached.
        """
        ev = Event(self)
        nbytes = float(nbytes)
        path = tuple(path)
        if nbytes <= 0 or not path:
            ev.set()
            return ev
        if len(path) != len(set(path)):
            # a duplicated resource would double-count its share in both
            # engines' incidence structures; no caller builds such a path
            raise ValueError(f"flow path contains a duplicate resource: {path!r}")
        self._eng.settle()
        flow = Flow(next(self._fid), path, nbytes, ev, self.now, tag)
        self.flow_seq += 1
        self._flows[flow] = None
        for res in path:
            res.flows[flow] = None
        self._eng.attach(flow)
        if self.telemetry is not None:
            self.telemetry.flow_started(flow, self.now)
        self._eng.reallocate()
        return ev

    # ----------------------------------------------------- engine entry points
    def _settle(self) -> None:
        """Advance in-flight flows to ``now`` (delegates to the engine)."""
        self._eng.settle()

    def _reallocate(self) -> None:
        """Re-solve max-min fair rates now (delegates to the engine)."""
        self._eng.reallocate()
        self._eng.flush()

    def _cancel_completion(self) -> None:
        if self._completion_handle is not None:
            self._completion_handle.fn = lambda: None  # tombstone
            self._completion_handle = None

    def _on_completion(self) -> None:
        self._completion_handle = None
        self._eng.on_completion()

    def _finish(self, flow: Flow) -> None:
        self.flow_seq += 1
        self.flows_settled += 1
        self._flows.pop(flow, None)
        for res in flow.path:
            res.flows.pop(flow, None)
        self._eng.detach(flow)
        if self.telemetry is not None:
            self.telemetry.flow_finished(flow, self.now)
        # defer the event so completions never reenter the solver
        self.schedule(0.0, flow.event.set)

    # ------------------------------------------------------------- invariants
    def assert_no_stranded_flows(self) -> None:
        """No live flow may sit at/below its completion epsilon.

        Between event-loop steps every sub-epsilon flow must have been
        finished by the preceding ``reallocate`` — a violation means a flow
        is stranded below :data:`EPS_BYTES` (the float-comparison hazard the
        shared epsilon exists to close).  The invariant suite calls this
        after (and during) scenario runs.
        """
        self._eng.flush()   # a deferred solve may still owe some finishes
        for f in self._flows:
            if f.negligible:
                raise AssertionError(
                    f"stranded flow fid={f.fid}: remaining={f.remaining!r} "
                    f"<= eps for size={f.size!r}"
                )

    # --------------------------------------------------------------------- run
    def run(self, until: Optional[float] = None) -> float:
        """Drain the event heap (optionally stopping at ``until`` seconds).

        A deferred rate solve (vector engine) is flushed whenever the current
        instant is complete — before time advances past it, before stopping
        at ``until``, and before concluding the heap is drained (the flush
        itself may schedule the next completion event).
        """
        heap = self._heap
        eng = self._eng
        while True:
            if eng.pending and (not heap or heap[0].when > self.now):
                eng.flush()     # may push a completion; re-inspect the heap
                continue
            if not heap:
                return self.now
            item = heap[0]
            if until is not None and item.when > until - 1e-12:
                self.now = until
                return self.now
            heapq.heappop(heap)
            self.now = max(self.now, item.when)
            item.fn()
