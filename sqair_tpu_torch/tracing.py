"""The port's own measurements: host spans, and a device stamp at the
first and the last node of every graph replay.

Spans.  ``span(name)`` times a stretch of host work on
``time.perf_counter_ns``.  Spans nest: each keeps its parent's id and the
index of the chain call it belongs to (``call()`` advances the index once
a ``ChainedTrainStep`` call, whether or not tracing is on, so that a
replay can be tied to its call).  Per-call spans are
recorded only while tracing is on (``enable()`` / ``disable()``, off by
default: a span then costs a function call and one branch).  One-off spans
(``setup_span``: the kernel build, the chain's warm-up and capture) are
recorded always; they happen once a run or once a curriculum stage.
Finished spans go into bounded rings (``SPAN_RING`` per-call spans, a few
thousand calls' worth), so that a long run does not grow.  While tracing
is on and a ``torch.profiler`` is active, every leaf span also opens a
``record_function`` of its name, so that the profiler's trace shows the
program's phases beside the device's work; an enclosing span (the
chain's prepare) never does.  The profiler then also records each
such span as a ``gpu_user_annotation`` device event over the device work
launched inside it (for ``sqair.chain.graph_launch``: the whole replay),
so a profile whose device events are summed as work is taken with
tracing off.

Counters.  The program's launch counter is ``ops/fused.launches``: one
count per wrapper call that launched its kernels, advanced only while a
graph is captured (and in its warm-up step); ``ChainedTrainStep.launches``
holds one capture's counts.  The stamp kernel below is not counted there;
a chain's replays are counted by its ``StampRing.launched``.

Replay stamps.  A ``StampRing`` is a chain's device ring of int64 stamps
and the host's record of which call launched each replay.  The chain's
capture launches a stamp (``ops/stamp.py``, ``csrc/trace_stamp.cu``) as
the graph's first node and another as its last, so every replay leaves
its (first, last) pair of the card's nanosecond clock (``%globaltimer``)
with no host work and no host sync.  The stamps sit in the graph whether
tracing is on or off: toggling needs no recapture.  The ring is read with
one device-to-host copy in ``summary()`` or ``records()``, which waits for
the card.

Clock.  ``calibrate()`` brackets a stamp between two syncs and host clock
reads, keeps the narrowest of a few tries and so gives the device clock's
offset from ``perf_counter_ns`` with its uncertainty (half the bracket).
Once a chain has registered its ring, ``enable()`` calibrates, and so does
every ``summary()`` while tracing is on; the first and the newest point
map the device clock onto the host's (a straight line, so a slow drift
between the clocks is taken out).

``summary()`` puts it together: per span name its count, total, median,
p90 and self time (its time less its recorded children's), the one-off
spans, the replays' gap share (the card's time between one replay's last stamp
and the next one's first, over the time from the first replay's first
stamp to the last one's last; it leaves out idle time inside a replay),
and the longest gaps between replays, each labelled with the innermost
host span that overlaps it most on the aligned clock.  ``records()``
gives the spans and replays of a range of calls themselves, with the map
from the card's clock onto the host's.
"""
from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SPAN_RING = 16384  # finished per-call spans kept: 2 a chain call
SETUP_RING = 1024  # finished one-off spans kept
STAMP_REPLAYS = 4096  # replays a chain's ring holds: 2 int64 stamps each, 64 KB
CALIBRATION_TRIES = 8
TOP_GAPS = 10
NO_SPAN = "no span"
NOT_ALIGNED = "clock not calibrated"

Replay = Tuple[int, int, int]  # (call index, first stamp ns, last stamp ns)
ClockPoint = Tuple[int, int, int]  # (host ns, device ns - host ns, uncertainty ns)

_enabled = False
_call = -1
_spans: collections.deque = collections.deque(maxlen=SPAN_RING)
_setup: collections.deque = collections.deque(maxlen=SETUP_RING)
_ids = itertools.count(1)
_local = threading.local()
_stamps: Optional["StampRing"] = None
_clock: List[ClockPoint] = []  # the first and the newest calibration


class Span:
    """A finished (or open) span: times in host ns."""

    __slots__ = ("id", "name", "start", "end", "parent", "call", "attrs")

    def __init__(self, name: str, attrs: Dict):
        self.id, self.name, self.attrs = next(_ids), name, attrs
        self.start = self.end = 0
        self.parent: Optional[int] = None
        self.call = _call

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Null:
    """What ``span`` returns while tracing is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiler_active() -> bool:
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


class _Open:
    """A span being recorded into ``store``."""

    __slots__ = ("span", "store", "leaf", "_rf")

    def __init__(self, name: str, attrs: Dict, store, leaf: bool):
        self.span, self.store, self.leaf, self._rf = Span(name, attrs), store, leaf, None

    def __enter__(self) -> Span:
        s, stack = self.span, _stack()
        s.parent = stack[-1].id if stack else None
        stack.append(s)
        if self.leaf and _enabled and _profiler_active():
            self._rf = torch.autograd.profiler.record_function(s.name)
            self._rf.__enter__()
        s.start = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        s = self.span
        s.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is s:
            stack.pop()
        self.store.append(s)
        return False


def enable():
    """Records per-call spans from now on; calibrates the device clock
    (once a chain's ring is registered)."""
    global _enabled
    _enabled = True
    calibrate()


def disable():
    global _enabled
    _enabled = False


def span(name: str):
    """A per-call span (recorded only while tracing is on)."""
    if not _enabled:
        return _NULL
    return _Open(name, {}, _spans, leaf=True)


def setup_span(name: str, leaf: bool = True, **attrs):
    """A one-off span, recorded always; ``leaf`` False for one that
    encloses others."""
    return _Open(name, attrs, _setup, leaf=leaf)


def call():
    """Starts the next chain call: the spans opened from now on carry its
    index."""
    global _call
    _call += 1


def mark() -> int:
    """The index the next chain call will have."""
    return _call + 1


def last(name: str) -> Optional[Span]:
    """The newest finished span called ``name``."""
    found = [s for s in itertools.chain(_setup, _spans) if s.name == name]
    return max(found, key=lambda s: s.end) if found else None


def reset():
    """Forgets every span, the stamp ring and the calibrations."""
    global _call, _stamps
    disable()
    _call, _stamps = -1, None
    _spans.clear()
    _setup.clear()
    _clock.clear()
    _local.stack = []


# ------------------------------------------------------------ stamps


class StampRing:
    """A device ring of replay stamps: int64 [1 + 2 ``replays``], the
    stamps written so far, then the ring; ``launch(buf)`` puts one stamp
    into it on the current stream (``ops/stamp.stamp``).  The host keeps
    each launched replay's call index beside it."""

    def __init__(self, device, launch: Callable[[torch.Tensor], None], steps: int = 1,
                 replays: int = STAMP_REPLAYS):
        self.launch, self.steps = launch, int(steps)
        self.buf = torch.zeros(1 + 2 * int(replays), dtype=torch.int64, device=device)
        self.calls: collections.deque = collections.deque(maxlen=int(replays))
        self.launched = 0

    def stamp(self):
        """Launches one stamp (captured into a graph while one is
        captured)."""
        self.launch(self.buf)

    def replayed(self):
        """Notes, on the host, that the graph was launched in this call."""
        self.calls.append(_call)
        self.launched += 1

    def read(self) -> List[Replay]:
        """Every replay whose two stamps the ring holds, oldest first (one
        copy, which waits for the card)."""
        raw = self.buf.cpu().tolist()
        return ring_replays(raw[0], raw[1:], list(self.calls), self.launched)


def register(ring: StampRing):
    """Makes ``ring`` the one that ``summary()`` reads (a chain's capture)."""
    global _stamps
    _stamps = ring


def ring_replays(written: int, ring: Sequence[int], calls: Sequence[int],
                 launched: int) -> List[Replay]:
    """(call, first, last) of each replay whose two stamps are still in the
    ring, oldest first.  ``written`` stamps went into ``ring`` (stamp j at
    j % len(ring)); ``calls`` holds the newest launched replays' call
    indices, the last of them the ``launched``-th."""
    cap = len(ring)
    n = min(written // 2, launched)
    oldest = max(0, n - cap // 2, launched - len(calls))
    skip = launched - len(calls)
    return [(calls[k - skip], ring[(2 * k) % cap], ring[(2 * k + 1) % cap])
            for k in range(oldest, n)]


def gap_share(replays: Sequence[Replay], before: Optional[Replay] = None) -> Optional[float]:
    """The share of the replays' stretch (first stamp of the first, last of
    the last) that lies between one replay and the next, in %.  With
    ``before``, the replay just before them, the stretch starts at its last
    stamp instead, so that the gap from it counts (and a single replay has
    a share)."""
    chain = ([before] if before else []) + list(replays)
    if len(chain) < 2:
        return None
    whole = replays[-1][2] - (before[2] if before else replays[0][1])
    if whole <= 0:
        return None
    return 100.0 * sum(b[1] - a[2] for a, b in zip(chain, chain[1:])) / whole


# ------------------------------------------------------------- clock


def clock_offset(brackets: Sequence[Tuple[int, int, int]]) -> ClockPoint:
    """The device clock's offset from the host's, from (host ns before, the
    device's stamp, host ns after) brackets: the narrowest one's midpoint,
    (host ns at it, device - host ns, half its width as the uncertainty)."""
    h0, g, h1 = min(brackets, key=lambda b: b[2] - b[0])
    mid = (h0 + h1) // 2
    return mid, g - mid, (h1 - h0) // 2


def to_host(points: Sequence[ClockPoint]):
    """Device ns -> host ns through the first and the newest calibration
    (the offset changes along a straight line between them)."""
    (a1, o1, _), (a2, o2, _) = points[0], points[-1]
    slope = (o2 - o1) / (a2 - a1) if a2 > a1 else 0.0
    return lambda g: (g - o1 + slope * a1) / (1.0 + slope)


def calibrate(tries: int = CALIBRATION_TRIES) -> Optional[ClockPoint]:
    """Adds a calibration of the device clock (see the module's docstring),
    with stamps into a ring of its own on the registered ring's device;
    nothing before a ring is registered."""
    if _stamps is None:
        return None
    device = _stamps.buf.device
    ring = StampRing(device, _stamps.launch, replays=tries)
    hosts = []
    for _ in range(tries):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        ring.stamp()
        torch.cuda.synchronize(device)
        hosts.append((h0, time.perf_counter_ns()))
    stamps = ring.buf[1:1 + tries].tolist()
    point = clock_offset([(h0, g, h1) for (h0, h1), g in zip(hosts, stamps)])
    _clock[1:] = []
    _clock.append(point)
    return point


# ----------------------------------------------------------- summary


def _nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


def span_stats(spans: Sequence[Span]) -> Dict[str, Dict[str, float]]:
    """Per span name: count, total_s, median_ms, p90_ms (nearest rank) and
    self_s (the total less the recorded children's)."""
    children: Dict[int, int] = collections.Counter()
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end - s.start
    by_name: Dict[str, List[Span]] = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    out = {}
    for name, group in by_name.items():
        ns = sorted(s.end - s.start for s in group)
        mid = len(ns) // 2
        median = ns[mid] if len(ns) % 2 else (ns[mid - 1] + ns[mid]) / 2
        out[name] = dict(count=len(ns), total_s=sum(ns) / 1e9, median_ms=median / 1e6,
                         p90_ms=_nearest_rank(ns, 0.9) / 1e6,
                         self_s=sum(s.end - s.start - children.get(s.id, 0)
                                    for s in group) / 1e9)
    return out


def label_gaps(gaps: Sequence[Tuple[float, float]], spans: Sequence[Span],
               n: int = TOP_GAPS) -> List[List]:
    """The ``n`` longest gaps (host ns, start and end), longest first, as
    [label, ms]: the innermost span overlapping the gap that overlaps it
    most (the shorter of equals), where a span is innermost unless one of
    its children overlaps the gap too; else ``NO_SPAN``."""
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        over = [s for s in spans if min(s.end, g1) > max(s.start, g0)]
        parents = {s.parent for s in over}
        inner = [s for s in over if s.id not in parents]
        best = min(inner, key=lambda s: (-(min(s.end, g1) - max(s.start, g0)),
                                         s.end - s.start), default=None)
        out.append([best.name if best else NO_SPAN, (g1 - g0) / 1e6])
    return out


def _kept(calls: Optional[Tuple[int, int]], c: int) -> bool:
    return calls is None or calls[0] <= c < calls[1]


def records(calls: Optional[Tuple[int, int]] = None
            ) -> Tuple[List[Span], List[Replay], Optional[Callable[[float], float]]]:
    """The finished spans (one-off ones first) and the replays of the chain
    calls ``calls`` (first, stop; all calls without it), and the map of the
    card's clock onto the host's (None before a calibration)."""
    spans = [s for s in itertools.chain(_setup, _spans) if _kept(calls, s.call)]
    replays = [r for r in _stamps.read() if _kept(calls, r[0])] if _stamps is not None else []
    return spans, replays, to_host(_clock) if _clock else None


def summary(calls: Optional[Tuple[int, int]] = None, continued: bool = False) -> Dict:
    """What the program recorded, as one dict (see the module's docstring);
    ``calls`` (first, stop) keeps the spans and replays of those calls.
    ``continued``: the first gap runs from the replay of the call just
    before ``calls``, as where one interval of calls follows another."""
    if _enabled:
        calibrate()
    spans, replays, host = records(calls)
    out = dict(enabled=_enabled, calls=_call + 1, spans=span_stats(spans),
               setup=[dict(name=s.name, call=s.call, s=s.seconds, **s.attrs)
                      for s in _setup if _kept(calls, s.call)])
    if _clock:
        out["clock"] = dict(offset_ns=_clock[-1][1],
                            uncertainty_ms=max(p[2] for p in _clock) / 1e6,
                            drift_ppm=(1e6 * (_clock[-1][1] - _clock[0][1])
                                       / (_clock[-1][0] - _clock[0][0])
                                       if _clock[-1][0] > _clock[0][0] else 0.0))
    if _stamps is not None:
        before = None
        if continued and calls is not None:
            before = next((r for r in _stamps.read() if r[0] == calls[0] - 1), None)
        chain = ([before] if before else []) + replays
        gaps = [(a[2], b[1]) for a, b in zip(chain, chain[1:])]
        lengths = sorted(r[2] - r[1] for r in replays)
        out["replays"] = dict(
            count=len(replays), steps=_stamps.steps,
            gap_share_pct=gap_share(replays, before) if replays else None,
            first_call=replays[0][0] if replays else None,
            last_call=replays[-1][0] if replays else None,
            replay_ms_median=lengths[len(lengths) // 2] / 1e6 if lengths else None,
            replay_ms_min=lengths[0] / 1e6 if lengths else None,
            replay_ms_max=lengths[-1] / 1e6 if lengths else None,
            gap_ms_median=(sorted(b - a for a, b in gaps)[len(gaps) // 2] / 1e6
                           if gaps else None))
        if host is not None:
            out["gaps"] = label_gaps([(host(a), host(b)) for a, b in gaps],
                                     list(itertools.chain(_setup, _spans)))
        else:
            out["gaps"] = [[NOT_ALIGNED, (b - a) / 1e6]
                           for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP_GAPS]]
    return out
