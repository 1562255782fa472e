"""Tracing, timing and memory accounting on CUDA (port of
``mixdq_tpu/utils/profiling.py``): ``jax.profiler`` traces ->
``torch.profiler``, ``TraceAnnotation`` -> ``record_function``, device
``memory_stats`` -> the CUDA caching allocator's, wall clocks around
``block_until_ready`` -> CUDA events.

The tracer, off by default; ``tracing()`` turns it on for a block::

    with profiling.tracing() as tracer:
        images = engine.generate(prompts, seed)
    (request,) = tracer.drain()

* ``span(name)`` names a host range. Off, it returns one shared null
  context. On, it records a ``Span`` on ``time.perf_counter_ns`` and
  opens ``record_function("mixdq." + name)``, so that a profiler (or
  ``trace``) shows the range beside the device operations. A span opened
  while none is open on its thread starts a request; the spans opened
  inside it share its id and name their parent.
* ``mark(name)`` is a device timestamp. Inside a CUDA graph capture made
  under ``graph_marks()`` (``pipelines.graphed.GraphedCall``), whatever
  the tracer's state, it records a timing event into the graph, owned by
  the caller of ``graph_marks``: every replay sets it again, and a graph
  serves tracing on and off alike (an event-record node touches no data).
  After a replay, ``Tracer.replayed`` hands the graph's marks to the open
  request. Otherwise, with the tracer on and a request open, it records a timing
  event where the request was anchored on CUDA (``Tracer.anchor``), and
  the host clock elsewhere. Otherwise it does nothing.
* A request's device marks are placed on the host clock when its root
  span closes, as ``anchor_ns + anchor.elapsed_time(mark)``: the anchor is
  a timing event recorded where the device is idle, with the host clock
  read just after, so host spans and device marks share one timeline.
* Finished requests stay in memory, in a ring of ``CAPACITY`` requests
  (the oldest dropped first); ``Tracer.drain()`` returns them and empties
  it. ``trace(outdir)`` writes a Chrome trace, in which the spans appear
  through their ``record_function`` ranges.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

#: requests a tracer keeps before it drops the oldest
CAPACITY = 4096


@contextlib.contextmanager
def trace(outdir: str):
    """Profile the block (CPU and CUDA activity) into a Chrome trace
    ``trace.json`` under ``outdir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class Span(NamedTuple):
    request: int
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int


class Mark(NamedTuple):
    request: int
    name: str
    t_ns: int


@dataclasses.dataclass
class Request:
    """One finished request: its spans by start (a parent before the
    children it starts with) and its marks in the order they ran."""
    id: int
    spans: List[Span]
    marks: List[Mark]


class _Open:
    """A request whose root span has not closed yet."""

    def __init__(self, rid: int):
        self.id = rid
        self.spans: List[Span] = []
        self.marks: List[Mark] = []
        self.pending: List[Tuple[str, "torch.cuda.Event"]] = []
        self.anchor: Optional[Tuple[Optional["torch.cuda.Event"], int]] = None

    def close(self, ok: bool) -> Request:
        if ok and self.pending:
            ev0, t0 = self.anchor
            self.marks += [Mark(self.id, name, t0 + round(
                ev0.elapsed_time(ev) * 1e6)) for name, ev in self.pending]
        self.spans.sort(key=lambda s: (s.start_ns, -s.end_ns))
        return Request(self.id, self.spans, self.marks)


class Tracer:
    """The records of one ``tracing()`` block."""

    def __init__(self):
        self.ring: collections.deque = collections.deque(maxlen=CAPACITY)
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> List["_Span"]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _request(self) -> Optional[_Open]:
        st = self._stack()
        return st[0].open if st else None

    def anchor(self, device) -> None:
        """Anchor the open request's device marks: on CUDA a timing event
        on ``device``'s current stream, then the host clock. Call it
        where the device is idle, so that the event runs as it is
        recorded."""
        req = self._request()
        if req is None:
            return
        ev = None
        if torch.device(device).type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
        req.anchor = (ev, time.perf_counter_ns())

    def replayed(self, marks: List[Tuple[str, "torch.cuda.Event"]]) -> None:
        """A graph's marks (``graph_marks``), just replayed, for the open
        request: read when its root span closes, before the graph's next
        replay sets them again."""
        req = self._request()
        if req is not None:
            req.pending += marks

    def _mark(self, name: str) -> None:
        req = self._request()
        if req is None:
            return
        if req.anchor is not None and req.anchor[0] is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            req.pending.append((name, ev))
        else:
            req.marks.append(Mark(req.id, name, time.perf_counter_ns()))

    def drain(self) -> List[Request]:
        """The finished requests, oldest first; empties the ring."""
        out = list(self.ring)
        self.ring.clear()
        return out


class _Span:
    __slots__ = ("tracer", "name", "open", "parent", "start", "rf")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        st = self.tracer._stack()
        if st:
            self.open, self.parent = st[0].open, st[-1].name
        else:
            self.open = _Open(next(self.tracer._ids))
            self.parent = None
        st.append(self)
        self.rf = torch.profiler.record_function("mixdq." + self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        st = self.tracer._stack()
        st.pop()
        req = self.open
        req.spans.append(Span(req.id, self.name, self.parent, self.start,
                              end))
        if not st:
            self.tracer.ring.append(req.close(exc[0] is None))
        return False


_NULL = contextlib.nullcontext()
#: the tracer of the innermost ``tracing()`` block, None when off
_active: Optional[Tracer] = None
#: the marks of the CUDA graph capture in progress (``graph_marks``)
_graph_marks: Optional[list] = None


@contextlib.contextmanager
def tracing():
    """The tracer on for the block; yields it."""
    global _active
    tracer = Tracer()
    prev, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = prev


def active() -> Optional[Tracer]:
    """The tracer when on, else None."""
    return _active


def span(name: str):
    """A named host range of the open request (or a new request)."""
    if _active is None:
        return _NULL
    return _Span(_active, name)


def mark(name: str) -> None:
    """A device timestamp: see the module's docstring."""
    if _graph_marks is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        _graph_marks.append((name, ev))
    elif _active is not None:
        _active._mark(name)


@contextlib.contextmanager
def graph_marks():
    """Around a CUDA graph capture: each ``mark`` inside it records a
    timing event into the graph. Yields the list of ``(name, event)``, in
    the order the graph runs them."""
    global _graph_marks
    marks: List[Tuple[str, "torch.cuda.Event"]] = []
    prev, _graph_marks = _graph_marks, marks
    try:
        yield marks
    finally:
        _graph_marks = prev


def device_memory_stats(device=None) -> Dict[str, float]:
    """Current device memory accounting in MB: bytes allocated now, their
    peak since the last reset, and the card's total."""
    mb = 1e6
    d = torch.device(device if device is not None else "cuda")
    return {
        "bytes_in_use_mb": torch.cuda.memory_allocated(d) / mb,
        "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(d) / mb,
        "bytes_limit_mb": torch.cuda.get_device_properties(d).total_memory
        / mb,
    }


def measure_memory(fn: Callable, *args, device=None) -> Dict[str, float]:
    """Run ``fn`` and report static (before the call) / dynamic (the
    peak above static) / peak memory in MB."""
    d = torch.device(device if device is not None else "cuda")
    torch.cuda.synchronize(d)
    torch.cuda.reset_peak_memory_stats(d)
    static = torch.cuda.memory_allocated(d) / 1e6
    fn(*args)
    torch.cuda.synchronize(d)
    peak = torch.cuda.max_memory_allocated(d) / 1e6
    return {"static_mb": static, "dynamic_mb": max(peak - static, 0.0),
            "peak_mb": peak}


_FINGERPRINT_CACHE: Dict[int, float] = {}


def host_fingerprint(n: int = 8192, iters: int = 5,
                     refresh: bool = False) -> float:
    """Machine-class fingerprint: ms of one n*n*n bf16 matmul on the card
    (median of ``iters``, CUDA events), cached per process. Recorded
    beside every bench result, it tells a change of card or clocks from a
    change of code."""
    if not refresh and n in _FINGERPRINT_CACHE:
        return _FINGERPRINT_CACHE[n]
    a = torch.ones((n, n), dtype=torch.bfloat16, device="cuda")
    a @ a
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        a @ a
        e.record()
        torch.cuda.synchronize()
        ts.append(s.elapsed_time(e))
    ms = round(statistics.median(ts), 2)
    _FINGERPRINT_CACHE[n] = ms
    return ms


def timeit(fn: Callable, *args, iters: int = 20, warmup: int = 3,
           strict: bool = False) -> float:
    """Mean ms per call by CUDA events. ``strict`` times each call alone
    (synchronizing after each); the default times ``iters`` calls
    enqueued back to back (throughput)."""
    for _ in range(warmup + 1):
        fn(*args)
    torch.cuda.synchronize()
    if strict:
        total = 0.0
        for _ in range(iters):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            fn(*args)
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / iters
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(iters):
        fn(*args)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters
