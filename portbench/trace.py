"""Reading the profiler's trace: device busy time, busy time inside the
benchmark's own spans, kernels by device time and idle gaps.

Spans are ``torch.profiler.record_function`` ranges that the harness
opens around its own calls (``portbench.request``, and the towers,
UNet and VAE wrappers of the eager run); their host start and end are
read from the same trace as the device operations, on one clock. A
span's device time is the device time that falls inside its host
interval: the harness synchronizes the device at both ends of a span
whose time it reads (a request ends in a copy to the host, an eager
span in a synchronize), so no other span's work lies inside it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

Interval = Tuple[int, int]  # ns

SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    """One profiled stretch: the device operations' intervals and names,
    and the harness's spans ``(name, start, end)``."""

    ops: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]

    def busy(self, lo: int, hi: int) -> int:
        """Nanoseconds in [lo, hi) in which a device operation ran."""
        total, last = 0, lo
        for _, s, e in self.ops:
            s, e = max(s, last), min(e, hi)
            if e > s:
                total += e - s
                last = e
        return total

    def spans_named(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for n, s, e in self.spans if n == SPAN_PREFIX + name]

    def kernels(self, lo: int, hi: int, top: int = 10) -> List[list]:
        """The device operations that took most time in [lo, hi), as
        [name, seconds]."""
        by: Dict[str, int] = {}
        for n, s, e in self.ops:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                by[n] = by.get(n, 0) + d
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], d / 1e9] for n, d in rows]

    def gaps(self, lo: int, hi: int, top: int = 10) -> List[list]:
        """The longest stretches of [lo, hi) with no device operation, as
        [what the host was in, seconds]: before the first or after the
        last device operation of a request span (tokenize and copy in; the
        images to numpy), between two of its operations, or between two
        requests (the client)."""
        busy: List[Interval] = []
        for _, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if busy and s <= busy[-1][1]:
                busy[-1] = (busy[-1][0], max(busy[-1][1], e))
            else:
                busy.append((s, e))
        reqs = sorted(self.spans_named("request"))
        starts = [rs for rs, _ in reqs]
        out, prev = [], lo
        for k, (s, e) in enumerate(busy + [(hi, hi)]):
            if s > prev:
                mid = (prev + s) // 2
                j = bisect.bisect_right(starts, mid) - 1
                label = "client: between requests"
                if j >= 0 and mid < reqs[j][1]:
                    rs, re_ = reqs[j]
                    first = k > 0 and busy[k - 1][0] >= rs
                    last = k < len(busy) and busy[k][0] < re_
                    label = ("request: between device operations"
                             if first and last else
                             "request: after its last device operation"
                             if first else
                             "request: before its first device operation")
                out.append([label, (s - prev) / 1e9])
            prev = max(prev, e)
        return sorted(out, key=lambda r: -r[1])[:top]


def read(prof, device: str = "cuda") -> Trace:
    """The device operations and harness spans of a finished
    ``torch.profiler.profile``. On a ``'cpu'`` run (the CPU tests) the
    ``aten`` operators stand in for the device operations."""
    ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        on_device = ("CUDA" in str(ev.device_type()) if device == "cuda"
                     else name.startswith("aten::"))
        if name.startswith(SPAN_PREFIX):
            if "CPU" in str(ev.device_type()):
                spans.append((name, start, end))
        elif on_device and end > start:
            ops.append((name, start, end))
    ops.sort(key=lambda o: o[1])
    return Trace(ops, spans)
