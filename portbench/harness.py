"""One run of one cell: set-up, the measured window, the traced readings
(``trace``), the check against the reference, and the result line.

The metrics are read by their own files (``portbench/metrics/``) from
``Readings``:

* ``setup_s``: process start (``t0``) to the window's start;
* ``window_s``, ``latencies_s``, ``images``, ``requests``: the window
  (one client, closed loop, ``serve.window``);
* ``graph_s``: with the trace, on the card, each request's CUDA graph
  replay device time in that same (unprofiled) window, from timing
  events (``serve.GraphClock``); None otherwise;
* ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over the window,
  reset at its start (0 on the CPU);
* ``batch``, ``counts`` (``counts.summary`` of the
  configuration), ``launches`` (the engine's launches counted at
  capture, or None);
* with the trace: ``loop`` (``trace.Trace`` of a profiled stretch of the
  loop) with ``loop_lo`` / ``loop_hi``, its first request's start and
  last one's end, and ``spans`` (the trace of one eager ``run`` with the
  towers, UNet and VAE spans); None without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import List, Optional

import torch

from . import catalog, counts, judge, serve
from .traffic import WARM, Traffic

#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mixdq_tpu")


@dataclasses.dataclass
class Readings:
    setup_s: float
    window_s: float
    latencies_s: List[float]
    images: int
    requests: int
    peak_bytes: int
    batch: int
    counts: dict
    launches: Optional[dict]
    graph_s: Optional[List[float]] = None
    loop: Optional[object] = None
    loop_lo: int = 0
    loop_hi: int = 0
    spans: Optional[object] = None


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods}
                  & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, root: str = catalog.ROOT,
             control: bool = False) -> dict:
    """The result of one run (``control``: also the control's readings,
    under ``"control"``)."""
    bench = catalog.benchmark(root)
    w = catalog.cell(bench, cell_name)
    cfg = catalog.config(bench, w["config"], root)
    mix = catalog.traffic(w["traffic"], root)
    lim = catalog.limits(cell_name, root)["checks"]
    tr = Traffic(mix, seed, root_dir=f"{root}/portbench")
    cuda = device.type == "cuda"

    log(f"set-up: process start to the harness {time.time() - t0:.2f} s")
    served = serve.build(cfg, mix, tr.calibration(), seed, device, root, log)
    # the loop itself, warmed for a fixed time: the host's allocator and
    # the card reach the state they hold through the window
    warm = serve.window(served.engine, lambda i: tr.request(WARM + i),
                        mix["warm_seconds"], None)
    like = served.engine.generate(*tr.request(WARM - 1))
    log(f"set-up: {warm.attempted} warm requests {warm.seconds:.2f} s")
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    keep = serve.Reservoir(mix["check_requests"], seed, like)
    del like
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.3f} s; window {seconds} s")
    clock = serve.GraphClock() if trace and cuda else None
    with clock or contextlib.nullcontext():
        win = serve.window(served.engine, tr.request, seconds, keep,
                           clock=clock)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    r = Readings(setup_s, win.seconds, win.latencies_s, win.images,
                 win.attempted, peak, served.batch, counts.summary(cfg),
                 served.engine.launches, win.graph_s)
    log(f"window {win.seconds:.3f} s, {win.attempted} requests, "
        f"{win.images} images")
    out = {"attempted": win.attempted, "failed": 0}
    if trace:
        nxt = win.attempted
        t1 = time.time()
        r.loop, r.loop_lo, r.loop_hi = serve.profile_loop(
            served.engine, tr.request, mix["trace_seconds"], nxt)
        t2 = time.time()
        r.spans = serve.profile_spans(served, *tr.request(nxt - 1))
        log(f"traced loop {t2 - t1:.1f} s ({len(r.loop.ops)} device "
            f"operations), eager spans {time.time() - t2:.1f} s")
        out["breakdown"] = {
            "device_ops": r.loop.kernels(r.loop_lo, r.loop_hi),
            "idle_gaps": r.loop.gaps(r.loop_lo, r.loop_hi)}
        busy = r.loop.busy(r.loop_lo, r.loop_hi)
        if busy <= 0:
            raise RuntimeError("the profiler recorded no device operation")
        dev_extra = {"busy_s": busy / 1e9,
                     "window_s": (r.loop_hi - r.loop_lo) / 1e9}
    else:
        dev_extra = {}
    entries = catalog.metrics(bench, trace)
    out["metrics"] = catalog.read_all(entries, r, root)
    silent = [m["name"] for m in entries if m["name"] not in out["metrics"]]
    if silent:
        log(f"metrics with nothing to read in this run: {silent}")
    serve.free(served)
    del served
    t1 = time.time()
    ok, checks, ctl = judge.check(cfg, seed, tr.calibration(), keep.items,
                                  lim, device, control)
    log(f"check of {len(keep.items)} requests {time.time() - t1:.1f} s")
    out["correct"] = ok
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": w["chips"], "memory_peak_bytes": int(peak), **dev_extra}
    if ctl is not None:
        out["control"] = ctl
    out["checks"] = checks
    return out
