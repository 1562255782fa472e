"""Tracing, timing and memory accounting on CUDA (port of
``mixdq_tpu/utils/profiling.py``): ``jax.profiler`` traces ->
``torch.profiler``, ``TraceAnnotation`` -> ``record_function``, device
``memory_stats`` -> the CUDA caching allocator's, wall clocks around
``block_until_ready`` -> CUDA events.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
from typing import Callable, Dict

import torch

logger = logging.getLogger(__name__)


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


def annotate(name: str):
    """A named range inside a trace."""
    return torch.profiler.record_function(name)


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
