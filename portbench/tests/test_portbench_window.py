"""The window's arithmetic and the result line: rate and tail over every
request and all the window's time (a stall planted in the loop moves
both), ``mfu``, the keys of the last line, and the guard against JAX
modules (top-level names compared whole)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import catalog, harness, serve


class _Engine:
    """``generate`` that takes ``ms`` ms, and ``stall_ms`` on every
    ``every``-th request."""

    def __init__(self, ms, every=0, stall_ms=0.0):
        self.ms, self.every, self.stall_ms, self.n = ms, every, stall_ms, 0

    def generate(self, prompts, seed):
        slow = self.every and self.n % self.every == self.every - 1
        self.n += 1
        time.sleep((self.stall_ms if slow else self.ms) / 1e3)
        return np.zeros((len(prompts), 2, 2, 3), np.float32)


def _read(win, name):
    r = harness.Readings(
        1.0, win.seconds, win.latencies_s, win.images, win.attempted, 0, 2,
        {"generation_least_compute_s": 1e-3}, None)
    return catalog.reader(name)(r)


def test_window_counts_every_request_and_all_time():
    req = lambda i: (["a", "b"], i)
    keep = serve.Reservoir(3, 5, np.zeros((2, 2, 2, 3), np.float32))
    win = serve.window(_Engine(20), req, 0.3, keep)
    assert win.images == 2 * win.attempted == 2 * len(win.latencies_s)
    assert win.seconds >= 0.3 and win.seconds >= sum(win.latencies_s)
    assert len(keep.items) == 3
    assert _read(win, "images_per_s") == pytest.approx(
        win.images / win.seconds)
    assert _read(win, "mfu") == pytest.approx(
        100 * 1e-3 * win.images / win.seconds)


def test_planted_stall_moves_rate_and_tail():
    req = lambda i: (["a", "b"], i)
    base = serve.window(_Engine(10), req, 0.6, None)
    lat = sorted(base.latencies_s)
    assert _read(base, "latency_p95_ms") == pytest.approx(
        1e3 * lat[int(np.ceil(0.95 * len(lat))) - 1])
    stalled = serve.window(_Engine(10, every=10, stall_ms=60), req, 0.6,
                           None)
    assert _read(stalled, "images_per_s") < 0.8 * _read(base,
                                                          "images_per_s")
    assert _read(stalled, "latency_p95_ms") > 2 * _read(base,
                                                        "latency_p95_ms")


def test_reservoir_is_drawn_from_the_seed():
    like = np.zeros((1, 2), np.float32)
    a, b = (serve.Reservoir(4, 11, like) for _ in range(2))
    for i in range(100):
        img = np.full((1, 2), i, np.float32)
        a.offer(i, ([str(i)], i, img))
        b.offer(i, ([str(i)], i, img))
        img[:] = -1  # the program's array is reused: the copy stands
    got = [(p, s, float(x[0, 0])) for p, s, x in a.items]
    assert got == [(p, s, float(x[0, 0])) for p, s, x in b.items]
    assert len({s for _, s, _ in got}) == 4
    assert all(p == [str(s)] and x == s for p, s, x in got)


def test_forbidden_modules_compare_top_level_names_whole():
    assert harness.forbidden_modules(
        {"mixdq_tpu_torch": 1, "mixdq_tpu_torch.ops": 1, "jaxtyping": 1,
         "flaxen": 1}) == []
    assert harness.forbidden_modules(
        {"mixdq_tpu.models": 1, "jax.numpy": 1, "flax": 1, "jaxlib": 1}) \
        == ["flax", "jax", "jaxlib", "mixdq_tpu"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(checkout, trace):
    out = harness.run_cell("small_sdxl.b2", 2 ** 33 + 5, 0.5, trace,
                           torch.device("cpu"), time.time(), checkout)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    b = catalog.benchmark(checkout)
    want = {m["name"] for m in catalog.metrics(b, trace)}
    got = set(out["metrics"])
    # a CPU run reads no device memory, counts no hand-written kernel and
    # replays no CUDA graph
    assert got == want - {"peak_mem_mb", "launches_per_image", "host_ms",
                          "idle_share"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and np.isfinite(v["value"])
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] >= dev["busy_s"]
        bd = out["breakdown"]
        assert 0 < len(bd["device_ops"]) <= 10
        assert len(bd["idle_gaps"]) <= 10
    else:
        assert "breakdown" not in out


def test_host_and_idle_from_graph_time():
    """``host_ms``: the median of wall minus replay per request;
    ``idle_share``: the window's time outside the replays."""
    lat, graph = [0.050, 0.052, 0.060, 0.051], [0.046, 0.047, 0.046, 0.047]
    r = harness.Readings(1.0, 0.25, lat, 4, 4, 0, 1, {}, None, graph)
    assert catalog.reader("host_ms")(r) == pytest.approx(4.5)
    assert catalog.reader("idle_share")(r) == pytest.approx(
        100 * (1 - sum(graph) / 0.25))
    r.graph_s = None
    assert catalog.reader("host_ms")(r) is None
    assert catalog.reader("idle_share")(r) is None
