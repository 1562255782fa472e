"""The split-K plan of the port's weight-only GEMM kernels
(``mixdq_tpu_torch/ops/wq_matmul.py:wq_plan``), a pure function of the
shapes and the card's SM count: its splits are whole k steps but the
last, cover the weight rows exactly once, appear only where the (M, N)
tiles alone fill fewer than the SMs, and size the workspace."""

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu_torch.ops.wq_matmul import wq_plan  # noqa: E402


def _ranges(plan):
    return [(s * plan.split_rows, min((s + 1) * plan.split_rows, plan.rows))
            for s in range(plan.splits)]


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 4096), K=st.integers(1, 12000).map(lambda k: 2 * k),
       N=st.integers(1, 12000), w4=st.booleans(), sms=st.integers(1, 264))
def test_wq_plan_covers_k_once(M, K, N, w4, sms):
    plan = wq_plan(M, K, N, w4, sms)
    assert plan.rows == (K // 2 if w4 else K)
    assert plan.tk == (32 if w4 else 64)
    ranges = _ranges(plan)
    # every split is non-empty and a whole number of k steps but the last
    assert all(lo < hi for lo, hi in ranges)
    assert all((hi - lo) % plan.tk == 0 for lo, hi in ranges[:-1])
    # the splits tile [0, rows) in order: each weight row exactly once
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.rows
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = -(-M // plan.tm) * -(-N // plan.tn)
    if tiles >= sms:
        assert plan.splits == 1
    else:  # one wave: no more blocks than SMs, nor splits than k steps
        assert plan.splits <= -(-plan.rows // plan.tk)
        assert tiles * plan.splits <= sms
    assert plan.ws_elems == (plan.splits * M * N if plan.splits > 1 else 0)
    # the deeper ring only where each block has an SM of its own
    assert plan.stages == (3 if tiles * plan.splits > sms else 5)


@pytest.mark.parametrize("M,K,N,w4,splits", [
    (1024, 640, 5120, False, 1),   # ff.net.0.proj at 32x32: 320 tiles
    (1024, 640, 5120, True, 1),
    (256, 5120, 1280, False, 6),   # ff.net.2 at 16x16: 20 tiles
    (77, 2048, 1280, False, 11),   # to_k / to_v on the text: 10 tiles
    (77, 2048, 1280, True, 11),
    (1, 1280, 1280, False, 10),    # time_emb_proj: 10 tiles, 20 steps
    (1, 1280, 1280, True, 10),     # 10 packed steps: one each
])
def test_wq_plan_weight_only_shapes(M, K, N, w4, splits):
    """The weight-only step's shapes on an H100's 132 SMs."""
    plan = wq_plan(M, K, N, w4, 132)
    assert (plan.tm, plan.tn) == (128, 128)
    assert plan.splits == splits


def test_wq_plan_ragged_k():
    """K = 2056 is not a multiple of splits x k step: the last split takes
    the remainder, a partial step."""
    plan = wq_plan(77, 2056, 1280, False, 132)
    ranges = _ranges(plan)
    assert plan.splits > 1
    assert (ranges[-1][1] - ranges[-1][0]) % plan.tk != 0
    assert sum(hi - lo for lo, hi in ranges) == 2056


def test_chip_smoke_wq_shape_counts():
    """``chip_smoke.py``'s histogram of the weight-only kernels' calls by
    shape (phase 6) on tiny-sdxl under ``pallas_dequant``: it counts every
    call the launch table expects, with each call's (M, K, N), and puts
    the module functions back."""
    import importlib.util
    import os

    import torch

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models import layers
    from mixdq_tpu_torch.quant import state

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    unet = pipeline.build_unet("tiny-sdxl", 0, torch.float32, "cpu")
    calib = pipeline.example_inputs("tiny-sdxl", 1, 0, torch.float32, "cpu")
    names = sorted(state.quantizable_layers(unet))
    wmap = {n: (4, 8)[i % 2] for i, n in enumerate(names)}
    amap = {n: 8 for n in names}
    ctx = pipeline.quantize_mixed(unet, calib, wmap, amap, [],
                                  deploy_compute="pallas_dequant")
    sound = (layers.wq_matmul, layers.wq4_matmul)
    with smoke.wq_shape_counts() as counts:
        pipeline.unet_step(unet, calib, ctx)
    assert (layers.wq_matmul, layers.wq4_matmul) == sound
    want = pipeline.expected_kernel_calls(unet.config, "auto",
                                          deploy=ctx.deploy,
                                          compute="pallas_dequant")
    for kernel in ("wq_matmul", "wq4_matmul"):
        got = sum(v for k, v in counts.items() if k[0] == kernel)
        assert got == want[kernel] > 0, kernel
    assert all(M >= 1 and K >= 1 and N >= 1 for _, M, K, N in counts)
