"""The split-K plan of the port's int8 GEMM mainloop
(``mixdq_tpu_torch/ops/qmatmul.py:qmm_plan``, and its conv counterpart
``ops/qconv.py:qconv_plan`` over ``Kdim = kh kw C``), a pure function of
the shapes and the card's SM count: its splits are whole k steps but the
last, cover Kdim exactly once with none empty, appear only where the
(M, N) tiles alone fill fewer than the SMs, and size the workspace and
the arrival counters."""

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu_torch.ops.qconv import conv_out_size, qconv_plan  # noqa: E402
from mixdq_tpu_torch.ops.qmatmul import (QMM_COUNTERS,  # noqa: E402
                                         QMM_MIN_SPLIT_STEPS, qmm_plan)


def _ranges(plan):
    return [(s * plan.split_k, min((s + 1) * plan.split_k, plan.kdim))
            for s in range(plan.splits)]


def _check(plan, M, kdim, N, sms):
    assert plan.kdim == kdim
    ranges = _ranges(plan)
    # every split is non-empty and a whole number of k steps but the last
    assert all(lo < hi for lo, hi in ranges)
    assert plan.split_k % plan.bk == 0
    assert all((hi - lo) % plan.bk == 0 for lo, hi in ranges[:-1])
    # the splits tile [0, kdim) in order: each k exactly once
    assert ranges[0][0] == 0 and ranges[-1][1] == kdim
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = -(-M // plan.bm) * -(-N // plan.bn)
    assert plan.tiles == tiles and plan.blocks == tiles * plan.splits
    if tiles >= sms:
        assert plan.splits == 1
    else:  # one wave, and no split shorter than the least but the last
        assert plan.blocks <= max(sms, tiles)
        if plan.splits > 1:
            assert plan.split_k >= QMM_MIN_SPLIT_STEPS * plan.bk
    if plan.splits > 1:
        assert plan.ws_elems == tiles * plan.splits * plan.bm * plan.bn
        assert plan.counters == tiles <= QMM_COUNTERS
    else:
        assert plan.ws_elems == plan.counters == 0


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 8192), kdim=st.integers(1, 30000),
       N=st.integers(1, 6000), sms=st.integers(1, 264))
def test_qmm_plan_covers_k_once(M, kdim, N, sms):
    _check(qmm_plan(M, kdim, N, sms), M, kdim, N, sms)


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 2), H=st.integers(3, 128), W=st.integers(3, 128),
       C=st.sampled_from([4, 12, 16, 320, 640, 960, 1280, 1920, 2560]),
       K=st.sampled_from([4, 8, 40, 320, 640, 1280]),
       stride=st.sampled_from([1, 2]), sms=st.integers(1, 264))
def test_qconv_plan_is_the_gemm_view(B, H, W, C, K, stride, sms):
    plan = qconv_plan(B, H, W, C, K, 3, 3, stride, (1, 1), sms)
    P, Q = conv_out_size(H, W, 3, 3, stride, (1, 1))
    assert plan == qmm_plan(B * P * Q, 9 * C, K, sms)
    _check(plan, B * P * Q, 9 * C, K, sms)


# (M, K, N) -> (tiles, splits, k steps per split) on an H100's 132 SMs, as
# the note at the head of csrc/qmatmul.cu states
QMM_SHAPES = [
    ((1024, 2560, 640), (40, 3, 7)),   # ff.net.2 at 32x32
    ((1024, 640, 640), (40, 2, 3)),    # attn1 to_out at 32x32
    ((4096, 960, 320), (96, 1, 8)),    # conv_shortcut at 64x64
    ((256, 5120, 1280), (20, 6, 7)),   # ff.net.2 at 16x16
    ((256, 1280, 1280), (20, 5, 2)),   # to_out, proj_in/out at 16x16
    ((77, 2048, 2560), (20, 6, 3)),    # attn2 to_kv at 16x16
    ((77, 2048, 1280), (10, 8, 2)),    # attn2 to_kv at 32x32
    ((1, 1280, 1280), (10, 5, 2)),     # time_emb_proj
]


@pytest.mark.parametrize("shape,want", QMM_SHAPES)
def test_qmm_plan_main_path_shapes(shape, want):
    plan = qmm_plan(*shape, 132)
    assert (plan.bm, plan.bn, plan.bk) == (128, 128, 128)
    assert (plan.tiles, plan.splits, plan.split_k // plan.bk) == want


# (B, H, C, K, stride) -> (tiles, splits, k steps per split) on 132 SMs,
# as the note at the head of csrc/qconv.cu states
QCONV_SHAPES = [
    ((1, 64, 320, 320, 1), (96, 1, 23)),
    ((1, 32, 1920, 640, 1), (40, 3, 45)),
    ((1, 16, 2560, 1280, 1), (20, 6, 30)),
    ((1, 16, 1280, 1280, 1), (20, 6, 15)),
    ((1, 64, 4, 320, 1), (96, 1, 1)),       # conv_in: one partial step
    ((1, 64, 320, 4, 1), (32, 4, 6)),       # conv_out
    ((1, 64, 320, 320, 2), (24, 5, 5)),
    ((1, 32, 640, 640, 2), (10, 12, 4)),
]


@pytest.mark.parametrize("shape,want", QCONV_SHAPES)
def test_qconv_plan_main_path_shapes(shape, want):
    B, H, C, K, stride = shape
    plan = qconv_plan(B, H, H, C, K, 3, 3, stride, (1, 1), 132)
    assert (plan.tiles, plan.splits, plan.split_k // plan.bk) == want


def test_qmm_plan_ragged_k():
    """K = 2056 is no multiple of the k step: the last split takes the
    remainder, a partial step."""
    plan = qmm_plan(77, 2056, 1280, 132)
    ranges = _ranges(plan)
    assert plan.splits > 1
    assert (ranges[-1][1] - ranges[-1][0]) % plan.bk != 0
    assert sum(hi - lo for lo, hi in ranges) == 2056


def test_igemm_scratch_sizes():
    """The workspace is the plan's size, and the counters are one zeroed
    buffer per device, kept across launches; one split takes neither."""
    import torch

    from mixdq_tpu_torch.ops.qmatmul import igemm_scratch

    plan = qmm_plan(256, 5120, 1280, 132)
    ws, counters = igemm_scratch(plan, torch.device("cpu"))
    assert ws.dtype == torch.int32 and ws.numel() == plan.ws_elems
    assert counters.numel() == QMM_COUNTERS and not counters.any()
    _, again = igemm_scratch(qmm_plan(77, 2048, 1280, 132),
                             torch.device("cpu"))
    assert again is counters
    assert igemm_scratch(qmm_plan(4096, 960, 320, 132),
                         torch.device("cpu")) == (None, None)


def test_chip_smoke_igemm_shape_counts():
    """``chip_smoke.py``'s histogram of the int8 GEMM calls by shape
    (phases 3 and 7) on tiny-sdxl's W8A8 step under ``"auto"``: it counts
    every call the launch table expects, with each call's shape, and puts
    the module functions back."""
    import importlib.util
    import os

    import torch

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models import layers
    from mixdq_tpu_torch.ops import qmatmul as qmm

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    unet = pipeline.build_unet("tiny-sdxl", 0, torch.float32, "cpu")
    calib = pipeline.example_inputs("tiny-sdxl", 1, 0, torch.float32, "cpu")
    ctx = pipeline.quantize_w8a8(unet, calib)
    sound = (qmm.qmatmul, layers.qconv2d, layers.qconv2d_s2)
    with smoke.igemm_shape_counts() as counts:
        pipeline.unet_step(unet, calib, ctx)
    assert (qmm.qmatmul, layers.qconv2d, layers.qconv2d_s2) == sound
    want = pipeline.ctx_kernel_calls(unet.config, ctx)
    for kernel in ("qmatmul", "qconv2d", "qconv2d_s2"):
        got = sum(v for k, v in counts.items() if k[0] == kernel)
        assert got == want[kernel] > 0, kernel
    assert all(len(k) == (4 if k[0] == "qmatmul" else 6) for k in counts)
