"""The launch plan of the port's cooperative ``sec_attention*`` kernels
(``mixdq_tpu_torch/ops/sec_attention.py:sec_plan``), a pure function of
the shapes, the SM count and the blocks an SM holds: each GEMM stage
(to_q ``[C_in, C]`` or the fused QKV ``[C, 3C]``, then to_out ``[C,
C_in]``) is ``qmm_plan``'s, its splits covering K once; the grid never
exceeds what the card holds nor the largest stage's items; the kernel's
grid strides (block b takes GEMM items b, b + grid, ...; its two
attention groups items b and b + grid, each then every 2 grid) reach
every item exactly once; the split workspace and counters that the
stages share fit ``QMM_COUNTERS``; and the main-path plans are pinned."""

import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from mixdq_tpu_torch.ops import sec_attention as tsa  # noqa: E402
from tests.test_torch_port_qmm_plan import _check  # noqa: E402


def _strided(grid, n, groups=1):
    """The items that ``groups`` groups a block of ``grid`` blocks take in
    the kernel's grid stride, in order."""
    return sorted(i for b in range(grid) for g in range(groups)
                  for i in range(b + g * grid, n, groups * grid))


def _check_sec(B, Tq, C_in, heads, d, sms, per_sm, qkv, out):
    plan = tsa.sec_plan(B, Tq, C_in, heads, d, sms, per_sm, qkv=qkv,
                        out=out)
    M, C = B * Tq, heads * d
    _check(plan.proj, M, C_in, 3 * C if qkv else C, sms)
    if out:
        _check(plan.out, M, C, C_in, sms)
    else:
        assert plan.out is None
    assert plan.attn_items == B * heads * -(-Tq // 64)
    largest = max(plan.attn_items, *(p.blocks for p in plan.gemms))
    assert 1 <= plan.grid <= min(per_sm * sms, largest)
    for p in plan.gemms:
        assert _strided(plan.grid, p.blocks) == list(range(p.blocks))
    assert (_strided(plan.grid, plan.attn_items, 2)
            == list(range(plan.attn_items)))
    assert plan.splits == max(p.splits for p in plan.gemms)
    assert plan.ws_elems == max(p.ws_elems for p in plan.gemms)
    assert plan.counters == max(p.counters for p in plan.gemms)
    assert plan.counters <= tqm.QMM_COUNTERS
    return plan


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 4), Tq=st.integers(1, 4096),
       C_in=st.sampled_from([16, 32, 96, 320, 640, 1280, 2048, 2560]),
       heads=st.integers(1, 20), d=st.sampled_from(tsa.HEAD_DIMS),
       sms=st.integers(1, 264), per_sm=st.integers(1, 4),
       qkv=st.booleans(), out=st.booleans())
def test_sec_plan_covers_every_item_once(B, Tq, C_in, heads, d, sms, per_sm,
                                         qkv, out):
    _check_sec(B, Tq, heads * d if qkv else C_in, heads, d, sms, per_sm, qkv,
               out)


# (B, Tq, C_in, heads, qkv, out) -> ((proj tiles, splits), (to_out tiles,
# splits) or None, attention items, grid) on an H100's 132 SMs at one
# block an SM, d = 64: SDXL-Turbo's attn1 (sec_attention_qkv) and attn2
# (sec_attention_q_out) at the 16x16 (60 of their 70 sites) and 32x32
# levels, and SDXL 1024's sec_attention_q at the 32x32 level, B = 1, 2
SEC_SHAPES = [
    ((1, 256, 1280, 20, True, False), ((60, 2), None, 80, 120)),
    ((1, 256, 1280, 20, False, True), ((20, 5), (20, 5), 80, 100)),
    ((1, 1024, 640, 10, True, False), ((120, 1), None, 160, 132)),
    ((1, 1024, 640, 10, False, True), ((40, 2), (40, 2), 160, 132)),
    ((1, 1024, 1280, 20, False, False), ((80, 1), None, 320, 132)),
    ((2, 1024, 1280, 20, False, False), ((160, 1), None, 640, 132)),
]


@pytest.mark.parametrize("shape,want", SEC_SHAPES)
def test_sec_plan_main_path_shapes(shape, want):
    B, Tq, C_in, heads, qkv, out = shape
    plan = _check_sec(B, Tq, C_in, heads, 64, 132, 1, qkv, out)
    got = ((plan.proj.tiles, plan.proj.splits),
           None if plan.out is None else (plan.out.tiles, plan.out.splits),
           plan.attn_items, plan.grid)
    assert got == want


def test_sec_plan_refuses_no_residency():
    for per_sm, sms in ((0, 132), (1, 0)):
        with pytest.raises(ValueError, match="blocks per SM"):
            tsa.sec_plan(1, 256, 1280, 20, 64, sms, per_sm, qkv=False,
                         out=True)


def test_sec_scratch_sizes():
    """A split plan takes one int32 workspace of its largest stage and the
    shared per-device counters; a plan without splits takes neither."""
    plan = tsa.sec_plan(1, 256, 1280, 20, 64, 132, 1, qkv=False, out=True)
    ws, counters = tqm.igemm_scratch(plan, torch.device("cpu"))
    assert ws.numel() == plan.ws_elems == 20 * 5 * 128 * 128
    assert counters.numel() == tqm.QMM_COUNTERS >= plan.counters == 20
    plan = tsa.sec_plan(1, 1024, 640, 10, 64, 132, 1, qkv=True, out=False)
    assert tqm.igemm_scratch(plan, torch.device("cpu")) == (None, None)
