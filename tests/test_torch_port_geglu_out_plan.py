"""The plan of ``geglu_out_qmatmul``'s cooperative launch
(``mixdq_tpu_torch/ops/qmatmul.py:geglu_out_plan``), a pure function of
the shapes, the card's SM count and the blocks an SM holds: the GEGLU
stage under ``geglu_plan``'s rule over the resident blocks, ff.net.2
under ``qmm_plan(M, H, C)``, both on one ring. Each stage's splits are
whole k steps but the last and cover K (GEGLU) or H (ff.net.2) exactly
once with none empty, the grid never exceeds the resident blocks and
covers the larger stage where it can, the shared workspace and counters
fit both stages, and the 512 px and 1024 px ff shapes take the waves
``csrc/geglu_qmatmul.cu`` and PERF.md name."""

import dataclasses

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu_torch.ops.qmatmul import (  # noqa: E402
    QMM_COUNTERS, QMM_STAGES, geglu_out_plan, geglu_plan, igemm_scratch,
    qmm_plan)


def _ranges(plan):
    return [(s * plan.split_k, min((s + 1) * plan.split_k, plan.kdim))
            for s in range(plan.splits)]


def _covers_once(plan, kdim):
    ranges = _ranges(plan)
    assert plan.kdim == kdim and plan.bk == 128
    assert all(lo < hi for lo, hi in ranges)
    assert plan.split_k % plan.bk == 0
    assert all((hi - lo) % plan.bk == 0 for lo, hi in ranges[:-1])
    assert ranges[0][0] == 0 and ranges[-1][1] == kdim
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 8192), K=st.integers(1, 6000),
       H=st.integers(1, 6000), C=st.integers(1, 3000),
       sms=st.integers(1, 264), per_sm=st.integers(1, 2))
def test_geglu_out_plan_stages(M, K, H, C, sms, per_sm):
    plan = geglu_out_plan(M, K, H, C, sms, per_sm)
    g, n2 = plan.geglu, plan.net2
    _covers_once(g, K)
    _covers_once(n2, H)
    assert g.stages == n2.stages == QMM_STAGES
    assert g.bm == n2.bm == 128
    # GEGLU: 128-column tiles of 64 output columns' values and gates
    assert g.tiles == -(-M // 128) * -(-H // 64)
    assert n2.tiles == -(-M // 128) * -(-C // 128)
    assert g == qmm_plan(M, K, 2 * H, per_sm * sms)
    assert n2 == qmm_plan(M, H, C, sms)
    # the grid: resident blocks only, every item of the larger stage
    # where the card holds that many
    assert 1 <= plan.grid <= per_sm * sms
    assert plan.grid == min(per_sm * sms, max(g.blocks, n2.blocks))
    # one workspace and one set of counters, used a stage at a time
    for p in (g, n2):
        if p.splits > 1:
            assert plan.ws_elems >= p.tiles * p.splits * 128 * 128
            assert plan.counters >= p.tiles
    assert plan.ws_elems == max(g.ws_elems, n2.ws_elems)
    assert plan.counters == max(g.counters, n2.counters) <= QMM_COUNTERS
    assert plan.splits == max(g.splits, n2.splits)


@settings(max_examples=100, deadline=None)
@given(M=st.integers(1, 4096), K=st.integers(1, 3000),
       H=st.integers(1, 6000), sms=st.integers(1, 264))
def test_geglu_out_plan_geglu_stage_is_geglu_plan(M, K, H, sms):
    """The GEGLU stage takes ``geglu_qmatmul``'s rule over the blocks
    the card holds: item for item ``geglu_plan``'s at two blocks an SM,
    on ``qmatmul``'s 4-stage ring; at one block an SM, the same rule
    over the SMs alone."""
    plan = geglu_out_plan(M, K, H, 640, sms, 2)
    assert plan.geglu == dataclasses.replace(geglu_plan(M, K, H, sms),
                                             stages=QMM_STAGES)
    plan = geglu_out_plan(M, K, H, 640, sms, 1)
    assert plan.geglu == qmm_plan(M, K, 2 * H, sms)


# (M, K = C, H) -> (GEGLU tiles, splits, waves of the grid; ff.net.2
# tiles, splits, k steps a split; grid) on an H100's 132 SMs, one block
# an SM on the 4-stage ring, as csrc/geglu_qmatmul.cu and PERF.md state
GEGLU_OUT_SHAPES = [
    ((256, 1280, 5120), (160, 1, 2, 20, 6, 7, 132)),     # 512 px 16x16
    ((1024, 640, 2560), (320, 1, 3, 40, 3, 7, 132)),     # 512 px 32x32
    ((1024, 1280, 5120), (640, 1, 5, 80, 1, 40, 132)),   # 1024 px 32x32
    ((4096, 640, 2560), (1280, 1, 10, 160, 1, 20, 132)),  # 1024 px 64x64
]


@pytest.mark.parametrize("shape,want", GEGLU_OUT_SHAPES)
def test_geglu_out_plan_main_path_shapes(shape, want):
    M, C, H = shape
    plan = geglu_out_plan(M, C, H, C, 132, 1)
    g, n2 = plan.geglu, plan.net2
    waves = -(-g.blocks // plan.grid)
    assert n2.blocks <= plan.grid or n2.splits == 1  # one wave if split
    assert (g.tiles, g.splits, waves, n2.tiles, n2.splits,
            n2.split_k // n2.bk, plan.grid) == want


def test_geglu_out_plan_scratch_and_refusals():
    """M = 1 splits both stages: the scratch is the larger stage's; a plan
    without resident blocks is refused."""
    import torch

    plan = geglu_out_plan(1, 1280, 5120, 1280, 132, 2)
    assert (plan.geglu.tiles, plan.geglu.splits) == (80, 3)
    assert (plan.net2.tiles, plan.net2.splits) == (10, 10)
    assert plan.grid == 240
    ws, counters = igemm_scratch(plan, torch.device("cpu"))
    assert ws.numel() == plan.ws_elems == 80 * 3 * 128 * 128
    assert counters.numel() == QMM_COUNTERS >= plan.counters == 80
    plan = geglu_out_plan(77, 640, 2560, 640, 132, 1)
    assert (plan.geglu.tiles, plan.geglu.splits) == (40, 2)
    assert (plan.net2.tiles, plan.net2.splits, plan.grid) == (5, 10, 80)
    assert plan.ws_elems == 40 * 2 * 128 * 128 and plan.counters == 40
    for bad in (dict(per_sm=0), dict(sms=0)):
        kw = dict(M=77, K=640, H=2560, C=640, sms=132, per_sm=2)
        kw.update(bad)
        with pytest.raises(ValueError):
            geglu_out_plan(**kw)
