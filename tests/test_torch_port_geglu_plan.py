"""The plan of ``geglu_qmatmul`` on the int8 mainloop
(``mixdq_tpu_torch/ops/qmatmul.py:geglu_plan``), a pure function of the
shapes and the card's SM count: ``qmm_plan`` over the ``2H`` weight
columns and the two blocks an SM holds, on the kernel's 2-stage ring.
Its tiles put every output column's value and gate in one tile, its
splits are whole k steps but the last and cover K exactly once with none
empty, its workspace and counters are sized, and the main-path shapes
take the waves ``csrc/geglu_qmatmul.cu`` and PERF.md name."""

import dataclasses

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu_torch.ops.qmatmul import (  # noqa: E402
    GEGLU_BLOCKS_PER_SM, GEGLU_STAGES, QMM_COUNTERS, QMM_MIN_SPLIT_STEPS,
    geglu_plan, qmm_plan)


def tile_columns(tile_n, H, bn):
    """What each physical column of column tile ``tile_n`` holds, in the
    B loader's order (``igemm::GegluB``): (output column, 0 for its value
    or 1 for its gate), None past H. 16-byte chunk c of a row is value
    columns ``n0 + 16 (c // 2)`` .. ``+ 15`` for even c and their gate
    columns for odd c, ``n0 = tile_n * bn / 2``."""
    n0 = tile_n * bn // 2
    cols = []
    for c in range(bn // 16):
        for j in range(16):
            n = n0 + 16 * (c // 2) + j
            cols.append(None if n >= H else (n, c % 2))
    return cols


def _ranges(plan):
    return [(s * plan.split_k, min((s + 1) * plan.split_k, plan.kdim))
            for s in range(plan.splits)]


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 8192), K=st.integers(1, 6000),
       H=st.integers(1, 6000), sms=st.integers(1, 264))
def test_geglu_plan_covers_k_once(M, K, H, sms):
    plan = geglu_plan(M, K, H, sms)
    assert plan.stages == GEGLU_STAGES
    assert plan.bk == 128 and plan.bm == 128 and plan.bn == 128
    assert plan.kdim == K
    ranges = _ranges(plan)
    assert all(lo < hi for lo, hi in ranges)
    assert plan.split_k % plan.bk == 0
    assert all((hi - lo) % plan.bk == 0 for lo, hi in ranges[:-1])
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # a tile is 128 weight columns: 64 output columns' values and gates
    col_tiles = -(-H // (plan.bn // 2))
    assert plan.tiles == -(-M // plan.bm) * col_tiles
    slots = GEGLU_BLOCKS_PER_SM * sms  # blocks the card holds at once
    if plan.tiles >= slots:
        assert plan.splits == 1
    elif plan.splits > 1:
        assert plan.blocks <= slots
        assert plan.split_k >= QMM_MIN_SPLIT_STEPS * plan.bk
    if plan.splits > 1:
        assert plan.ws_elems == plan.tiles * plan.splits * 128 * 128
        assert plan.counters == plan.tiles <= QMM_COUNTERS
    else:
        assert plan.ws_elems == plan.counters == 0
    assert plan == dataclasses.replace(qmm_plan(M, K, 2 * H, slots),
                                       stages=GEGLU_STAGES)


@settings(max_examples=200, deadline=None)
@given(H=st.integers(1, 3000))
def test_geglu_tiles_pair_value_and_gate(H):
    """Every output column n < H has its value and its gate in the same
    tile, in lanes t and t ^ 2 of one warp slab (physical columns p and p
    + 16 of a 32-column slab), and no tile reads a column past H."""
    plan = geglu_plan(128, 640, H, 132)
    seen = {}
    for tn in range(-(-H // (plan.bn // 2))):
        cols = tile_columns(tn, H, plan.bn)
        assert len(cols) == plan.bn
        for p, col in enumerate(cols):
            if col is None:
                continue
            n, gate = col
            assert n < H
            seen.setdefault(n, []).append((tn, p, gate))
    assert sorted(seen) == list(range(H))
    for n, where in seen.items():
        (t0, p0, g0), (t1, p1, g1) = sorted(where, key=lambda w: w[2])
        assert (g0, g1) == (0, 1) and t0 == t1
        # the thread of physical column p holds 8t .. 8t + 7 of its slab
        assert p1 == p0 + 16 and p0 // 32 == p1 // 32
        assert (p0 % 32) // 8 ^ 2 == (p1 % 32) // 8


# (M, K, H) -> (tiles, splits, k steps per split, waves of 264 blocks) on
# an H100's 132 SMs, as csrc/geglu_qmatmul.cu and PERF.md state
GEGLU_SHAPES = [
    ((256, 1280, 5120), (160, 1, 10, 1)),    # 512 px 16x16 (60 sites)
    ((1024, 640, 2560), (320, 1, 5, 2)),     # 512 px 32x32 (10 sites)
    ((1024, 1280, 5120), (640, 1, 10, 3)),   # 1024 px 32x32
    ((4096, 640, 2560), (1280, 1, 5, 5)),    # 1024 px 64x64
]


@pytest.mark.parametrize("shape,want", GEGLU_SHAPES)
def test_geglu_plan_main_path_shapes(shape, want):
    plan = geglu_plan(*shape, 132)
    waves = -(-plan.blocks // (GEGLU_BLOCKS_PER_SM * 132))
    assert (plan.tiles, plan.splits, plan.split_k // plan.bk, waves) == want


def test_geglu_plan_splits_few_tiles():
    """M = 64 at H = 2560 has 40 tiles for 264 resident blocks: K splits
    into whole steps, and the scratch is the plan's size; M = 1 at H =
    5120 (80 tiles) splits in three."""
    import torch

    from mixdq_tpu_torch.ops.qmatmul import igemm_scratch

    plan = geglu_plan(64, 640, 2560, 132)
    assert plan.tiles == 40 and plan.splits == 2
    assert [hi - lo for lo, hi in _ranges(plan)] == [384, 256]
    ws, counters = igemm_scratch(plan, torch.device("cpu"))
    assert ws.numel() == plan.ws_elems == 40 * 2 * 128 * 128
    assert counters.numel() == QMM_COUNTERS >= plan.counters
    one = geglu_plan(1, 1280, 5120, 132)
    assert (one.tiles, one.splits, one.split_k) == (80, 3, 512)
