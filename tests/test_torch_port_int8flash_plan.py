"""The launch plan and fragment layout of the port's int8 flash kernels
(``mixdq_tpu_torch/ops/attention.py:int8_flash_plan`` and ``s8_slot``,
mirrors of ``csrc/int8_flash.cu``), pure Python: the main path's plan,
a key ring that fits one SM's shared memory at every head dim, stages
that tile every key block, and an s8 PV product whose p and v fragments
name the same key at every (lane, register, byte) under the PTX layouts
of ``mma.sync.m16n8k32``."""

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu_torch.ops import attention  # noqa: E402
from mixdq_tpu_torch.ops.attention import (int8_block_keys,  # noqa: E402
                                           int8_flash_plan, s8_slot)

HEAD_DIMS = (16, 32, 64, 128)
#: shared memory of one H100 SM, and what one block may take
SM_SMEM, BLOCK_SMEM = 233_472, 232_448
#: shared memory the runtime reserves per block
RESERVED = 1024


@pytest.mark.parametrize("int8_v,stage_bytes,blocks", [(False, 7168, 5),
                                                       (True, 5120, 4)])
def test_main_path_plan(int8_v, stage_bytes, blocks):
    """SDXL 1024's attn1 at 64x64: 10 heads of 64. 64-row blocks of four
    warps, a 4-stage ring of 32-key stages (k rows of 64 + 16 bytes, then
    v: 32 x (64 + 8) bf16 or 32 x 80 codes); five blocks an SM with bf16
    v (640 blocks at B=1 in one wave on 132 SMs), four with v codes."""
    plan = int8_flash_plan(64, int8_v)
    assert (plan.rows, plan.threads, plan.stages, plan.stage_keys) == (
        64, 128, 4, 32)
    assert plan.stage_bytes == stage_bytes
    assert plan.ring_bytes == 4 * stage_bytes
    assert plan.blocks_per_sm == blocks


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("int8_v", [False, True])
def test_ring_fits(d, int8_v):
    """The ring fits a block's shared memory, the build's blocks fit an
    SM, and every row of a stage starts on 16 bytes (cp.async, ldmatrix)
    at an odd multiple of 16 bytes apart (the 8 row addresses of an
    ldmatrix fall in distinct banks)."""
    plan = int8_flash_plan(d, int8_v)
    assert plan.ring_bytes == plan.stages * plan.stage_bytes <= BLOCK_SMEM
    assert plan.blocks_per_sm * (plan.ring_bytes + RESERVED) <= SM_SMEM
    assert plan.threads == plan.rows // 16 * 32
    ldk = max(d, 32) + 16
    ldv = ldk if int8_v else (d + 8) * 2
    assert plan.stage_bytes == plan.stage_keys * (ldk + ldv)
    for ld in (ldk, ldv):
        assert ld % 16 == 0 and (ld // 16) % 2 == 1
        # the 16-byte bank group (of 8 in 128 bytes) of each row's start
        assert len({(r * ld // 16) % 8 for r in range(8)}) == 8


def test_plan_refuses_other_head_dims():
    with pytest.raises(ValueError):
        int8_flash_plan(48, False)


@settings(max_examples=300, deadline=None)
@given(Tk=st.integers(1, 70000), d=st.sampled_from(HEAD_DIMS),
       int8_v=st.booleans())
def test_stages_tile_every_key_block(Tk, d, int8_v):
    """A stage's keys divide every key block (the C launcher refuses
    another bk), so that no stage straddles two blocks and the last
    block's tail is a whole stage with its keys >= Tk zero-filled."""
    plan = int8_flash_plan(d, int8_v)
    bk = int8_block_keys(Tk)
    assert bk % plan.stage_keys == 0 and bk >= min(Tk, 512)


def test_s8_slot_is_a_bijection():
    """Within each 32-key step the permutation puts each key at its own
    k slot, so the s32 PV sum takes every key once."""
    assert sorted(s8_slot(q) for q in range(32)) == list(range(32))
    # the logits' tile nt holds keys 2t, 2t+1 of lane t
    assert [s8_slot(q) for q in (0, 1, 8, 9)] == [0, 1, 2, 3]
    assert [s8_slot(q) for q in (16, 17, 24, 25)] == [16, 17, 18, 19]


# PTX ISA, mma.sync.m16n8k32 .s8 (lane = 4 g + t):
#   accumulator c_r: row g + 8 (r >= 2), column 2t + (r & 1)
#   A a_j byte i: row g + 8 (j & 1), k 16 (j >> 1) + 4t + i
#   B b_j byte i: k 16 j + 4t + i, column g

def _acc_key(nt, t, r):
    """Key of the logits' accumulator tile nt, register r, lane t."""
    return nt * 8 + 2 * t + (r & 1)


def _p_fragment_key(t, j, i):
    """Key whose code int8_flash.cu packs at byte i of p's A register j
    (pack_s8 of c[2 (j >> 1) + (i >> 1)][2 (j & 1) + (i & 1)])."""
    return _acc_key(2 * (j >> 1) + (i >> 1), t, 2 * (j & 1) + (i & 1))


def _ldsm_trans(rows, g, t):
    """ldmatrix.x4.trans.b16 of four 8x8 b16 matrices (``rows[m][row]``
    the 16 bytes a lane addresses): lane (g, t) gets, from matrix m, rows
    2t and 2t + 1 of b16 column g, each two bytes, the lower row in the
    lower half."""
    out = []
    for m in range(4):
        lo, hi = rows[m][2 * t], rows[m][2 * t + 1]
        out.append([lo[2 * g], lo[2 * g + 1], hi[2 * g], hi[2 * g + 1]])
    return out


def _byte_perm(x, y, sel):
    xy = x + y
    return [xy[(sel >> (4 * b)) & 0xF] for b in range(4)]


def _v_fragments(g, t, G):
    """The B fragments of ring_pv_s8 for 16-column group G at lane (g, t),
    each byte as (key, column): (even tile b0, b1), (odd tile b0, b1)."""
    # v rows as copied: key q (lane q addresses it), 16 bytes of columns
    rows = [[[(8 * m + r, 16 * G + c) for c in range(16)] for r in range(8)]
            for m in range(4)]
    r = _ldsm_trans(rows, g, t)
    even = [_byte_perm(r[0], r[1], 0x6420), _byte_perm(r[2], r[3], 0x6420)]
    odd = [_byte_perm(r[0], r[1], 0x7531), _byte_perm(r[2], r[3], 0x7531)]
    return even, odd


@pytest.mark.parametrize("G", [0, 1, 3, 7])
def test_p_and_v_fragments_name_the_same_key(G):
    """At every lane, A register and byte, p's fragment holds the key that
    v's B fragment holds at the same k slot; the even tile's column n is
    the group's column 2n, the odd tile's 2n + 1."""
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        even, odd = _v_fragments(g, t, G)
        for j in range(4):  # p's A registers
            for i in range(4):
                slot = 16 * (j >> 1) + 4 * t + i
                key = _p_fragment_key(t, j, i)
                assert s8_slot(key) == slot
                # B register j >> 1 holds k slots 16 (j >> 1) + 4t + i
                assert even[j >> 1][i] == (key, 16 * G + 2 * g)
                assert odd[j >> 1][i] == (key, 16 * G + 2 * g + 1)


def test_s8_output_columns():
    """The s8 PV's accumulator (tile dt, register r) of lane t is column
    (dt >> 1) 16 + 4t + 2 (r & 1) + (dt & 1) (int8_flash.cu's store): each
    row's D columns exactly once over the lanes of a row."""
    for d in HEAD_DIMS:
        for half in (0, 2):  # rows g and g + 8
            cols = sorted((dt >> 1) * 16 + 4 * t + 2 * (r & 1) + (dt & 1)
                          for t in range(4) for dt in range(d // 8)
                          for r in (half, half + 1))
            assert cols == list(range(d))


def test_plan_constants_match_the_source():
    """The plan's constants are the CUDA source's (``I8_ROWS``,
    ``I8_STAGES``, ``MIN_BLOCKS``; ``KCH``)."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(attention.__file__), os.pardir,
                        "csrc")
    src = open(os.path.join(csrc, "int8_flash.cu")).read()
    warps = int(re.search(r"I8_WARPS = (\d+);", src).group(1))
    assert attention.INT8_FLASH_ROWS == 16 * warps
    assert attention.INT8_FLASH_STAGES == int(
        re.search(r"I8_STAGES = (\d+);", src).group(1))
    m = re.search(r"MIN_BLOCKS =\s+D <= 32 \? (\d+) : D == 40 \? (\d+) : "
                  r"D == 64 \? \(V8 \? (\d+) : (\d+)\)\s+: D == 80 \? "
                  r"\(V8 \? (\d+) : (\d+)\) : (\d+);", src)
    small, d40, v8, bf16_v, v8_80, bf16_80, large = (int(x)
                                                     for x in m.groups())
    assert attention.INT8_FLASH_BLOCKS == {
        16: (small, small), 32: (small, small), 40: (d40, d40),
        64: (bf16_v, v8), 80: (bf16_80, v8_80), 128: (large, large),
        160: (large, large)}
    hdr = open(os.path.join(csrc, "attn_mma.cuh")).read()
    assert attention.INT8_FLASH_STAGE_KEYS == int(
        re.search(r"constexpr int KCH = (\d+);", hdr).group(1))
