"""The launch plan of the port's fused act-quantize GEMMs
(``mixdq_tpu_torch/ops/qmatmul.py``): both run ``qmm_plan`` (its splits
cover K once), ``qmatmul_fused2`` also a codes workspace
(``fused2_codes_shape``) and a cooperative grid (``fused2_grid``, a pure
function of the plan and the blocks the card holds) that never exceeds
the plan's (tile, split) items nor what the card holds at once, and
whose grid stride reaches every item once. ``qmatmul_fused2`` takes any
K: its plain path at K = 16384 against the Pallas kernel in interpret
mode, to ``tests/test_torch_port_fused.py``'s tolerance
(``chip_smoke.fused_err``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from mixdq_tpu.ops import pallas_qmatmul as jpq  # noqa: E402

from mixdq_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from tests.test_torch_port_model import T, load_smoke  # noqa: E402
from tests.test_torch_port_qmm_plan import _check  # noqa: E402


def _check_fused2(M, K, N, sms, per_sm):
    plan = tqm.qmm_plan(M, K, N, sms)
    _check(plan, M, K, N, sms)
    rows, ldc = tqm.fused2_codes_shape(M, K)
    assert rows == M and ldc % 16 == 0 and K <= ldc < K + 16
    grid = tqm.fused2_grid(plan, per_sm, sms)
    assert 1 <= grid <= min(plan.blocks, per_sm * sms)
    # the kernel's grid stride over items: block b takes b, b + grid, ...
    items = sorted(i for b in range(grid)
                   for i in range(b, plan.blocks, grid))
    assert items == list(range(plan.blocks))
    return plan, grid


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 8192), K=st.integers(1, 40000),
       N=st.integers(1, 6000), sms=st.integers(1, 264),
       per_sm=st.integers(1, 4))
def test_fused2_plan_grid_and_codes(M, K, N, sms, per_sm):
    _check_fused2(M, K, N, sms, per_sm)


# (M, K, N) -> (tiles, splits, cooperative grid) on an H100's 132 SMs at
# one block an SM: the kernel benchmark's shapes, the ragged one and
# K = 16384
FUSED_SHAPES = [
    ((1024, 5120, 1280), (80, 1, 80)),
    ((4096, 640, 640), (160, 1, 132)),
    ((1024, 1280, 1280), (80, 1, 80)),
    ((1024, 1280, 5120), (320, 1, 132)),
    ((48, 300, 130), (2, 1, 2)),
    ((64, 16384, 128), (1, 64, 64)),
    ((1, 1280, 1280), (10, 5, 50)),
]


@pytest.mark.parametrize("shape,want", FUSED_SHAPES)
def test_fused_plan_bench_shapes(shape, want):
    plan, grid = _check_fused2(*shape, 132, 1)
    assert (plan.tiles, plan.splits, grid) == want


def test_fused2_grid_refuses_no_residency():
    plan = tqm.qmm_plan(1024, 5120, 1280, 132)
    for per_sm, sms in ((0, 132), (1, 0)):
        with pytest.raises(ValueError, match="blocks per SM"):
            tqm.fused2_grid(plan, per_sm, sms)


def test_fused_scratch_sizes():
    """A split fused plan takes ``qmatmul``'s workspace and the shared
    per-device counters; the codes workspace is [M, K rounded up to
    16]."""
    plan = tqm.qmm_plan(64, 16384, 128, 132)
    ws, counters = tqm.igemm_scratch(plan, torch.device("cpu"))
    assert ws.numel() == plan.ws_elems == plan.splits * 128 * 128
    assert counters.numel() == tqm.QMM_COUNTERS >= plan.counters == 1
    assert tqm.fused2_codes_shape(48, 300) == (48, 304)
    assert tqm.fused2_codes_shape(1024, 5120) == (1024, 5120)


def test_fused2_has_no_k_limit():
    """The port's ``qmatmul_fused2`` at K = 16384 (the JAX function shrinks
    its tiles there; the kernel streams any K): its plain path against
    the Pallas kernel in interpret mode."""
    M, K, N = 24, 16384, 128
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((M, K)) * 3).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    sinv, zp = float(np.float32(9.7)), -4.0
    scale = ((rng.random(N) + 0.1) * 0.01 / sinv).astype(np.float32)
    bias0 = (zp * w.astype(np.int64).sum(0)).astype(np.float32)
    assert not hasattr(tqm, "FUSED2_MAX_K")
    want = jpq.qmatmul_fused2(jnp.asarray(x), jnp.asarray(w),
                              jnp.float32(sinv), jnp.float32(zp),
                              jnp.asarray(scale), jnp.asarray(bias0),
                              out_dtype=jnp.float32, interpret=True)
    got = tqm.qmatmul_fused2(T(x), T(w), sinv, zp, T(scale), T(bias0),
                             torch.float32)
    assert got.shape == (M, N) and got.dtype == torch.float32
    code = T(scale) * T(w).abs().amax(0).float()
    load_smoke().fused_err(torch, got, T(np.asarray(want)), code)
