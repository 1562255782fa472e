"""The kernel benchmark slice of the port against the JAX package, on the
CPU: ``qmatmul_fused_plain`` (the plain version of ``qmatmul_fused`` and
``qmatmul_fused2``, which their wrappers run for CPU tensors) against
both Pallas kernels in interpret mode, the CPU wrappers, and every row of
``mixdq_tpu_torch.scripts.kernel_bench`` against its row of
``scripts/kernel_bench.py``. Inputs come from numpy seeds (the kernel
benchmark's from its own seeded generator, handed to JAX as numpy).

Tolerances: the fused GEMMs and the int8 rows as ``chip_smoke.fused_err``
(rtol 1e-3 / atol 1e-2, but for < 1% of entries, each within one code's
worth of its column, ``scale[n] * max |w[:, n]|``: both sides quantize the
same bf16 values and sum the codes exactly); the bf16 and weight-only rows
max |d| <= 2 bf16 ulps of max |ref| and |d| / |ref| <= 1e-2 (bf16 products
summed in f32 in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.ops import pallas_qmatmul as jpq  # noqa: E402
from mixdq_tpu.ops import pallas_wq_matmul as jwq  # noqa: E402
from mixdq_tpu.ops import qops as jq  # noqa: E402

from mixdq_tpu_torch import ops  # noqa: E402
from mixdq_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from mixdq_tpu_torch.scripts import kernel_bench as kb  # noqa: E402
from tests.test_torch_port_model import T, load_smoke  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SCALE_INV, ZP = float(np.float32(9.7)), -4.0


def _operands(M, K, N, seed):
    """x [M, K] f32, int8 w [K, N], f32 scale and bias0 (zp * sum_K w)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 3).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = ((rng.random(N) + 0.1) * 0.01 / SCALE_INV).astype(np.float32)
    bias0 = (ZP * w.astype(np.int64).sum(0)).astype(np.float32)
    return x, w, scale, bias0


def _jax_fused(kernel, x, w, scale, bias0, jdt):
    a = (jnp.asarray(x), jnp.asarray(w), jnp.float32(SCALE_INV),
         jnp.float32(ZP), jnp.asarray(scale), jnp.asarray(bias0))
    if kernel == "qmatmul_fused":
        return jpq.qmatmul_fused(*a, bm=32, bn=128, bk=128, out_dtype=jdt,
                                 interpret=True)
    return jpq.qmatmul_fused2(*a, bm=32, bn=128, out_dtype=jdt,
                              interpret=True)


def _code(scale, w):
    """One code's worth of each column: ``scale[n] * max |w[:, n]|``."""
    return T(scale) * T(w).abs().amax(0).float()


@pytest.mark.parametrize("M,K,N", [
    (48, 300, 130),   # ragged M, K and N
    (100, 128, 257),
    (64, 640, 96),    # K > 512: B9 walks five K blocks of 128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["qmatmul_fused", "qmatmul_fused2"])
def test_fused_plain_vs_pallas(kernel, M, K, N, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, scale, bias0 = _operands(M, K, N, 30)
    want = _jax_fused(kernel, x, w, scale, bias0, jdt)
    got = tqm.qmatmul_fused_plain(T(x), T(w), SCALE_INV, ZP, T(scale),
                                  T(bias0), tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    want = T(want.astype(jnp.float32))
    load_smoke().fused_err(torch, got, want, _code(scale, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_wrappers_cpu(dtype):
    """On CPU tensors both wrappers are the plain version (of x in any
    float dtype), count their calls and launch nothing."""
    tdt = DTYPES[dtype][0]
    x, w, scale, bias0 = _operands(40, 96, 72, 31)
    a = (T(x).to(tdt), T(w), SCALE_INV, ZP, T(scale), T(bias0))
    want = tqm.qmatmul_fused_plain(*a, torch.float32)
    ops.reset_counts()
    for fn in (tqm.qmatmul_fused, tqm.qmatmul_fused2):
        torch.testing.assert_close(fn(*a, out_dtype=torch.float32), want,
                                   rtol=0, atol=0)
    assert ops.call_counts()["qmatmul_fused"] == 1
    assert ops.call_counts()["qmatmul_fused2"] == 1
    assert set(ops.launch_counts().values()) == {0}


def _jax_rows(inp):
    """``scripts/kernel_bench.py``'s rows (:79-93) on the port's operands,
    Pallas in interpret mode."""
    x, wb, wi, sc, b0 = (jnp.asarray(inp[k].float().numpy()).astype(
        jnp.bfloat16 if k in ("x", "wb") else jnp.float32)
        for k in ("x", "wb", "wi", "sc", "b0"))
    wi = wi.astype(jnp.int8)
    si, zp = jnp.float32(kb.SCALE_INV), jnp.float32(kb.ZP_SHIFTED)
    codes = jq.quantize_per_tensor(x, si, zp)
    return {
        "bf16 matmul": jnp.dot(x, wb, preferred_element_type=jnp.float32
                               ).astype(jnp.bfloat16),
        "torch int8 (quant+int_gemm)": jq.qlinear(codes, wi, sc, b0),
        "quantize + qmatmul": jpq.qmatmul(codes, wi, sc, b0, interpret=True),
        "fused-quant (qmatmul_fused)": jpq.qmatmul_fused(
            x, wi, si, zp, sc, b0, interpret=True),
        "fused-quant v2 (qmatmul_fused2)": jpq.qmatmul_fused2(
            x, wi, si, zp, sc, b0, interpret=True),
        "w8-dequant (wq_matmul)": jwq.wq_matmul(x, wi, sc, interpret=True),
        "w4-packed (wq4_matmul)": jwq.wq4_matmul(
            x, jwq.pack_w4_halves(jnp.clip(wi, -8, 7)), sc, interpret=True),
    }


def test_kernel_bench_rows_match_jax():
    """Each row of the port's kernel benchmark, built at a small shape on
    the CPU, computes what its row of the JAX script computes on the same
    operands; the int8 rows agree with each other."""
    inp = kb.make_inputs(64, 256, 96, "cpu", seed=3)
    rows = kb.build_rows(inp)
    want = _jax_rows(inp)
    assert list(rows) == list(want)
    smoke = load_smoke()
    ref = None
    for name, fn in rows.items():
        got = fn()
        w = T(want[name].astype(jnp.float32))
        assert got.dtype == torch.bfloat16 and got.shape == (64, 96), name
        if "int8" in name or "qmatmul" in name:
            smoke.fused_err(torch, got, w, kb.W_SCALE * 127)
            ref = got if ref is None else ref
            smoke.fused_err(torch, got, ref, kb.W_SCALE * 127)
        else:
            smoke.wq_err(torch, got, w)


def test_kernel_bench_script():
    """The script imports without CUDA or triton, has ``main()``, and
    refuses to run without a card; its table prints every row with its
    ratio against the bf16 row."""
    import sys

    assert callable(kb.main) and "triton" not in sys.modules
    with pytest.raises(SystemExit, match="CUDA"):
        kb.main(["--iters", "1"])
    table = [((8, 16, 24), [("bf16 matmul", 0.5, None), ("x", 0.25, None)])]
    assert kb.format_table(table) == [
        "M=8 K=16 N=24",
        "  bf16 matmul                        0.5000 ms (1.00x vs bf16)",
        "  x                                  0.2500 ms (2.00x vs bf16)"]
