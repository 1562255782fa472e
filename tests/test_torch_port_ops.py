"""The port's ops (``mixdq_tpu_torch.ops``, plain versions on the CPU)
against the JAX package's ops and Pallas kernels in interpret mode, on the
same numpy-seeded inputs, plus the port's import and device guards.

Tolerances: int8 codes may differ by 1 on under 1% of elements (float sums
run in another order; tests/test_pallas_sec_attention.py:46-49); float
outputs of exact integer accumulations match to f32 rounding.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.ops import qops as jq  # noqa: E402
from mixdq_tpu.quant import core as jcore  # noqa: E402

from mixdq_tpu_torch import ops  # noqa: E402
from mixdq_tpu_torch.ops import qops as tq  # noqa: E402
from mixdq_tpu_torch.ops.gn_quant import gn_silu_quantize  # noqa: E402
from mixdq_tpu_torch.ops.ln_quant import ln_quantize  # noqa: E402
from mixdq_tpu_torch.ops.qconv import qconv2d, qconv2d_s2  # noqa: E402
from mixdq_tpu_torch.ops.qmatmul import geglu_qmatmul  # noqa: E402
from mixdq_tpu_torch.quant import core as tcore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.from_numpy(np.array(a))


def assert_codes_close(got, want):
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, f"max code diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, f"{(diff > 0).mean():.4f} differ"


def codes(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("a_bits", [8, 4])
def test_quantize_per_tensor(a_bits):
    rng = np.random.default_rng(0)
    # include exact .5 boundaries: round half to even on both sides
    x = np.concatenate([rng.standard_normal(500).astype(np.float32) * 3,
                        np.arange(-8, 8, 0.5, dtype=np.float32) / 4.0])
    lo, hi = tq.act_clip_range(a_bits)
    assert (lo, hi) == jq.act_clip_range(a_bits)
    want = jq.quantize_per_tensor(jnp.asarray(x), jnp.float32(4.0),
                                  jnp.float32(-3.0), lo, hi)
    got = tq.quantize_per_tensor(t(x), 4.0, -3.0, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K,N,with_bias", [(7, 20, 12, False),
                                              (33, 64, 48, True)])
def test_qlinear(M, K, N, with_bias):
    rng = np.random.default_rng(1)
    x, w = codes(rng, M, K), codes(rng, K, N)
    scale = rng.random(N).astype(np.float32) * 1e-3
    bias0 = rng.integers(-3000, 3000, N).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    want = jq.qlinear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                      jnp.asarray(bias0),
                      None if bias is None else jnp.asarray(bias),
                      out_dtype=jnp.float32)
    got = tq.qlinear(t(x), t(w), t(scale), t(bias0),
                     None if bias is None else t(bias),
                     out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _conv_case(rng, B, H, W, C, K):
    x, w = codes(rng, B, H, W, C), codes(rng, 3, 3, C, K)
    scale = (rng.random(K).astype(np.float32) + 0.5) * 1e-3
    bias0 = rng.integers(-2000, 2000, K).astype(np.float32)
    return x, w, scale, bias0


@pytest.mark.parametrize("pad,stride", [(1, 1), (0, 1), (1, 2)])
def test_qops_qconv2d(pad, stride):
    rng = np.random.default_rng(2)
    x, w, scale, bias0 = _conv_case(rng, 2, 9, 7, 12, 8)
    bias = rng.standard_normal(8).astype(np.float32)
    want = jq.qconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                      jnp.asarray(bias0), jnp.float32(5.0), jnp.asarray(bias),
                      strides=(stride, stride), padding=(pad, pad),
                      out_dtype=jnp.float32)
    got = tq.qconv2d(t(x), t(w), t(scale), t(bias0), 5.0, t(bias),
                     strides=(stride, stride), padding=(pad, pad),
                     out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize(
    "B,H,W,C,K,pad,stride,epilogue",
    [
        (1, 8, 8, 4, 16, 1, 1, True),    # conv_in-like: C=4
        (1, 8, 8, 16, 4, 1, 1, False),   # conv_out-like: K=4
        (2, 6, 5, 12, 8, 0, 1, True),    # width not a multiple of 8, pad 0
        (1, 8, 8, 16, 16, 1, 2, False),  # downsampler
        (2, 9, 6, 8, 8, 1, 2, True),     # odd height, stride 2 + epilogue
    ])
def test_qconv_kernel_plain_vs_pallas(B, H, W, C, K, pad, stride, epilogue):
    from mixdq_tpu.ops.pallas_qconv import qconv2d_pallas, qconv2d_pallas_s2

    rng = np.random.default_rng(3)
    x, w, scale, bias0 = _conv_case(rng, B, H, W, C, K)
    P = (H + 2 * pad - 3) // stride + 1
    Q = (W + 2 * pad - 3) // stride + 1
    bias = rng.standard_normal(K).astype(np.float32)
    eb = rng.standard_normal((B, K)).astype(np.float32) if epilogue else None
    res = (rng.standard_normal((B, P, Q, K)).astype(np.float32)
           if epilogue else None)
    jfn = qconv2d_pallas if stride == 1 else qconv2d_pallas_s2
    want = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
               jnp.asarray(bias0), jnp.float32(-7.0), bias=jnp.asarray(bias),
               extra_bias=None if eb is None else jnp.asarray(eb),
               residual=None if res is None else jnp.asarray(res),
               padding=(pad, pad), out_dtype=jnp.float32, interpret=True)
    tfn = qconv2d if stride == 1 else qconv2d_s2
    got = tfn(t(x), t(w), t(scale), t(bias0), -7.0, bias=t(bias),
              extra_bias=None if eb is None else t(eb),
              residual=None if res is None else t(res), padding=(pad, pad),
              out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("silu,a_bits,eps,C,groups", [
    (True, 8, 1e-5, 64, 32),
    (False, 8, 1e-6, 96, 32),   # proj_in form; group width 3
    (True, 4, 1e-5, 48, 16),
])
def test_gn_silu_quantize_plain_vs_pallas(silu, a_bits, eps, C, groups):
    from mixdq_tpu.ops.pallas_gn_quant import gn_silu_quantize as jgn

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 8, 6, C)) * 2 + 0.3).astype(np.float32)
    gamma = (rng.random(C) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.2).astype(np.float32)
    clip = tq.act_clip_range(a_bits)
    sinv, zp = (30.0, -5.0) if a_bits == 8 else (2.0, 1.0)
    want = jgn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
               jnp.float32(sinv), jnp.float32(zp), groups=groups, eps=eps,
               silu=silu, interpret=True, clip=clip)
    got = gn_silu_quantize(t(x), t(gamma), t(beta), sinv, zp, groups=groups,
                           eps=eps, silu=silu, clip=clip)
    assert_codes_close(got.numpy(), want)


@pytest.mark.parametrize("a_bits,shape", [(8, (1, 40, 64)), (4, (2, 12, 24))])
def test_ln_quantize_plain_vs_pallas(a_bits, shape):
    from mixdq_tpu.ops.pallas_ln_quant import ln_quantize as jln

    rng = np.random.default_rng(5)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    gamma = (rng.random(C) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.2).astype(np.float32)
    clip = tq.act_clip_range(a_bits)
    want = jln(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
               jnp.float32(20.0), jnp.float32(3.0), interpret=True, clip=clip)
    got = ln_quantize(t(x), t(gamma), t(beta), 20.0, 3.0, clip=clip)
    assert_codes_close(got.numpy(), want)


@pytest.mark.parametrize("gelu_tanh,with_bias,M,K,H,a_bits", [
    (True, True, 40, 64, 48, 8),
    (False, True, 17, 32, 24, 8),
    (True, False, 9, 40, 20, 4),   # widths not multiples of 16
])
def test_geglu_qmatmul_plain_vs_pallas(gelu_tanh, with_bias, M, K, H, a_bits):
    from mixdq_tpu.ops.pallas_qmatmul import geglu_qmatmul as jgeglu

    rng = np.random.default_rng(6)
    x, w = codes(rng, M, K), codes(rng, K, 2 * H)
    scale = (rng.random(2 * H).astype(np.float32) + 0.5) * 2e-4
    bias0 = (rng.integers(-40, 40) * w.astype(np.int32).sum(0)).astype(
        np.float32)
    bias = (rng.standard_normal(2 * H).astype(np.float32) * 0.3
            if with_bias else None)
    clip = tq.act_clip_range(a_bits)
    sinv, zp = (25.0, 4.0) if a_bits == 8 else (3.0, -1.0)
    want = jgeglu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                  jnp.asarray(bias0), jnp.float32(sinv), jnp.float32(zp),
                  bias=None if bias is None else jnp.asarray(bias),
                  gelu_tanh=gelu_tanh, clip=clip, interpret=True)
    got = geglu_qmatmul(t(x), t(w), t(scale), t(bias0), sinv, zp,
                        bias=None if bias is None else t(bias),
                        gelu_tanh=gelu_tanh, clip=clip)
    assert_codes_close(got.numpy(), want)


@pytest.mark.parametrize("kind,with_alpha,n_bits,a_bits", [
    ("linear", False, 8, 8), ("linear", True, 4, 8), ("conv", False, 8, 4),
])
def test_prepare_params_exact(kind, with_alpha, n_bits, a_bits):
    rng = np.random.default_rng(7)
    shape = (24, 16) if kind == "linear" else (3, 3, 8, 16)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    d, _ = jcore.fit_weight_qparams(jnp.asarray(w), jcore.QuantSpec(
        sym=True, channel_wise=True, round_mode="nearest"))
    w_delta = np.asarray(d[list(jcore.DEFAULT_CANDIDATE_BITS).index(n_bits)])
    alpha = (rng.standard_normal(shape).astype(np.float32)
             if with_alpha else None)
    a_delta, a_zp = np.float32(0.037), np.float32(101.0)
    jfn = (jq.prepare_qlinear_params if kind == "linear"
           else jq.prepare_qconv_params)
    tfn = (tq.prepare_qlinear_params if kind == "linear"
           else tq.prepare_qconv_params)
    want = jfn(jnp.asarray(w), jnp.asarray(w_delta), jnp.asarray(a_delta),
               jnp.asarray(a_zp), n_bits=n_bits,
               alpha=None if alpha is None else jnp.asarray(alpha),
               a_bits=a_bits)
    got = tfn(t(w), t(w_delta), t(a_delta), t(a_zp), n_bits=n_bits,
              alpha=None if alpha is None else t(alpha), a_bits=a_bits)
    for k in ("w_int", "scale", "bias0"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["scale_inv"] == float(want["scale_inv"])
    assert got["zp_shifted"] == float(want["zp_shifted"])


@pytest.mark.parametrize("sym,channel_wise", [(True, True), (False, False)])
def test_quantizer_fits_exact(sym, channel_wise):
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.3 + 0.05).astype(np.float32)
    kw = dict(sym=sym, channel_wise=channel_wise)
    jd, jz = jcore.fit_weight_qparams(jnp.asarray(w), jcore.QuantSpec(**kw))
    td, tz = tcore.fit_weight_qparams(t(w), tcore.QuantSpec(**kw))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert {f.name for f in dataclasses.fields(tcore.QuantSpec)} == \
        {f.name for f in dataclasses.fields(jcore.QuantSpec)}


def test_dispatch_counts_and_devices():
    """CPU tensors take the plain version (a call, no launch); tensors on
    a device without a kernel raise instead of running anything."""
    rng = np.random.default_rng(9)
    x = t(rng.standard_normal((1, 4, 8)).astype(np.float32))
    g, b = torch.ones(8), torch.zeros(8)
    ops.reset_counts()
    ln_quantize(x, g, b, 10.0, 0.0)
    assert ops.call_counts()["ln_quantize"] == 1
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        ln_quantize(x.to("meta"), g.to("meta"), b.to("meta"), 10.0, 0.0)
    with pytest.raises(ValueError):
        ln_quantize(x, g.to("meta"), b, 10.0, 0.0)


def test_entry_points_refuse_cpu_without_cuda(monkeypatch):
    """Without ``device='cpu'`` the entry points ask for CUDA and raise
    when it is absent, instead of running on the CPU."""
    from mixdq_tpu_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.build_unet("tiny-sdxl")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.example_inputs("tiny-sdxl")
    assert pipeline.resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where there
    is no CUDA device, and alone in a directory without the port."""
    import shutil
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for cwd in (REPO, str(tmp_path)):
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert r.stdout == ""


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax or
    the JAX package (``mixdq_tpu``, as opposed to ``mixdq_tpu_torch``)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mixdq_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "mixdq_tpu"):
                bad.append(f"{os.path.relpath(f, REPO)}: {mod}")
    assert len(files) > 10
    assert not bad, bad
