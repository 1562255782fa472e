"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test needs a CUDA device and skips without one. This file
imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_port_gpu.py

Tolerances: int8 codes max |diff| <= 1 on under 1% of elements; float
outputs rtol 1e-3 / atol 1e-2 (the same integer sums, f32 epilogues that
round at the same steps; bf16 outputs may differ by one bf16 ulp); the
int8 GEMMs on the shared mainloop (``qmatmul``, ``qconv2d``, the fused
act-quantize GEMMs, and the GEMM stages of the cooperative
``sec_attention*`` kernels) equal bit for bit (``chip_smoke.exact_err``).
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_codes_close(got, want):
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1, f"max code diff {diff.max().item()}"
    frac = (diff > 0).float().mean().item()
    assert frac < 0.01, f"{frac:.4f} of codes differ"


def smoke():
    """``chip_smoke.py`` as a module: the kernel cases it checks."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _codes(g, dev, *shape):
    return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8
                         ).to(dev)


@pytest.mark.parametrize("B,H,W,C,K,pad,stride,dtype,epilogue", [
    (1, 64, 64, 4, 320, 1, 1, torch.bfloat16, False),    # conv_in
    (1, 64, 64, 320, 4, 1, 1, torch.bfloat16, False),    # conv_out
    (1, 16, 16, 640, 1280, 1, 1, torch.bfloat16, True),  # temb + residual
    (1, 64, 64, 320, 320, 1, 2, torch.bfloat16, False),  # downsampler
    (2, 9, 7, 12, 8, 0, 1, torch.float32, True),         # byte paths, pad 0
    (2, 9, 6, 24, 40, 1, 2, torch.float32, True),        # odd, stride 2
])
def test_qconv_kernel(dev, B, H, W, C, K, pad, stride, dtype, epilogue):
    from mixdq_tpu_torch.ops.qconv import qconv2d, qconv2d_plain, qconv2d_s2

    g = torch.Generator().manual_seed(0)
    x, w = _codes(g, dev, B, H, W, C), _codes(g, dev, 3, 3, C, K)
    scale = ((torch.rand(K, generator=g) + 0.5) * 1e-4).to(dev)
    bias0 = (-5.0 * w.int().sum((0, 1, 2))).float()
    bias = torch.randn(K, generator=g).to(dev, dtype)
    P, Q = (H + 2 * pad - 3) // stride + 1, (W + 2 * pad - 3) // stride + 1
    eb = torch.randn(B, K, generator=g).to(dev, dtype) if epilogue else None
    res = (torch.randn(B, P, Q, K, generator=g).to(dev, dtype)
           if epilogue else None)
    fn = qconv2d if stride == 1 else qconv2d_s2
    got = fn(x, w, scale, bias0, -5.0, bias=bias, extra_bias=eb,
             residual=res, padding=(pad, pad), out_dtype=dtype)
    want = qconv2d_plain(x, w, scale, bias0, -5.0, bias, eb, res, stride,
                         (pad, pad), dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("shape,groups,silu,eps,dtype", [
    ((1, 64, 64, 320), 32, True, 1e-5, torch.bfloat16),
    ((1, 32, 32, 640), 32, False, 1e-6, torch.bfloat16),
    ((2, 5, 7, 96), 32, True, 1e-5, torch.bfloat16),
    ((1, 64, 64, 960), 32, True, 1e-5, torch.bfloat16),
    ((1, 16, 16, 2560), 32, True, 1e-5, torch.bfloat16),
    ((1, 32, 32, 640), 32, True, 1e-5, torch.float32),   # f32 x
    ((2, 32, 32, 1280), 32, True, 1e-5, torch.bfloat16),  # B = 2
    ((1, 3, 5, 96), 32, True, 1e-5, torch.bfloat16),      # N < 64 rows
    ((2, 7, 9, 96), 32, False, 1e-5, torch.float32),      # N < 64, f32
    ((1, 6, 5, 36), 4, True, 1e-5, torch.bfloat16),       # C % 8 != 0
    ((2, 4, 4, 33), 3, True, 1e-5, torch.bfloat16),       # C odd
])
def test_gn_quant_kernel(dev, shape, groups, silu, eps, dtype):
    from mixdq_tpu_torch.ops.gn_quant import (gn_silu_quantize,
                                              gn_silu_quantize_plain)

    g = torch.Generator().manual_seed(1)
    C = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + 0.3).to(dev, dtype)
    gamma = (torch.rand(C, generator=g) + 0.5).to(dev)
    beta = (torch.randn(C, generator=g) * 0.2).to(dev)
    got = gn_silu_quantize(x, gamma, beta, 30.0, -5.0, groups, eps, silu)
    want = gn_silu_quantize_plain(x, gamma, beta, 30.0, -5.0, groups, eps,
                                  silu)
    torch.cuda.synchronize()
    assert_codes_close(got, want)


@pytest.mark.parametrize("shape,dtype,offset", [
    ((1, 1024, 640), torch.bfloat16, 0),
    ((1, 256, 1280), torch.bfloat16, 0),
    ((3, 7, 40), torch.bfloat16, 0),
    ((1, 4096, 640), torch.bfloat16, 0),   # 1024 px, 64x64
    ((1, 1024, 1280), torch.bfloat16, 0),  # 1024 px, 32x32
    ((1, 256, 1280), torch.float32, 0),    # f32 rows
    ((2, 50, 2560), torch.float32, 0),     # 10 KB f32 rows
    ((5, 33, 40), torch.float32, 0),
    ((4, 9, 77), torch.bfloat16, 0),       # C % 8 != 0: scalar loads
    ((4, 9, 77), torch.float32, 0),
    ((1, 256, 1280), torch.bfloat16, 1),   # a view off 16 bytes
    ((2, 64, 640), torch.float32, 3),
])
def test_ln_quant_kernel(dev, shape, dtype, offset):
    """Against the plain version; a view at an odd element offset takes
    the scalar loads and must give the aligned copy's codes bit for bit
    (both paths sum in the same order)."""
    from mixdq_tpu_torch.ops.ln_quant import ln_quantize, ln_quantize_plain

    g = torch.Generator().manual_seed(2)
    C = shape[-1]
    x = (torch.randn(shape, generator=g) * 3 + 1).to(dev, dtype)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
        buf[offset:].copy_(x.reshape(-1))
        x_view = buf[offset:].view(shape)
        assert x_view.data_ptr() % 16
    gamma = (torch.rand(C, generator=g) + 0.5).to(dev)
    beta = (torch.randn(C, generator=g) * 0.2).to(dev)
    got = ln_quantize(x, gamma, beta, 20.0, 3.0)
    want = ln_quantize_plain(x, gamma, beta, 20.0, 3.0)
    torch.cuda.synchronize()
    assert_codes_close(got, want)
    if offset:
        assert torch.equal(ln_quantize(x_view, gamma, beta, 20.0, 3.0), got)


@pytest.mark.parametrize("M,K,H,gelu_tanh,with_bias", [
    (1024, 640, 2560, True, True),
    (256, 1280, 5120, False, True),
    (37, 40, 24, True, False),  # widths not multiples of 16
    (1024, 1280, 5120, True, True),  # 1024 px
    (4096, 640, 2560, True, True),   # 1024 px
    (1, 1280, 5120, True, True),     # M = 1
    (300, 1000, 640, True, True),    # K % 128 != 0, ragged M
    (200, 640, 2576, False, True),   # H % 64 != 0, H % 16 == 0
    (129, 1280, 100, True, False),   # H % 16 != 0: 4-byte copies
    (50, 96, 37, True, True),        # H odd: byte copies
    (64, 640, 2560, True, True),     # the plan splits K (40 tiles)
])
def test_geglu_kernel(dev, M, K, H, gelu_tanh, with_bias):
    from mixdq_tpu_torch.ops.qmatmul import (geglu_qmatmul,
                                             geglu_qmatmul_plain)

    g = torch.Generator().manual_seed(3)
    x, w = _codes(g, dev, M, K), _codes(g, dev, K, 2 * H)
    scale = ((torch.rand(2 * H, generator=g) + 0.5) * 2e-5).to(dev)
    bias0 = (7.0 * w.int().sum(0)).float()
    bias = ((torch.randn(2 * H, generator=g) * 0.3).to(dev, torch.bfloat16)
            if with_bias else None)
    got = geglu_qmatmul(x, w, scale, bias0, 25.0, 4.0, bias, gelu_tanh)
    want = geglu_qmatmul_plain(x, w, scale, bias0, 25.0, 4.0, bias,
                               gelu_tanh)
    torch.cuda.synchronize()
    assert_codes_close(got, want)


@pytest.mark.parametrize("M,K,N", [(1, 320, 1280), (77, 2048, 1280),
                                   (5, 20, 12)])
def test_qlinear_int_mm(dev, M, K, N):
    """``qlinear`` on CUDA (the ``qmatmul`` kernel) against the exact
    float64 product on the CPU."""
    from mixdq_tpu_torch.ops.qops import qlinear

    g = torch.Generator().manual_seed(4)
    x, w = _codes(g, dev, M, K), _codes(g, dev, K, N)
    scale = torch.rand(N, generator=g).to(dev) * 1e-4
    bias0 = (3.0 * w.int().sum(0)).float()
    got = qlinear(x, w, scale, bias0, out_dtype=torch.float32)
    want = qlinear(x.cpu(), w.cpu(), scale.cpu(), bias0.cpu(),
                   out_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,K,N,with_bias,dtype", [
    (1, 1280, 1280, True, torch.bfloat16),     # time_emb_proj
    (77, 2048, 2560, False, torch.bfloat16),   # attn2 to_kv
    (256, 5120, 1280, True, torch.bfloat16),   # ff.net.2 at 16x16
    (1024, 2560, 640, True, torch.bfloat16),   # ff.net.2 at 32x32
    (4096, 960, 320, True, torch.bfloat16),    # conv_shortcut at 64x64
    (37, 40, 40, True, torch.float32),         # ragged, f32 out
])
def test_qmatmul_kernel(dev, M, K, N, with_bias, dtype):
    from mixdq_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

    g = torch.Generator().manual_seed(5)
    x, w = _codes(g, dev, M, K), _codes(g, dev, K, N)
    scale = ((torch.rand(N, generator=g) + 0.5) * 1e-5).to(dev)
    bias0 = (-9.0 * w.int().sum(0)).float()
    bias = torch.randn(N, generator=g).to(dev, dtype) if with_bias else None
    got = qmatmul(x, w, scale, bias0, bias, dtype)
    want = qmatmul_plain(x, w, scale, bias0, bias, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("M", [1, 77, 256, 1000])
@pytest.mark.parametrize("K,N,bias_dtype,dtype", [
    (2056, 1280, torch.bfloat16, torch.bfloat16),  # K not a whole k step
    (40, 1000, torch.float32, torch.bfloat16),     # one partial step
    (1280, 40, None, torch.float32),               # ragged N, f32 out
    (5120, 1280, torch.float32, torch.float32),    # the longest split
])
def test_qmatmul_split_regimes(dev, M, K, N, bias_dtype, dtype):
    """``qmatmul`` under every plan regime (one split, split-K with a
    partial last step, ragged N): equal to its plain version bit for bit,
    since the int32 sums are exact in any split and order, and two calls
    equal each other."""
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain, qmm_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = qmm_plan(M, K, N, sms)
    g = torch.Generator().manual_seed(15)
    x, w = _codes(g, dev, M, K), _codes(g, dev, K, N)
    scale = ((torch.rand(N, generator=g) + 0.5) * 1e-5).to(dev)
    bias0 = (-9.0 * w.int().sum(0)).float()
    bias = (None if bias_dtype is None
            else torch.randn(N, generator=g).to(dev, bias_dtype))
    ops.reset_counts()
    a = qmatmul(x, w, scale, bias0, bias, dtype)
    b = qmatmul(x, w, scale, bias0, bias, dtype)
    want = qmatmul_plain(x, w, scale, bias0, bias, dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qmatmul"] == ops.call_counts()["qmatmul"] == 2
    assert a.dtype == dtype and a.shape == (M, N)
    assert torch.equal(a, want), (plan, (a.float() - want.float()).abs().max())
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,W,C,K,stride,dtype,epilogue", [
    (1, 16, 16, 1280, 1280, 1, torch.bfloat16, True),   # 16x16, split-K
    (1, 16, 16, 2560, 1280, 1, torch.bfloat16, True),   # the longest Kdim
    (2, 16, 16, 640, 1280, 1, torch.float32, True),     # two images
    (1, 64, 64, 320, 320, 2, torch.bfloat16, False),    # stride 2, split
    (1, 32, 32, 640, 640, 2, torch.bfloat16, True),     # stride 2, 13 splits
    (2, 9, 6, 24, 40, 2, torch.float32, True),          # odd, ragged K
    (1, 64, 64, 4, 320, 1, torch.bfloat16, False),      # C % 16 != 0
    (1, 64, 64, 320, 4, 1, torch.bfloat16, False),      # K % 16 != 0
    (2, 7, 9, 12, 8, 1, torch.float32, True),           # both, bytes
])
def test_qconv_split_regimes(dev, B, H, W, C, K, stride, dtype, epilogue):
    """``qconv2d`` / ``qconv2d_s2`` with split-K, a border of zero-point
    taps (pad 1, zp -5), stride 2 and the byte paths: equal to the plain
    version bit for bit, and two calls equal each other; bias and the
    extra bias in bf16 and f32 alike (read as stored)."""
    from mixdq_tpu_torch.ops.qconv import qconv2d, qconv2d_plain, qconv2d_s2

    g = torch.Generator().manual_seed(16)
    x, w = _codes(g, dev, B, H, W, C), _codes(g, dev, 3, 3, C, K)
    scale = ((torch.rand(K, generator=g) + 0.5) * 1e-4).to(dev)
    bias0 = (-5.0 * w.int().sum((0, 1, 2))).float()
    bias = torch.randn(K, generator=g).to(dev, torch.bfloat16)
    P, Q = (H - 1) // stride + 1, (W - 1) // stride + 1
    eb = torch.randn(B, K, generator=g).to(dev) if epilogue else None
    res = (torch.randn(B, P, Q, K, generator=g).to(dev, dtype)
           if epilogue else None)
    fn = qconv2d if stride == 1 else qconv2d_s2
    kw = dict(bias=bias, extra_bias=eb, residual=res, out_dtype=dtype)
    a = fn(x, w, scale, bias0, -5.0, **kw)
    b = fn(x, w, scale, bias0, -5.0, **kw)
    want = qconv2d_plain(x, w, scale, bias0, -5.0, stride=stride, **kw)
    torch.cuda.synchronize()
    assert a.shape == (B, P, Q, K) and a.dtype == dtype
    assert torch.equal(a, want), (a.float() - want.float()).abs().max()
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,T,heads,d", [
    (1, 1024, 10, 64),   # SDXL-Turbo attn1 at 32x32
    (1, 256, 20, 64),    # attn1 at 16x16 (split QKV GEMM, streamed keys)
    (2, 100, 2, 16),     # ragged T, small heads
    (1, 72, 3, 32),
    (2, 40, 2, 128),
    # C = 512: two splits of the QKV GEMM; M = 400 / 200 / 300 ragged over
    # 128-row tiles; keys in place (d = 16 / 64: T <= 256 / 224) or
    # streamed (d = 32 / 128)
    (2, 200, 32, 16),
    (2, 200, 8, 64),
    (1, 300, 16, 32),
    (1, 200, 4, 128),
])
def test_sec_attention_qkv_kernel(dev, B, T, heads, d):
    from mixdq_tpu_torch.ops import sec_attention as sa

    g = torch.Generator(device=dev).manual_seed(6)
    args, kw = smoke().qkv_case(torch, g, dev, B, T, heads, d)
    with sa.probe() as recs:
        got = sa.sec_attention_qkv(*args, **kw)
    want = sa.sec_attention_qkv_plain(*args, **kw)
    # the fused QKV GEMM's workspace: its plain product bit for bit
    proj = sa._proj_plain(*args[:4], torch.bfloat16)
    torch.cuda.synchronize()
    assert len(recs) == 1 and torch.equal(recs[0]["proj"], proj)
    assert_codes_close(got, want)


@pytest.mark.parametrize("B,Tq,heads,d,C_in,dtype,ln", [
    (1, 1024, 10, 64, 640, torch.bfloat16, True),   # attn2 at 32x32
    (1, 256, 20, 64, 1280, torch.bfloat16, True),   # attn2 at 16x16
    (1, 256, 20, 64, 1280, torch.bfloat16, False),  # pre-coded + residual
    (2, 50, 3, 32, 96, torch.bfloat16, True),       # ragged Tq, odd heads
    (2, 40, 2, 128, 256, torch.bfloat16, False),
    (1, 64, 2, 64, 320, torch.bfloat16, True),      # C_in != heads * d
    (1, 70, 2, 16, 32, torch.float32, True),        # f32 (tiny-sdxl)
    (2, 33, 5, 64, 320, torch.float32, False),
    # C = C_in = 512: both GEMMs in two splits, M = 400 ragged over
    # 128-row tiles; every head dim; C_in != heads * d with ragged widths
    # (run-time copy modes), f32 at a split
    (2, 200, 8, 64, 512, torch.bfloat16, True),
    (1, 130, 32, 16, 512, torch.bfloat16, False),
    (2, 100, 16, 32, 512, torch.float32, True),
    (1, 200, 4, 128, 384, torch.bfloat16, True),
    (1, 90, 2, 64, 200, torch.bfloat16, True),
    (2, 70, 4, 32, 200, torch.float32, False),
])
def test_sec_attention_q_out_kernel(dev, B, Tq, heads, d, C_in, dtype, ln):
    from mixdq_tpu_torch.ops import sec_attention as sa

    g = torch.Generator(device=dev).manual_seed(7)
    args, kw = smoke().q_out_case(torch, g, dev, B, Tq, 77, heads, d, C_in,
                                  dtype, ln)
    with sa.probe() as recs:
        got = sa.sec_attention_q_out(*args, **kw)
    want = sa.sec_attention_q_out_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Tq, C_in)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)
    # both GEMM stages bit for bit against their plain products on the
    # kernel's own codes (to_q: the LN codes it wrote; to_out: its to_out
    # codes), the residual the raw input in LN-folded mode
    (rec,) = recs
    x, wq, sq, b0q, _, _, _, _, wout, so, b0o, bo, residual = args
    assert torch.equal(rec["proj"],
                       sa._proj_plain(rec["codes"], wq, sq, b0q, dtype))
    assert torch.equal(got, sa._out_proj_plain(
        rec["o"], wout, so, b0o, bo, x if ln else residual, dtype))


@pytest.mark.parametrize("B,Tq,Tk,heads,d,dtype,self_attn", [
    (1, 4096, 4096, 10, 64, torch.bfloat16, True),  # SDXL 1024 attn1, 64x64
    (2, 300, 300, 3, 64, torch.bfloat16, True),     # ragged Tq/Tk, odd heads
    (1, 200, 77, 2, 128, torch.bfloat16, False),    # d=128, masked tail
    (2, 130, 130, 4, 16, torch.bfloat16, True),
    (1, 100, 90, 2, 32, torch.float32, False),      # f32 scalar path
    (2, 70, 70, 2, 128, torch.float32, True),
    # mha's 1024-key blocks: a full block then a masked ragged one
    (1, 256, 1100, 2, 64, torch.bfloat16, False),
    (1, 200, 2100, 2, 128, torch.bfloat16, False),
    (1, 100, 1300, 2, 32, torch.float32, False),
    # the bf16 ring (4 stages of 32 keys, 3 in flight) and 64-row tile: Tq
    # off the tile, Tk around the prologue (96), the ring (128, 256) and
    # a key block plus one, every head dim (cross: self-attention takes
    # Tk = Tq)
    (1, 4000, 4000, 2, 64, torch.bfloat16, True),
    (1, 100, 95, 2, 16, torch.bfloat16, False),
    (1, 100, 97, 2, 32, torch.bfloat16, False),
    (2, 70, 127, 2, 64, torch.bfloat16, False),
    (1, 130, 129, 3, 128, torch.bfloat16, False),
    (1, 64, 255, 2, 64, torch.bfloat16, False),
    (1, 65, 257, 2, 128, torch.bfloat16, False),
    (1, 300, 1025, 2, 32, torch.bfloat16, False),
])
def test_flash_attention_kernel(dev, B, Tq, Tk, heads, d, dtype, self_attn):
    from mixdq_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(8)
    srcs, kw = smoke().attn_case(torch, g, dev, B, Tq, Tk, heads, d, dtype,
                                 not self_attn)
    got = flash_attention(*srcs, **kw)
    want = flash_attention_plain(*srcs, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Tq, heads * d)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2)
    else:  # p rounds to bf16 against a running max (chip_smoke.py)
        smoke().flash_err(torch, got, want)


@pytest.mark.parametrize("B,Tq,Tk,heads,d,dtype,cross", [
    (1, 1024, 1024, 20, 64, torch.bfloat16, False),  # SDXL 1024 attn1, 32x32
    (1, 4096, 77, 10, 64, torch.bfloat16, True),     # attn2 at 64x64
    (2, 100, 100, 3, 32, torch.bfloat16, False),     # ragged, odd heads
    (2, 50, 77, 2, 128, torch.bfloat16, True),
    (1, 70, 70, 2, 16, torch.float32, False),        # f32 scalar path
    (2, 33, 77, 5, 64, torch.float32, True),
])
def test_sec_attention_kernel(dev, B, Tq, Tk, heads, d, dtype, cross):
    from mixdq_tpu_torch.ops.sec_attention import (sec_attention,
                                                   sec_attention_plain)

    g = torch.Generator(device=dev).manual_seed(9)
    srcs, kw = smoke().attn_case(torch, g, dev, B, Tq, Tk, heads, d, dtype,
                                 cross)
    got = sec_attention(*srcs, 40.0, -3.0, **kw)
    want = sec_attention_plain(*srcs, 40.0, -3.0, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (B, Tq, heads * d)
    assert_codes_close(got, want)


@pytest.mark.parametrize("B,Tq,heads,d,C_in,dtype", [
    (1, 1024, 20, 64, 1280, torch.bfloat16),  # SDXL 1024 attn2, 32x32
    (2, 1024, 20, 64, 1280, torch.bfloat16),
    (2, 50, 3, 32, 96, torch.bfloat16),       # ragged Tq, odd heads
    (1, 64, 2, 128, 320, torch.bfloat16),     # C_in != heads * d
    (2, 33, 5, 64, 320, torch.float32),       # f32 (k/v dtype) path
])
def test_sec_attention_q_kernel(dev, B, Tq, heads, d, C_in, dtype):
    from mixdq_tpu_torch.ops.sec_attention import (sec_attention_q,
                                                   sec_attention_q_plain)

    g = torch.Generator(device=dev).manual_seed(10)
    args, kw = smoke().sec_q_case(torch, g, dev, B, Tq, 77, heads, d, C_in,
                                  dtype)
    got = sec_attention_q(*args, **kw)
    want = sec_attention_q_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (B, Tq, heads * d)
    assert_codes_close(got, want)


#: wq4/wq_matmul shapes of the weight-only SDXL-Turbo step: ff.net.0.proj
#: at 32x32, ff.net.2 at 16x16, to_k/to_v on the text, time_emb_proj, and
#: ragged N / K / M
WQ_SHAPES = [(1024, 640, 5120), (256, 5120, 1280), (77, 2048, 1280),
             (1, 1280, 1280), (77, 2048, 1000), (33, 72, 20), (5, 100, 37),
             # split-K regimes of wq_plan on 132 SMs: M = 1 / 77 / 256
             # split, K = 2056 no multiple of splits x k step, ragged and
             # odd N (4-byte and byte weight copies), M = 1000 on 128-row
             # tiles (no split)
             (1, 2056, 1280), (77, 2056, 1000), (256, 2056, 1280),
             (1, 640, 999), (1000, 640, 1280), (129, 640, 130)]


def wq_err(got, want):
    """max |d| <= 2 bf16 ulps of max |want| and |d| / |want| <= 1e-2 (the
    two sum the same bf16 products in f32 in other orders)."""
    import math

    d = (got.float() - want.float())
    lim = 2 * 2.0 ** (math.floor(math.log2(want.float().abs().max().item()))
                      - 7)
    assert d.abs().max().item() <= lim, (d.abs().max().item(), lim)
    assert (d.norm() / want.float().norm()).item() <= 1e-2


@pytest.mark.parametrize("M,K,N", WQ_SHAPES)
@pytest.mark.parametrize("w4", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wq_matmul_kernels(dev, M, K, N, w4, dtype):
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops import wq_matmul as wq

    g = torch.Generator().manual_seed(11)
    x = torch.randn(M, K, generator=g).to(dev, dtype)
    lo = -8 if w4 else -128
    w = torch.randint(lo, -lo, (K, N), generator=g, dtype=torch.int8).to(dev)
    s = ((torch.rand(N, generator=g) + 0.5) / (K ** 0.5 * -lo)).to(dev)
    bias = None if w4 else torch.randn(N, generator=g).to(dev)
    ops.reset_counts()
    if w4:
        packed = wq.pack_w4_halves(w)
        got = wq.wq4_matmul(x, packed, s, out_dtype=dtype)
        want = wq.wq4_matmul_plain(x, packed, s, out_dtype=dtype)
    else:
        got = wq.wq_matmul(x, w, s, bias, out_dtype=dtype)
        want = wq.wq_matmul_plain(x, w, s, bias, out_dtype=dtype)
    torch.cuda.synchronize()
    name = "wq4_matmul" if w4 else "wq_matmul"
    # a CUDA tensor launches the kernel; the plain version is never taken
    assert ops.launch_counts()[name] == ops.call_counts()[name] == 1
    assert got.dtype == dtype and got.shape == (M, N) and got.is_cuda
    wq_err(got, want)


@pytest.mark.parametrize("M,K,N", [(1, 1280, 1280), (77, 2048, 1280),
                                   (256, 5120, 1280), (77, 2056, 1000)])
@pytest.mark.parametrize("w4", [True, False])
def test_wq_matmul_split_k_deterministic(dev, M, K, N, w4):
    """Split-K sums its partials in a fixed order: two calls agree bit for
    bit."""
    from mixdq_tpu_torch.ops import wq_matmul as wq

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert wq.wq_plan(M, K, N, w4, sms).splits > 1
    g = torch.Generator().manual_seed(14)
    x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    lo = -8 if w4 else -128
    w = torch.randint(lo, -lo, (K, N), generator=g, dtype=torch.int8).to(dev)
    s = ((torch.rand(N, generator=g) + 0.5) / (K ** 0.5 * -lo)).to(dev)
    if w4:
        packed = wq.pack_w4_halves(w)
        a, b = (wq.wq4_matmul(x, packed, s) for _ in range(2))
    else:
        bias = torch.randn(N, generator=g).to(dev)
        a, b = (wq.wq_matmul(x, w, s, bias) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,T,heads,d,dtype,ln", [
    (1, 1024, 10, 64, torch.bfloat16, True),   # SDXL-Turbo attn1 at 32x32
    (1, 256, 20, 64, torch.bfloat16, False),   # 16x16, pre-coded + residual
    (2, 100, 2, 16, torch.bfloat16, True),     # ragged T, small heads
    (2, 40, 2, 128, torch.bfloat16, False),
    (1, 64, 2, 64, torch.float32, True),       # f32 (small-sdxl)
    (2, 33, 3, 32, torch.float32, False),
])
def test_sec_attention_qkv_out_kernel(dev, B, T, heads, d, dtype, ln):
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops.sec_attention import (
        sec_attention_qkv_out, sec_attention_qkv_out_plain)

    g = torch.Generator(device=dev).manual_seed(12)
    args, kw = smoke().qkv_out_case(torch, g, dev, B, T, heads, d, dtype, ln)
    ops.reset_counts()
    got = sec_attention_qkv_out(*args, **kw)
    want = sec_attention_qkv_out_plain(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sec_attention_qkv_out"] == 1
    assert got.dtype == dtype and got.shape == (B, T, heads * d)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("M,K,H,C,dtype,ln", [
    (1024, 640, 2560, 640, torch.bfloat16, True),     # ff at 32x32
    (256, 1280, 5120, 1280, torch.bfloat16, False),   # 16x16, pre-coded
    (50, 128, 100, 128, torch.bfloat16, True),        # ragged H, M < 64
    (37, 40, 24, 40, torch.float32, False),           # widths not x16
    (64, 128, 512, 128, torch.float32, True),         # f32 (small-sdxl)
    (1, 640, 2560, 640, torch.bfloat16, True),        # M = 1: split plans
    (77, 1280, 5120, 1280, torch.bfloat16, False),    # M = 77
    (77, 640, 2560, 640, torch.bfloat16, True),
    (256, 640, 2560, 640, torch.float32, False),      # f32 out, pre-coded
    (40, 77, 200, 77, torch.bfloat16, True),          # C % 8: scalar LN
])
def test_geglu_out_kernel(dev, M, K, H, C, dtype, ln):
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops.qmatmul import (geglu_out_qmatmul,
                                             geglu_out_qmatmul_plain)

    g = torch.Generator(device=dev).manual_seed(13)
    args, kw = smoke().geglu_out_case(torch, g, dev, M, K, H, C, dtype, ln)
    ops.reset_counts()
    got = geglu_out_qmatmul(*args, **kw)
    want = geglu_out_qmatmul_plain(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["geglu_out_qmatmul"] == 1
    assert got.dtype == dtype and got.shape == (M, C)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("name", ["int8_flash_attention",
                                  "int8qkv_flash_attention"])
@pytest.mark.parametrize("B,Tq,Tk,heads,d,dtype,self_attn", [
    (1, 4096, 4096, 10, 64, torch.bfloat16, True),  # SDXL 1024 attn1, 64x64
    (2, 300, 700, 3, 64, torch.bfloat16, False),    # two key blocks, ragged
    (1, 200, 77, 2, 128, torch.bfloat16, False),    # d=128, masked tail
    (2, 130, 130, 4, 16, torch.bfloat16, True),
    (1, 100, 90, 2, 32, torch.float32, False),      # f32
    (2, 70, 600, 2, 128, torch.float32, False),
    # the key ring's cursor at its edges
    (1, 64, 513, 2, 64, torch.bfloat16, False),     # a key block of one key
    (2, 1, 600, 3, 64, torch.bfloat16, False),      # Tq = 1
    (2, 70, 33, 2, 32, torch.bfloat16, False),      # one stage and one key
    (1, 100, 300, 4, 16, torch.float32, False),     # d=16, int8 v f32 out
])
def test_int8_flash_kernels(dev, name, B, Tq, Tk, heads, d, dtype,
                            self_attn):
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(14)
    srcs, kw = smoke().attn_case(torch, g, dev, B, Tq, Tk, heads, d, dtype,
                                 not self_attn)
    ops.reset_counts()
    got = getattr(attention, name)(*srcs, **kw)
    want = getattr(attention, name + "_plain")(*srcs, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == ops.call_counts()[name] == 1
    assert got.dtype == dtype and got.shape == (B, Tq, heads * d)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2)
    else:  # p rounds against a running max (chip_smoke.py)
        smoke().flash_err(torch, got, want)


@pytest.mark.parametrize("kernel", ["qmatmul_fused", "qmatmul_fused2"])
@pytest.mark.parametrize("M,K,N,xcol", [
    (4096, 640, 640, 0), (1024, 1280, 1280, 0), (1024, 1280, 5120, 0),
    (1024, 5120, 1280, 0),        # the kernel benchmark's shapes
    (48, 300, 130, 0),            # ragged: scalar loads, masked tails
    (200, 1000, 384, 0),          # K % 128 != 0, 16-byte loads
    (1, 1280, 1280, 0),           # M = 1: one live m16 tile, split K
    (256, 1280, 640, 3),          # bf16 x a column slice: unaligned rows
    (256, 1280, 640, 8),          # a column slice of 16-byte rows
    (64, 16384, 128, 0),          # K = 16384: split K, no K limit
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_fused_kernels(dev, kernel, M, K, N, xcol, dtype):
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops import qmatmul as qm

    g = torch.Generator().manual_seed(15)
    x = torch.randn(M, K + xcol, generator=g).to(dev)
    # f32 x: the wrapper casts; a bf16 slice is read in place
    x = x.to(torch.bfloat16)[:, xcol:] if xcol else x
    w = _codes(g, dev, K, N)
    scale = ((torch.rand(N, generator=g) + 0.5) * 1e-5).to(dev)
    bias0 = (-3.0 * w.int().sum(0)).float()
    ops.reset_counts()
    got = getattr(qm, kernel)(x, w, 10.0, -3.0, scale, bias0, dtype)
    want = qm.qmatmul_fused_plain(x, w, 10.0, -3.0, scale, bias0, dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] == ops.call_counts()[kernel] == 1
    assert got.dtype == dtype and got.shape == (M, N)
    smoke().exact_err(torch, got, want)


@pytest.mark.parametrize("kernel", ["qmatmul_fused", "qmatmul_fused2"])
@pytest.mark.parametrize("zp", [-3.0, -3.5, 2.0 ** 22])
def test_qmatmul_fused_quantizer_range(dev, kernel, zp):
    """The kernels' act quantizer against the plain version's at every
    kind of zero point (integer-valued ones take the f32 rounding path,
    any other ``quant_code``) on values that round to ties, saturate, and
    lie past 2^22 once scaled."""
    from mixdq_tpu_torch.ops import qmatmul as qm

    g = torch.Generator().manual_seed(16)
    M, K, N = 256, 640, 256
    x = torch.randn(M, K, generator=g) * 20
    x[:, :64] = (torch.arange(64) - 32).float() * 0.25  # ties at * 10
    x[0, 64:72] = torch.tensor([3e6, -3e6, 1e30, -1e30, 4.2e5, -4.2e5,
                                1e-30, 0.0])
    x = x.to(dev, torch.bfloat16)
    w = _codes(g, dev, K, N)
    scale = ((torch.rand(N, generator=g) + 0.5) * 1e-5).to(dev)
    bias0 = (-3.0 * w.int().sum(0)).float()
    got = getattr(qm, kernel)(x, w, 10.0, zp, scale, bias0)
    want = qm.qmatmul_fused_plain(x, w, 10.0, zp, scale, bias0)
    torch.cuda.synchronize()
    smoke().exact_err(torch, got, want)


@pytest.mark.parametrize("B,H,C,K", [
    (1, 32, 128, 3),    # the VAE's conv_out: N = 3
    (2, 16, 4, 512),    # the VAE's conv_in: C = 4
    (2, 24, 256, 128),  # a 512 -> 256 -> 128 level, B = 2
])
def test_qconv_kernel_vae_shapes(dev, B, H, C, K):
    """The VAE decoder's ragged convs (small maps): equal to the plain
    version bit for bit."""
    from mixdq_tpu_torch.ops.qconv import qconv2d, qconv2d_plain

    g = torch.Generator().manual_seed(2)
    x, w = _codes(g, dev, B, H, H, C), _codes(g, dev, 3, 3, C, K)
    scale = ((torch.rand(K, generator=g) + 0.5) * 1e-4).to(dev)
    bias0 = (-5.0 * w.int().sum((0, 1, 2))).float()
    bias = torch.randn(K, generator=g).to(dev, torch.bfloat16)
    got = qconv2d(x, w, scale, bias0, -5.0, bias=bias)
    want = qconv2d_plain(x, w, scale, bias0, -5.0, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_graphed_step_equals_eager(dev):
    """A CUDA graph of one small-sdxl W8A8 ``auto`` step (the whole-
    attention kernels, cooperative launches included) replays equal bit for
    bit to the eager step on the same inputs, and records each kernel
    launch of the step (``ctx_kernel_calls``)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall

    unet = pipeline.build_unet("small-sdxl", 0, torch.float32, dev)
    req = pipeline.example_inputs("small-sdxl", 1, 3, torch.float32, dev)
    ctx = pipeline.quantize_w8a8(unet, req)
    sample, t, ehs, added = req
    want = pipeline.unet_step(unet, req, ctx)
    g = GraphedCall(lambda s: unet(s, t, ehs, added, ctx=ctx), (sample,))
    got = g(sample)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert g.launches == pipeline.ctx_kernel_calls(unet.config, ctx)
    assert g.launches["sec_attention_qkv"] > 0
    other = pipeline.example_inputs("small-sdxl", 1, 4, torch.float32, dev)
    got2 = g(other[0])
    assert torch.equal(got2.clone(), pipeline.unet_step(
        unet, (other[0], t, ehs, added), ctx))


def test_graphed_serving_engine(dev):
    """A tiny-sdxl ``ServingEngine`` (W8A8 UNet, one captured graph a
    batch): the same images for the same seed, other images for another
    seed, equal to the eager ``run`` on the same noise, and the capture
    records every kernel launch of the UNet step."""
    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.serving import ServingEngine
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline

    pipe = Text2ImgPipeline("tiny-sdxl", torch.float32, dev).init_weights(0)
    calib = pipeline.example_inputs("tiny-sdxl", 2, 1, torch.float32, dev)
    ctx = pipeline.quantize_w8a8(pipe.unet, calib)
    eng = ServingEngine(pipe, ctx, batch_size=2, steps=1).compile()
    prompts = ["a red cube", "a blue sphere"]
    a = eng.generate(prompts, seed=1)
    b = eng.generate(prompts, seed=1)
    c = eng.generate(prompts, seed=2)
    assert a.shape == (2, 128, 128, 3) and np.isfinite(a).all()
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert 0.0 <= a.min() and a.max() <= 1.0
    eager = eng.run(*eng.inputs(prompts, 1)).float().cpu().numpy()
    assert np.array_equal(a, eager)
    assert eng.launches == pipeline.ctx_kernel_calls(pipe.unet.config, ctx)


@pytest.mark.parametrize("family,steps", [("tiny-sdxl", 1),
                                          ("tiny-sd15", 4)])
def test_graphed_engine_marks(dev, family, steps):
    """The marks a ``ServingEngine`` capture records into its graph (2 +
    2 S + 2 timing events) resolve after every replay, tracing off and
    on; with them in the graph the replay still equals the eager ``run``
    bit for bit, tracing on and off give the same images, and the capture
    counts S steps' kernel launches, as before the marks."""
    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.serving import ServingEngine, phases
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline
    from mixdq_tpu_torch.utils import profiling

    pipe = Text2ImgPipeline(family, torch.float32, dev).init_weights(0)
    calib = pipeline.example_inputs(family, 2, 1, torch.float32, dev)
    ctx = pipeline.quantize_w8a8(pipe.unet, calib)
    eng = ServingEngine(pipe, ctx, batch_size=2, steps=steps).compile()
    graph = eng._graph
    names = (["run.begin", "towers.end"] + ["unet.begin", "unet.end"] * steps
             + ["vae.begin", "run.end"])
    assert [n for n, _ in graph.marks] == names
    prompts = ["a red cube", "a blue sphere"]
    off = []
    for seed in range(3):
        off.append(eng.generate(prompts, seed=seed))
        ms = [graph.marks[0][1].elapsed_time(e) for _, e in graph.marks]
        assert ms == sorted(ms) and ms[-1] > 0
    eager = eng.run(*eng.inputs(prompts, 2)).float().cpu().numpy()
    assert np.array_equal(off[2], eager)
    with profiling.tracing() as tracer:
        on = [eng.generate(prompts, seed=seed) for seed in range(3)]
    assert all(np.array_equal(a, b) for a, b in zip(on, off))
    reqs = tracer.drain()
    assert len(reqs) == 3
    for req in reqs:
        spans = {s.name: s for s in req.spans}
        assert [s.name for s in req.spans] == [
            "engine.request", "engine.tokenize", "engine.noise",
            "engine.copy_in", "engine.launch", "engine.wait",
            "engine.to_host"]
        assert [m.name for m in req.marks] == names
        t = [m.t_ns for m in req.marks]
        assert t == sorted(t)
        assert spans["engine.copy_in"].start_ns <= t[0]
        assert t[-1] <= spans["engine.wait"].end_ns
        ph = phases(req.marks)
        assert min(ph.values()) >= 0 and ph["run"] == t[-1] - t[0]
    per_step = pipeline.ctx_kernel_calls(pipe.unet.config, ctx)
    assert eng.launches == {k: steps * v for k, v in per_step.items()}


def _split_unet(dev, dtype=torch.float32):
    """tiny-sdxl on the card in ``dtype``, calibrated with its channel splits and
    deployed W8A8 (``int8_sec``, fused QKV/KV, ``conv_split`` entries)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.unet import conv_shortcut_splits
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    unet = pipeline.build_unet("tiny-sdxl", 0, dtype, dev)
    req = pipeline.example_inputs("tiny-sdxl", 1, 5, dtype, dev)
    splits = conv_shortcut_splits(unet.config)
    qparams = calibrate(unet, [req], pipeline.WQ, pipeline.AQ, splits=splits)
    ctx = deploy_unet_ctx(unet, qparams,
                          uniform_ctrl(list(quantizable_layers(unet))),
                          pipeline.WQ, fuse_qkv=True, splits=splits)
    assert sum(e.kind == "conv_split" for e in ctx.deploy.values()) == 6
    return unet, req, ctx, splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_split_entry_equals_plain(dev, dtype):
    """A ``conv_split`` entry under ``int8_sec`` (two act-quantizes, two
    ``qmatmul`` launches, the bias on part0's) equals the same sum of the
    plain ``qmatmul_plain`` products bit for bit."""
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.ops.qmatmul import qmatmul_plain
    from mixdq_tpu_torch.ops.qops import act_clip_range, quantize_per_tensor
    from mixdq_tpu_torch.quant.state import quantizable_layers

    unet, req, ctx, splits = _split_unet(dev, dtype)
    seen = {}
    name = "up_blocks.0.resnets.0.conv_shortcut"
    layer = quantizable_layers(unet)[name]

    def hook(mod, args, kwargs):
        seen["x"] = args[0]

    h = layer.register_forward_pre_hook(hook, with_kwargs=True)
    with torch.inference_mode():
        unet(*req)
    h.remove()
    x = seen["x"] * 3  # past the calibrated range: clipped codes
    e = ctx.deploy[name]
    s = e.split
    ops.reset_counts()
    with torch.inference_mode():
        got = layer(x, ctx, split=s)
        torch.cuda.synchronize()
        assert ops.launch_counts()["qmatmul"] == 2
        ys = []
        for xh, p, b in ((x[..., :s], e.part0, layer.bias),
                         (x[..., s:], e.part1, None)):
            c = quantize_per_tensor(xh, p.scale_inv, p.zp_shifted,
                                    *act_clip_range(p.a_bits))
            C = c.shape[-1]
            ys.append(qmatmul_plain(c.reshape(-1, C), p.w_int.reshape(C, -1),
                                    p.scale, p.bias0, b, dtype).reshape(
                *c.shape[:-1], -1))
        want = ys[0] + ys[1]
    assert got.dtype == dtype and torch.equal(got, want)


def test_graphed_split_step_equals_eager(dev):
    """A CUDA graph of one tiny-sdxl W8A8 step with ``conv_split`` entries
    replays equal bit for bit to the eager step, and the capture counts
    ``ctx_kernel_calls`` (two ``qmatmul`` launches a split entry)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall

    unet, req, ctx, _ = _split_unet(dev)
    sample, t, ehs, added = req
    want = pipeline.unet_step(unet, req, ctx)
    g = GraphedCall(lambda x: unet(x, t, ehs, added, ctx=ctx), (sample,))
    got = g(sample)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    calls = pipeline.ctx_kernel_calls(unet.config, ctx)
    assert g.launches == calls
    no_split = {n: e for n, e in ctx.deploy.items() if e.kind != "conv_split"}
    assert calls["qmatmul"] == pipeline.expected_kernel_calls(
        unet.config, ctx.attn_impl, deploy=no_split)["qmatmul"] + 12


@pytest.mark.parametrize("kernel", ["qmatmul_fused", "qmatmul_fused2"])
def test_fused_gemms_capture(dev, kernel):
    """The fused act-quantize GEMMs (``qmatmul_fused2`` one cooperative
    launch) captured into a CUDA graph: a replay equals the eager call bit
    for bit, and the capture counts one launch."""
    from mixdq_tpu_torch.ops import qmatmul as qm
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall

    g = torch.Generator().manual_seed(16)
    x = torch.randn(1024, 5120, generator=g).to(dev, torch.bfloat16)
    w = _codes(g, dev, 5120, 1280)
    scale = ((torch.rand(1280, generator=g) + 0.5) * 1e-5).to(dev)
    bias0 = (-3.0 * w.int().sum(0)).float()
    fn = getattr(qm, kernel)
    want = fn(x, w, 10.0, -3.0, scale, bias0)
    graph = GraphedCall(lambda a: fn(a, w, 10.0, -3.0, scale, bias0), (x,))
    got = graph(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert graph.launches[kernel] == 1 and sum(graph.launches.values()) == 1


def test_profiling_on_card(dev):
    """``utils.profiling`` on the card: ``timeit`` (back to back and
    strict) gives a positive time per call, ``measure_memory`` sees the
    call's allocation above the static bytes, ``device_memory_stats``
    reports the allocator's bytes within the card's, and the fingerprint
    is cached."""
    from mixdq_tpu_torch.utils import profiling

    a = torch.ones((1024, 1024), device=dev)
    for strict in (False, True):
        assert profiling.timeit(lambda: a @ a, iters=3, strict=strict) > 0
    mem = profiling.measure_memory(lambda: torch.empty(64 << 20,
                                                       dtype=torch.uint8,
                                                       device=dev))
    assert mem["dynamic_mb"] >= 64 * 1.048 and \
        mem["peak_mb"] >= mem["static_mb"] + mem["dynamic_mb"] - 1e-6
    st = profiling.device_memory_stats(dev)
    assert 0 < st["bytes_in_use_mb"] <= st["peak_bytes_in_use_mb"] \
        < st["bytes_limit_mb"]
    ms = profiling.host_fingerprint(n=1024, iters=2)
    assert ms > 0 and profiling.host_fingerprint(n=1024) == ms


@pytest.mark.parametrize("name", ["flash_attention", "int8_flash_attention",
                                  "int8qkv_flash_attention"])
@pytest.mark.parametrize("B,Tq,Tk,heads,d,self_attn", [
    (1, 1024, 77, 10, 64, False),   # SDXL-Turbo attn2, 32x32
    (1, 256, 77, 20, 64, False),    # SDXL-Turbo attn2, 16x16
    (1, 256, 256, 20, 64, True),    # SDXL-Turbo attn1, 16x16
    (1, 1024, 1024, 10, 64, True),  # SDXL-Turbo attn1, 32x32
    (2, 256, 77, 20, 64, False),
])
def test_explicit_attention_sites(dev, name, B, Tq, Tk, heads, d, self_attn):
    """The kernels an explicit ``attn_impl`` runs at every SDXL-Turbo
    site, ragged key counts (77 text tokens) and Tq = 256 included,
    against their plain versions by ``chip_smoke.flash_err``; the kernel
    reading all but the last 64 keys fails it."""
    from mixdq_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(16)
    srcs, kw = smoke().attn_case(torch, g, dev, B, Tq, Tk, heads, d,
                                 torch.bfloat16, not self_attn)
    got = getattr(attention, name)(*srcs, **kw)
    want = getattr(attention, name + "_plain")(*srcs, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, Tq, heads * d) and got.dtype == torch.bfloat16
    smoke().flash_err(torch, got, want)
    q, k, v = srcs
    bad = getattr(attention, name)(q, k[:, :-64].contiguous(),
                                   v[:, :-64].contiguous(), **kw)
    with pytest.raises(AssertionError):
        smoke().flash_err(torch, bad, want)


@pytest.mark.parametrize("impl", ["auto", "flash", "int8_flash"])
def test_fake_graph_equals_eager(dev, impl):
    """A CUDA graph of one small-sdxl fake-quant step (``fake_quant_ctx``;
    under an explicit ``attn_impl`` too, whose kernel runs at every site)
    replays equal bit for bit to the eager step, and the launches counted
    at capture are ``ctx_kernel_calls``."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall

    unet = pipeline.build_unet("small-sdxl", 0, torch.bfloat16, dev)
    req = pipeline.example_inputs("small-sdxl", 1, 3, torch.bfloat16, dev)
    ctx = dataclasses.replace(pipeline.fake_quant_ctx(unet, req),
                              attn_impl=impl)
    sample, t, ehs, added = req
    want = pipeline.unet_step(unet, req, ctx)
    g = GraphedCall(lambda s: unet(s, t, ehs, added, ctx=ctx), (sample,))
    got = g(sample)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert g.launches == pipeline.ctx_kernel_calls(unet.config, ctx)
    assert sum(g.launches.values()) == (0 if impl == "auto" else 8)
    fp = pipeline.unet_step(unet, req)
    assert not torch.equal(fp, want)
