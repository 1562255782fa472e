"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test needs a CUDA device and skips without one. This file
imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_port_gpu.py

Tolerances: int8 codes max |diff| <= 1 on under 1% of elements; float
outputs rtol 1e-3 / atol 1e-2 (the same integer sums, f32 epilogues that
round at the same steps; bf16 outputs may differ by one bf16 ulp).
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


@pytest.mark.parametrize("shape,groups,silu,eps", [
    ((1, 64, 64, 320), 32, True, 1e-5),
    ((1, 32, 32, 640), 32, False, 1e-6),
    ((2, 5, 7, 96), 32, True, 1e-5),
])
def test_gn_quant_kernel(dev, shape, groups, silu, eps):
    from mixdq_tpu_torch.ops.gn_quant import (gn_silu_quantize,
                                              gn_silu_quantize_plain)

    g = torch.Generator().manual_seed(1)
    C = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + 0.3).to(dev, torch.bfloat16)
    gamma = (torch.rand(C, generator=g) + 0.5).to(dev)
    beta = (torch.randn(C, generator=g) * 0.2).to(dev)
    got = gn_silu_quantize(x, gamma, beta, 30.0, -5.0, groups, eps, silu)
    want = gn_silu_quantize_plain(x, gamma, beta, 30.0, -5.0, groups, eps,
                                  silu)
    torch.cuda.synchronize()
    assert_codes_close(got, want)


@pytest.mark.parametrize("shape", [(1, 1024, 640), (1, 256, 1280),
                                   (3, 7, 40)])
def test_ln_quant_kernel(dev, shape):
    from mixdq_tpu_torch.ops.ln_quant import ln_quantize, ln_quantize_plain

    g = torch.Generator().manual_seed(2)
    C = shape[-1]
    x = (torch.randn(shape, generator=g) * 3 + 1).to(dev, torch.bfloat16)
    gamma = (torch.rand(C, generator=g) + 0.5).to(dev)
    beta = (torch.randn(C, generator=g) * 0.2).to(dev)
    got = ln_quantize(x, gamma, beta, 20.0, 3.0)
    want = ln_quantize_plain(x, gamma, beta, 20.0, 3.0)
    torch.cuda.synchronize()
    assert_codes_close(got, want)


@pytest.mark.parametrize("M,K,H,gelu_tanh,with_bias", [
    (1024, 640, 2560, True, True),
    (256, 1280, 5120, False, True),
    (37, 40, 24, True, False),  # widths not multiples of 16
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


@pytest.mark.parametrize("B,T,heads,d", [
    (1, 1024, 10, 64),   # SDXL-Turbo attn1 at 32x32
    (1, 256, 20, 64),    # attn1 at 16x16
    (2, 100, 2, 16),     # ragged T, small heads
    (1, 72, 3, 32),
    (2, 40, 2, 128),
])
def test_sec_attention_qkv_kernel(dev, B, T, heads, d):
    from mixdq_tpu_torch.ops.sec_attention import (sec_attention_qkv,
                                                   sec_attention_qkv_plain)

    g = torch.Generator(device=dev).manual_seed(6)
    args, kw = smoke().qkv_case(torch, g, dev, B, T, heads, d)
    got = sec_attention_qkv(*args, **kw)
    want = sec_attention_qkv_plain(*args, **kw)
    torch.cuda.synchronize()
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
])
def test_sec_attention_q_out_kernel(dev, B, Tq, heads, d, C_in, dtype, ln):
    from mixdq_tpu_torch.ops.sec_attention import (
        sec_attention_q_out, sec_attention_q_out_plain)

    g = torch.Generator(device=dev).manual_seed(7)
    args, kw = smoke().q_out_case(torch, g, dev, B, Tq, 77, heads, d, C_in,
                                  dtype, ln)
    got = sec_attention_q_out(*args, **kw)
    want = sec_attention_q_out_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Tq, C_in)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("B,Tq,Tk,heads,d,dtype,self_attn", [
    (1, 4096, 4096, 10, 64, torch.bfloat16, True),  # SDXL 1024 attn1, 64x64
    (2, 300, 300, 3, 64, torch.bfloat16, True),     # ragged Tq/Tk, odd heads
    (1, 200, 77, 2, 128, torch.bfloat16, False),    # d=128, masked tail
    (2, 130, 130, 4, 16, torch.bfloat16, True),
    (1, 100, 90, 2, 32, torch.float32, False),      # f32 scalar path
    (2, 70, 70, 2, 128, torch.float32, True),
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
             (1, 1280, 1280), (77, 2048, 1000), (33, 72, 20), (5, 100, 37)]


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
