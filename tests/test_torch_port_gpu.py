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
    """``qlinear`` on CUDA (``torch._int_mm`` with padding) against the
    exact float64 product on the CPU."""
    from mixdq_tpu_torch.ops.qops import qlinear

    g = torch.Generator().manual_seed(4)
    x, w = _codes(g, dev, M, K), _codes(g, dev, K, N)
    scale = torch.rand(N, generator=g).to(dev) * 1e-4
    bias0 = (3.0 * w.int().sum(0)).float()
    got = qlinear(x, w, scale, bias0, out_dtype=torch.float32)
    want = qlinear(x.cpu(), w.cpu(), scale.cpu(), bias0.cpu(),
                   out_dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
