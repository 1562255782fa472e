"""Int8 compute ops with fused dequant epilogues (port of
``mixdq_tpu/ops/qops.py``).

Integer contract: activation codes are asymmetric and shifted into the
signed range (``zp_s = zp - 2^(a_bits-1)``), weights are per-out-channel
symmetric int8, and the zero-point term ``bias0 = zp_s * sum_K(W_int)``
is subtracted in the epilogue. Convolutions pad the code tensor with the
zero-point code, so a padded position represents exactly ``x = 0`` and
``bias0`` is one constant per output channel.

Dense int8 products (``qlinear``, and the 1x1 convs through it) are XLA
ops in the JAX package, not Pallas kernels; here they are
``torch._int_mm`` on CUDA and an exact float64 product on the CPU.
``qconv2d`` is the plain int8 convolution; the model's convs run the
hand-written kernel in ``ops/qconv.py``, whose plain version builds on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def act_clip_range(a_bits: int) -> Tuple[float, float]:
    """(lo, hi) code clip bounds of an ``a_bits`` activation quantizer in
    int8 storage: A8 -> (-128, 127), A4 -> (-8, 7)."""
    half = 1 << (a_bits - 1)
    return float(-half), float(half - 1)


def quantize_per_tensor(x: torch.Tensor, scale_inv: float, zp_shifted: float,
                        lo: float = -128.0, hi: float = 127.0) -> torch.Tensor:
    """fp -> int8 codes ``clip(round(x * (1/s_a)) + zp_s, lo, hi)``, with
    round half to even."""
    codes = torch.round(x.float() * scale_inv) + zp_shifted
    return codes.clamp_(lo, hi).to(torch.int8)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def int_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``x @ w`` of int8 ``[M, K]`` and ``[K, N]``, as int32 (CUDA,
    ``torch._int_mm``) or as integer-valued float64 (CPU; exact since
    ``|sum| <= 2^14 K < 2^53``). cuBLASLt's int8 product refuses small or
    ragged shapes, so zero code rows/columns pad M, K and N to multiples
    of 32 (M > 16); they add 0."""
    if x.device.type != "cuda":
        return x.double() @ w.double()
    M, K = x.shape
    N = w.shape[1]
    Mp, Kp, Np = (_round_up(max(M, 17), 32), _round_up(K, 32),
                  _round_up(N, 32))
    if (Mp, Kp) != (M, K):
        x = F.pad(x, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        w = F.pad(w, (0, Np - N, 0, Kp - K))
    acc = torch._int_mm(x.contiguous(), w.contiguous())
    return acc[:M, :N]


def qlinear(x_int8: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
            bias0: torch.Tensor, bias: Optional[torch.Tensor] = None,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8 matmul ``(acc - bias0) * scale (+ bias)`` over the last axis;
    ``acc`` converts to f32 before the subtraction, as in the reference."""
    lead = x_int8.shape[:-1]
    acc = int_gemm(x_int8.reshape(-1, x_int8.shape[-1]), w_int8)
    out = (acc.float() - bias0) * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).reshape(*lead, -1)


def pad_codes(x_int8: torch.Tensor, zp_shifted: float, ph: int,
              pw: int) -> torch.Tensor:
    """NHWC code tensor padded with the zero-point code."""
    return F.pad(x_int8, (0, 0, pw, pw, ph, ph), value=int(zp_shifted))


def conv_acc(x_int8: torch.Tensor, w_int8: torch.Tensor, zp_shifted: float,
             stride=(1, 1), padding=(1, 1)) -> torch.Tensor:
    """Exact int8 NHWC x HWIO convolution accumulator (integer-valued
    float64, NHWC) over the zp-code-padded input."""
    xp = pad_codes(x_int8, zp_shifted, padding[0], padding[1])
    acc = F.conv2d(xp.permute(0, 3, 1, 2).double(),
                   w_int8.permute(3, 2, 0, 1).double(), stride=tuple(stride))
    return acc.permute(0, 2, 3, 1)


def qconv2d(x_int8: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
            bias0: torch.Tensor, zp_shifted: float,
            bias: Optional[torch.Tensor] = None, strides=(1, 1),
            padding=(1, 1), out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain W8A8 NHWC conv with fused dequant epilogue and zp-code
    padding."""
    acc = conv_acc(x_int8, w_int8, zp_shifted, strides, padding)
    out = (acc.float() - bias0) * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Deployment parameter precomputation
# ---------------------------------------------------------------------------


def _weight_codes(w, w_delta_b, n_bits, alpha=None):
    """Integer weight codes; with AdaRound ``alpha`` the learned hard
    rounding ``floor(w/delta) + (alpha >= 0)`` replaces nearest rounding."""
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    scaled = w.float() / w_delta_b
    if alpha is None:
        codes = torch.round(scaled)
    else:
        codes = torch.floor(scaled) + (alpha >= 0).float()
    return codes.clamp_(lo, hi).to(torch.int8)


def _prepare(w_int, w_sum, w_delta, a_delta, a_zp, bias, a_bits):
    zp_s = (a_zp.float() - float(1 << (a_bits - 1)))
    return {
        "w_int": w_int,
        "scale": (w_delta * a_delta).float(),
        "bias0": zp_s * w_sum.float(),
        "scale_inv": float((1.0 / a_delta).float()),
        "zp_shifted": float(zp_s),
        "bias": None if bias is None else bias.float(),
    }


def prepare_qlinear_params(w, w_delta, a_delta, a_zp, bias=None, n_bits=8,
                           alpha=None, a_bits=8):
    """Deploy-side constants of one linear layer. ``w``: [K, N];
    ``w_delta``: [N]; ``a_delta``, ``a_zp``: 0-d (``a_zp`` unshifted).
    ``scale_inv`` and ``zp_shifted`` come back as Python floats (f32
    values), so kernels take them as launch arguments."""
    w_int = _weight_codes(w, w_delta[None, :], n_bits, alpha)
    w_sum = w_int.to(torch.int32).sum(0)
    return _prepare(w_int, w_sum, w_delta, a_delta, a_zp, bias, a_bits)


def prepare_qconv_params(w, w_delta, a_delta, a_zp, bias=None, n_bits=8,
                         alpha=None, a_bits=8):
    """Same for a conv, ``w``: [kh, kw, C, K] HWIO, ``w_delta``: [K]."""
    w_int = _weight_codes(w, w_delta[None, None, None, :], n_bits, alpha)
    w_sum = w_int.to(torch.int32).sum((0, 1, 2))
    return _prepare(w_int, w_sum, w_delta, a_delta, a_zp, bias, a_bits)
