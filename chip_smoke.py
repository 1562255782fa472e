#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: W8A8 and mixed-precision
SDXL-Turbo (512 px) and W8A8 SDXL (1024 px) UNet steps through the
hand-written kernels.

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):

0. Build every CUDA kernel from ``mixdq_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once); the compiler's register / shared memory /
   spill report goes to ``chiprun_out/nvcc_build.txt``.
1. Each kernel against its plain PyTorch version at the main-path shapes,
   at B=1 and B=2 for the 1024 px kernels (int8 codes: max |diff| <= 1
   on < 1% of codes; floats rtol 1e-3 / atol 1e-2; flash attention, at
   the kernel's key block size: max |diff| <= 2 bf16 ulps of the plain
   output's max |x| and |diff| / |plain| <= 1e-2),
   with the kernel's and the plain version's time, the card's bound for
   the same work and, where one PyTorch call computes the same function,
   its time (``torch._int_mm`` for ``qmatmul``, the product alone;
   ``scaled_dot_product_attention`` for flash attention; ``torch.matmul``
   on the weight dequantized beforehand for ``wq4_matmul`` /
   ``wq_matmul``, whose check is flash attention's).
2. ``tiny-sdxl`` and ``small-sdxl`` (a small UNet whose attention sites
   take the whole-attention kernels), W8A8 steps in float32
   under ``attn_impl='einsum'`` and ``'auto'``: kernels on the GPU
   against the plain versions on the CPU
   (whole step: |d|/|ref| <= 1e-2, max |d| < 0.3; under ``'auto'`` each
   attention module on its GPU-step input: rtol 1e-3 / atol 1e-2).
3. The main paths: SDXL-Turbo UNet at full width (random weights from a
   seed), calibrated on one request, deployed W8A8 once (int8_sec, fused
   QKV/KV, BoS-aware), answering a few requests at bf16 under
   ``attn_impl='auto'`` (the headline: whole-attention kernels) and
   ``'einsum'`` (the same deploy, the context's ``attn_impl`` swapped).
   Asserts each path's kernel launch counts, finite outputs, and the
   SQNR of int8 against the bf16 FP UNet (>= 16 dB); prints the SQNR of
   auto against einsum and paired median step times. One-layer faults
   injected into the deploy show what the SQNR gate sees.
4. Every deploy entry at full width, teacher-forced on the input its
   layer sees in an FP step, against fake quantization computed from the
   quantizers' definition (>= 30 dB each), and every attention module,
   teacher-forced on its FP-step input, under ``'auto'`` against
   ``'einsum'`` on the same deploy (>= ``SITE_SQNR_DB``); the injected
   faults must fail these checks.
5. A per-kernel device-time breakdown of one step of each int8 path and
   of bf16 from torch.profiler (written to ``chiprun_out/``).
6. The mixed-precision deploys of the same UNet from the repo's elected
   maps (``configs/mp/sdxl_turbo``: W5.04, A7.43, act-protect list), on
   the phase 3 requests: ``int8_sec`` under ``'auto'`` and the weight-only
   ``'dequant'`` and ``'pallas_dequant'`` (``wq4_matmul`` for every packed
   entry, ``wq_matmul`` for the int8 ones). Launch counts (``MP_CALLS``),
   SQNR against bf16 (>= ``MP_SQNR_DB``), ``pallas_dequant`` against
   ``dequant`` (>= ``WONLY_SQNR_DB``), every deploy entry against fake
   quantization at its bits and every attention site auto against
   einsum, each failed by a planted fault (swapped nibble halves, an A4
   entry clipped at A8, zero points at the ``sec_attention`` sites the
   protect list makes); paired step medians with bf16 and W8A8 auto,
   resident weight bytes, peak memory over a step, and one profiled step
   per path (``chiprun_out/profile_mp_*.txt``).
7. SDXL at 1024 px (128x128 latent), full width and depth, built in
   place of SDXL-Turbo: the same deploy under ``'auto'`` (flash
   attention, ``sec_attention`` and ``sec_attention_q``) and
   ``'einsum'``, and the bf16 UNet under ``'auto'`` (flash attention);
   launch counts, SQNR against bf16 (>= 16 dB), bf16 auto against bf16
   einsum (>= ``FLASH_SQNR_DB``) and each bf16 flash site against the
   einsum chain (>= ``FLASH_SITE_SQNR_DB``), both failed by flash attention
   that drops one block of keys, every attention module auto against
   einsum with injected zero-point faults at ``sec_attention`` and
   ``sec_attention_q`` sites, paired step medians and one profiled step
   per path.

Stdout ends with the ``tpu_kernels`` table, the ``kernels`` line, the
card's name and power limit, and the ``ok`` line.
"""

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
N_REQUESTS = 4
TIMING_ROUNDS = 3
MIN_SQNR_DB = 16.0     # whole step, int8 vs bf16 (sound: about 20-23 dB)
LAYER_SQNR_DB = 30.0   # each deploy entry vs fake quantization
# one fault each: caught only per layer / by both gates
FAULT_LAYERS = ("mid_block.attentions.0.transformer_blocks.0.attn2.to_kv",
                "time_embedding.linear_1")
SITE_SQNR_DB = 25.0    # each attention module, auto vs einsum
SITE_DB_PER_BIT = 3.0  # lower for each bit of to_out's act codes below 8
# to_out entries whose act zero point the attention kernels see shifted
# by 8 codes (the to_out GEMM's bias0 keeps the sound one)
FAULT_SITES = (
    "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0",
    "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0")
OUT_DIR = "chiprun_out"
N_SDXL_REQUESTS = 2
# zero-point faults at SDXL 1024 sites: sec_attention (attn1 at 32x32,
# attn2 at 64x64) and sec_attention_q (attn2 at 32x32)
SDXL_FAULT_SITES = (
    "mid_block.attentions.0.transformer_blocks.0.attn1.to_out.0",
    "down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_out.0",
    "up_blocks.0.attentions.0.transformer_blocks.0.attn2.to_out.0")
# whole SDXL 1024 bf16 step, flash attention (auto) vs the einsum chain:
# sound 34.96-35.28 dB, every flash site dropping one key block 32.23-33.00
FLASH_SQNR_DB = 34.0
# each bf16 flash site vs the einsum chain: sound 50.65-53.68 dB, one
# site dropping one key block 38.63
FLASH_SITE_SQNR_DB = 45.0
# whole SDXL-Turbo step, each out-fusion set against the default one (one
# deploy, the same integer sums; the whole-block kernels round the output
# once where the default route rounds to_out and the residual add apart,
# and one bf16 ulp flips act codes downstream): sound 22.79-24.42 dB, one
# attn1 dropping its residual -3.87-3.33 (H100 80GB HBM3, 700 W)
OUTFUSE_STEP_SQNR_DB = 15.0
# each attn1 / ff module teacher-forced under out-fusion against the same
# module on the default route: sound 41.86-45.77 dB, mid zero points
# shifted by 8 codes 12.58 (attn1) / 1.25 (ff)
OUTFUSE_SITE_SQNR_DB = 30.0
# the whole-block faults: an attn1 site and an ff site whose mid act
# quantizer (to_out's, ff.net.2's) sees its zero point shifted by 8 codes;
# for the whole step, one attn1 site that drops its residual
OUTFUSE_FAULT_SITES = (
    "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0",
    "mid_block.attentions.0.transformer_blocks.0.ff.net.2")
# each int8 flash site of the SDXL 1024 deploy against its bf16 flash site
# on the same input: sound qk 40.12-48.16, qkv 39.71-47.09 dB; the q scale
# doubled 12.94 / 12.50
INT8_FLASH_SITE_SQNR_DB = {"qk": 30.0, "qkv": 30.0}
_NONE = dict(qconv2d=0, qconv2d_s2=0, gn_silu_quantize=0, ln_quantize=0,
             geglu_qmatmul=0, qmatmul=0, sec_attention_qkv=0,
             sec_attention_q_out=0, flash_attention=0, sec_attention=0,
             sec_attention_q=0, wq4_matmul=0, wq_matmul=0,
             sec_attention_qkv_out=0, geglu_out_qmatmul=0,
             int8_flash_attention=0, int8qkv_flash_attention=0)
# launches per SDXL-Turbo W8A8 step, B=1, under the default kernel options
# (out-fusion at attn2, LN folded)
TURBO_CALLS = dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                   ln_quantize=140, geglu_qmatmul=70, qmatmul=264,
                   sec_attention_qkv=70, sec_attention_q_out=70)
# ... under the other out-fusion sets: every site whole-block (LN folded or
# materialized at the block: 70 ln_quantize each for norm1, norm2, norm3),
# and none (attn2 on sec_attention_q, to_out and ff.net.2 on qmatmul)
ALL_SITES = frozenset({"attn1", "attn2", "ff"})
OUTFUSE_PATHS = {"all": dict(out_fuse=ALL_SITES),
                 "all_nofold": dict(out_fuse=ALL_SITES, ln_fold=False),
                 "none": dict(out_fuse=frozenset())}
_WHOLE = dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
              qmatmul=124, sec_attention_qkv_out=70, sec_attention_q_out=70,
              geglu_out_qmatmul=70)
OUTFUSE_CALLS = {
    "all": _WHOLE, "all_nofold": dict(_WHOLE, ln_quantize=210),
    "none": dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                 ln_quantize=210, geglu_qmatmul=70, qmatmul=334,
                 sec_attention_qkv=70, sec_attention_q=70)}
# launches per SDXL 1024 step, B=1: 70 transformer blocks, 10 at T=4096
# and 60 at T=1024, every norm materialized, the 60 to_q of the 32x32
# level inside sec_attention_q; int8_flash moves the 10 int8 flash sites
_SDXL_AUTO = dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                  ln_quantize=210, geglu_qmatmul=70, qmatmul=414,
                  sec_attention=70, sec_attention_q=60)
SDXL_CALLS = {
    "auto": dict(_SDXL_AUTO, flash_attention=10),
    "einsum": dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                   ln_quantize=210, geglu_qmatmul=70, qmatmul=474),
    "bf16": dict(_NONE, flash_attention=10),
    "int8_qk": dict(_SDXL_AUTO, int8_flash_attention=10),
    "int8_qkv": dict(_SDXL_AUTO, int8qkv_flash_attention=10),
}
# launches per mixed-precision SDXL-Turbo step (W5.04 / A7.43 +
# act-protect, B=1) under each deploy compute: int8_sec unfuses the 22 attn2
# sites whose to_k is protected or whose to_k and to_v differ in act bits
# (sec_attention there and at the protected to_q); the weight-only deploys
# run every packed dense entry on wq4_matmul, pallas_dequant every
# act-quantized W8 one on wq_matmul and its eight act-quantized 1x1 convs
# on qmatmul
MP_CALLS = {
    "int8_sec": dict(_NONE, qconv2d=37, qconv2d_s2=2, gn_silu_quantize=46,
                     ln_quantize=160, geglu_qmatmul=68, qmatmul=324,
                     sec_attention_qkv=70, sec_attention_q_out=48,
                     sec_attention=22),
    "dequant": dict(_NONE, wq4_matmul=376),
    "pallas_dequant": dict(_NONE, qmatmul=8, wq4_matmul=376, wq_matmul=365),
}
MP_DIR = os.path.join("configs", "mp", "sdxl_turbo")
MP_PATHS = {"int8_sec": "sdxl-turbo mp auto",
            "dequant": "sdxl-turbo w-only dequant",
            "pallas_dequant": "sdxl-turbo w-only pallas_dequant"}
# each mixed path vs bf16 (random weights: 28 W2 and 6 A2 layers; the W8A8
# gate of 16 dB does not apply): sound 0.48-5.70 dB on an H100 80GB HBM3 at
# 700 W, an all-zero output reads 0 dB
MP_SQNR_DB = 0.25
# whole step, pallas_dequant vs dequant: one deploy, the scale rounded
# before (kernels) or after (plain product) the W8 products, and the 1x1
# convs act-quantized under pallas_dequant: sound 26.84-29.38 dB, swapped
# nibbles in time_embedding.linear_1 -0.65-4.04 dB (H100 80GB HBM3, 700 W)
WONLY_SQNR_DB = 20.0
# a packed W4 entry whose output feeds every resnet
MP_FAULT_PACKED = "time_embedding.linear_1"
# to_out entries of two sec_attention sites the protect list makes: attn2
# with its to_k protected (to_kv unfused) and with its to_q protected
MP_FAULT_SITES = (
    "mid_block.attentions.0.transformer_blocks.2.attn2.to_out.0",
    "mid_block.attentions.0.transformer_blocks.6.attn2.to_out.0")

# every function of the JAX package that reaches pl.pallas_call
TPU_KERNELS = [
    ("pallas_qconv.py:331 qconv2d_pallas", "qconv2d"),
    ("pallas_qconv.py:500 qconv2d_pallas_s2", "qconv2d_s2"),
    ("pallas_gn_quant.py:116 gn_silu_quantize", "gn_silu_quantize"),
    ("pallas_ln_quant.py:55 ln_quantize", "ln_quantize"),
    ("pallas_qmatmul.py:352 geglu_qmatmul", "geglu_qmatmul"),
    ("pallas_qmatmul.py:67 qmatmul", "qmatmul"),
    ("pallas_qmatmul.py:205 qmatmul_fused2", None),
    ("pallas_qmatmul.py:557 geglu_out_qmatmul", "geglu_out_qmatmul"),
    ("pallas_qmatmul.py:724 qmatmul_fused", None),
    ("pallas_sec_attention.py:99 sec_attention", "sec_attention"),
    ("pallas_sec_attention.py:223 sec_attention_q", "sec_attention_q"),
    ("pallas_sec_attention.py:409 sec_attention_qkv", "sec_attention_qkv"),
    ("pallas_sec_attention.py:647 sec_attention_qkv_out",
     "sec_attention_qkv_out"),
    ("pallas_sec_attention.py:814 sec_attention_q_out",
     "sec_attention_q_out"),
    ("pallas_attention.py:83 flash_attention", "flash_attention"),
    ("pallas_attention.py:204 int8_flash_attention",
     "int8_flash_attention"),
    ("pallas_attention.py:303 int8qkv_flash_attention",
     "int8qkv_flash_attention"),
    ("pallas_wq_matmul.py:96 wq4_matmul", "wq4_matmul"),
    ("pallas_wq_matmul.py:164 wq_matmul", "wq_matmul"),
]
PORTED = {
    "qconv2d": ("mixdq_tpu_torch/csrc/qconv.cu",
                "mixdq_tpu/ops/pallas_qconv.py:437"),
    "qconv2d_s2": ("mixdq_tpu_torch/csrc/qconv.cu",
                   "mixdq_tpu/ops/pallas_qconv.py:500"),
    "gn_silu_quantize": ("mixdq_tpu_torch/csrc/gn_quant.cu",
                         "mixdq_tpu/ops/pallas_gn_quant.py:147"),
    "ln_quantize": ("mixdq_tpu_torch/csrc/ln_quant.cu",
                    "mixdq_tpu/ops/pallas_ln_quant.py:82"),
    "geglu_qmatmul": ("mixdq_tpu_torch/csrc/geglu_qmatmul.cu",
                      "mixdq_tpu/ops/pallas_qmatmul.py:438"),
    "qmatmul": ("mixdq_tpu_torch/csrc/qmatmul.cu",
                "mixdq_tpu/ops/pallas_qmatmul.py:109"),
    "sec_attention_qkv": ("mixdq_tpu_torch/csrc/sec_attention.cu",
                          "mixdq_tpu/ops/pallas_sec_attention.py:460"),
    "sec_attention_q_out": ("mixdq_tpu_torch/csrc/sec_attention.cu",
                            "mixdq_tpu/ops/pallas_sec_attention.py:927"),
    "sec_attention": ("mixdq_tpu_torch/csrc/sec_attention.cu",
                      "mixdq_tpu/ops/pallas_sec_attention.py:151"),
    "sec_attention_q": ("mixdq_tpu_torch/csrc/sec_attention.cu",
                        "mixdq_tpu/ops/pallas_sec_attention.py:271"),
    "flash_attention": ("mixdq_tpu_torch/csrc/flash_attention.cu",
                        "mixdq_tpu/ops/pallas_attention.py:106"),
    "wq4_matmul": ("mixdq_tpu_torch/csrc/wq_matmul.cu",
                   "mixdq_tpu/ops/pallas_wq_matmul.py:133"),
    "wq_matmul": ("mixdq_tpu_torch/csrc/wq_matmul.cu",
                  "mixdq_tpu/ops/pallas_wq_matmul.py:208"),
    "sec_attention_qkv_out": ("mixdq_tpu_torch/csrc/sec_attention.cu",
                              "mixdq_tpu/ops/pallas_sec_attention.py:757"),
    "geglu_out_qmatmul": ("mixdq_tpu_torch/csrc/geglu_qmatmul.cu",
                          "mixdq_tpu/ops/pallas_qmatmul.py:702"),
    "int8_flash_attention": ("mixdq_tpu_torch/csrc/flash_attention.cu",
                             "mixdq_tpu/ops/pallas_attention.py:228"),
    "int8qkv_flash_attention": ("mixdq_tpu_torch/csrc/flash_attention.cu",
                                "mixdq_tpu/ops/pallas_attention.py:330"),
}

# what library_ms times, where a kernel has one
LIBRARY = {"qmatmul": "torch._int_mm on the same operands: the int32 "
                      "product without the epilogue",
           "flash_attention": "torch.nn.functional.scaled_dot_product_"
                              "attention on head-major views of the same "
                              "q/k/v (output [B, heads, T, d])",
           "wq4_matmul": "torch.matmul(x, w) on the weight dequantized to "
                         "bf16 before the timed region",
           "wq_matmul": "torch.matmul(x, w) on the weight dequantized to "
                        "bf16 before the timed region"}


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations over the peak rate of their type; ``ops`` is a list of
    (count, peak) pairs, one per type."""
    tb, to = nbytes / HBM_BYTES_PER_S, sum(n / peak for n, peak in ops)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` per call, each call timed alone by CUDA
    events after overwriting a 256 MB buffer (the L2 holds 50 MB), so
    weights come from device memory as in a UNet step."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def codes_err(torch, got, want, what="codes"):
    diff = (got.int() - want.int()).abs()
    frac = (diff > 0).float().mean().item()
    err = diff.max().item()
    if err > 1 or frac >= 0.01:
        raise AssertionError(f"{what} differ: max {err}, fraction {frac}")
    return float(err)


def float_err(torch, got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)
    return (got.float() - want.float()).abs().max().item()


def kernel_cases(torch, dev):
    """(kernel, shape label, kernel call, plain call, compare, bytes,
    [(ops, peak) per type], library call or None) at the main-path shapes;
    the first case of each kernel is its reported shape."""
    from mixdq_tpu_torch.ops import (attention, gn_quant, ln_quant, qconv,
                                     qmatmul, sec_attention, wq_matmul)

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = []
    convs = [("qconv2d", 1, 64, 320, 320, True), ("qconv2d", 1, 16, 2560,
             1280, True), ("qconv2d", 1, 64, 4, 320, False),
             ("qconv2d", 1, 64, 320, 4, False), ("qconv2d", 1, 32, 1920,
             640, True), ("qconv2d_s2", 2, 64, 320, 320, False),
             ("qconv2d_s2", 2, 32, 640, 640, False)]
    for name, stride, H, C, K, epi in convs:
        x, w = codes(1, H, H, C), codes(3, 3, C, K)
        scale = (torch.rand(K, generator=g, device=dev) + 0.5) * 1e-4
        bias0 = -3.0 * w.int().sum((0, 1, 2)).float()
        P = H // stride
        kw = dict(bias=randn(K, dtype=bf16),
                  extra_bias=randn(1, K, dtype=bf16) if epi else None,
                  residual=randn(1, P, P, K, dtype=bf16) if epi else None)
        fn = qconv.qconv2d if stride == 1 else qconv.qconv2d_s2
        nbytes = (H * H * C + 9 * C * K + 2 * P * P * K * (2 if epi else 1))
        cases.append((
            name, f"{C}->{K} @{H}x{H}" + (" +temb+res" if epi else ""),
            lambda fn=fn, a=(x, w, scale, bias0), kw=kw: fn(*a, -3.0, **kw),
            lambda s=stride, a=(x, w, scale, bias0), kw=kw:
                qconv.qconv2d_plain(*a, -3.0, stride=s, **kw),
            float_err, nbytes, [(2 * P * P * K * 9 * C, INT8_OPS_PER_S)],
            None))
    for shape, silu, eps in [((1, 64, 64, 320), True, 1e-5),
                             ((1, 32, 32, 640), False, 1e-6),
                             ((1, 16, 16, 2560), True, 1e-5)]:
        C = shape[-1]
        x = randn(*shape, dtype=bf16) * 2
        gam, bet = torch.rand(C, generator=g, device=dev) + 0.5, randn(C)
        args = (x, gam, bet, 30.0, -5.0, 32, eps, silu)
        n = x.numel()
        cases.append(("gn_silu_quantize",
                      f"{list(shape)} silu={silu}",
                      lambda a=args: gn_quant.gn_silu_quantize(*a),
                      lambda a=args: gn_quant.gn_silu_quantize_plain(*a),
                      codes_err, 3 * n, [(12 * n, F32_OPS_PER_S)], None))
    for shape in [(1, 1024, 640), (1, 256, 1280)]:
        C = shape[-1]
        x = randn(*shape, dtype=bf16) * 3
        args = (x, torch.rand(C, generator=g, device=dev) + 0.5, randn(C),
                20.0, 3.0)
        n = x.numel()
        cases.append(("ln_quantize", str(list(shape)),
                      lambda a=args: ln_quant.ln_quantize(*a),
                      lambda a=args: ln_quant.ln_quantize_plain(*a),
                      codes_err, 3 * n, [(8 * n, F32_OPS_PER_S)], None))
    for M, K, H in [(256, 1280, 5120), (1024, 640, 2560)]:
        x, w = codes(M, K), codes(K, 2 * H)
        scale = (torch.rand(2 * H, generator=g, device=dev) + 0.5) * 2e-5
        bias0 = 5.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, 25.0, 4.0, randn(2 * H, dtype=bf16))
        cases.append(("geglu_qmatmul", f"M={M} K={K} 2H={2 * H}",
                      lambda a=args: qmatmul.geglu_qmatmul(*a),
                      lambda a=args: qmatmul.geglu_qmatmul_plain(*a),
                      codes_err, M * K + 2 * K * H + M * H,
                      [(4 * M * K * H, INT8_OPS_PER_S)], None))
    # qmatmul: ff.net.2 @32x32 first, time_emb_proj, to_kv, ff.net.2
    # @16x16, conv_shortcut @64x64; library: torch._int_mm, the product
    # alone (cuBLASLt refuses M <= 16)
    for M, K, N in [(1024, 2560, 640), (1, 1280, 1280), (77, 2048, 2560),
                    (256, 5120, 1280), (4096, 960, 320)]:
        x, w = codes(M, K), codes(K, N)
        scale = (torch.rand(N, generator=g, device=dev) + 0.5) * 1e-5
        bias0 = -9.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, randn(N, dtype=bf16))
        cases.append(("qmatmul", f"M={M} K={K} N={N}",
                      lambda a=args: qmatmul.qmatmul(*a),
                      lambda a=args: qmatmul.qmatmul_plain(*a),
                      float_err, M * K + K * N + 10 * N + 2 * M * N,
                      [(2 * M * K * N, INT8_OPS_PER_S)],
                      (lambda x=x, w=w: torch._int_mm(x, w)) if M > 16
                      else None))
    # attn1 / attn2 at the 32x32 (T=1024, C=640, 10 heads) and 16x16
    # (T=256, C=1280, 20 heads) levels, d=64, Tk=77
    for T, heads in [(1024, 10), (256, 20)]:
        C = heads * 64
        args, kw = qkv_case(torch, g, dev, 1, T, heads, 64)
        cases.append(("sec_attention_qkv", f"T={T} C={C} heads={heads}",
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv_plain(*a, **kw),
                      codes_err, 2 * T * C + 3 * C * C + 24 * C,
                      [(6 * T * C * C, INT8_OPS_PER_S),
                       (4 * T * T * C, BF16_OPS_PER_S)], None))
    for T, heads, ln in [(1024, 10, True), (256, 20, True), (256, 20, False)]:
        C = heads * 64
        args, kw = q_out_case(torch, g, dev, 1, T, 77, heads, 64, C, bf16, ln)
        nbytes = (T * C * (2 if ln else 3) + 2 * C * C + 4 * 77 * C
                  + 2 * T * C + 30 * C)
        cases.append(("sec_attention_q_out",
                      f"Tq={T} C={C} heads={heads} "
                      + ("LN-folded" if ln else "pre-coded + residual"),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q_out(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q_out_plain(*a, **kw),
                      float_err, nbytes,
                      [(4 * T * C * C, INT8_OPS_PER_S),
                       (4 * T * 77 * C, BF16_OPS_PER_S),
                       (8 * T * C if ln else 0, F32_OPS_PER_S)], None))
    # attn1 whole-block at the same levels: LN-folded (the main path) and
    # pre-coded + residual (ln_fold off)
    for T, heads, ln in [(1024, 10, True), (256, 20, True), (1024, 10, False),
                         (256, 20, False)]:
        C = heads * 64
        args, kw = qkv_out_case(torch, g, dev, 1, T, heads, 64, bf16, ln)
        cases.append(("sec_attention_qkv_out",
                      f"T={T} C={C} heads={heads} "
                      + ("LN-folded" if ln else "pre-coded + residual"),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv_out(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv_out_plain(*a, **kw),
                      float_err,
                      T * C * (2 if ln else 3) + 4 * C * C + 2 * T * C
                      + 30 * C,
                      [(8 * T * C * C, INT8_OPS_PER_S),
                       (4 * T * T * C, BF16_OPS_PER_S),
                       (8 * T * C if ln else 0, F32_OPS_PER_S)], None))
    # the whole feed-forward at both levels, LN-folded and pre-coded
    for M, C, ln in [(1024, 640, True), (256, 1280, True), (1024, 640, False),
                     (256, 1280, False)]:
        H = 4 * C
        args, kw = geglu_out_case(torch, g, dev, M, C, H, C, bf16, ln)
        cases.append(("geglu_out_qmatmul",
                      f"M={M} K=C={C} H={H} "
                      + ("LN-folded" if ln else "pre-coded + residual"),
                      lambda a=args, kw=kw: qmatmul.geglu_out_qmatmul(*a,
                                                                     **kw),
                      lambda a=args, kw=kw:
                          qmatmul.geglu_out_qmatmul_plain(*a, **kw),
                      float_err,
                      M * C * (2 if ln else 3) + 3 * C * H + 2 * M * C
                      + 12 * H + 20 * C,
                      [(4 * M * C * H + 2 * M * H * C, INT8_OPS_PER_S),
                       (8 * M * C if ln else 0, F32_OPS_PER_S)], None))
    # SDXL 1024: flash at attn1 of the 64x64 level (T=4096, 10 heads),
    # sec_attention at attn1 of the 32x32 level (T=1024, C=1280) and attn2
    # of the 64x64 level (Tq=4096, Tk=77, C=640), sec_attention_q at attn2
    # of the 32x32 level; each at B=1 and B=2
    for B in (1, 2):
        T, heads, d = 4096, 10, 64
        C = heads * d
        srcs, kw = attn_case(torch, g, dev, B, T, T, heads, d, bf16, False)

        def sdpa(y=srcs[0], shape=(B, T, 3, heads, d)):
            qkv = y.view(shape).permute(2, 0, 3, 1, 4)
            return torch.nn.functional.scaled_dot_product_attention(
                qkv[0], qkv[1], qkv[2], scale=shape[-1] ** -0.5)
        cases.append(("flash_attention", f"B={B} T={T} heads={heads} d={d}",
                      lambda a=srcs, kw=kw: attention.flash_attention(*a,
                                                                     **kw),
                      lambda a=srcs, kw=kw:
                          attention.flash_attention_plain(*a, **kw),
                      flash_err, 8 * B * T * C,
                      [(4 * B * T * T * C, BF16_OPS_PER_S)], sdpa))
    # int8 flash at the same sites: the kernels on the codes and scales
    # that the wrappers' quantize (plain PyTorch ops) makes
    for name in ("int8_flash_attention", "int8qkv_flash_attention"):
        for B in (1, 2):
            T, heads, d = 4096, 10, 64
            C = heads * d
            srcs, kw = attn_case(torch, g, dev, B, T, T, heads, d, bf16, False)
            qkv = name.startswith("int8qkv")
            qi, ki, vi, s_qk, sv = attention._int8_operands(
                *srcs, heads, d, 0, C, 2 * C, qkv)
            args = (qi, ki, vi if qkv else srcs[2], s_qk * d ** -0.5, sv)
            ckw = dict(heads=heads, head_dim=d, v_off=0 if qkv else 2 * C,
                       out_dtype=bf16)
            matmuls = ([(4 * B * T * T * C, INT8_OPS_PER_S)] if qkv else
                       [(2 * B * T * T * C, INT8_OPS_PER_S),
                        (2 * B * T * T * C, BF16_OPS_PER_S)])
            cases.append((name, f"B={B} T={T} heads={heads} d={d} on codes",
                          lambda a=args, kw=ckw:
                              attention.int8_flash_codes(*a, **kw),
                          lambda a=args, kw=ckw:
                              attention.int8_flash_codes_plain(*a, **kw),
                          flash_err, B * T * C * (5 if qkv else 6), matmuls,
                          None))
    for B in (1, 2):
        for Tq, Tk, heads, cross in [(1024, 1024, 20, False),
                                     (4096, 77, 10, True)]:
            C = heads * 64
            srcs, kw = attn_case(torch, g, dev, B, Tq, Tk, heads, 64, bf16,
                                 cross)
            args = (*srcs, 40.0, -3.0)
            nbytes = (2 * B * Tq * C + 4 * B * Tk * C + B * Tq * C if cross
                      else 6 * B * Tq * C + B * Tq * C)
            cases.append(("sec_attention",
                          f"B={B} Tq={Tq} Tk={Tk} C={C} heads={heads} "
                          + ("cross" if cross else "self"),
                          lambda a=args, kw=kw:
                              sec_attention.sec_attention(*a, **kw),
                          lambda a=args, kw=kw:
                              sec_attention.sec_attention_plain(*a, **kw),
                          codes_err, nbytes,
                          [(4 * B * Tq * Tk * C, BF16_OPS_PER_S)], None))
    for B in (1, 2):
        Tq, heads, C = 1024, 20, 1280
        args, kw = sec_q_case(torch, g, dev, B, Tq, 77, heads, 64, C, bf16)
        cases.append(("sec_attention_q",
                      f"B={B} Tq={Tq} Tk=77 C_in=C={C} heads={heads}",
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q_plain(*a, **kw),
                      codes_err,
                      2 * B * Tq * C + C * C + 8 * C + 4 * B * 77 * C,
                      [(2 * B * Tq * C * C, INT8_OPS_PER_S),
                       (4 * B * Tq * 77 * C, BF16_OPS_PER_S)], None))
    # the weight-only step: ff.net.0.proj at 32x32, ff.net.2 at 16x16,
    # attn2 to_k/to_v at 16x16, time_emb_proj, and a ragged N; library:
    # torch.matmul on the weight dequantized to bf16 beforehand
    for w4 in (True, False):
        for M, K, N in [(1024, 640, 5120), (256, 5120, 1280),
                        (77, 2048, 1280), (1, 1280, 1280), (77, 2048, 1000)]:
            x = randn(M, K, dtype=bf16)
            lim = 8 if w4 else 128
            w = torch.randint(-lim, lim, (K, N), generator=g, device=dev,
                              dtype=torch.int8)
            s = (torch.rand(N, generator=g, device=dev) + 0.5) / (
                lim * K ** 0.5)
            w_dq = wq_matmul.dequant_bf16(w, s)
            if w4:
                args, name = (x, wq_matmul.pack_w4_halves(w), s), "wq4_matmul"
                fn, plain = wq_matmul.wq4_matmul, wq_matmul.wq4_matmul_plain
            else:
                args, name = (x, w, s), "wq_matmul"
                fn, plain = wq_matmul.wq_matmul, wq_matmul.wq_matmul_plain
            cases.append((
                name, f"M={M} K={K} N={N}", lambda f=fn, a=args: f(*a),
                lambda f=plain, a=args: f(*a), wq_err,
                2 * M * K + K * N // (2 if w4 else 1) + 4 * N + 2 * M * N,
                [(2 * M * K * N, BF16_OPS_PER_S), (K * N, F32_OPS_PER_S)],
                lambda x=x, w=w_dq: torch.matmul(x, w)))
    return cases


def wq_err(torch, got, want):
    """A weight-only GEMM against its plain version: max |diff| <= 2 bf16
    ulps of max |want| (the same bf16 products summed in f32 in other
    orders, then rounded to bf16) and |diff| / |want| <= 1e-2."""
    return flash_err(torch, got, want)


def flash_err(torch, got, want):
    """Flash attention's bf16 output against its plain version at the same
    key block size: max |diff| <= 2 bf16 ulps of max |want| (the two sum
    in other orders, so an element or a rounded ``p`` may land one ulp
    apart) and |diff| / |want| <= 1e-2 (one block of keys dropped moves
    it by several per cent)."""
    got, want = got.float(), want.float()
    d = got - want
    err = d.abs().max().item()
    tol = 2 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    rel = (d.norm() / want.norm()).item()
    if not (err <= tol and rel <= 1e-2):
        raise AssertionError(f"max |diff| {err} (limit {tol}), |diff|/|ref| "
                             f"{rel} (limit 1e-2)")
    return err


def attn_case(torch, g, dev, B, Tq, Tk, heads, d, dtype, cross):
    """q/k/v sources of one attention site, about unit size: self, the
    fused to_qkv output ``[B, T, 3C]`` at 0/C/2C; cross, q ``[B, Tq, C]``
    and a fused to_kv output ``[B, Tk, 2C]`` at 0/C whose first (BoS) row
    is twice the others. Returns (sources, kwargs)."""
    C = heads * d

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5)
    if not cross:
        y = (randn(B, Tq, 3 * C) * 1.5).to(dtype)
        return (y, y, y), dict(kw, q_off=0, k_off=C, v_off=2 * C)
    y = randn(B, Tk, 2 * C)
    y[:, 0] *= 2
    y = y.to(dtype)
    return ((randn(B, Tq, C) * 1.5).to(dtype), y, y), dict(
        kw, q_off=0, k_off=0, v_off=C)


def sec_q_case(torch, g, dev, B, Tq, Tk, heads, d, C_in, dtype):
    """Inputs of ``sec_attention_q`` at one attn2 site: to_q codes, a to_q
    weight whose q comes out about unit size, and a fused to_kv output
    with a BoS-like first row; returns (args, kwargs)."""
    C = heads * d
    x = torch.randint(-128, 128, (B, Tq, C_in), generator=g, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-128, 128, (C_in, C), generator=g, device=dev,
                       dtype=torch.int8)
    sq = (torch.rand(C, generator=g, device=dev) + 0.5) / (3000.0
                                                            * C_in ** 0.5)
    y = torch.randn((B, Tk, 2 * C), generator=g, device=dev)
    y[:, 0] *= 2
    args = (x, wq, sq, 3.0 * wq.int().sum(0).float(), y.to(dtype),
            y.to(dtype), 40.0, -2.0)
    return args, dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0,
                      v_off=C)


def qkv_case(torch, g, dev, B, T, heads, d):
    """Inputs of ``sec_attention_qkv``: random codes, a fused QKV weight
    whose q/k/v come out about unit size (random codes sum to ~5500
    sqrt(C)), so the softmax is not one-hot; returns (args, kwargs)."""
    C = heads * d
    x = torch.randint(-128, 128, (B, T, C), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (C, 3 * C), generator=g, device=dev,
                      dtype=torch.int8)
    scale = (torch.rand(3 * C, generator=g, device=dev) + 0.5) / (
        5500.0 * C ** 0.5)
    args = (x, w, scale, 4.0 * w.int().sum(0).float(), 200.0, -3.0)
    return args, dict(heads=heads, head_dim=d, scale=d ** -0.5)


def q_out_case(torch, g, dev, B, Tq, Tk, heads, d, C_in, dtype, ln):
    """Inputs of ``sec_attention_q_out`` at one attn2 site: the raw stream
    (LN-folded) or to_q codes + a residual, a fused to_kv output ``y``
    ``[B, Tk, 2C]`` with a BoS-like first row, weights and constants, at
    sizes where |out| < 2 (one bf16 ulp within the float tolerance);
    returns (args, kwargs)."""
    C = heads * d

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    wq, wout = codes(C_in, C), codes(C, C_in)
    sq = (rand(C) + 0.5) / (3000.0 * C_in ** 0.5)
    so = (rand(C_in) + 0.5) * 2e-6
    y = randn(B, Tk, 2 * C)
    y[:, 0] *= 8
    stream = (randn(B, Tq, C_in) * 0.25).to(dtype)
    if ln:
        x, residual = stream, None
        fold = (rand(C_in) + 0.5, randn(C_in) * 0.2, 25.0, 2.0,
                (-128.0, 127.0), 1e-5)
    else:
        x, residual, fold = codes(B, Tq, C_in), stream, None
    args = (x, wq, sq, 3.0 * wq.int().sum(0).float(), y.to(dtype),
            y.to(dtype), 100.0, -2.0, wout, so,
            -6.0 * wout.int().sum(0).float(), (randn(C_in) * 0.1).to(dtype),
            residual)
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0, v_off=C,
              out_dtype=dtype, ln=fold)
    return args, kw


def qkv_out_case(torch, g, dev, B, T, heads, d, dtype, ln):
    """Inputs of ``sec_attention_qkv_out`` at one attn1 site: the raw stream
    (LN-folded) or the to_qkv codes + a residual, ``qkv_case``'s fused QKV
    weight, a to_out weight and constants at sizes where |out| < 2;
    returns (args, kwargs)."""
    C = heads * d
    (codes, w, scale, bias0, _, _), kw = qkv_case(torch, g, dev, B, T, heads,
                                                  d)
    wout = torch.randint(-128, 128, (C, C), generator=g, device=dev,
                         dtype=torch.int8)
    so = (torch.rand(C, generator=g, device=dev) + 0.5) * 2e-6
    stream = (torch.randn((B, T, C), generator=g, device=dev) * 0.25).to(
        dtype)
    fold = None
    if ln:
        fold = (torch.rand(C, generator=g, device=dev) + 0.5,
                torch.randn(C, generator=g, device=dev) * 0.2, 25.0, 2.0,
                (-128.0, 127.0), 1e-5)
    args = (stream if ln else codes, w, scale, bias0, 200.0, -3.0, wout, so,
            -6.0 * wout.int().sum(0).float(),
            (torch.randn(C, generator=g, device=dev) * 0.1).to(dtype),
            None if ln else stream)
    return args, dict(kw, out_dtype=dtype, ln=fold)


def geglu_out_case(torch, g, dev, M, K, H, C, dtype, ln):
    """Inputs of ``geglu_out_qmatmul`` at one ff site: the raw stream [M, K]
    (LN-folded, K == C) or proj codes + a residual, weights whose gate
    input and output stay a few units, constants; returns (args,
    kwargs)."""
    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    w, w2 = codes(K, 2 * H), codes(H, C)
    stream = (torch.randn((M, C), generator=g, device=dev) * 0.25).to(dtype)
    fold = ((rand(K) + 0.5, torch.randn(K, generator=g, device=dev) * 0.2,
             25.0, 2.0, (-128.0, 127.0), 1e-5) if ln else None)
    args = (stream if ln else codes(M, K), w,
            (rand(2 * H) + 0.5) / (2500.0 * K ** 0.5),
            5.0 * w.int().sum(0).float(), 25.0, 4.0, w2,
            (rand(C) + 0.5) / (4e4 * H ** 0.5),
            -4.0 * w2.int().sum(0).float())
    kw = dict(bias=torch.randn(2 * H, generator=g, device=dev) * 0.3,
              out_bias=(torch.randn(C, generator=g, device=dev) * 0.1).to(
                  dtype),
              residual=None if ln else stream, out_dtype=dtype, ln=fold)
    return args, kw


def phase_kernels(torch, dev, flush):
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.configs import get_family

    per_step = {
        f"{f}{tag}": pipeline.expected_kernel_calls(get_family(f).unet, "auto",
                                                    **kw)
        for f, tag, kw in (("sdxl-turbo", "", {}), ("sdxl", "", {}),
                           ("sdxl-turbo", " all", OUTFUSE_PATHS["all"]),
                           ("sdxl", " qk", dict(int8_flash="qk")),
                           ("sdxl", " qkv", dict(int8_flash="qkv")))}
    report = {}
    for name, label, fn, plain, cmp, nbytes, ops, lib in kernel_cases(
            torch, dev):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err = cmp(torch, got, want)
        k_ms = time_ms(torch, fn, 20, flush)
        p_ms = time_ms(torch, plain, 3, flush)
        l_ms = None if lib is None else time_ms(torch, lib, 20, flush)
        b_ms, b_by = bound(nbytes, ops)
        log(f"kernel {name} [{label}]: max_abs_err={err} kernel_ms={k_ms:.4f}"
            f" plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})"
            f" library_ms={'null' if l_ms is None else f'{l_ms:.4f}'}"
            f" launches/step {({p: c[name] for p, c in per_step.items()})}")
        r = report.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append(dict(shape=label, ms=k_ms, plain_ms=p_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=l_ms))
    return report


def to_device(qparams, dev):
    return {n: qp.replace(**{k: (None if v is None else v.to(dev))
                             for k, v in vars(qp).items()})
            for n, qp in qparams.items()}


def phase_tiny_parity(torch, dev):
    """Whole W8A8 step of ``tiny-sdxl`` and ``small-sdxl`` under each
    ``attn_impl``, and of ``small-sdxl`` with every site out-fused (LN
    folded and not): GPU kernels vs CPU plain versions."""
    import dataclasses

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.models import routing
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    f32 = torch.float32
    paths = [("einsum", dict(attn_impl="einsum")),
             ("auto", dict(attn_impl="auto"))]
    for label in ("tiny-sdxl", "small-sdxl"):
        cpu_m = pipeline.build_unet(label, 0, f32, "cpu")
        gpu_m = pipeline.build_unet(label, 0, f32, dev)
        gpu_m.load_state_dict(cpu_m.state_dict())
        inp = pipeline.example_inputs(label, 1, 0, f32, "cpu")
        inp_gpu = tuple(x.to(dev) if torch.is_tensor(x) else
                        {k: v.to(dev) for k, v in x.items()} for x in inp)
        qp = calibrate(cpu_m, [inp], pipeline.WQ, pipeline.AQ)
        ctrl = uniform_ctrl(list(quantizable_layers(cpu_m)))
        cpu_ctx = deploy_unet_ctx(cpu_m, qp, ctrl, pipeline.WQ, fuse_qkv=True)
        gpu_ctx = deploy_unet_ctx(gpu_m, to_device(qp, dev), ctrl,
                                  pipeline.WQ, fuse_qkv=True)
        if label == "small-sdxl":
            paths += [(f"auto outfuse {t}", dict(attn_impl="auto", **o))
                      for t, o in OUTFUSE_PATHS.items() if t != "none"]
        for impl, opts in paths:
            c_ctx = dataclasses.replace(cpu_ctx, **opts)
            g_ctx = dataclasses.replace(gpu_ctx, **opts)
            ref = pipeline.unet_step(cpu_m, inp, c_ctx)
            ops.reset_counts()
            got = pipeline.unet_step(gpu_m, inp_gpu, g_ctx).cpu()
            launches = ops.launch_counts()
            if launches != pipeline.ctx_kernel_calls(gpu_m.config, g_ctx):
                raise AssertionError(f"{label} {impl} launches {launches}")
            rel = ((got - ref).norm() / ref.norm()).item()
            mx = (got - ref).abs().max().item()
            log(f"{label} int8 step ({impl}) GPU vs CPU plain: rel={rel:.3e} "
                f"max={mx:.3e}; attention launches "
                f"{ {k: launches[k] for k in routing.KERNELS} }, "
                f"geglu_out_qmatmul {launches['geglu_out_qmatmul']}")
            if impl == "einsum":
                if not (math.isfinite(rel) and rel <= 1e-2 and mx < 0.3):
                    raise AssertionError(f"{label} parity ({impl}): rel {rel} "
                                         f"max {mx}")
                continue
            # The attention kernels sum in another order than the CPU; one
            # act code that differs by one at one site can grow past the
            # whole-step tolerance in a small UNet. So each attention (and
            # out-fused feed-forward) module is held alone, on the input it
            # had in the GPU step.
            seen = record_attention_inputs(torch, gpu_m, inp_gpu, g_ctx,
                                           ff="outfuse" in impl)
            err = 0.0
            for name, (stream, ehs) in sorted(seen.items()):
                g = attention_site(torch, gpu_m, name, stream, ehs, g_ctx)
                c = attention_site(torch, cpu_m, name, stream.cpu(),
                                   None if ehs is None else ehs.cpu(), c_ctx)
                err = max(err, float_err(torch, g.cpu(), c))
            log(f"{label} ({impl}): {len(seen)} modules, each on its "
                f"GPU-step input, GPU vs CPU plain: max |d| {err:.3e}")


def sqnr_db(ref, got):
    ref, got = ref.float(), got.float()
    return 10 * math.log10((ref.pow(2).sum() / (ref - got).pow(2).sum()
                            ).item())


def fake_quant_layer(torch, m, x, kw, qp_w, qp_a, bos=False, w_bits=8,
                     a_bits=8):
    """What the deploy of layer ``m`` at ``w_bits`` / ``a_bits`` should
    give for its FP input ``x`` (call kwargs ``kw``), from the quantizers'
    definition in f32: the input as its dequantized ``a_bits`` act codes
    under ``qp_a`` (rounding ``x * (1 / delta)``, as the deploy does; the
    BoS token kept FP when ``bos``; the input itself for ``a_bits`` None,
    a weight-only layer), the weight as its dequantized codes under
    ``qp_w`` (2-bit deltas on the 4-bit code range, as the deploy stores
    them), then bias, ``extra_bias`` and ``residual``. Shares no code with
    the deploy path (fused scales, ``bias0``, packing, padded GEMMs,
    kernels). Returns (output, output without the residual)."""
    import torch.nn.functional as F

    from mixdq_tpu_torch.pipeline import WQ

    cb = WQ.candidate_bits
    xf = x.float()
    xq = xf
    if a_bits is not None:
        b = cb.index(a_bits)
        ad, az = qp_a.a_delta[b].float(), qp_a.a_zp[b].float()
        xq = ((xf * (1 / ad)).round() + az).clamp(0, 2 ** a_bits - 1).sub(
            az).mul(ad)
        if bos:
            xq[..., :1, :] = xf[..., :1, :]
    wd = qp_w.w_delta[cb.index(w_bits)].float()
    lim = 2 ** (max(w_bits, 4) - 1)
    w = (m.weight.float() / wd).round().clamp(-lim, lim - 1) * wd
    if w.ndim == 2:
        y = xq @ w
    else:
        y = F.conv2d(xq.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=m.strides, padding=m.padding).permute(0, 2, 3, 1)
    if m.bias is not None:
        y = y + m.bias.float()
    if kw.get("extra_bias") is not None:
        y = y + kw["extra_bias"].float()[:, None, None, :]
    if kw.get("residual") is None:
        return y, y
    return y + kw["residual"].float(), y


def record_layer_inputs(torch, unet, req):
    """{layer name: (input, call kwargs)} of every quantizable layer in
    one FP step."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import quantizable_layers

    seen = {}

    def hook(mod, args, kwargs):
        seen[mod.qname] = (args[0], kwargs)

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in quantizable_layers(unet).values()]
    try:
        pipeline.unet_step(unet, req)
    finally:
        for h in handles:
            h.remove()
    return seen


def layer_sqnrs(torch, unet, ctx, qparams, seen, names, bits=None):
    """SQNR in dB of each deploy entry in ``names``, run alone on the
    input its layer saw in the FP step, against ``fake_quant_layer`` at
    the layer's ``bits`` ({name: (w_bits, a_bits or None)}, default W8A8);
    the signal is the layer's own output (without a fused residual). Acts
    count as FP where the deploy's compute runs the entry weight-only. An
    entry with acts below 8 bits runs on that input doubled, so that its
    act clip takes effect. A fused QKV/KV entry runs as the attention runs
    it (anchor's codes, FP BoS row for cross-attention k/v); an
    ``ff.net.0.proj`` whose GEGLU kernel runs also runs it, whose codes
    must match the reference within one code."""
    import torch.nn.functional as F

    from mixdq_tpu_torch.models.attention import geglu_fusable
    from mixdq_tpu_torch.models.layers import (bos_row, deploy_linear,
                                               layer_compute)
    from mixdq_tpu_torch.pipeline import WQ
    from mixdq_tpu_torch.quant.state import quantizable_layers

    layers = quantizable_layers(unet)
    bits = bits or {}
    out = {}

    def act_bits(name, e):
        """The layer's act bits where ``ctx`` quantizes its acts, else
        None (weight-only)."""
        quantized = (not e.act_off and ctx.deploy_compute != "dequant"
                     if e.kind == "conv" else
                     layer_compute(ctx.deploy_compute, e) == "int8")
        return bits.get(name, (8, 8))[1] if quantized else None

    def stress(x, a_bits):
        return x * 2 if a_bits is not None and a_bits < 8 else x

    with torch.inference_mode():
        for name in names:
            e = ctx.deploy[name]
            prefix, _, leaf = name.rpartition(".")
            if leaf in ("to_qkv", "to_kv"):
                members = [f"{prefix}.{n}" for n in (
                    ("to_q", "to_k", "to_v") if leaf == "to_qkv"
                    else ("to_k", "to_v"))]
                a_bits = act_bits(members[0], e)
                x = stress(seen[members[0]][0], a_bits)
                bos = leaf == "to_kv" and ctx.bos_aware
                got = deploy_linear(x, e, layer_compute(ctx.deploy_compute, e),
                                    unet.dtype)
                if bos:
                    got = torch.cat([bos_row(x, e, unet.dtype),
                                     got[..., 1:, :]], -2)
                ref = torch.cat([fake_quant_layer(
                    torch, layers[n], x, {}, qparams[n], qparams[members[0]],
                    bos, bits.get(n, (8, 8))[0], a_bits)[0]
                    for n in members], -1)
                signal = ref
            else:
                m = layers[name]
                w_bits, a_bits = bits.get(name, (8, 8))[0], act_bits(name, e)
                x, kw = seen[name]
                x = stress(x, a_bits)
                got = m(x, ctx, **kw)
                # an unfused cross-attention k/v keeps its BoS row FP
                bos = (bool(kw.get("bos_aware")) and ctx.bos_aware
                       and a_bits is not None)
                ref, signal = fake_quant_layer(torch, m, x, kw, qparams[name],
                                               qparams[name], bos, w_bits,
                                               a_bits)
                consumer = name[:-len("0.proj")] + "2"
                if name.endswith(".ff.net.0.proj") and geglu_fusable(
                        ctx.deploy_compute, e, ctx.entry(consumer)):
                    c_bits = bits.get(consumer, (8, 8))[1]
                    b = WQ.candidate_bits.index(c_bits)
                    c_qp = qparams[consumer]
                    codes = m(x, ctx, geglu_out=ctx.entry(consumer))
                    h, g = ref.chunk(2, -1)
                    a = h * F.gelu(g, approximate=(
                        "tanh" if ctx.gelu == "tanh" else "none"))
                    want = ((a * (1 / c_qp.a_delta[b])).round()
                            + c_qp.a_zp[b]).clamp(0, 2 ** c_bits - 1) - (
                                2 ** (c_bits - 1))
                    codes_err(torch, codes, want, f"{name} GEGLU codes")
            err = (got.float() - ref).pow(2).sum().item()
            out[name] = (math.inf if err == 0 else 10 * math.log10(
                signal.pow(2).sum().item() / err))
    return out


def faulted_ctx(ctx, name):
    """``ctx`` with one fault in one layer: the second half of entry
    ``name``'s output channels (the value half of a fused ``to_kv``)
    dequantized with twice their scale, as if rebuilt against the wrong
    act params."""
    import dataclasses

    e = ctx.deploy[name]
    half = e.scale.shape[0] // 2
    scale = e.scale.clone()
    scale[half:] *= 2
    return dataclasses.replace(ctx, deploy={**ctx.deploy,
                                            name: e.replace(scale=scale)})


def nibble_swapped_ctx(ctx, name):
    """``ctx`` with the packed entry ``name``'s nibble halves swapped
    (rows k and k + K/2 of its weight exchanged)."""
    import dataclasses

    e = ctx.deploy[name]
    p = e.w_packed
    return dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: e.replace(w_packed=(p >> 4) | (p << 4))})


def a8_clip_ctx(ctx, name):
    """``ctx`` with the A4/A2 entry ``name``'s codes clipped at A8."""
    import dataclasses

    return dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: ctx.deploy[name].replace(a_bits=8)})


def resident_weight_bytes(unet, deploy):
    """(total, deploy) bytes of the weights a deploy keeps resident once
    the fp weights it replaces are pruned: every parameter the deploy does
    not replace, plus its entries' tensors (codes, packed codes, scales,
    ``bias0``, BoS weights)."""
    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()

    dep = sum(nbytes(getattr(e, f)) for e in deploy.values()
              for f in ("w_int", "w_packed", "scale", "bias0", "bos_w"))
    fp = sum(nbytes(p) for n, p in unet.named_parameters()
             if not (n.endswith(".weight") and n[:-len(".weight")] in deploy))
    return fp + dep, dep


def step_peak_bytes(torch, unet, req, ctx):
    """``torch.cuda.max_memory_allocated`` over one step, and its rise
    above what was allocated before the step."""
    from mixdq_tpu_torch import pipeline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    pipeline.unet_step(unet, req, ctx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def phase_mixed(torch, unet, calib, requests, w8a8_ctx, qparams, seen,
                card):
    """The three mixed-precision SDXL-Turbo paths (W5.04 / A7.43 +
    act-protect, ``MP_CALLS``) on the phase 3 UNet and requests: launch
    counts (every packed entry on ``wq4_matmul``), SQNR against bf16
    (>= ``MP_SQNR_DB``), ``pallas_dequant`` against ``dequant`` (>=
    ``WONLY_SQNR_DB``, failed by one packed entry with its nibble halves
    swapped), every deploy entry against fake quantization at its bits
    (>= ``LAYER_SQNR_DB``, failed by the swapped nibbles and by an A4
    entry clipped at A8), every attention site of the mixed int8 deploy
    auto against einsum (>= ``SITE_SQNR_DB``, with zero-point faults at
    the ``sec_attention`` sites the protect list makes), paired step
    medians, resident weight bytes and peak memory, and one profiled step
    per path. Returns {path: launches}."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant import bitmaps
    from mixdq_tpu_torch.quant.deploy import layer_bits_from_ctrl
    from mixdq_tpu_torch.quant.state import (FP_CTX, apply_bitwidth_config,
                                             protect_layers,
                                             quantizable_layers,
                                             uniform_ctrl)

    wmap = bitmaps.load_bit_map(os.path.join(MP_DIR, "final_config",
                                             "weight", "5.04.yaml"))
    amap = bitmaps.load_bit_map(os.path.join(MP_DIR, "final_config", "act",
                                             "7.43.yaml"))
    protect = bitmaps.load_layer_list(os.path.join(MP_DIR,
                                                   "act_protect.yaml"))
    t0 = time.time()
    ctxs = {c: pipeline.quantize_mixed(unet, calib, wmap, amap, protect,
                                       deploy_compute=c) for c in MP_CALLS}
    torch.cuda.synchronize()
    log(f"sdxl-turbo mixed deploys (calibrate + deploy, x{len(ctxs)}): "
        f"{time.time() - t0:.1f}s, entries "
        f"{ {c: len(x.deploy) for c, x in ctxs.items()} }")
    ctrl = uniform_ctrl(list(quantizable_layers(unet)))
    ctrl = apply_bitwidth_config(ctrl, wmap, "weight")
    ctrl = apply_bitwidth_config(protect_layers(ctrl, protect), amap, "act")
    bits = layer_bits_from_ctrl(ctrl)
    labels = {c: MP_PATHS[c] for c in ctxs}
    for c, ctx in ctxs.items():
        if pipeline.expected_kernel_calls(
                unet.config, "auto", deploy=ctx.deploy,
                compute=c) != MP_CALLS[c]:
            raise AssertionError(f"{labels[c]}: the deploy's launch counts "
                                 "are not MP_CALLS")
    for ctx in ctxs.values():  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], ctx)
    outs, launches = {}, {}
    for c, ctx in ctxs.items():
        outs[c], launches[labels[c]] = run_path(torch, unet, requests, ctx,
                                                labels[c])
        packed = sum(e.w_packed is not None for e in ctx.deploy.values())
        if launches[labels[c]]["wq4_matmul"] != packed * len(requests):
            raise AssertionError(f"{labels[c]}: {packed} packed entries, "
                                 f"{launches[labels[c]]['wq4_matmul']} "
                                 "wq4_matmul launches")

    refs = [pipeline.unet_step(unet, r) for r in requests]
    sqnrs = {labels[c]: [] for c in ctxs}
    wonly = "pallas_dequant vs dequant"
    swapped = f"pallas_dequant, {MP_FAULT_PACKED} nibbles swapped, vs dequant"
    sqnrs.update({wonly: [], swapped: []})
    bad = nibble_swapped_ctx(ctxs["pallas_dequant"], MP_FAULT_PACKED)
    for i, (r, ref) in enumerate(zip(requests, refs)):
        for c in ctxs:
            x = outs[c][i]
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"{labels[c]}: bad output {x.shape}")
            sqnrs[labels[c]].append(sqnr_db(ref, x))
        sqnrs[wonly].append(sqnr_db(outs["dequant"][i],
                                    outs["pallas_dequant"][i]))
        sqnrs[swapped].append(sqnr_db(outs["dequant"][i],
                                      pipeline.unet_step(unet, r, bad)))
    for k, v in sqnrs.items():
        log(f"SQNR {k if 'vs' in k else k + ' vs bf16'} per request (dB): "
            f"{[round(x, 2) for x in v]}")
    if min(min(sqnrs[labels[c]]) for c in ctxs) < MP_SQNR_DB:
        raise AssertionError(f"mixed SQNR vs bf16 < {MP_SQNR_DB} dB")
    if min(sqnrs[wonly]) < WONLY_SQNR_DB:
        raise AssertionError(f"{wonly}: {sqnrs[wonly]} dB < {WONLY_SQNR_DB}")
    if max(sqnrs[swapped]) >= WONLY_SQNR_DB:
        raise AssertionError(f"the {WONLY_SQNR_DB} dB gate misses swapped "
                             f"nibbles: {sqnrs[swapped]}")

    # every entry against fake quantization at its bits, and the faults
    a4 = next(n for n, e in sorted(ctxs["int8_sec"].deploy.items())
              if e.kind == "linear" and e.a_bits == 4 and not e.act_off
              and not n.endswith(("to_qkv", "to_kv", ".ff.net.0.proj")))
    faults = {"pallas_dequant": (nibble_swapped_ctx, MP_FAULT_PACKED),
              "int8_sec": (a8_clip_ctx, a4)}
    for c, ctx in ctxs.items():
        names = [n for n, e in ctx.deploy.items() if e.kind != "fused_away"]
        s = layer_sqnrs(torch, unet, ctx, qparams, seen, names, bits)
        low = sorted(s.items(), key=lambda kv: kv[1])
        log(f"{labels[c]}: per-entry SQNR vs fake quantization over {len(s)}"
            f" entries (dB): min {low[0][1]:.2f} median "
            f"{statistics.median(s.values()):.2f}; lowest "
            f"{[(n, round(v, 2)) for n, v in low[:3]]}")
        for kind, test in (("weight-only", lambda e: e.act_off),
                           ("packed", lambda e: e.w_packed is not None),
                           ("A2/A4", lambda e: not e.act_off
                            and e.a_bits < 8)):
            v = [s[n] for n in names if test(ctx.deploy[n])]
            if v:
                log(f"  {kind} entries: {len(v)}, min {min(v):.2f} dB")
        if low[0][1] < LAYER_SQNR_DB:
            raise AssertionError(f"{labels[c]} entry {low[0][0]}: SQNR "
                                 f"{low[0][1]} dB < {LAYER_SQNR_DB}")
        if c in faults:
            fault, name = faults[c]
            f = layer_sqnrs(torch, unet, fault(ctx, name), qparams, seen,
                            [name], bits)[name]
            log(f"{labels[c]}: per-entry SQNR of {name} with its "
                f"{fault.__name__[:-4]} fault: {f:.2f} dB")
            if f >= LAYER_SQNR_DB:
                raise AssertionError(f"the per-entry check misses the fault "
                                     f"in {name}")
    kernels = phase_attention_sites(torch, unet, ctxs["int8_sec"],
                                    requests[0], MP_FAULT_SITES)
    log(f"{labels['int8_sec']} attention kernels: "
        f"{dict(collections.Counter(kernels.values()))}")

    paths = (("bf16", FP_CTX), ("w8a8_auto", w8a8_ctx),
             *((f"mp_{c}", ctxs[c]) for c in ctxs))
    paired_step_ms(torch, unet, requests, paths, card, "sdxl-turbo mixed")
    for tag, ctx in paths:
        total, dep = resident_weight_bytes(
            unet, ctx.deploy if ctx.mode == "int8" else {})
        peak, rise = step_peak_bytes(torch, unet, requests[0], ctx)
        log(f"{tag}: resident weights {total / 2**20:.1f} MiB (deploy "
            f"entries {dep / 2**20:.1f} MiB); one step: "
            f"max_memory_allocated {peak / 2**20:.1f} MiB, "
            f"{rise / 2**20:.1f} MiB above the step's start")
    phase_profile(torch, unet, requests[0],
                  [(f"mp_{c}", ctxs[c]) for c in ctxs])
    return launches


def step_ms(torch, fn):
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def run_path(torch, unet, requests, ctx, label):
    """One path (``ctx``: a deploy under its compute and kernel options, or
    FP; either ``attn_impl``) over ``requests`` with the launch counts set to 0 just
    before it and read just after; fails unless every kernel launched as
    often as the structure and the deploy imply, and every wrapper call
    launched its kernel."""
    from mixdq_tpu_torch import ops, pipeline

    ops.reset_counts()
    outs = [pipeline.unet_step(unet, r, ctx) for r in requests]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    per_step = pipeline.ctx_kernel_calls(unet.config, ctx)
    want = {k: v * len(requests) for k, v in per_step.items()}
    log(f"{label} path launches over {len(requests)} requests: {launches}")
    if launches != want or ops.call_counts() != launches:
        raise AssertionError(f"{label} launch counts {launches}, calls "
                             f"{ops.call_counts()}, expected {want}")
    return outs, launches


def phase_main_path(torch, dev, card):
    """The SDXL-Turbo step under ``attn_impl='auto'`` (``quantize_w8a8``'s
    context, the headline) and ``'einsum'`` on the same deploy."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sdxl-turbo", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sdxl-turbo", 1, 0, bf16, dev)
    ctx = pipeline.quantize_w8a8(unet, calib)
    ectx = dataclasses.replace(ctx, attn_impl="einsum")
    torch.cuda.synchronize()
    log(f"sdxl-turbo build+calibrate+deploy: {time.time() - t0:.1f}s, "
        f"{len(ctx.deploy)} deploy entries")
    if pipeline.expected_kernel_calls(unet.config, "auto") != TURBO_CALLS:
        raise AssertionError("the structure's launch counts changed")
    requests = [pipeline.example_inputs("sdxl-turbo", 1, 100 + i, bf16, dev)
                for i in range(N_REQUESTS)]
    for c in (ctx, ectx):  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    torch.cuda.synchronize()
    outs, launches = run_path(torch, unet, requests, ctx, "sdxl-turbo auto")
    e_outs, e_launches = run_path(torch, unet, requests, ectx,
                                  "sdxl-turbo einsum")

    refs = []
    sqnrs = {"auto": [], "einsum": [], "auto vs einsum": []}
    for r, q, e in zip(requests, outs, e_outs):
        ref = pipeline.unet_step(unet, r)
        for x in (q, e):
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"bad int8 output {x.shape}")
        refs.append(ref)
        sqnrs["auto"].append(sqnr_db(ref, q))
        sqnrs["einsum"].append(sqnr_db(ref, e))
        sqnrs["auto vs einsum"].append(sqnr_db(e, q))
    for k, v in sqnrs.items():
        log(f"SQNR {k if 'vs' in k else k + ' vs bf16'} per request (dB): "
            f"{[round(x, 2) for x in v]}")
    if min(sqnrs["auto"] + sqnrs["einsum"]) < MIN_SQNR_DB:
        raise AssertionError(f"SQNR {sqnrs} dB < {MIN_SQNR_DB}")
    for name in FAULT_LAYERS:
        bad = faulted_ctx(ctx, name)
        s = [sqnr_db(ref, pipeline.unet_step(unet, r, bad))
             for r, ref in zip(requests, refs)]
        log(f"SQNR with one fault in {name} (dB): {[round(x, 2) for x in s]}")
        if name == FAULT_LAYERS[-1] and max(s) >= MIN_SQNR_DB:
            raise AssertionError(f"the SQNR gate misses a fault in {name}")

    paired_step_ms(torch, unet, requests,
                   (("bf16", FP_CTX), ("auto", ctx), ("einsum", ectx)), card,
                   "sdxl-turbo")
    return unet, ctx, calib, requests, launches, e_launches, refs, outs


def phase_layers(torch, unet, ctx, calib, req):
    """Every deploy entry of the full-width deploy, teacher-forced on the
    input its layer sees in an FP step, against ``fake_quant_layer``. A
    one-layer fault that the whole-model SQNR cannot tell from request to
    request spread shows here; each of ``FAULT_LAYERS`` proves it."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.calibrate import calibrate

    qparams = calibrate(unet, [calib], pipeline.WQ, pipeline.AQ)
    seen = record_layer_inputs(torch, unet, req)
    names = [n for n, e in ctx.deploy.items() if e.kind != "fused_away"]
    s = layer_sqnrs(torch, unet, ctx, qparams, seen, names)
    low = sorted(s.items(), key=lambda kv: kv[1])
    log(f"per-layer SQNR vs fake quantization over {len(s)} deploy entries "
        f"(dB): min {low[0][1]:.2f} median {statistics.median(s.values()):.2f}"
        f"; lowest {[(n, round(v, 2)) for n, v in low[:4]]}")
    if low[0][1] < LAYER_SQNR_DB:
        raise AssertionError(f"layer {low[0][0]}: SQNR {low[0][1]} dB < "
                             f"{LAYER_SQNR_DB}")
    for name in FAULT_LAYERS:
        f = layer_sqnrs(torch, unet, faulted_ctx(ctx, name), qparams, seen,
                        [name])[name]
        log(f"per-layer SQNR with one fault in {name}: {f:.2f} dB")
        if f >= LAYER_SQNR_DB:
            raise AssertionError(f"the per-layer check misses a fault in "
                                 f"{name}")
    return qparams, seen


def record_attention_inputs(torch, unet, req, ctx=None, ff=False):
    """{attention module name: (residual stream, encoder states)} of every
    attention module (and with ``ff`` every feed-forward, encoder states
    None) in one step under ``ctx`` (default: FP)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.attention import Attention, FeedForward

    seen = {}

    def hook(mod, args, kwargs):
        seen[mod.qname] = (kwargs["residual"],
                           args[1] if isinstance(mod, Attention) else None)

    kinds = (Attention, FeedForward) if ff else Attention
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in unet.modules() if isinstance(m, kinds)]
    try:
        pipeline.unet_step(unet, req, *([] if ctx is None else [ctx]))
    finally:
        for h in handles:
            h.remove()
    return seen


def attention_site(torch, unet, name, stream, ehs, ctx):
    """Attention (or feed-forward) module ``name`` run as its transformer
    block runs it (the block's pre-LayerNorm, deferred or materialized as
    ``ctx`` says, and the residual add) on ``stream``."""
    block, _, which = name.rpartition(".")
    blk = unet.get_submodule(block)
    if which == "attn1":
        norm, consumer = blk.norm1, (f"{block}.attn1.to_qkv"
                                     if ctx.fuse_qkv else None)
    elif which == "attn2":
        norm, consumer = blk.norm2, f"{block}.attn2.to_q"
    else:
        norm, consumer = blk.norm3, f"{block}.ff.net.0.proj"
    with torch.inference_mode():
        h, ln = blk._ln(stream, norm, consumer, ctx)
        if which == "ff":
            return blk.ff(h, ctx, residual=stream, ln=ln)
        return getattr(blk, which)(h, ehs, ctx, residual=stream, ln=ln)


def zp_faulted_ctx(ctx, name):
    """``ctx`` with entry ``name``'s act zero point shifted by 8 codes (its
    ``bias0`` keeps the sound one)."""
    import dataclasses

    e = ctx.deploy[name]
    return dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: e.replace(zp_shifted=e.zp_shifted + 8.0)})


def site_sqnrs(torch, unet, ctx, seen, names=None, ref_ctx=None,
               kernels=None):
    """SQNR in dB of each attention (or feed-forward) module's output
    delta under ``ctx`` against the same module under ``ref_ctx``
    (default: ``ctx`` with ``attn_impl='einsum'``), both teacher-forced on
    the FP-step input. ``kernels``: a dict that gets each module's kernel
    under ``ctx`` (an attention route or a feed-forward kernel; ``'einsum'``
    where none ran)."""
    import dataclasses

    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.models import routing

    ref_ctx = ref_ctx or dataclasses.replace(ctx, attn_impl="einsum")
    site_kernels = routing.KERNELS + ("geglu_out_qmatmul", "geglu_qmatmul")
    out = {}
    for name in names or sorted(seen):
        stream, ehs = seen[name]
        ops.reset_counts()
        got = attention_site(torch, unet, name, stream, ehs, ctx).float()
        if kernels is not None:
            calls = ops.call_counts()
            kernels[name] = next((k for k in site_kernels if calls[k]),
                                 routing.EINSUM)
        ref = attention_site(torch, unet, name, stream, ehs, ref_ctx).float()
        signal = (ref - stream.float()).pow(2).sum().item()
        err = (got - ref).pow(2).sum().item()
        out[name] = math.inf if err == 0 else 10 * math.log10(signal / err)
    return out


def site_gate(ctx, site):
    """The per-site SQNR limit: ``SITE_SQNR_DB`` where ``to_out`` takes
    8-bit act codes, ``SITE_DB_PER_BIT`` lower for each bit below 8 (one
    code apart between two kernels costs a step that doubles per bit
    dropped, at half the rate)."""
    e = ctx.entry(f"{site}.to_out.0")
    a_bits = 8 if e is None or e.act_off else e.a_bits
    return SITE_SQNR_DB - SITE_DB_PER_BIT * (8 - a_bits)


def phase_attention_sites(torch, unet, ctx, req, fault_sites=FAULT_SITES):
    """Every attention module, teacher-forced on its FP-step input, under
    ``ctx`` (``attn_impl='auto'``) against ``attn_impl='einsum'`` on the
    same deploy (>= ``site_gate``): a fault at one attention kernel's
    site, which the whole-step SQNR cannot see, shows here. Each of
    ``fault_sites`` (a to_out entry whose act zero point the kernel sees
    shifted by 8 codes) proves it. Returns {module: its attention kernel
    under ``ctx``}."""
    import dataclasses

    seen = record_attention_inputs(torch, unet, req)
    kernels = {}
    s = site_sqnrs(torch, unet, ctx, seen, kernels=kernels)
    low = sorted(s.items(), key=lambda kv: kv[1])
    log(f"attention sites auto vs einsum over {len(s)} modules (dB): min "
        f"{low[0][1]:.2f} median {statistics.median(s.values()):.2f}; "
        f"lowest {[(n, round(v, 2)) for n, v in low[:4]]}")
    for k in sorted(set(kernels.values())):
        v = [s[n] for n in s if kernels[n] == k]
        log(f"  {k} sites: {len(v)}, min {min(v):.2f} median "
            f"{statistics.median(v):.2f} dB")
    for gate in sorted({site_gate(ctx, n) for n in s}):
        v = [s[n] for n in s if site_gate(ctx, n) == gate]
        log(f"  sites with limit {gate:.1f} dB: {len(v)}, min {min(v):.2f}")
    bad = [(n, v) for n, v in low if v < site_gate(ctx, n)]
    if bad:
        raise AssertionError(f"sites below their SQNR limit: {bad}")
    einsum = dataclasses.replace(ctx, attn_impl="einsum")
    for name in fault_sites:
        site = name[:-len(".to_out.0")]
        f = site_sqnrs(torch, unet, zp_faulted_ctx(ctx, name), seen, [site],
                       ref_ctx=einsum)[site]
        log(f"attention site SQNR with the {name} zero point shifted by 8 "
            f"codes: {f:.2f} dB")
        if f >= site_gate(ctx, site):
            raise AssertionError(f"the site check misses a fault in {name}")
    return kernels


def phase_outfuse_sites(torch, unet, ctx, req,
                        fault_sites=OUTFUSE_FAULT_SITES):
    """Every attn1 and ff module, teacher-forced on its FP-step input,
    with every site out-fused (LN folded, then not) against the same
    module under ``ctx`` (the default route, same deploy): >=
    ``OUTFUSE_SITE_SQNR_DB``; each of ``fault_sites`` (a whole-block
    kernel's mid act quantizer, to_out's or ff.net.2's, with its zero
    point shifted by 8 codes) must fail. Returns {module: its kernel with
    every site out-fused}."""
    import dataclasses

    seen = record_attention_inputs(torch, unet, req, ff=True)
    names = sorted(n for n in seen if n.endswith((".attn1", ".ff")))
    kernels = {}
    for tag in ("all", "all_nofold"):
        octx = dataclasses.replace(ctx, **OUTFUSE_PATHS[tag])
        s = site_sqnrs(torch, unet, octx, seen, names, ref_ctx=ctx,
                       kernels=kernels)
        for kind in (".attn1", ".ff"):
            v = [x for n, x in s.items() if n.endswith(kind)]
            log(f"out-fusion {tag}: {len(v)} {kind[1:]} modules vs the "
                f"default route (dB): min {min(v):.2f} median "
                f"{statistics.median(v):.2f}")
        low = min(s.items(), key=lambda kv: kv[1])
        if low[1] < OUTFUSE_SITE_SQNR_DB:
            raise AssertionError(f"out-fusion {tag}: {low[0]} at {low[1]} dB "
                                 f"< {OUTFUSE_SITE_SQNR_DB}")
    octx = dataclasses.replace(ctx, **OUTFUSE_PATHS["all"])
    for name in fault_sites:
        site = name[:-len(".to_out.0" if name.endswith(".to_out.0")
                          else ".net.2")]
        f = site_sqnrs(torch, unet, zp_faulted_ctx(octx, name), seen, [site],
                       ref_ctx=ctx)[site]
        log(f"out-fusion site {site} with the {name} zero point shifted by "
            f"8 codes: {f:.2f} dB")
        if f >= OUTFUSE_SITE_SQNR_DB:
            raise AssertionError(f"the out-fusion site check misses a fault "
                                 f"in {name}")
    return kernels


@contextlib.contextmanager
def whole_block_drops_residual():
    """Within the block, the first ``sec_attention_qkv_out`` call returns
    its output without the residual (a whole-block kernel that drops its
    residual add at one site of a step)."""
    from mixdq_tpu_torch.models import attention as mod

    sound = mod.sec_attention_qkv_out
    calls = []

    def faulted(x, *args, **kw):
        out = sound(x, *args, **kw)
        calls.append(1)
        res = x if kw.get("ln") is not None else args[9]
        if len(calls) > 1 or res is None:
            return out
        return (out.float() - res.float()).to(out.dtype)

    mod.sec_attention_qkv_out = faulted
    try:
        yield
    finally:
        mod.sec_attention_qkv_out = sound


def phase_outfuse(torch, unet, ctx, requests, refs, outs, card):
    """The SDXL-Turbo deploy of phase 3 under the other out-fusion sets
    (``OUTFUSE_PATHS``: every site, LN folded and not; none) beside the
    default: launch counts (``OUTFUSE_CALLS``), SQNR against bf16 (>=
    ``MIN_SQNR_DB``), the whole step against the default route's ``outs``
    (>= ``OUTFUSE_STEP_SQNR_DB``, failed by an attn1 site that drops its
    residual), every attn1 / ff module against the default route, paired
    step medians and one profiled step of every site out-fused. Returns
    {path: launches}."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    ctxs = {tag: dataclasses.replace(ctx, **o)
            for tag, o in OUTFUSE_PATHS.items()}
    for tag, c in ctxs.items():
        if pipeline.ctx_kernel_calls(unet.config, c) != OUTFUSE_CALLS[tag]:
            raise AssertionError(f"out-fusion {tag}: the launch counts are "
                                 "not OUTFUSE_CALLS")
    for c in ctxs.values():  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    launches, sqnrs = {}, {}
    for tag, c in ctxs.items():
        label = f"sdxl-turbo outfuse {tag}"
        got, launches[label] = run_path(torch, unet, requests, c, label)
        for x in got:
            if x.shape != refs[0].shape or not torch.isfinite(x).all():
                raise AssertionError(f"{label}: bad output {x.shape}")
        sqnrs[f"{tag} vs bf16"] = [sqnr_db(r, x) for r, x in zip(refs, got)]
        sqnrs[f"{tag} vs default"] = [sqnr_db(o, x) for o, x in zip(outs, got)]
    bad = []
    for r in requests:
        with whole_block_drops_residual():
            bad.append(pipeline.unet_step(unet, r, ctxs["all"]))
    sqnrs["all, one attn1 dropping its residual, vs default"] = [
        sqnr_db(o, x) for o, x in zip(outs, bad)]
    for k, v in sqnrs.items():
        log(f"SQNR out-fusion {k} per request (dB): "
            f"{[round(x, 2) for x in v]}")
    if min(min(sqnrs[f"{t} vs bf16"]) for t in ctxs) < MIN_SQNR_DB:
        raise AssertionError(f"out-fusion SQNR vs bf16 < {MIN_SQNR_DB} dB")
    if min(min(sqnrs[f"{t} vs default"]) for t in ctxs) < \
            OUTFUSE_STEP_SQNR_DB:
        raise AssertionError(f"out-fusion vs default < {OUTFUSE_STEP_SQNR_DB}"
                             " dB")
    if max(sqnrs["all, one attn1 dropping its residual, vs default"]) >= \
            OUTFUSE_STEP_SQNR_DB:
        raise AssertionError("the out-fusion step gate misses a dropped "
                             "residual")
    kernels = phase_outfuse_sites(torch, unet, ctx, requests[0])
    log(f"out-fusion modules by kernel: "
        f"{dict(collections.Counter(kernels.values()))}")
    paired_step_ms(torch, unet, requests,
                   (("bf16", FP_CTX), ("default", ctx),
                    *((f"outfuse_{t}", c) for t, c in ctxs.items())), card,
                   "sdxl-turbo out-fusion")
    phase_profile(torch, unet, requests[0], [("outfuse_all", ctxs["all"])])
    return launches


@contextlib.contextmanager
def int8_flash_q_scale_doubled():
    """Within the block, the int8 flash attention of the UNet dequantizes
    its logits with twice the q scale."""
    from mixdq_tpu_torch.ops import attention as mod

    sound = mod._int8_operands

    def faulted(*args, **kw):
        qi, ki, v, s_qk, sv = sound(*args, **kw)
        return qi, ki, v, 2 * s_qk, sv

    mod._int8_operands = faulted
    try:
        yield
    finally:
        mod._int8_operands = sound


def phase_int8_flash_sites(torch, unet, ctx, req):
    """Each int8 flash site of the SDXL 1024 deploy under
    ``int8_flash`` 'qk' and 'qkv', teacher-forced on its FP-step input,
    against the bf16 flash site of ``ctx`` (same deploy) on the same
    input (>= ``INT8_FLASH_SITE_SQNR_DB``); with its q scale doubled, the
    first site must fail."""
    import dataclasses

    seen = record_attention_inputs(torch, unet, req)
    names = sorted(n for n, (x, ehs) in seen.items()
                   if ehs is None and x.shape[1] ** 2 >= 2 ** 22)
    for mode, gate in INT8_FLASH_SITE_SQNR_DB.items():
        c = dataclasses.replace(ctx, int8_flash=mode)
        kernels = {}
        s = site_sqnrs(torch, unet, c, seen, names, ref_ctx=ctx,
                       kernels=kernels)
        v = [s[n] for n in names]
        log(f"sdxl int8 flash {mode}: {len(v)} sites "
            f"({dict(collections.Counter(kernels.values()))}) vs bf16 flash "
            f"(dB): min {min(v):.2f} median {statistics.median(v):.2f} "
            f"max {max(v):.2f}")
        if min(v) < gate:
            raise AssertionError(f"sdxl int8 flash {mode} site SQNR {min(v)} "
                                 f"dB < {gate}")
        with int8_flash_q_scale_doubled():
            f = site_sqnrs(torch, unet, c, seen, names[:1],
                           ref_ctx=ctx)[names[0]]
        log(f"sdxl int8 flash {mode} site {names[0]} with its q scale "
            f"doubled: {f:.2f} dB")
        if f >= gate:
            raise AssertionError(f"the int8 flash {mode} site check misses a "
                                 "doubled q scale")


def phase_profile(torch, unet, req, paths):
    """Device time by kernel over one step of each of ``paths`` ((tag,
    context) pairs), written to ``chiprun_out/profile_{tag}.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from mixdq_tpu_torch import pipeline

    os.makedirs(OUT_DIR, exist_ok=True)
    for tag, c in paths:
        args = (unet, req, c)
        pipeline.unet_step(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipeline.unet_step(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = getattr(e, "cuda_time_total", 0)
            if dt and str(getattr(e, "device_type", "")).endswith("CUDA"):
                rows.append((dt / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
            f.write(f"wall_ms {wall:.3f} device_busy_ms {busy:.3f}\n")
            for ms, n, key in rows:
                f.write(f"{ms:10.4f} ms {n:6d}  {key}\n")
        if not rows:
            log(f"profile {tag}: no device time recorded (not measured)")
            continue
        log(f"profile {tag}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"(idle share {max(0.0, 1 - busy / wall):.3f})")
        for ms, n, key in rows[:8]:
            log(f"  {ms:9.4f} ms x{n:5d} {key[:90]}")


def paired_step_ms(torch, unet, requests, paths, card, label):
    """Median step time of each of ``paths`` ((tag, context) pairs) over
    ``TIMING_ROUNDS`` rounds of ``requests``, the paths in turn for each
    request (CUDA events)."""
    from mixdq_tpu_torch import pipeline

    times = {tag: [] for tag, _ in paths}
    for _ in range(TIMING_ROUNDS):
        for r in requests:
            for tag, c in paths:
                times[tag].append(step_ms(
                    torch, lambda: pipeline.unet_step(unet, r, c)))
    med = {k: statistics.median(v) for k, v in times.items()}
    n = len(next(iter(times.values())))
    log(f"{label} step ms (median of {n} paired steps, CUDA events, {card}): "
        + " ".join(f"{k}={v:.3f}" for k, v in med.items()) + " "
        + " ".join(f"bf16/{k}={med['bf16'] / v:.3f}" for k, v in med.items()
                   if k != "bf16"))
    return med


@contextlib.contextmanager
def flash_drops_key_block():
    """Within the block, the UNet's flash attention drops the last block of
    keys at every site (a kernel that skips one key block)."""
    from mixdq_tpu_torch.models import attention as mod
    from mixdq_tpu_torch.ops.attention import flash_block_keys

    sound = mod.flash_attention

    def faulted(q_src, k_src, v_src, **kw):
        n = k_src.shape[1] - flash_block_keys(kw["head_dim"])
        return sound(q_src, k_src[:, :n].contiguous(),
                     v_src[:, :n].contiguous(), **kw)

    mod.flash_attention = faulted
    try:
        yield
    finally:
        mod.flash_attention = sound


def phase_flash_sites(torch, unet, ctx, req):
    """Each flash attention site of the bf16 UNet under ``ctx``
    (``attn_impl='auto'``), teacher-forced on its FP-step input, against
    the einsum chain (>= ``FLASH_SITE_SQNR_DB``); with its last key block
    dropped, the first site must fail that check."""
    seen = record_attention_inputs(torch, unet, req)
    kernels = {}
    s = site_sqnrs(torch, unet, ctx, seen, kernels=kernels)
    sites = sorted(n for n, k in kernels.items() if k == "flash_attention")
    v = [s[n] for n in sites]
    log(f"sdxl bf16 flash sites auto vs einsum: {len(v)}, min {min(v):.2f} "
        f"median {statistics.median(v):.2f} dB")
    if min(v) < FLASH_SITE_SQNR_DB:
        raise AssertionError(f"sdxl bf16 flash site SQNR {min(v)} dB < "
                             f"{FLASH_SITE_SQNR_DB}")
    with flash_drops_key_block():
        f = site_sqnrs(torch, unet, ctx, seen, sites[:1])[sites[0]]
    log(f"sdxl bf16 flash site {sites[0]} with its last key block dropped: "
        f"{f:.2f} dB")
    if f >= FLASH_SITE_SQNR_DB:
        raise AssertionError("the site check misses a dropped key block")


def phase_sdxl(torch, dev, card):
    """SDXL at 1024 px: the W8A8 deploy under ``'auto'`` (bf16 and both
    int8 flash modes) and ``'einsum'`` and the bf16 UNet under ``'auto'``,
    each path's launches against the
    structure (and ``SDXL_CALLS``), SQNR against bf16, bf16 auto (flash
    attention) against bf16 einsum, whole and per flash site, with a
    dropped key block that must fail both, every attention site auto
    against einsum with zero-point faults, each int8 flash site against
    the bf16 flash site (``phase_int8_flash_sites``), paired step medians
    and one profiled step per path. Returns
    ({path: launches per step}, {path: launches})."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sdxl", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sdxl", 1, 0, bf16, dev)
    ctx = pipeline.quantize_w8a8(unet, calib)
    paths = (("bf16", dataclasses.replace(FP_CTX, attn_impl="auto")),
             ("auto", ctx), ("einsum", dataclasses.replace(
                 ctx, attn_impl="einsum")),
             ("int8_qk", dataclasses.replace(ctx, int8_flash="qk")),
             ("int8_qkv", dataclasses.replace(ctx, int8_flash="qkv")))
    int8 = [tag for tag, _ in paths if tag != "bf16"]
    torch.cuda.synchronize()
    log(f"sdxl build+calibrate+deploy: {time.time() - t0:.1f}s, "
        f"{len(ctx.deploy)} deploy entries")
    for tag, c in paths:
        if pipeline.expected_kernel_calls(
                unet.config, c.attn_impl, mode=c.mode,
                int8_flash=c.int8_flash) != SDXL_CALLS[tag]:
            raise AssertionError(f"sdxl {tag}: the structure's launch "
                                 "counts changed")
    requests = [pipeline.example_inputs("sdxl", 1, 200 + i, bf16, dev)
                for i in range(N_SDXL_REQUESTS)]
    for _, c in paths:  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    outs, launches = {}, {}
    for tag, c in paths:
        outs[tag], launches[f"sdxl {tag}"] = run_path(
            torch, unet, requests, c, f"sdxl {tag}")
    flash = "bf16 auto vs bf16 einsum"
    dropped = "bf16 auto, flash dropping a key block, vs bf16 einsum"
    sqnrs = {**{tag: [] for tag in int8}, flash: [], dropped: []}
    for i, r in enumerate(requests):
        ref = outs["bf16"][i]
        for tag in int8:
            x = outs[tag][i]
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"sdxl {tag}: bad output {x.shape}")
            sqnrs[tag].append(sqnr_db(ref, x))
        fp_einsum = pipeline.unet_step(unet, r)
        sqnrs[flash].append(sqnr_db(fp_einsum, ref))
        with flash_drops_key_block():
            sqnrs[dropped].append(sqnr_db(
                fp_einsum, pipeline.unet_step(unet, r, paths[0][1])))
    for k, v in sqnrs.items():
        log(f"sdxl SQNR {k if 'vs' in k else k + ' vs bf16 auto'} per "
            f"request (dB): {[round(x, 2) for x in v]}")
    if min(min(sqnrs[tag]) for tag in int8) < MIN_SQNR_DB:
        raise AssertionError(f"sdxl SQNR {sqnrs} dB < {MIN_SQNR_DB}")
    if min(sqnrs[flash]) < FLASH_SQNR_DB:
        raise AssertionError(f"sdxl {flash}: {sqnrs[flash]} dB < "
                             f"{FLASH_SQNR_DB}")
    if max(sqnrs[dropped]) >= FLASH_SQNR_DB:
        raise AssertionError(f"the {FLASH_SQNR_DB} dB gate on {flash} misses "
                             f"a dropped key block: {sqnrs[dropped]} dB")
    paired_step_ms(torch, unet, requests, paths, card, "sdxl")
    phase_attention_sites(torch, unet, ctx, requests[0], SDXL_FAULT_SITES)
    phase_flash_sites(torch, unet, paths[0][1], requests[0])
    phase_int8_flash_sites(torch, unet, ctx, requests[0])
    phase_profile(torch, unet, requests[0],
                  [(f"sdxl_{tag}", c) for tag, c in paths])
    return {p: {k: v // N_SDXL_REQUESTS for k, v in c.items()}
            for p, c in launches.items()}, launches


def main():
    import dataclasses
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mixdq_tpu_torch.ops import _build
    from mixdq_tpu_torch.quant.state import FP_CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build_all()
    log(f"phase 0: built {len(_build.SOURCES)} kernel sources in "
        f"{time.time() - t0:.1f}s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "nvcc_build.txt"), "w") as f:
        for src, text in _build.BUILD_LOGS.items():
            f.write(f"===== {src}\n{text}\n")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    report = phase_kernels(torch, dev, flush)
    del flush
    log("phase 1: every kernel matches its plain version")
    phase_tiny_parity(torch, dev)
    log("phase 2: tiny-sdxl and small-sdxl parity ok under both attn_impl "
        "values and small-sdxl out-fused")
    unet, ctx, calib, requests, launches, e_launches, refs, outs = \
        phase_main_path(torch, dev, card)
    req = requests[0]
    log("phase 3: main paths ok (auto, einsum)")
    totals = {"sdxl-turbo auto": launches, "sdxl-turbo einsum": e_launches}
    totals.update(phase_outfuse(torch, unet, ctx, requests, refs, outs, card))
    del refs, outs
    log("phase 3: out-fusion paths ok (all sites, all sites without LN "
        "fold, none)")
    qparams, seen = phase_layers(torch, unet, ctx, calib, req)
    log("phase 4: every deploy entry matches fake quantization")
    phase_attention_sites(torch, unet, ctx, req)
    log("phase 4: every attention site matches under auto and einsum")
    phase_profile(torch, unet, req, (
        ("auto", ctx), ("einsum", dataclasses.replace(ctx, attn_impl="einsum")),
        ("bf16", FP_CTX)))
    log("phase 5: profiles written")
    totals.update(phase_mixed(torch, unet, calib, requests, ctx, qparams,
                              seen, card))
    log("phase 6: mixed-precision paths ok (mp auto, w-only dequant, "
        "w-only pallas_dequant)")
    del unet, ctx, calib, req, requests, qparams, seen
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {p: {k: v // N_REQUESTS for k, v in c.items()}
                for p, c in totals.items()}
    sdxl_per_step, sdxl_totals = phase_sdxl(torch, dev, card)
    per_step.update(sdxl_per_step)
    totals.update(sdxl_totals)
    log("phase 7: sdxl 1024 paths ok (auto, int8 flash qk / qkv, einsum, "
        "bf16 auto)")

    log(json.dumps({"tpu_kernels": [
        {"tpu_kernel": f"mixdq_tpu/ops/{tk}",
         "status": f"ported: {k}" if k else "still to port"}
        for tk, k in TPU_KERNELS]}))
    kernels = []
    for name, (src, replaces) in PORTED.items():
        r = report[name]
        first, extra = r["shapes"][0], {}
        if first["library_ms"] is not None:
            extra["library"] = LIBRARY[name]
        # the main path a kernel runs on: the SDXL-Turbo headline, else the
        # weight-only pallas_dequant step, else SDXL 1024 under auto, else
        # the path of its kernel option
        main_path = next((p for p in ("sdxl-turbo auto",
                                      MP_PATHS["pallas_dequant"], "sdxl auto",
                                      "sdxl-turbo outfuse all",
                                      "sdxl int8_qk", "sdxl int8_qkv")
                          if totals[p][name]), None)
        if main_path is None:
            raise AssertionError(f"{name} never launched on a main path")
        requests = (N_SDXL_REQUESTS if main_path.startswith("sdxl ")
                    else N_REQUESTS)
        kernels.append({
            **extra, "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": totals[main_path][name],
            "launches_path": main_path, "requests": requests,
            "launches_per_step": {p: c[name] for p, c in per_step.items()},
            "max_abs_err": r["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shape": first["shape"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
