#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: W8A8 SDXL-Turbo UNet
steps through the hand-written kernels.

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):

0. Build every CUDA kernel from ``mixdq_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once); the compiler's register / shared memory /
   spill report goes to ``chiprun_out/nvcc_build.txt``.
1. Each kernel against its plain PyTorch version at the main-path shapes
   (int8 codes: max |diff| <= 1 on < 1% of codes; floats rtol 1e-3 /
   atol 1e-2), with the kernel's and the plain version's time and the
   card's bound for the same work.
2. ``tiny-sdxl`` W8A8 step in float32: kernels on the GPU against the
   plain versions on the CPU (|d|/|ref| <= 1e-2, max |d| < 0.3).
3. The main path: SDXL-Turbo UNet at full width (random weights from a
   seed), calibrated on one request, deployed W8A8 (int8_sec, fused
   QKV/KV, BoS-aware, einsum attention), answering a few requests at
   bf16. Asserts the kernel launch counts, finite outputs, and the SQNR
   of int8 against the bf16 FP UNet (>= 16 dB); prints median step times.
   One-layer faults injected into the deploy show what that gate sees.
4. Every deploy entry at full width, teacher-forced on the input its
   layer sees in an FP step, against fake quantization computed from the
   quantizers' definition (>= 30 dB each); the injected faults must fail
   this check.
5. A per-kernel device-time breakdown of one step from torch.profiler
   (written to ``chiprun_out/``).

Stdout ends with the ``tpu_kernels`` table, the ``kernels`` line, the
card's name and power limit, and the ``ok`` line.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
N_REQUESTS = 4
TIMING_ROUNDS = 3
MIN_SQNR_DB = 16.0     # whole step, int8 vs bf16 (sound: about 20-23 dB)
LAYER_SQNR_DB = 30.0   # each deploy entry vs fake quantization
# one fault each: caught only per layer / by both gates
FAULT_LAYERS = ("mid_block.attentions.0.transformer_blocks.0.attn2.to_kv",
                "time_embedding.linear_1")
OUT_DIR = "chiprun_out"

# every function of the JAX package that reaches pl.pallas_call
TPU_KERNELS = [
    ("pallas_qconv.py:331 qconv2d_pallas", "qconv2d"),
    ("pallas_qconv.py:500 qconv2d_pallas_s2", "qconv2d_s2"),
    ("pallas_gn_quant.py:116 gn_silu_quantize", "gn_silu_quantize"),
    ("pallas_ln_quant.py:55 ln_quantize", "ln_quantize"),
    ("pallas_qmatmul.py:352 geglu_qmatmul", "geglu_qmatmul"),
    ("pallas_qmatmul.py:67 qmatmul", None),
    ("pallas_qmatmul.py:205 qmatmul_fused2", None),
    ("pallas_qmatmul.py:557 geglu_out_qmatmul", None),
    ("pallas_qmatmul.py:724 qmatmul_fused", None),
    ("pallas_sec_attention.py:99 sec_attention", None),
    ("pallas_sec_attention.py:223 sec_attention_q", None),
    ("pallas_sec_attention.py:409 sec_attention_qkv", None),
    ("pallas_sec_attention.py:647 sec_attention_qkv_out", None),
    ("pallas_sec_attention.py:814 sec_attention_q_out", None),
    ("pallas_attention.py:83 flash_attention", None),
    ("pallas_attention.py:204 int8_flash_attention", None),
    ("pallas_attention.py:303 int8qkv_flash_attention", None),
    ("pallas_wq_matmul.py:96 wq4_matmul", None),
    ("pallas_wq_matmul.py:164 wq_matmul", None),
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
}


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / peak
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
    """(kernel, shape label, kernel call, plain call, compare, bytes, ops,
    peak) at the main-path shapes; the first case of each kernel is its
    reported shape."""
    from mixdq_tpu_torch.ops import gn_quant, ln_quant, qconv, qmatmul

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
            float_err, nbytes, 2 * P * P * K * 9 * C, INT8_OPS_PER_S))
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
                      codes_err, 3 * n, 12 * n, F32_OPS_PER_S))
    for shape in [(1, 1024, 640), (1, 256, 1280)]:
        C = shape[-1]
        x = randn(*shape, dtype=bf16) * 3
        args = (x, torch.rand(C, generator=g, device=dev) + 0.5, randn(C),
                20.0, 3.0)
        n = x.numel()
        cases.append(("ln_quantize", str(list(shape)),
                      lambda a=args: ln_quant.ln_quantize(*a),
                      lambda a=args: ln_quant.ln_quantize_plain(*a),
                      codes_err, 3 * n, 8 * n, F32_OPS_PER_S))
    for M, K, H in [(256, 1280, 5120), (1024, 640, 2560)]:
        x, w = codes(M, K), codes(K, 2 * H)
        scale = (torch.rand(2 * H, generator=g, device=dev) + 0.5) * 2e-5
        bias0 = 5.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, 25.0, 4.0, randn(2 * H, dtype=bf16))
        cases.append(("geglu_qmatmul", f"M={M} K={K} 2H={2 * H}",
                      lambda a=args: qmatmul.geglu_qmatmul(*a),
                      lambda a=args: qmatmul.geglu_qmatmul_plain(*a),
                      codes_err, M * K + 2 * K * H + M * H, 4 * M * K * H,
                      INT8_OPS_PER_S))
    return cases


def phase_kernels(torch, dev, flush):
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.configs import get_family

    per_step = pipeline.expected_kernel_calls(get_family("sdxl-turbo").unet)
    report = {}
    for name, label, fn, plain, cmp, nbytes, ops, peak in kernel_cases(
            torch, dev):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err = cmp(torch, got, want)
        k_ms = time_ms(torch, fn, 20, flush)
        p_ms = time_ms(torch, plain, 3, flush)
        b_ms, b_by = bound(nbytes, ops, peak)
        log(f"kernel {name} [{label}]: max_abs_err={err} kernel_ms={k_ms:.4f}"
            f" plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})"
            f" launches/step={per_step[name]}")
        r = report.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append(dict(shape=label, ms=k_ms, plain_ms=p_ms,
                                bound_ms=b_ms, bound_by=b_by))
    return report


def to_device(qparams, dev):
    return {n: qp.replace(**{k: (None if v is None else v.to(dev))
                             for k, v in vars(qp).items()})
            for n, qp in qparams.items()}


def phase_tiny_parity(torch, dev):
    """Whole tiny-sdxl W8A8 step: GPU kernels vs CPU plain versions."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    f32 = torch.float32
    cpu_m = pipeline.build_unet("tiny-sdxl", 0, f32, "cpu")
    gpu_m = pipeline.build_unet("tiny-sdxl", 0, f32, dev)
    gpu_m.load_state_dict(cpu_m.state_dict())
    inp = pipeline.example_inputs("tiny-sdxl", 1, 0, f32, "cpu")
    inp_gpu = tuple(x.to(dev) if torch.is_tensor(x) else
                    {k: v.to(dev) for k, v in x.items()} for x in inp)
    qp = calibrate(cpu_m, [inp], pipeline.WQ, pipeline.AQ)
    ctrl = uniform_ctrl(list(quantizable_layers(cpu_m)))
    ref = pipeline.unet_step(cpu_m, inp, deploy_unet_ctx(
        cpu_m, qp, ctrl, pipeline.WQ, fuse_qkv=True))
    got = pipeline.unet_step(gpu_m, inp_gpu, deploy_unet_ctx(
        gpu_m, to_device(qp, dev), ctrl, pipeline.WQ, fuse_qkv=True)).cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    mx = (got - ref).abs().max().item()
    log(f"tiny-sdxl int8 step GPU vs CPU plain: rel={rel:.3e} max={mx:.3e}")
    if not (math.isfinite(rel) and rel <= 1e-2 and mx < 0.3):
        raise AssertionError(f"tiny-sdxl parity: rel {rel} max {mx}")


def sqnr_db(ref, got):
    ref, got = ref.float(), got.float()
    return 10 * math.log10((ref.pow(2).sum() / (ref - got).pow(2).sum()
                            ).item())


def fake_quant_layer(torch, m, x, kw, qp_w, qp_a, bos=False):
    """What the W8A8 deploy of layer ``m`` should give for its FP input
    ``x`` (call kwargs ``kw``), from the quantizers' definition in f32:
    the input as its dequantized 8-bit act codes under ``qp_a`` (rounding
    ``x * (1 / delta)``, as the deploy does; the BoS token kept FP when
    ``bos``), the weight as its dequantized codes under ``qp_w``, then
    bias, ``extra_bias`` and ``residual``. Shares no code with the deploy
    path (fused scales, ``bias0``, padded int8 GEMMs, kernels). Returns
    (output, output without the residual)."""
    import torch.nn.functional as F

    from mixdq_tpu_torch.pipeline import WQ

    b = WQ.candidate_bits.index(8)
    ad, az = qp_a.a_delta[b].float(), qp_a.a_zp[b].float()
    xf = x.float()
    xq = ((xf * (1 / ad)).round() + az).clamp(0, 255).sub(az).mul(ad)
    if bos:
        xq[..., :1, :] = xf[..., :1, :]
    wd = qp_w.w_delta[b].float()
    w = (m.weight.float() / wd).round().clamp(-128, 127) * wd
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


def layer_sqnrs(torch, unet, ctx, qparams, seen, names):
    """SQNR in dB of each deploy entry in ``names``, run alone on the
    input its layer saw in the FP step, against ``fake_quant_layer``; the
    signal is the layer's own output (without a fused residual). A fused
    QKV/KV entry runs as the attention runs it (anchor's codes, FP BoS
    row for cross-attention k/v); ``ff.net.0.proj`` also runs the GEGLU
    kernel, whose codes must match the reference within one code."""
    import torch.nn.functional as F

    from mixdq_tpu_torch.models.layers import bos_row, deploy_linear
    from mixdq_tpu_torch.pipeline import WQ
    from mixdq_tpu_torch.quant.state import quantizable_layers

    layers = quantizable_layers(unet)
    b = WQ.candidate_bits.index(8)
    out = {}
    with torch.inference_mode():
        for name in names:
            e = ctx.deploy[name]
            prefix, _, leaf = name.rpartition(".")
            if leaf in ("to_qkv", "to_kv"):
                members = [f"{prefix}.{n}" for n in (
                    ("to_q", "to_k", "to_v") if leaf == "to_qkv"
                    else ("to_k", "to_v"))]
                x = seen[members[0]][0]
                bos = leaf == "to_kv" and ctx.bos_aware
                got = deploy_linear(x, e, unet.dtype)
                if bos:
                    got = torch.cat([bos_row(x, e, unet.dtype),
                                     got[..., 1:, :]], -2)
                ref = torch.cat([fake_quant_layer(
                    torch, layers[n], x, {}, qparams[n], qparams[members[0]],
                    bos)[0] for n in members], -1)
                signal = ref
            else:
                m = layers[name]
                x, kw = seen[name]
                got = m(x, ctx, **kw)
                ref, signal = fake_quant_layer(torch, m, x, kw, qparams[name],
                                               qparams[name])
                if name.endswith(".ff.net.0.proj"):
                    consumer = name[:-len("0.proj")] + "2"
                    c_qp = qparams[consumer]
                    codes = m(x, ctx, geglu_out=ctx.entry(consumer))
                    h, g = ref.chunk(2, -1)
                    a = h * F.gelu(g, approximate=(
                        "tanh" if ctx.gelu == "tanh" else "none"))
                    want = ((a * (1 / c_qp.a_delta[b])).round()
                            + c_qp.a_zp[b]).clamp(0, 255) - 128
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


def step_ms(torch, fn):
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def phase_main_path(torch, dev, card):
    from mixdq_tpu_torch import ops, pipeline

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sdxl-turbo", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sdxl-turbo", 1, 0, bf16, dev)
    ctx = pipeline.quantize_w8a8(unet, calib)
    torch.cuda.synchronize()
    log(f"sdxl-turbo build+calibrate+deploy: {time.time() - t0:.1f}s, "
        f"{len(ctx.deploy)} deploy entries")
    requests = [pipeline.example_inputs("sdxl-turbo", 1, 100 + i, bf16, dev)
                for i in range(N_REQUESTS)]
    pipeline.unet_step(unet, requests[0], ctx)  # warm-up outside the count
    torch.cuda.synchronize()

    ops.reset_counts()
    outs = [pipeline.unet_step(unet, r, ctx) for r in requests]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    per_step = pipeline.expected_kernel_calls(unet.config)
    want = {k: v * N_REQUESTS for k, v in per_step.items()}
    log(f"main path launches over {N_REQUESTS} requests: {launches}")
    if launches != want or per_step != {
            "qconv2d": 38, "qconv2d_s2": 2, "gn_silu_quantize": 46,
            "ln_quantize": 210, "geglu_qmatmul": 70}:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    refs, sqnrs = [], []
    for r, q in zip(requests, outs):
        ref = pipeline.unet_step(unet, r)
        if q.shape != ref.shape or not torch.isfinite(q).all():
            raise AssertionError(f"bad int8 output {q.shape}")
        refs.append(ref)
        sqnrs.append(sqnr_db(ref, q))
    log(f"SQNR int8 vs bf16 per request (dB): "
        f"{[round(s, 2) for s in sqnrs]}")
    if min(sqnrs) < MIN_SQNR_DB:
        raise AssertionError(f"SQNR {min(sqnrs)} dB < {MIN_SQNR_DB}")
    for name in FAULT_LAYERS:
        bad = faulted_ctx(ctx, name)
        s = [sqnr_db(ref, pipeline.unet_step(unet, r, bad))
             for r, ref in zip(requests, refs)]
        log(f"SQNR with one fault in {name} (dB): {[round(x, 2) for x in s]}")
        if name == FAULT_LAYERS[-1] and max(s) >= MIN_SQNR_DB:
            raise AssertionError(f"the SQNR gate misses a fault in {name}")

    fp_t, q_t = [], []
    for _ in range(TIMING_ROUNDS):
        for r in requests:
            fp_t.append(step_ms(torch, lambda: pipeline.unet_step(unet, r)))
            q_t.append(step_ms(torch,
                               lambda: pipeline.unet_step(unet, r, ctx)))
    fp_ms, q_ms = statistics.median(fp_t), statistics.median(q_t)
    log(f"step ms (median of {len(q_t)}, CUDA events, {card}): "
        f"int8={q_ms:.3f} bf16={fp_ms:.3f} bf16/int8={fp_ms / q_ms:.3f}")
    return unet, ctx, calib, requests[0], launches


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


def phase_profile(torch, unet, ctx, req):
    """Device time by kernel over one int8 and one bf16 step."""
    from torch.profiler import ProfilerActivity, profile

    from mixdq_tpu_torch import pipeline

    os.makedirs(OUT_DIR, exist_ok=True)
    for tag, c in (("int8", ctx), ("bf16", None)):
        args = (unet, req) if c is None else (unet, req, c)
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mixdq_tpu_torch.ops import _build

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
    log("phase 2: tiny-sdxl parity ok")
    unet, ctx, calib, req, launches = phase_main_path(torch, dev, card)
    log("phase 3: main path ok")
    phase_layers(torch, unet, ctx, calib, req)
    log("phase 4: every deploy entry matches fake quantization")
    phase_profile(torch, unet, ctx, req)
    log("phase 5: profile written")

    log(json.dumps({"tpu_kernels": [
        {"tpu_kernel": f"mixdq_tpu/ops/{tk}",
         "status": f"ported: {k}" if k else "still to port"}
        for tk, k in TPU_KERNELS]}))
    kernels = []
    for name, (src, replaces) in PORTED.items():
        r = report[name]
        first = r["shapes"][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "requests": N_REQUESTS,
            "launches_per_step": launches[name] // N_REQUESTS,
            "max_abs_err": r["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "shape": first["shape"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
