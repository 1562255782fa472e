"""A/B of the redesigned kernels between two checkouts on one card.

Runs the ``sec_attention*`` kernels (with ``geglu_out_qmatmul`` and
``ln_quantize``, which share their LayerNorm code), ``geglu_qmatmul``,
``gn_silu_quantize``, the int8 flash kernels and ``flash_attention`` of
the checkout at ``--root`` at the main-path shapes of ``chip_smoke.py``
and at small test shapes, on inputs made
from seed 0 (the attention cases by that checkout's ``chip_smoke.py``
case builders), so that two checkouts see the same inputs. Prints each
case's median device time (each call after a 256 MB flush and a spin
that covers the wrapper's host time) and, where the package has
``sec_attention.probe``, the mean stage split; saves every output for
``compare``. Needs a CUDA device. Build both checkouts' kernels first
(``_build.build_all()``; otherwise each source builds at its first
call, one after another). Run it by path, so that the package comes
from ``--root``::

    python3 mixdq_tpu_torch/scripts/sec_ab.py run --root PARENT --tag parent --out a.pt
    python3 mixdq_tpu_torch/scripts/sec_ab.py run --root . --tag change --out b.pt
    python3 mixdq_tpu_torch/scripts/sec_ab.py compare a.pt b.pt

``run --only ln_quantize ln=True`` keeps the cases whose label holds one
of the words (then build only the sources those cases reach); ``run
--only int8`` the int8 flash kernels' cases.
"""

import argparse
import os
import sys

ITERS = 30        # timed calls a case; the median is printed
SPLIT_ITERS = 10  # probed calls a cooperative case
SPIN_CYCLES = 1_000_000


def cases(torch, cs, g, dev):
    """(label, call, cooperative) of every case, in a fixed order."""
    from mixdq_tpu_torch.ops import gn_quant, ln_quant, qmatmul
    from mixdq_tpu_torch.ops import sec_attention as sa

    bf16 = torch.bfloat16
    out = []
    for T, heads in [(256, 20), (1024, 10)]:
        C = heads * 64
        a, kw = cs.qkv_case(torch, g, dev, 1, T, heads, 64)
        out.append((f"qkv T={T} C={C}", lambda a=a, kw=kw:
                    sa.sec_attention_qkv(*a, **kw), True))
        for ln in (True, False):
            a, kw = cs.q_out_case(torch, g, dev, 1, T, 77, heads, 64, C, bf16,
                                  ln)
            out.append((f"q_out T={T} C={C} ln={ln}", lambda a=a, kw=kw:
                        sa.sec_attention_q_out(*a, **kw), True))
            a, kw = cs.qkv_out_case(torch, g, dev, 1, T, heads, 64, bf16, ln)
            out.append((f"qkv_out T={T} C={C} ln={ln}", lambda a=a, kw=kw:
                        sa.sec_attention_qkv_out(*a, **kw), True))
    for B in (1, 2):
        a, kw = cs.sec_q_case(torch, g, dev, B, 1024, 77, 20, 64, 1280, bf16)
        out.append((f"q B={B} Tq=1024 C=1280", lambda a=a, kw=kw:
                    sa.sec_attention_q(*a, **kw), True))
        for Tq, Tk, heads, cross in [(1024, 1024, 20, False),
                                     (4096, 77, 10, True)]:
            s, kw = cs.attn_case(torch, g, dev, B, Tq, Tk, heads, 64, bf16,
                                 cross)
            out.append((f"attn B={B} Tq={Tq} Tk={Tk}", lambda s=s, kw=kw:
                        sa.sec_attention(*s, 40.0, -3.0, **kw), False))
    for d, dt in [(16, torch.float32), (32, bf16), (128, bf16)]:
        heads = 256 // d
        a, kw = cs.q_out_case(torch, g, dev, 2, 200, 77, heads, d, 256, dt,
                              True)
        out.append((f"q_out d={d} {dt}", lambda a=a, kw=kw:
                    sa.sec_attention_q_out(*a, **kw), True))
        a, kw = cs.qkv_out_case(torch, g, dev, 2, 200, heads, d, dt, False)
        out.append((f"qkv_out d={d} {dt}", lambda a=a, kw=kw:
                    sa.sec_attention_qkv_out(*a, **kw), True))
    for M, C, ln in [(1024, 640, True), (256, 1280, True), (256, 1280, False)]:
        a, kw = cs.geglu_out_case(torch, g, dev, M, C, 4 * C, C, bf16, ln)
        out.append((f"geglu_out M={M} C={C} ln={ln}", lambda a=a, kw=kw:
                    qmatmul.geglu_out_qmatmul(*a, **kw), False))
    for shape in [(1, 1024, 640), (1, 256, 1280), (2, 77, 48)]:
        x = (torch.randn(shape, generator=g, device=dev) * 2).to(bf16)
        gamma = torch.rand(shape[-1], generator=g, device=dev) + 0.5
        beta = torch.randn(shape[-1], generator=g, device=dev) * 0.2
        out.append((f"ln_quantize {shape}",
                    lambda x=x, ga=gamma, be=beta:
                        ln_quant.ln_quantize(x, ga, be, 25.0, 2.0), False))
    # geglu_qmatmul: the 512 and 1024 px shapes, M = 1, ragged widths, no
    # bias, the exact gelu
    for M, K, H, bias, tanh in [(256, 1280, 5120, True, True),
                                (1024, 640, 2560, True, True),
                                (1024, 1280, 5120, True, True),
                                (4096, 640, 2560, True, True),
                                (1, 1280, 5120, True, True),
                                (37, 40, 24, True, True),
                                (256, 1280, 5120, False, True),
                                (1024, 640, 2560, True, False)]:
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, 2 * H), generator=g, device=dev,
                          dtype=torch.int8)
        scale = (torch.rand(2 * H, generator=g, device=dev) + 0.5) * 2e-5
        bias0 = 5.0 * w.int().sum(0).float()
        b = (torch.randn(2 * H, generator=g, device=dev).to(bf16) if bias
             else None)
        out.append((f"geglu M={M} K={K} H={H} bias={bias} tanh={tanh}",
                    lambda a=(x, w, scale, bias0, 25.0, 4.0, b), t=tanh:
                        qmatmul.geglu_qmatmul(*a, gelu_tanh=t), False))
    # gn_silu_quantize: chip_smoke's phase-1 shapes, f32 x, B = 2
    for shape, silu, eps, dt in [((1, 64, 64, 320), True, 1e-5, bf16),
                                 ((1, 32, 32, 640), False, 1e-6, bf16),
                                 ((1, 16, 16, 2560), True, 1e-5, bf16),
                                 ((1, 64, 64, 960), True, 1e-5, bf16),
                                 ((1, 128, 128, 320), True, 1e-5, bf16),
                                 ((1, 32, 32, 640), True, 1e-5,
                                  torch.float32),
                                 ((2, 32, 32, 1280), True, 1e-5, bf16)]:
        C = shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 2).to(dt)
        gamma = torch.rand(C, generator=g, device=dev) + 0.5
        beta = torch.randn(C, generator=g, device=dev)
        out.append((f"gn {shape} {dt} silu={silu}",
                    lambda a=(x, gamma, beta, 30.0, -5.0, 32, eps, silu):
                        gn_quant.gn_silu_quantize(*a), False))
    # ln_quantize: the 1024 px shapes, f32 rows, ragged C (the scalar
    # loads), a view off 16 bytes
    for shape, dt, off in [((1, 4096, 640), bf16, 0),
                           ((1, 1024, 1280), bf16, 0),
                           ((1, 256, 1280), torch.float32, 0),
                           ((2, 50, 2560), torch.float32, 0),
                           ((4, 9, 77), bf16, 0),
                           ((4, 9, 77), torch.float32, 0),
                           ((1, 256, 1280), bf16, 1)]:
        n = torch.Size(shape).numel()
        buf = (torch.randn(n + off, generator=g, device=dev) * 2).to(dt)
        x = buf[off:].view(shape)
        gamma = torch.rand(shape[-1], generator=g, device=dev) + 0.5
        beta = torch.randn(shape[-1], generator=g, device=dev) * 0.2
        out.append((f"ln_quantize {shape} {dt} offset={off}",
                    lambda x=x, ga=gamma, be=beta:
                        ln_quant.ln_quantize(x, ga, be, 25.0, 2.0), False))
    # geglu_out_qmatmul: M = 1024 pre-coded, M = 77, f32
    for M, C, ln, dt in [(1024, 640, False, bf16), (77, 640, True, bf16),
                         (77, 1280, False, bf16),
                         (256, 640, False, torch.float32)]:
        a, kw = cs.geglu_out_case(torch, g, dev, M, C, 4 * C, C, dt, ln)
        out.append((f"geglu_out M={M} C={C} ln={ln} {dt}", lambda a=a, kw=kw:
                    qmatmul.geglu_out_qmatmul(*a, **kw), False))
    # int8 flash attention on codes (as phase 1 of chip_smoke.py): the
    # SDXL 1024 attn1 site at B=1 and B=2, two key blocks with a ragged
    # tail, d = 16 and 128, and int8 v with f32 output
    from mixdq_tpu_torch.ops import attention
    for qkv in (False, True):
        name = "int8qkv_flash" if qkv else "int8_flash"
        for B, Tq, Tk, heads, d, cross, odt in [
                (1, 4096, 4096, 10, 64, False, bf16),
                (2, 4096, 4096, 10, 64, False, bf16),
                (2, 300, 700, 3, 64, True, bf16),
                (2, 130, 130, 4, 16, False, bf16),
                (1, 200, 600, 2, 128, True, bf16)] + (
                    [(1, 4096, 4096, 10, 64, False, torch.float32),
                     (2, 300, 700, 3, 16, True, torch.float32)] if qkv
                    else []):
            srcs, kw = cs.attn_case(torch, g, dev, B, Tq, Tk, heads, d, bf16,
                                    cross)
            qi, ki, vi, s_qk, sv = attention._int8_operands(
                *srcs, heads, d, kw["q_off"], kw["k_off"], kw["v_off"], qkv)
            a = (qi, ki, vi if qkv else srcs[2], s_qk * d ** -0.5, sv)
            ckw = dict(heads=heads, head_dim=d,
                       v_off=0 if qkv else kw["v_off"], out_dtype=odt)
            out.append((f"{name} B={B} Tq={Tq} Tk={Tk} {heads}x{d} {odt}",
                        lambda a=a, kw=ckw: attention.int8_flash_codes(*a,
                                                                       **kw),
                        False))
    # bf16 (and f32) flash attention at every head dim both checkouts
    # build: the SDXL 1024 attn1 site, a ragged cross site, d = 16 / 32 /
    # 128, f32 q/k/v
    for B, Tq, Tk, heads, d, cross, dt in [
            (1, 4096, 4096, 10, 64, False, bf16),
            (2, 300, 700, 3, 64, True, bf16),
            (2, 130, 130, 4, 16, False, bf16),
            (1, 256, 77, 2, 32, True, bf16),
            (1, 200, 600, 2, 128, True, bf16),
            (2, 300, 700, 3, 64, True, torch.float32)]:
        srcs, kw = cs.attn_case(torch, g, dev, B, Tq, Tk, heads, d, dt, cross)
        out.append((f"flash B={B} Tq={Tq} Tk={Tk} {heads}x{d} {dt}",
                    lambda s=srcs, kw=kw: attention.flash_attention(*s, **kw),
                    False))
    return out


def median_ms(torch, fn, flush):
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[ITERS // 2]


def run(root, tag, out_path, only=None):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from mixdq_tpu_torch.ops import sec_attention as sa

    if not torch.cuda.is_available():
        raise SystemExit("sec_ab: needs a CUDA device")
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    probe = getattr(sa, "probe", None)
    outs = {}
    for label, fn, coop in cases(torch, cs, g, dev):
        if only and not any(w in label for w in only):
            continue
        outs[label] = fn().cpu()
        ms = median_ms(torch, fn, flush)
        split = ""
        if coop and probe is not None:
            total = dict.fromkeys(sa.STAGES, 0.0)
            for _ in range(SPLIT_ITERS):
                flush.zero_()
                with probe() as recs:
                    fn()
                torch.cuda.synchronize()
                for k, v in sa.stage_ms(recs[0]).items():
                    total[k] += v / SPLIT_ITERS
            split = " " + " ".join(f"{k}={v:.4f}" for k, v in total.items())
        print(f"{tag} {label}: median {ms:.4f} ms{split}", flush=True)
    torch.save(outs, out_path)


def compare(path_a, path_b):
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    equal = 0
    for k in a:
        d = (a[k].float() - b[k].float()).abs()
        same = torch.equal(a[k], b[k])
        equal += same
        print(f"{k}: equal={same} max={d.max().item()} "
              f"frac={(d > 0).float().mean().item():.6f}")
    print(f"compare: {equal} of {len(a)} cases equal bit for bit")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--root", required=True)
    r.add_argument("--tag", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--only", nargs="+", metavar="WORD",
                   help="keep the cases whose label holds one of these")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.root, args.tag, args.out, args.only)
    else:
        compare(args.a, args.b)


if __name__ == "__main__":
    main()
