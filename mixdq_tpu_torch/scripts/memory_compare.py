"""Memory of the bf16 and the quantized UNet: static, dynamic and peak MB
(port of ``scripts/memory_compare.py``).

    python -m mixdq_tpu_torch.scripts.memory_compare [--family sdxl-turbo] \\
        [--batch 1] [--w_bits 8|4] [--compute int8|int8_sec|dequant] \\
        [--pack_w4] [--mp_w W.yaml] [--mp_a A.yaml] [--act_protect P.yaml] \\
        [--json] [--device cuda]

Each UNet (random weights from seed 0, bf16) runs one step at B =
``--batch`` on zero inputs (t = 999); the quantized one is calibrated on
them, every layer W``--w_bits``A8, then the bit maps and the act-protect
list where given, deployed under ``--compute`` (``--pack_w4``: W<=4
dense weights kept halves-packed; BoS-aware as the JAX script's deploy,
the cross-attention k/v BoS rows of ``int8`` / ``int8_sec`` computed once
from the request's first text token, as ``quant_txt2img --backend int8``
computes them, so no f32 BoS weight stays resident) and its replaced fp
weights pruned (``quant.deploy.prune_deployed_weights``). The JAX script
reads XLA's compiled ``memory_analysis``; the port defines its figures
itself:

* static: the bytes of the tensors resident after the prune: the UNet's
  parameters and buffers and every tensor of the deploy (codes, packed
  codes, scales, biases, BoS rows) and of the banks its first
  step stacks (``QuantCtx.bank_cache``), each storage counted once;
* peak: ``torch.cuda.max_memory_allocated`` over one step (after a warm
  step and ``reset_peak_memory_stats``): the allocator's peak can be
  reset, so each variant is measured in the same process;
* dynamic: peak - static.

On the CPU only static is defined; dynamic and peak print as ``null``.
Prints a table like the JAX script's and, with ``--json``, one JSON line.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
from typing import Iterator, Optional, Tuple

import torch

from .. import pipeline
from ..models.configs import get_family
from ..quant.bitmaps import load_bit_map, load_layer_list
from ..quant.calibrate import calibrate
from ..quant.core import QuantSpec
from ..quant.deploy import (deploy_unet_ctx, precompute_bos_outputs,
                            prune_deployed_weights)
from ..quant.state import (FP_CTX, apply_bitwidth_config, protect_layers,
                           quantizable_layers, uniform_ctrl)

MB = 1e6


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor inside ``obj``: a tensor, a map, a sequence or a
    dataclass (deploy entries, bank groups), recursively."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def resident_bytes(model: torch.nn.Module, ctx=FP_CTX) -> int:
    """Bytes of ``model``'s parameters and buffers, and of ``ctx``'s deploy
    and bank tensors, each storage once."""
    storages = {}
    for t in list(model.parameters()) + list(model.buffers()) + list(
            _tensors((ctx.deploy, ctx.bank_cache))):
        s = t.untyped_storage()
        storages[(s.device, s.data_ptr())] = s.nbytes()
    return sum(storages.values())


def zero_inputs(family: str, B: int, device) -> pipeline.Inputs:
    """Zero latents and text embeddings at t = 999 (the JAX script's)."""
    f = get_family(family)
    u = f.unet
    bf16 = torch.bfloat16
    sample = torch.zeros(B, u.sample_size, u.sample_size, u.in_channels,
                         dtype=bf16, device=device)
    ehs = torch.zeros(B, pipeline.TEXT_TOKENS, u.cross_attention_dim,
                      dtype=bf16, device=device)
    added = None
    if u.addition_embed_type == "text_time":
        added = {"text_embeds": torch.zeros(B, f.pooled_dim, dtype=bf16,
                                            device=device),
                 "time_ids": torch.zeros(B, 6, dtype=bf16, device=device)}
    return sample, torch.tensor(999.0, device=device), ehs, added


def build(family: str, B: int, quant: Optional[str] = None, w_bits: int = 8,
          pack_w4: bool = False, mp_w=None, mp_a=None, act_protect=None,
          device=None):
    """(UNet, context, inputs) of one variant after its prune and one warm
    step (the banks stack their constants at a context's first);
    ``quant``: the deploy compute (None: the bf16 UNet, ``FP_CTX``)."""
    dev = pipeline.resolve_device(device)
    unet = pipeline.build_unet(family, seed=0, dtype=torch.bfloat16,
                               device=dev)
    inputs = zero_inputs(family, B, dev)
    ctx = FP_CTX
    if quant:
        wq = QuantSpec(sym=True, channel_wise=True, round_mode="nearest",
                       n_bits=w_bits)
        aq = QuantSpec(running_stat=True)
        qparams = calibrate(unet, [inputs], wq, aq)
        cb = wq.candidate_bits
        ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=w_bits,
                            a_bits=8)
        if mp_w:
            ctrl = apply_bitwidth_config(ctrl, load_bit_map(mp_w), "weight",
                                         cb)
        if act_protect:
            ctrl = protect_layers(ctrl, load_layer_list(act_protect))
        if mp_a:
            ctrl = apply_bitwidth_config(ctrl, load_bit_map(mp_a), "act", cb)
        ctx = deploy_unet_ctx(unet, qparams, ctrl, wq, pack_w4=pack_w4,
                              deploy_compute=quant)
        if quant in ("int8", "int8_sec"):
            # the BoS rows from the request's first text token, before the
            # prune (as the int8 CLI computes them): no f32 BoS weight
            # stays resident
            ctx = dataclasses.replace(ctx, deploy=precompute_bos_outputs(
                ctx.deploy, unet, inputs[2][0, 0]))
        prune_deployed_weights(unet, ctx.deploy)
    pipeline.unet_step(unet, inputs, ctx)
    return unet, ctx, inputs


def unet_mem(family: str, B: int, quant: Optional[str] = None,
             w_bits: int = 8, pack_w4: bool = False, mp_w=None, mp_a=None,
             act_protect=None, device=None
             ) -> Tuple[float, Optional[float], Optional[float]]:
    """(static MB, dynamic MB, peak MB) of one UNet step of ``build``'s
    variant. Dynamic and peak are None on the CPU."""
    unet, ctx, inputs = build(family, B, quant, w_bits, pack_w4, mp_w, mp_a,
                              act_protect, device)
    dev = inputs[0].device
    static = resident_bytes(unet, ctx) / MB
    dynamic = peak = None
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pipeline.unet_step(unet, inputs, ctx)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) / MB
        dynamic = peak - static
    del unet, ctx, inputs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return static, dynamic, peak


def _mb(v: Optional[float], width: int) -> str:
    return f"{'null':>{width}}" if v is None else f"{v:>{width}.1f}"


def _round(v: Optional[float], nd: int = 1) -> Optional[float]:
    return None if v is None else round(v, nd)


def main(argv=None):
    """Returns ``{'bf16': (static, dynamic, peak), 'quant': (...),
    'config', 'static_saving', 'peak_saving'}`` (MB; None where not
    defined)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="sdxl-turbo")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--w_bits", type=int, default=8)
    ap.add_argument("--compute", default="int8",
                    choices=["int8", "int8_sec", "dequant"])
    ap.add_argument("--pack_w4", action="store_true",
                    help="keep W<=4 weights halves-packed resident (pairs "
                         "with --compute dequant)")
    ap.add_argument("--mp_w", default=None,
                    help="elected weight bit map (per-layer bits)")
    ap.add_argument("--mp_a", default=None, help="elected act bit map")
    ap.add_argument("--act_protect", default=None,
                    help="act-protect list (yaml or reference .pt)")
    ap.add_argument("--json", action="store_true",
                    help="also print one machine-readable JSON line")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"{'config':<16} {'static MB':>10} {'dynamic MB':>11} "
          f"{'peak MB':>9}")
    s0, d0, p0 = unet_mem(args.family, args.batch, device=args.device)
    print(f"{'bf16':<16} {s0:>10.1f} {_mb(d0, 11)} {_mb(p0, 9)}")
    s, d, p = unet_mem(args.family, args.batch, quant=args.compute,
                       w_bits=args.w_bits, pack_w4=args.pack_w4,
                       mp_w=args.mp_w, mp_a=args.mp_a,
                       act_protect=args.act_protect, device=args.device)
    if args.mp_w or args.mp_a:
        name = "MP"
        if args.mp_w:
            name += f"-W{os.path.basename(args.mp_w).rsplit('.yaml', 1)[0]}"
        if args.mp_a:
            name += f"-A{os.path.basename(args.mp_a).rsplit('.yaml', 1)[0]}"
    else:
        name = f"W{args.w_bits}A8"
    if args.pack_w4:
        name += "-packed"
    name += f"-{args.compute}"
    print(f"{name:<16} {s:>10.1f} {_mb(d, 11)} {_mb(p, 9)}")
    static_saving = s0 / max(s, 1e-9)
    peak_saving = None if p is None else p0 / max(p, 1e-9)
    print(f"static saving: {static_saving:.2f}x  peak saving: "
          + ("null" if peak_saving is None else f"{peak_saving:.2f}x"))
    if args.json:
        print(json.dumps({
            "family": args.family, "batch": args.batch, "config": name,
            "bf16": {"static_mb": round(s0, 1), "dynamic_mb": _round(d0),
                     "peak_mb": _round(p0)},
            "quant": {"static_mb": round(s, 1), "dynamic_mb": _round(d),
                      "peak_mb": _round(p)},
            "static_saving": round(static_saving, 2),
            "peak_saving": _round(peak_saving, 2),
        }), flush=True)
    return {"bf16": (s0, d0, p0), "quant": (s, d, p), "config": name,
            "static_saving": static_saving, "peak_saving": peak_saving}


if __name__ == "__main__":
    main()
