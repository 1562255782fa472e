"""Operations and bytes of one generation, from a configuration file's
published sizes alone, and the chip's published peaks.

Each layer is ``(part, kind, ops, bytes)``: ``ops`` counts a multiply-add
as two; ``bytes`` counts each input and output once (weights too) at the
precision the configuration declares for it. ``kind`` is ``'int8'`` for
a UNet linear or conv layer of a W8A8 configuration (its input codes and
weight one byte each, its output bfloat16) and ``'bf16'`` for everything
else: the attention products, the towers, the VAE decoder, and the UNet
of a configuration that quantizes nothing. Norms, activations, softmax
and the sampler arithmetic are left out, so a least time from these
counts is a lower bound. Counts are per image: per prompt for the
towers, per step for the UNet times the steps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: NVIDIA H100 SXM5 data sheet, dense: int8 TOP/s, bf16 TFLOP/s, HBM3
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

Layer = Tuple[str, str, float, float]
TEXT_TOKENS = 77


def _dense(part, kind, m, k, n, act_bytes, w_bytes, out_bytes=2):
    return (part, kind, 2.0 * m * k * n,
            float(m * k * act_bytes + k * n * w_bytes + m * n * out_bytes))


def _conv(part, kind, h_in, c_in, c_out, k, stride, act_bytes, w_bytes):
    h_out = h_in // stride
    return (part, kind, 2.0 * h_out * h_out * k * k * c_in * c_out,
            float(h_in * h_in * c_in * act_bytes + k * k * c_in * c_out
                  * w_bytes + h_out * h_out * c_out * 2))


def _attn(part, tq, tk, heads, d):
    """QK^T and PV of ``heads`` heads of ``d``, bf16: q, k, v in, out."""
    c = heads * d
    return (part, "bf16", 4.0 * tq * tk * c,
            float(2 * (2 * tq * c + 2 * tk * c)))


def unet_layers(cfg: dict) -> List[Layer]:
    """One UNet call on one image."""
    u = cfg["unet"]
    q = cfg.get("quant", {})
    int8 = q.get("weight_bits") == 8 and q.get("act_bits") == 8
    kind, ab, wb = ("int8", 1, 1) if int8 else ("bf16", 2, 2)
    ch = list(u["block_out_channels"])
    n, lpb, s = len(ch), u["layers_per_block"], u["sample_size"]
    heads = u.get("num_attention_heads") or u["attention_head_dim"]
    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads] * n
    tl = u.get("transformer_layers_per_block", 1)
    tl = list(tl) if isinstance(tl, (list, tuple)) else [tl] * n
    cross = u["cross_attention_dim"]
    temb = 4 * ch[0]
    L: List[Layer] = []

    def dense(m, k, nn):
        L.append(_dense("unet", kind, m, k, nn, ab, wb))

    def conv(h, ci, co, k=3, stride=1):
        L.append(_conv("unet", kind, h, ci, co, k, stride, ab, wb))

    def resnet(h, ci, co):
        conv(h, ci, co)
        dense(1, temb, co)
        conv(h, co, co)
        if ci != co:
            conv(h, ci, co, 1)

    def transformer(h, c, lvl):
        t = h * h
        d = c // heads[lvl]
        dense(t, c, c)  # proj_in (a 1x1 conv counts the same)
        for _ in range(tl[lvl]):
            for _ in range(3):
                dense(t, c, c)  # attn1 q, k, v
            L.append(_attn("unet", t, t, heads[lvl], d))
            dense(t, c, c)  # attn1 out
            dense(t, c, c)  # attn2 q
            dense(TEXT_TOKENS, cross, c)
            dense(TEXT_TOKENS, cross, c)  # attn2 k, v
            L.append(_attn("unet", t, TEXT_TOKENS, heads[lvl], d))
            dense(t, c, c)  # attn2 out
            dense(t, c, 8 * c)  # GEGLU proj
            dense(t, 4 * c, c)  # ff.net.2
        dense(t, c, c)  # proj_out

    dense(1, ch[0], temb)
    dense(1, temb, temb)
    if u.get("addition_embed_type") == "text_time":
        dense(1, u["projection_class_embeddings_input_dim"], temb)
        dense(1, temb, temb)
    conv(s, u["in_channels"], ch[0])
    out, h = ch[0], s
    for i, btype in enumerate(u["down_block_types"]):
        prev, out = out, ch[i]
        for j in range(lpb):
            resnet(h, prev if j == 0 else out, out)
            if btype.startswith("CrossAttn"):
                transformer(h, out, i)
        if i < n - 1:
            conv(h, out, out, 3, 2)
            h //= 2
    resnet(h, ch[-1], ch[-1])
    transformer(h, ch[-1], n - 1)
    resnet(h, ch[-1], ch[-1])
    rev = ch[::-1]
    for i, btype in enumerate(u["up_block_types"]):
        prev, out, skip = rev[max(i - 1, 0)], rev[i], rev[min(i + 1, n - 1)]
        for j in range(lpb + 1):
            resnet(h, (prev if j == 0 else out) + (skip if j == lpb
                                                   else out), out)
            if btype.startswith("CrossAttn"):
                transformer(h, out, n - 1 - i)
        if i < n - 1:
            h *= 2
            conv(h, out, out)
    conv(s, ch[0], u["out_channels"])
    return L


def tower_layers(t: dict, projected: bool) -> List[Layer]:
    """One CLIP text tower on one prompt of 77 tokens (bf16)."""
    c, T = t["hidden_size"], TEXT_TOKENS
    L: List[Layer] = []
    for _ in range(t["num_hidden_layers"]):
        for _ in range(4):
            L.append(_dense("towers", "bf16", T, c, c, 2, 2))
        L.append(_attn("towers", T, T, t["num_attention_heads"],
                       c // t["num_attention_heads"]))
        L.append(_dense("towers", "bf16", T, c, t["intermediate_size"], 2,
                        2))
        L.append(_dense("towers", "bf16", T, t["intermediate_size"], c, 2,
                        2))
    if projected:
        L.append(_dense("towers", "bf16", 1, c, t["projection_dim"], 2, 2))
    return L


def vae_layers(cfg: dict) -> List[Layer]:
    """The VAE decode of one image (bf16)."""
    v = cfg["vae"]
    ch = list(v["block_out_channels"])[::-1]
    h = cfg["unet"]["sample_size"]
    lat = v["latent_channels"]
    L: List[Layer] = []

    def conv(hh, ci, co, k=3):
        L.append(_conv("vae", "bf16", hh, ci, co, k, 1, 2, 2))

    def resnet(hh, ci, co):
        conv(hh, ci, co)
        conv(hh, co, co)
        if ci != co:
            conv(hh, ci, co, 1)

    conv(h, lat, lat, 1)  # post_quant_conv
    conv(h, lat, ch[0])
    resnet(h, ch[0], ch[0])
    t = h * h
    for _ in range(4):
        L.append(_dense("vae", "bf16", t, ch[0], ch[0], 2, 2))
    L.append(_attn("vae", t, t, 1, ch[0]))
    resnet(h, ch[0], ch[0])
    prev = ch[0]
    for i, c in enumerate(ch):
        for _ in range(v["layers_per_block"] + 1):
            resnet(h, prev, c)
            prev = c
        if i < len(ch) - 1:
            h *= 2
            conv(h, c, c)
    conv(h, ch[-1], v["out_channels"])
    return L


def generation_layers(cfg: dict) -> List[Layer]:
    """Every counted layer of one image's generation: the towers (twice
    under classifier-free guidance), the UNet at each step (on a doubled
    batch under guidance), the VAE decode."""
    cfg_mult = 2 if cfg["guidance_scale"] > 1.0 else 1
    towers = tower_layers(cfg["text_encoder"], False)
    if "text_encoder_2" in cfg:
        towers += tower_layers(cfg["text_encoder_2"], True)
    unet = unet_layers(cfg)
    return (towers * cfg_mult + unet * (cfg["steps"] * cfg_mult)
            + vae_layers(cfg))


def least_compute_s(layers: List[Layer]) -> float:
    """Seconds of the layers' operations at the peak of each one's
    precision."""
    return sum(ops / PEAK_OPS[kind] for _, kind, ops, _ in layers)


def least_roofline_s(layers: List[Layer]) -> float:
    """Sum over the layers of the larger of compute and memory time."""
    return sum(max(ops / PEAK_OPS[kind], b / PEAK_BYTES_PER_S)
               for _, kind, ops, b in layers)


def summary(cfg: dict) -> Dict[str, float]:
    """Per-image figures the metric readers take."""
    gen = generation_layers(cfg)
    unet = [x for x in gen if x[0] == "unet"]
    return {"generation_least_compute_s": least_compute_s(gen),
            "unet_least_roofline_s": least_roofline_s(unet)}
