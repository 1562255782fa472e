"""Converters from public PyTorch checkpoints into the port (port of
``mixdq_tpu/utils/torch_convert.py``).

Model weights: each ``*_params`` function maps a state dict in its public
naming onto the JAX package's params tree (flax module names, ``kernel`` /
``scale`` / ``embedding`` leaves, in the state dict's order), and each
``convert_*_state_dict`` maps it on to the port's own state dict through
``convert.params_to_state_dict``. Torch weights are ``[out, in]`` and
OIHW; the port's are ``[in, out]`` and HWIO (flax's layouts); norm
``weight`` becomes ``scale``. Leaves keep their dtype.

* ``unet_params`` / ``convert_unet_state_dict``: HF diffusers
  ``UNet2DConditionModel``; ``clip_params`` / ``convert_clip_state_dict``:
  HF ``CLIPTextModel(WithProjection)``; ``vae_params`` /
  ``convert_vae_state_dict``: HF ``AutoencoderKL`` (the VAE's block lists
  flatten into one name: ``up_blocks_0_resnets_1``,
  ``up_blocks_0_upsampler``). A leaf these do not know is logged and
  skipped, as the JAX converters do.
* ``fuse_lora_state_dict``: peft (``lora_A`` / ``lora_B``) or kohya
  (``lora_down`` / ``lora_up``) pairs merged as ``W + scale (alpha / r) B
  A`` in float32 (the LCM-LoRA merge of the SD1.5 flow).
* ``convert_reference_qparams``: the reference's ``ckpt.pth`` quantizer
  buffers -> ``{layer: LayerQParams}``; ``convert_bos_precomputed``: its
  ``bos_pre_computed.pt`` -> ``{layer: [1, N] float32}``.
* ``load_safetensors``: a ``.safetensors`` file read without the
  ``safetensors`` package (the card lacks it).
* ``load_inception_state_dict`` / ``load_clip_vision_state_dict``: the
  evaluation towers' readers, straight to the port's state dicts. A leaf
  they do not know raises: a dropped leaf would leave a random weight
  inside a metric.
"""

from __future__ import annotations

import json
import logging
import math
import mmap
import re
import struct
from typing import Any, Dict, List, Mapping

import torch

from .. import convert

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]

_BN_LEAF = re.compile(
    r"^(.*)\.(conv\.weight|bn\.weight|bn\.bias|bn\.running_mean"
    r"|bn\.running_var)$")
_CLIP_LAYER = re.compile(
    r"^encoder\.layers\.(\d+)\.(self_attn\.(?:q|k|v|out)_proj|mlp\.fc1"
    r"|mlp\.fc2|layer_norm1|layer_norm2)\.(weight|bias)$")


def _tensor(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def load_inception_state_dict(sd: Mapping[str, Any], bn_eps: float = 1e-3
                              ) -> StateDict:
    """torchvision ``Inception3`` state dict -> ``InceptionV3Features``'s.
    ``w' = w * gamma / sqrt(var + eps)`` (as HWIO), ``b' = beta - mean *
    gamma / sqrt(var + eps)``, in float32 (``gamma`` 1 and ``beta`` 0 where
    the bn has none). ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked``
    are skipped (FID reads pool3)."""
    blocks: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, v in sd.items():
        if name.startswith(("fc.", "AuxLogits.")) or \
                name.endswith("num_batches_tracked"):
            continue
        m = _BN_LEAF.match(name)
        if not m:
            raise KeyError(f"unknown Inception3 leaf {name!r}")
        blocks.setdefault(m.group(1), {})[m.group(2)] = _tensor(v).float()
    out: StateDict = {}
    for block, d in blocks.items():
        w = d["conv.weight"]  # OIHW
        gamma = d.get("bn.weight", torch.ones(w.shape[0]))
        beta = d.get("bn.bias", torch.zeros(w.shape[0]))
        # the square root in f64, then rounded: numpy's correctly rounded
        # f32 sqrt (torch's vectorized f32 sqrt on the CPU is an ulp off
        # at times)
        s = gamma / torch.sqrt((d["bn.running_var"] + bn_eps).double()
                               ).float()
        out[f"{block}.conv.weight"] = (w * s[:, None, None, None]).permute(
            2, 3, 1, 0).contiguous()
        out[f"{block}.conv.bias"] = beta - d["bn.running_mean"] * s
    return out


def load_clip_vision_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """HF CLIP vision state dict (``vision_model.`` prefix optional) ->
    ``CLIPVisionModel``'s. ``embeddings.position_ids`` (an index buffer,
    no weight) is skipped."""
    out: StateDict = {}
    for name, v in sd.items():
        w = _tensor(v)
        n = re.sub(r"^vision_model\.", "", name)
        if n == "embeddings.position_ids":
            continue
        if n == "embeddings.class_embedding":
            out["class_embedding"] = w
        elif n == "embeddings.patch_embedding.weight":
            out["patch_embedding.weight"] = w.permute(2, 3, 1, 0).contiguous()
        elif n == "embeddings.position_embedding.weight":
            out["position_embedding"] = w
        elif n in ("pre_layrnorm.weight", "pre_layrnorm.bias",
                   "post_layernorm.weight", "post_layernorm.bias"):
            out[n] = w
        elif n == "visual_projection.weight":
            out[n] = w.T.contiguous()
        else:
            m = _CLIP_LAYER.match(n)
            if not m:
                raise KeyError(f"unknown CLIP vision leaf {name!r}")
            i, mod, leaf = m.groups()
            key = f"layers.{i}.{mod.replace('mlp.', '')}.{leaf}"
            out[key] = w.T.contiguous() if w.ndim == 2 else w
    return out


# ---------------------------------------------------------------------------
# Model weights
# ---------------------------------------------------------------------------

_LIST_NAMES = ("down_blocks", "up_blocks", "resnets", "attentions",
               "transformer_blocks", "downsamplers", "upsamplers", "net",
               "to_out", "layers")


def _flaxify(parts: List[str]) -> List[str]:
    """Diffusers name parts -> flax module names (``['resnets', '0']`` ->
    ``'resnets_0'``)."""
    out, i = [], 0
    while i < len(parts):
        if (i + 1 < len(parts) and parts[i] in _LIST_NAMES
                and parts[i + 1].isdigit()):
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def _set(tree: Dict, path: List[str], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.T.contiguous()


def _weight_leaf(tree, mod, w):
    """A ``weight``: conv OIHW -> HWIO ``kernel``, linear -> ``[in, out]``
    ``kernel``, else a norm ``scale``."""
    if w.ndim == 4:
        _set(tree, mod + ["kernel"], _hwio(w))
    elif w.ndim == 2:
        _set(tree, mod + ["kernel"], _t(w))
    else:
        _set(tree, mod + ["scale"], w)


def unet_params(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF diffusers ``UNet2DConditionModel`` state dict -> the JAX
    package's UNet params tree."""
    params: Dict[str, Any] = {}
    for name, w in sd.items():
        w = _tensor(w)
        parts = name.split(".")
        mod = _flaxify(parts[:-1])
        if parts[-1] == "weight":
            _weight_leaf(params, mod, w)
        elif parts[-1] == "bias":
            _set(params, mod + ["bias"], w)
        else:
            logger.warning("unhandled unet leaf %s", name)
    return params


_CLIP_TEXT_LAYER = re.compile(
    r"encoder\.layers\.(\d+)\.(self_attn|mlp|layer_norm1|layer_norm2)"
    r"\.?(.*)\.(weight|bias)$")


def clip_params(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``CLIPTextModel(WithProjection)`` state dict -> the JAX
    package's CLIP text params tree."""
    params: Dict[str, Any] = {}
    for name, w in sd.items():
        w = _tensor(w)
        n = re.sub(r"^text_model\.", "", name)
        if n.startswith("embeddings.token_embedding"):
            _set(params, ["token_embedding", "embedding"], w)
        elif n.startswith("embeddings.position_embedding"):
            _set(params, ["position_embedding"], w)
        elif n == "final_layer_norm.weight":
            _set(params, ["final_layer_norm", "scale"], w)
        elif n == "final_layer_norm.bias":
            _set(params, ["final_layer_norm", "bias"], w)
        elif n == "text_projection.weight":
            _set(params, ["text_projection", "kernel"], _t(w))
        else:
            m = _CLIP_TEXT_LAYER.match(n)
            if not m:
                logger.warning("unhandled clip leaf %s", name)
                continue
            li, group, sub, leaf = m.groups()
            mod = [f"layers_{li}"]
            if group == "self_attn":
                mod += ["self_attn", sub]
            elif group == "mlp":
                mod += [sub]  # fc1 / fc2 live on the layer
            else:
                mod += [group]
            if leaf == "weight":
                _weight_leaf(params, mod, w)
            else:
                _set(params, mod + ["bias"], w)
    return params


_VAE_RESNET = re.compile(
    r"^(decoder|encoder)\.(up_blocks|down_blocks)\.(\d+)\.(resnets)\.(\d+)"
    r"\.(.+)$")
_VAE_SAMPLER = re.compile(
    r"^(decoder|encoder)\.(up_blocks|down_blocks)\.(\d+)\."
    r"(upsamplers|downsamplers)\.0\.conv\.(weight|bias)$")


def _norm_or_conv_leaf(params, mod, leaf, w):
    if leaf == "weight":
        _weight_leaf(params, mod, w)
    elif leaf == "bias":
        _set(params, mod + ["bias"], w)
    else:
        logger.warning("unhandled vae leaf %s", ".".join(mod + [leaf]))


def vae_params(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``AutoencoderKL`` state dict -> the JAX package's VAE params
    tree."""
    params: Dict[str, Any] = {}
    for name, w in sd.items():
        w = _tensor(w)
        parts = name.split(".")
        m = _VAE_SAMPLER.match(name)
        if m:
            tower, _, bi, kind, leaf = m.groups()
            up = kind.startswith("up")
            mod = [tower, f"{'up' if up else 'down'}_blocks_{bi}_"
                   f"{'upsampler' if up else 'downsampler'}"]
            if leaf == "weight":
                _set(params, mod + ["kernel"], _hwio(w))
            else:
                _set(params, mod + ["bias"], w)
            continue
        m = _VAE_RESNET.match(name)
        if m:
            tower, blocks, bi, _, ri, rest = m.groups()
            rest = rest.split(".")
            mod = [tower, f"{blocks}_{bi}_resnets_{ri}"] + _flaxify(rest[:-1])
            _norm_or_conv_leaf(params, mod, rest[-1], w)
            continue
        # mid_block, conv_in / conv_out, the norms, the quant convs
        _norm_or_conv_leaf(params, _flaxify(parts[:-1]), parts[-1], w)
    return params


def convert_unet_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """HF diffusers UNet state dict -> the port's ``UNet2DConditionModel``
    state dict."""
    return convert.params_to_state_dict(unet_params(sd))


def convert_clip_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """HF CLIP text state dict -> the port's ``CLIPTextModel`` state
    dict."""
    return convert.params_to_state_dict(clip_params(sd))


def convert_vae_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """HF ``AutoencoderKL`` state dict -> the port's ``AutoencoderKL``
    state dict."""
    return convert.params_to_state_dict(vae_params(sd))


def fuse_lora_state_dict(sd: Mapping[str, Any], lora_sd: Mapping[str, Any],
                         scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``sd`` with each LoRA pair of ``lora_sd`` fused into its base
    weight: ``W' = W + scale * (alpha / r) * B @ A``, float32 (as the JAX
    package's). Pairs: ``{base}.lora_A.weight`` /
    ``{base}.lora_B.weight`` (peft) or ``lora_down`` / ``lora_up``
    (kohya), ``{base}.alpha`` optional (default r, the rank)."""
    out = dict(sd)
    pairs: Dict[str, Dict[str, str]] = {}
    for k in lora_sd:
        for down, up in (("lora_A", "lora_B"), ("lora_down", "lora_up")):
            if f".{down}." in k or k.endswith(f".{down}.weight"):
                pairs.setdefault(k.split(f".{down}")[0], {})["down"] = k
            elif f".{up}." in k or k.endswith(f".{up}.weight"):
                pairs.setdefault(k.split(f".{up}")[0], {})["up"] = k
    fused = 0
    for base, pq in pairs.items():
        if "down" not in pq or "up" not in pq:
            continue
        a = _tensor(lora_sd[pq["down"]]).float()  # [r, in]
        b = _tensor(lora_sd[pq["up"]]).float()  # [out, r]
        r = a.shape[0]
        alpha = float(_tensor(lora_sd.get(f"{base}.alpha", r)))
        target = f"{base}.weight"
        if target not in out:
            logger.warning("LoRA target missing in base sd: %s", target)
            continue
        w = _tensor(out[target]).float()
        out[target] = w + ((b @ a) * (scale * alpha / r)).reshape(w.shape)
        fused += 1
    logger.info("fused %d LoRA layers", fused)
    return out


# ---------------------------------------------------------------------------
# The reference's quant checkpoint
# ---------------------------------------------------------------------------

_QUANTIZER_SUFFIXES = ((".weight_quantizer_0", "w0"),
                       (".weight_quantizer", "w"),
                       (".act_quantizer_0", "a0"), (".act_quantizer", "a"))


def convert_reference_qparams(ckpt: Mapping[str, Any],
                              candidate_bits=(2, 4, 8)):
    """The reference's ``ckpt.pth`` (``{quantizer name: [buffers,
    parameters]}``) -> ``{layer: LayerQParams}`` (float32 CPU tensors).
    ``...weight_quantizer[_0]`` / ``...act_quantizer[_0]`` fill ``w`` /
    ``w0`` / ``a`` / ``a0``; a bare quantizer (the attention's q/k/v/
    softmax) keeps its whole name as an act quantizer. ``delta_list`` /
    ``zero_point_list`` ``[n_bits, C, 1, ...]`` become ``[n_bits, C]``
    (``[n_bits]`` per tensor); a single-bit ``delta`` / ``zero_point`` is
    repeated over ``candidate_bits``."""
    from ..quant.state import LayerQParams

    frag: Dict[str, Dict[str, torch.Tensor]] = {}
    for qname, entry in ckpt.items():
        buffers = dict(entry[0]) if isinstance(entry, (list, tuple)) \
            else dict(entry)
        name = qname[len("model."):] if qname.startswith("model.") else qname
        for suf, field in _QUANTIZER_SUFFIXES:
            if name.endswith(suf):
                layer = name[:-len(suf)]
                break
        else:
            layer, field = name, "a"
        delta = buffers.get("delta_list", buffers.get("delta"))
        zp = buffers.get("zero_point_list", buffers.get("zero_point"))
        if delta is None:
            logger.warning("no delta in %s", qname)
            continue
        delta, zp = _tensor(delta).float(), _tensor(zp).float()
        if "delta_list" not in buffers:  # single-bit: repeat over the bits
            delta = torch.stack([delta] * len(candidate_bits))
            zp = torch.stack([zp] * len(candidate_bits))
        delta = delta.reshape(delta.shape[0], -1)
        zp = zp.reshape(zp.shape[0], -1)
        if delta.shape[1] == 1:
            delta, zp = delta[:, 0], zp[:, 0]
        f = frag.setdefault(layer, {})
        f[f"{field}_delta"] = delta.contiguous()
        f[f"{field}_zp"] = zp.contiguous()
    return {layer: LayerQParams(**f) for layer, f in frag.items()}


def convert_bos_precomputed(d: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's ``bos_pre_computed.pt`` (cross-attention ``to_k`` /
    ``to_v`` names -> the BoS token's FP output ``[1, 1, N]``) ->
    ``{layer: [1, N] float32}``; any other name raises."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in d.items():
        if name.startswith("model."):
            name = name[len("model."):]
        if not (".attn2.to_k" in name or ".attn2.to_v" in name):
            raise ValueError(f"unexpected BoS entry {name!r} (want "
                             "cross-attn to_k/to_v projections)")
        a = _tensor(v).float()
        out[name] = a.reshape(1, a.shape[-1])
    return out


# ---------------------------------------------------------------------------
# .safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file (an 8-byte little-endian
    header length, a JSON header ``{name: {dtype, shape, data_offsets}}``,
    then the raw bytes), in the order of their data, as
    ``safetensors.numpy.load_file`` gives them. The tensors view a
    copy-on-write ``mmap`` of the file: no host copy is made."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header.pop("__metadata__", None)
    start = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in sorted(header.items(),
                             key=lambda kv: (kv[1]["data_offsets"], kv[0])):
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name}: dtype {info['dtype']} not "
                             f"read here ({sorted(_ST_DTYPES)})")
        dtype = _ST_DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        if (e - b) % size or (e - b) // size != math.prod(info["shape"]):
            raise ValueError(f"{path}: {name}: {e - b} bytes for shape "
                             f"{info['shape']} of {info['dtype']}")
        t = (torch.frombuffer(mm, dtype=dtype, count=(e - b) // size,
                              offset=start + b) if e > b
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out
