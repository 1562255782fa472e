"""Zero-copy deployment checkpoint container (port of
``mixdq_tpu/runtime/tensorstore.py``).

A JSON index followed by 64-byte-aligned raw blobs, read back as tensors
over a memory map (``torch.from_numpy`` on a copy-on-write ``np.memmap``:
no deserializing copy of multi-GB int8 weights). Tensors named in
``pack4_names`` are stored as packed int4 (``runtime.pack_int4``, two
codes a byte), half the bytes of int8.

Layout: ``[u64 magic][u64 index_len][index JSON][pad64][blob0][pad64]...``
Index entries: ``{name: {dtype, shape, offset, nbytes, packed_int4}}``.
For the same tensors the port writes the bytes the JAX package writes,
and each package reads the other's files.

The deploy container (``save_deploy_ckpt``) holds the five fields JAX
stores -- ``w_int``, ``scale``, ``bias0``, ``scale_inv``, ``zp_shifted``
-- and each entry's ``kind`` and ``split``. JAX drops the rest of an
entry silently; the port raises on an entry whose fields the format
cannot hold (packed ``w_packed``, a precomputed ``bos_out``, ``a_bits``
other than 8, a weight-only ``act_off`` entry), naming the layer and the
field. ``bos_w`` is not stored: it is derived from the codes and the
scale, and ``load_deploy_ckpt`` attaches it again as ``deploy_unet_ctx``
does.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import pack_int4, unpack_int4

MAGIC = 0x4D495844515453
#: the fields of a deploy entry the container holds (JAX's five)
DEPLOY_FIELDS = ("w_int", "scale", "bias0", "scale_inv", "zp_shifted")

_DTYPES = {str(d).replace("torch.", ""): d for d in (
    torch.float32, torch.float16, torch.bfloat16, torch.float64, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool)}


def _align(o: int) -> int:
    return (o + 63) & ~63


def _as_tensor(x) -> torch.Tensor:
    return (x.detach() if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.asarray(x)))


def _raw(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes in C order, as a uint8 array."""
    return t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def save_tensors(tensors: Dict[str, Any], path: str,
                 pack4_names: Optional[set] = None) -> None:
    """Write ``tensors`` (tensors or arrays, in order) to ``path``;
    ``pack4_names``: int8 tensors whose codes fit int4, stored packed."""
    pack4_names = pack4_names or set()
    index: Dict[str, Any] = {}
    payload = []
    rel = 0
    for name, x in tensors.items():
        t = _as_tensor(x)
        dtype = str(t.dtype).replace("torch.", "")
        if dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no container "
                             "code")
        packed = name in pack4_names and t.dtype == torch.int8
        data = pack_int4(t).numpy() if packed else _raw(t)
        rel = _align(rel)
        index[name] = {"dtype": dtype, "shape": list(t.shape),
                       "offset": rel, "nbytes": int(data.nbytes),
                       "packed_int4": packed}
        payload.append(data)
        rel += data.nbytes

    idx_bytes = json.dumps(index).encode()
    data_start = _align(16 + len(idx_bytes))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", MAGIC, len(idx_bytes)))
        f.write(idx_bytes)
        f.write(b"\0" * (data_start - 16 - len(idx_bytes)))
        pos = 0
        for meta, data in zip(index.values(), payload):
            f.write(b"\0" * (meta["offset"] - pos))
            f.write(memoryview(data))
            pos = meta["offset"] + data.nbytes


def load_tensors(path: str, mmap: bool = True) -> Dict[str, torch.Tensor]:
    """The tensors of ``path`` on the CPU: views of one copy-on-write
    memory map of the file (``mmap``), else of one read of it. Packed
    int4 tensors come back unpacked to int8."""
    with open(path, "rb") as f:
        magic, idx_len = struct.unpack("<QQ", f.read(16))
        if magic != MAGIC:
            raise ValueError(f"bad magic in {path}")
        index = json.loads(f.read(idx_len))
    data_start = _align(16 + idx_len)
    raw = (np.memmap(path, dtype=np.uint8, mode="c") if mmap
           else np.fromfile(path, dtype=np.uint8))
    out = {}
    for name, meta in index.items():
        off = data_start + meta["offset"]
        buf = raw[off:off + meta["nbytes"]]
        shape = tuple(meta["shape"])
        if meta["packed_int4"]:
            out[name] = unpack_int4(buf, int(np.prod(shape))).reshape(shape)
        else:
            out[name] = torch.from_numpy(buf).view(
                _DTYPES[meta["dtype"]]).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Deploy dicts ({layer: DeployEntry})
# ---------------------------------------------------------------------------


def _check_entry(layer: str, e) -> None:
    """Raise on a field of ``e`` that the container cannot hold."""
    bad = [f for f in ("w_packed", "bos_out") if getattr(e, f) is not None]
    if e.a_bits != 8:
        bad.append(f"a_bits={e.a_bits}")
    if e.act_off:
        bad.append("act_off")
    if bad:
        raise ValueError(f"deploy entry {layer}: field {bad[0]} is not held "
                         "by the container (it stores w_int, scale, bias0, "
                         "scale_inv, zp_shifted, kind and split)")


def save_deploy_ckpt(deploy: Dict[str, Any], path: str,
                     w4_layers: Optional[set] = None) -> None:
    """Flatten ``{layer: DeployEntry}`` into the container, as the JAX
    package does: ``{prefix}::{field}`` tensors (the float constants as
    0-d f32) and a ``__meta__`` JSON of each entry's ``kind`` / ``split``,
    split halves under ``{layer}::part0`` / ``::part1``. ``w4_layers``:
    layers whose ``w_int`` codes are 4-bit, stored packed."""
    w4_layers = w4_layers or set()
    tensors: Dict[str, torch.Tensor] = {}
    meta: Dict[str, Any] = {}
    pack4 = set()

    def add_entry(prefix, e, layer):
        _check_entry(prefix, e)
        meta[prefix] = {"kind": e.kind, "split": e.split}
        for f in DEPLOY_FIELDS:
            v = getattr(e, f)
            if v is None:
                continue
            key = f"{prefix}::{f}"
            tensors[key] = (v if isinstance(v, torch.Tensor)
                            else torch.tensor(v, dtype=torch.float32))
            if f == "w_int" and layer in w4_layers:
                pack4.add(key)
        if e.part0 is not None:
            add_entry(prefix + "::part0", e.part0, layer)
            add_entry(prefix + "::part1", e.part1, layer)

    for layer, e in deploy.items():
        add_entry(layer, e, layer)
    tensors["__meta__"] = torch.frombuffer(
        bytearray(json.dumps(meta).encode()), dtype=torch.uint8)
    save_tensors(tensors, path, pack4)


def load_deploy_ckpt(path: str, device=None) -> Dict[str, Any]:
    """The deploy dict of ``path`` (the port's or the JAX package's), its
    tensors on ``device`` (on the CPU they stay views of the memory map):
    ``scale_inv`` / ``zp_shifted`` as Python floats, int4 fields (JAX's
    ``int4_fields``) as int8 codes, and each cross-attention k/v entry's
    ``bos_w`` attached (``deploy.attach_bos_weights``), as
    ``quantize_w8a8`` attaches it."""
    from ..quant.deploy import DeployEntry, attach_bos_weights

    tensors = load_tensors(path)
    meta = json.loads(tensors.pop("__meta__").numpy().tobytes().decode())

    def build(prefix):
        m = meta[prefix]
        kw = {}
        for f in DEPLOY_FIELDS:
            key = f"{prefix}::{f}"
            if key not in tensors:
                continue
            t = tensors[key]
            if f in ("scale_inv", "zp_shifted"):
                kw[f] = float(t)
            else:
                kw[f] = t.to(torch.int8) if f in m.get(
                    "int4_fields", ()) else t
                if device is not None:
                    kw[f] = kw[f].to(device)
        if f"{prefix}::part0" in meta:
            kw["part0"] = build(f"{prefix}::part0")
            kw["part1"] = build(f"{prefix}::part1")
        return DeployEntry(kind=m["kind"], split=m["split"], **kw)

    deploy = {layer: build(layer) for layer in meta if "::" not in layer}
    return attach_bos_weights(deploy)
