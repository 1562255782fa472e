"""The msgpack format of flax's checkpoints (``flax.serialization``), read
and written without the ``msgpack`` package, which the card lacks.

What flax writes, and so what this module reads and writes:

* the msgpack base types: nil, bools, ints, float64, str, bin, arrays
  (from lists and tuples), maps (in insertion order, string keys);
* ext type 1, an ndarray: its payload is itself the packed triple
  ``(shape, dtype.name, C-order bytes)``, strings as str and the bytes as
  bin (flax ``_ndarray_to_bytes``);
* ext type 3, a numpy scalar, packed as a 0-d ndarray;
* an ndarray of more than ``MAX_CHUNK_SIZE`` bytes inside a map, written
  as ``{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...},
  'chunks': {'0': flat chunk, ...}}`` (flax ``_chunk`` / ``_unchunk``).

Headers are the smallest that fit, as msgpack-python picks them, and maps
keep their insertion order, so the same tree gives the same bytes as flax
(``msgpack_serialize`` sorts dict keys first, through
``jax.tree_util.tree_map``: a caller that wants its bytes passes a sorted
tree; a chunked array's maps keep flax's insertion order). Array leaves are
``torch.Tensor``s (or numpy arrays / scalars) on the way in and CPU
``torch.Tensor``s on the way out; ``bfloat16`` needs no numpy dtype (the
card's numpy has none): its bytes go through ``torch.int16``.

``pack(tree, write)`` streams: each leaf is copied to the host and
written alone, so writing a model needs no host copy of the whole tree.
``unpack(buffer)`` returns leaves that view ``buffer`` when it is writable
(an ``mmap`` of the file: no second host copy either), and leaves that view
one copy of it when it is read-only.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

#: flax's chunk limit (``serialization.MAX_CHUNK_SIZE``): msgpack holds at
#: most 2**31 - 1 bytes in one object
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _int_header(v: int) -> bytes:
    if 0 <= v < 128:
        return struct.pack("B", v)
    if -32 <= v < 0:
        return struct.pack("b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """Header of a str / bin / array / map of ``n`` items or bytes:
    ``fix | n`` below ``fix_max`` (None: no fix form), else the first of
    the 8 / 16 / 32-bit forms ``codes`` that holds ``n``."""
    if fix_max and n < fix_max:
        return bytes([fix | n])
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} items or bytes do not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _len_header(n, 0, 0, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _len_header(n, 0x90, 16, (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _len_header(n, 0x80, 16, (None, 0xDE, 0xDF))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _len_header(n, 0, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _host_array(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array leaf on the host."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"no msgpack dtype for {t.dtype}")
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(x)
        name = a.dtype.name
        if a.dtype.hasobject or name not in _TORCH_DTYPES:
            raise TypeError(f"no msgpack dtype for {a.dtype}")
    shape = tuple(int(d) for d in x.shape)
    return shape, name, memoryview(a.reshape(-1).view(np.uint8))


def _write_ndarray(write, x, code: int = EXT_NDARRAY) -> None:
    shape, name, data = _host_array(x)
    head = (_array_header(3) + _array_header(len(shape))
            + b"".join(_int_header(d) for d in shape) + _str(name)
            + _bin_header(len(data)))
    write(_ext_header(code, len(head) + len(data)) + head)
    write(data)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def _chunked(x) -> Dict[str, Any]:
    """flax's ``_chunk``: the flat array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    item = (x.element_size() if isinstance(x, torch.Tensor)
            else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def pack(obj: Any, write: Callable[[bytes], Any]) -> None:
    """Write ``obj`` through ``write`` (a file's ``write``), leaf by leaf;
    an array above ``MAX_CHUNK_SIZE`` bytes in a map is chunked."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        write(_int_header(obj))
    elif type(obj) is float:
        write(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        write(_str(obj))
    elif type(obj) in (bytes, bytearray, memoryview):
        b = bytes(obj)
        write(_bin_header(len(b)) + b)
    elif isinstance(obj, dict):
        write(_map_header(len(obj)))
        for k, v in obj.items():
            pack(k, write)
            pack(_chunked(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE
                 else v, write)
    elif type(obj) in (list, tuple):
        write(_array_header(len(obj)))
        for v in obj:
            pack(v, write)
    elif _is_array(obj):
        _write_ndarray(write, obj)
    elif isinstance(obj, np.generic):
        _write_ndarray(write, np.asarray(obj), EXT_NPSCALAR)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.num("B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0F)
        if c < 0xA0:
            return [self.obj() for _ in range(c & 0x0F)]
        if c < 0xC0:
            return str(self.take(c & 0x1F), "utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sized:
            return bytes(self.take(self.num(sized[c])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in ext:
            n = self.num(ext[c])
            return self.ext(self.num("B"), n)
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.num(nums[c])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(self.num("B"), fixext[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return str(self.take(self.num(strs[c])), "utf-8")
        if c in (0xDC, 0xDD):
            n = self.num(">H" if c == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not read here")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> torch.Tensor:
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not read here")
        end = self.pos + n
        inner = _Reader(self.take(n))
        if inner.num("B") != 0x93:
            raise ValueError("an ndarray ext holds (shape, dtype, bytes)")
        shape = inner.obj()
        name = inner.obj()
        name = name.decode() if isinstance(name, bytes) else name
        c = inner.num("B")
        size = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c not in size:
            raise ValueError("an ndarray's data must be bin")
        data = inner.take(inner.num(size[c]))
        if inner.pos != n or self.pos != end:
            raise ValueError("trailing bytes in an ndarray ext")
        return _tensor(data, name, tuple(shape))


def _tensor(data: memoryview, name: str, shape) -> torch.Tensor:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"ndarray dtype {name!r} is not read here")
    dtype = _TORCH_DTYPES[name]
    if len(data) == 0:
        return torch.empty(shape, dtype=dtype)
    # bfloat16 as its int16 bit patterns: no numpy dtype needed
    bf16 = dtype == torch.bfloat16
    t = torch.frombuffer(data, dtype=torch.int16 if bf16 else dtype)
    return (t.view(torch.bfloat16) if bf16 else t).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def unpack(buf) -> Any:
    """The tree packed in ``buf`` (bytes-like). Array leaves come back as
    CPU tensors that view ``buf`` when it is writable (an ``mmap`` opened
    ``ACCESS_COPY``, a ``bytearray``), else one copy of it; chunked arrays
    joined."""
    mv = memoryview(buf)
    if mv.readonly:
        mv = memoryview(bytearray(mv))
    r = _Reader(mv.cast("B"))
    out = r.obj()
    if r.pos != len(mv):
        raise ValueError(f"{len(mv) - r.pos} bytes after the msgpack object")
    return _unchunk(out)
