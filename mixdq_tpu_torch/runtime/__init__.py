"""Native host runtime (port of ``mixdq_tpu/runtime/__init__.py``): ctypes
bindings over ``native/mixdq_native.cpp``, threaded C++ for the host's
multi-GB passes: int4 packing of deploy codes and per-channel weight
quantization.

The library builds with ``g++`` at first use into ``runtime/build/``
(listed in ``.gitignore``), named after a hash of the source, so a stale
build is never loaded. Unlike the JAX package, which falls back to numpy
when the build fails, a failed build or load raises: nothing falls back
quietly. The numpy versions (``*_plain``) are the plain references the
tests hold the library against.

The int4 packing here is the deploy container's: adjacent codes paired,
the first in the low nibble, each biased by +8; an odd tail gets its own
byte. The weight-only kernels' ``ops/wq_matmul.py:pack_w4_halves`` pairs
row ``k`` with row ``k + K/2`` instead; the two layouts never mix.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "native", "mixdq_native.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
#: portable code (no ``-march=native``): a checkout may be copied to a
#: machine with another CPU, build directory and all
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def lib_path() -> str:
    """The shared library's path, named after the source and flags."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmixdq_native_{h.hexdigest()[:12]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC}:\n{r.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = lib_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.pack_int4.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64]
        lib.unpack_int4.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64]
        lib.quantize_per_channel.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        for fn in (lib.pack_int4, lib.unpack_int4, lib.quantize_per_channel):
            fn.restype = None
        _lib = lib
        return _lib


def _host(t, dtype) -> np.ndarray:
    """``t`` (a tensor on any device, or an array) as a contiguous host
    array of ``dtype``."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t, dtype=dtype)


def pack_int4(codes) -> torch.Tensor:
    """int8 codes in [-8, 7] (any shape) -> packed uint8 ``[(n + 1) // 2]``,
    two codes a byte, the first in the low nibble, each biased by +8."""
    flat = _host(codes, np.int8).reshape(-1)
    out = np.empty((flat.size + 1) // 2, dtype=np.uint8)
    get_lib().pack_int4(flat.ctypes.data, out.ctypes.data, flat.size)
    return torch.from_numpy(out)


def unpack_int4(packed, n: int) -> torch.Tensor:
    """The first ``n`` int8 codes of ``pack_int4``'s bytes."""
    packed = _host(packed, np.uint8).reshape(-1)
    if packed.size < (n + 1) // 2:
        raise ValueError(f"{packed.size} bytes hold fewer than {n} codes")
    out = np.empty(n, dtype=np.int8)
    get_lib().unpack_int4(packed.ctypes.data, out.ctypes.data, n)
    return torch.from_numpy(out)


def quantize_per_channel(w, delta, n_bits: int = 8) -> torch.Tensor:
    """Per-out-channel symmetric codes ``clip(round(w / delta), lo, hi)``
    (half to even) of ``w`` ``[..., C]`` with ``delta`` ``[C]``, int8 of
    ``w``'s shape, on the host."""
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    shape = tuple(w.shape)
    w2 = _host(w, np.float32).reshape(-1, shape[-1])
    d = _host(delta, np.float32).reshape(-1)
    if d.size != shape[-1]:
        raise ValueError(f"delta has {d.size} channels, w {shape[-1]}")
    out = np.empty(w2.shape, dtype=np.int8)
    get_lib().quantize_per_channel(w2.ctypes.data, d.ctypes.data,
                                   out.ctypes.data, w2.shape[0],
                                   w2.shape[1], lo, hi)
    return torch.from_numpy(out.reshape(shape))


def pack_int4_plain(codes: np.ndarray) -> np.ndarray:
    """``pack_int4`` in numpy (the JAX package's fallback)."""
    flat = np.ascontiguousarray(codes, dtype=np.int8).reshape(-1)
    n = flat.size
    b = (flat.astype(np.int16) + 8).astype(np.uint8) & 0xF
    if n % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return (b[0::2] | (b[1::2] << 4)).astype(np.uint8)[: (n + 1) // 2]


def unpack_int4_plain(packed: np.ndarray, n: int) -> np.ndarray:
    """``unpack_int4`` in numpy."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8).reshape(-1)
    out = np.empty(packed.size * 2, np.int8)
    out[0::2] = (packed & 0xF).astype(np.int8) - 8
    out[1::2] = ((packed >> 4) & 0xF).astype(np.int8) - 8
    return out[:n]


def quantize_per_channel_plain(w: np.ndarray, delta: np.ndarray,
                               n_bits: int = 8) -> np.ndarray:
    """``quantize_per_channel`` in numpy."""
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    w = np.asarray(w, dtype=np.float32)
    d = np.asarray(delta, dtype=np.float32)
    return np.clip(np.round(w / d), lo, hi).astype(np.int8)
