"""Build the CUDA C++ kernels under ``csrc/`` with ``nvcc`` and load them
with ``ctypes`` (plain C interface, no PyTorch headers, so each source
compiles in seconds).

Each source compiles into its own shared library, named after the source
and a hash of the sources, in ``csrc/build/`` (listed in ``.gitignore``).
``build_all`` starts one ``nvcc`` per source at once and waits for all.
Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("qconv.cu", "geglu_qmatmul.cu", "gn_quant.cu", "ln_quant.cu",
           "qmatmul.cu", "sec_attention.cu", "sec_coop_d16.cu",
           "sec_coop_d32.cu", "sec_coop_d64.cu", "sec_coop_d128.cu",
           "flash_attention.cu", "int8_flash.cu", "wq_matmul.cu",
           "qmatmul_fused.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills)
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(src: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")) and (name == src
                                              or name.endswith(".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{src[:-3]}_{h.hexdigest()[:12]}.so")


def _start(src: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
           "-o", tmp, os.path.join(CSRC, src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build_all(sources: List[str] = None) -> Dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``s in
    parallel; returns ``{source: library path}``. Raises on a failed
    build with the compiler's output."""
    sources = list(sources or SOURCES)
    with _LOCK:
        paths = {s: _lib_path(s) for s in sources}
        running = {s: _start(s) for s in sources
                   if not os.path.exists(paths[s])}
        errors = []
        for s, (proc, tmp) in running.items():
            log, _ = proc.communicate()
            BUILD_LOGS[s] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc {s} failed ({proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[s])
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(src: str) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""
    lib = _LIBS.get(src)
    if lib is None:
        path = build_all([src])[src]
        with _LOCK:
            lib = _LIBS.get(src)
            if lib is None:
                lib = ctypes.CDLL(path)
                lib.mixdq_error_string.argtypes = [ctypes.c_int]
                lib.mixdq_error_string.restype = ctypes.c_char_p
                _LIBS[src] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.mixdq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t) -> int:
    """Raw device pointer of a tensor, or NULL for ``None``."""
    return 0 if t is None else t.data_ptr()


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
