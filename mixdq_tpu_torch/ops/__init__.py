"""Device dispatch and launch counts for the port's kernels.

Every kernel wrapper takes its plain PyTorch version for a tensor on the
CPU and launches its CUDA kernel for a tensor on a CUDA device. Nothing
reads an environment variable and nothing falls back: a CUDA call either
launches the kernel or raises.

Each wrapper owns one ``KernelCount``: ``calls`` counts every call (any
device), ``launches`` only the calls that launched the CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class KernelCount:
    name: str
    calls: int = 0
    launches: int = 0


_COUNTS: Dict[str, KernelCount] = {}


def register(name: str) -> KernelCount:
    """The counter of kernel ``name`` (one per wrapper)."""
    if name in _COUNTS:
        raise ValueError(f"kernel {name!r} registered twice")
    _COUNTS[name] = KernelCount(name)
    return _COUNTS[name]


def reset_counts() -> None:
    for c in _COUNTS.values():
        c.calls = 0
        c.launches = 0


def launch_counts() -> Dict[str, int]:
    return {n: c.launches for n, c in _COUNTS.items()}


def call_counts() -> Dict[str, int]:
    return {n: c.calls for n, c in _COUNTS.items()}


def use_kernel(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); raises for any other device or mixed devices."""
    for o in others:
        if o is not None and o.device != x.device:
            raise ValueError(f"tensors on {x.device} and {o.device}")
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def check_cuda_args(name: str, **tensors: torch.Tensor) -> None:
    """Contiguity check on the tensors a kernel reads by raw pointer."""
    for k, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
