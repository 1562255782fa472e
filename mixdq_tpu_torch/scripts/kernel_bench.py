"""Kernel microbenchmark: the int8, fused act-quantize, weight-dequant and
packed-W4 GEMMs against the bf16 matmul at SDXL shapes (port of
``scripts/kernel_bench.py``).

    python -m mixdq_tpu_torch.scripts.kernel_bench [--iters 20]

Rows, per shape, in the JAX script's order: the bf16 ``torch.matmul``
(the baseline); the int8 product in PyTorch ops (quantize, the exact int
GEMM, the epilogue: ``qmatmul_plain``); the quantize then the ``qmatmul``
kernel; ``qmatmul_fused``; ``qmatmul_fused2``; ``wq_matmul``;
``wq4_matmul``. Each row's time is the median over ``--iters`` calls,
each timed alone by CUDA events after warm-up, with the operands warm in
L2 (the JAX script chained calls in one scan to get past a remote TPU's
dispatch floor). A row that fails raises: the script exits non-zero. It
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List, Tuple

import torch

from mixdq_tpu_torch.ops import qops
from mixdq_tpu_torch.ops.qmatmul import (qmatmul, qmatmul_fused,
                                         qmatmul_fused2, qmatmul_plain)
from mixdq_tpu_torch.ops.wq_matmul import (pack_w4_halves, wq4_matmul,
                                           wq_matmul)

#: (M, K, N) of SDXL's dense layers (``scripts/kernel_bench.py:66-67``)
SHAPES = ((4096, 640, 640), (1024, 1280, 1280), (1024, 1280, 5120),
          (1024, 5120, 1280))
#: the act quantizer's 1 / s_a and shifted zero point, and the weight scale
SCALE_INV, ZP_SHIFTED, W_SCALE = 10.0, -3.0, 0.01
#: untimed calls of each row before its timed ones
WARMUP = 3

Row = Callable[[], torch.Tensor]


def make_inputs(M: int, K: int, N: int, device, seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """The operands of one shape, made from ``seed`` on ``device``: x and
    the bf16 weight ``wb`` from ``randn``, int8 weight codes ``wi`` in
    [-127, 126], their clip to [-8, 7] halves-packed (``packed``, even K
    only), scale ``sc`` 0.01 and ``bias0`` 0 per column."""
    g = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16
    inp = dict(
        x=torch.randn((M, K), generator=g, device=device, dtype=bf16),
        wb=torch.randn((K, N), generator=g, device=device, dtype=bf16),
        wi=torch.randint(-127, 127, (K, N), generator=g, device=device,
                         dtype=torch.int8),
        sc=torch.full((N,), W_SCALE, device=device),
        b0=torch.zeros((N,), device=device))
    if K % 2 == 0:
        inp["packed"] = pack_w4_halves(inp["wi"].clamp(-8, 7))
    return inp


def build_rows(inp: Dict[str, torch.Tensor]) -> Dict[str, Row]:
    """{row name: zero-argument call} on the operands of ``make_inputs``."""
    x, wb, wi, sc, b0 = (inp[k] for k in ("x", "wb", "wi", "sc", "b0"))
    q = (SCALE_INV, ZP_SHIFTED)
    rows = {
        "bf16 matmul": lambda: torch.matmul(x, wb),
        "torch int8 (quant+int_gemm)": lambda: qmatmul_plain(
            qops.quantize_per_tensor(x, *q), wi, sc, b0),
        "quantize + qmatmul": lambda: qmatmul(
            qops.quantize_per_tensor(x, *q), wi, sc, b0),
        "fused-quant (qmatmul_fused)": lambda: qmatmul_fused(
            x, wi, *q, sc, b0),
        "fused-quant v2 (qmatmul_fused2)": lambda: qmatmul_fused2(
            x, wi, *q, sc, b0),
        "w8-dequant (wq_matmul)": lambda: wq_matmul(x, wi, sc),
    }
    if "packed" in inp:
        rows["w4-packed (wq4_matmul)"] = lambda: wq4_matmul(
            x, inp["packed"], sc)
    return rows


def time_ms(fn: Row, iters: int) -> Tuple[float, torch.Tensor]:
    """(median device ms of one call over ``iters`` calls, the last
    output)."""
    for _ in range(WARMUP):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        out = fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev), out


def bench(device, iters: int, shapes=SHAPES
          ) -> List[Tuple[Tuple[int, int, int], List[Tuple[str, float,
                                                           torch.Tensor]]]]:
    """Every row at every shape: [((M, K, N), [(row, ms, last output)])]."""
    table = []
    for M, K, N in shapes:
        rows = [(name, *time_ms(fn, iters)) for name, fn in
                build_rows(make_inputs(M, K, N, device)).items()]
        table.append(((M, K, N), rows))
    return table


def format_table(table) -> List[str]:
    """The printed lines: each row's ms and its ratio against bf16."""
    lines = []
    for (M, K, N), rows in table:
        lines.append(f"M={M} K={K} N={N}")
        base = rows[0][1]
        for name, ms, _ in rows:
            lines.append(f"  {name:<32} {ms:8.4f} ms ({base / ms:.2f}x vs "
                         "bf16)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for line in format_table(bench(torch.device("cuda"), args.iters)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
