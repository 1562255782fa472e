"""Per-layer sensitivity sweeps, metric-decoupled (port of
``mixdq_tpu/mixed_precision/sensitivity.py``).

For every (layer, bits) point the sweep quantizes that layer alone
(fake-quant mode, ``quant.state.group_ctrl``) and measures

* the SQNR of the UNet's output against its FP output on a calibration
  batch, for the "quality" layers (all but ff/attn2), or
* the SSIM of generated images against the FP images of the same noise,
  for the "content" layers (ff/attn2),

higher meaning less sensitive. The JAX package carries the controls as
jit data, so one compiled program serves every point, and its batched
sweeps vmap ``chunk`` points at once; here a control is Python data and
each point runs eagerly, one after another, so the batched sweeps equal
the sequential ones exactly and ``chunk`` only groups the progress log.
With a ``mesh`` (``parallel.mesh.make_mesh``; every rank calls the sweep)
the batched sweeps share their (layer, bits) points out over dp: each
rank runs every dp-th point on its replicated model, and the values are
all-gathered (the only collective), so each equals the sequential
sweep's.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..parallel import mesh as pmesh
from ..quant.state import QuantCtx, group_ctrl
from ..utils.metrics import sqnr, ssim

logger = logging.getLogger(__name__)


def split_metric_groups(names: Iterable[str]) -> Tuple[List[str], List[str]]:
    """(content, quality): ff/attn2 layers are 'content'."""
    content, quality = [], []
    for n in names:
        if ".ff." in n or ".attn2." in n:
            content.append(n)
        else:
            quality.append(n)
    return content, quality


def _fake_ctx(qparams, ctrl, wq, aq) -> QuantCtx:
    """The sweep's context: fake mode under ``ctrl``, as the JAX sweeps
    build it (no BoS protection, einsum attention)."""
    return QuantCtx(qparams=qparams, ctrl=ctrl, mode="fake", wq=wq, aq=aq)


def _check_points(fn: str, layer_names, all_names, wq, bits) -> None:
    """The batched sweeps' checks: exact layer names only, and bits
    among ``wq.candidate_bits`` (the calibrated ones)."""
    pos = set(all_names)
    unknown = [n for n in layer_names if n not in pos]
    if unknown:
        raise KeyError(f"{fn} takes exact layer names only (no prefix "
                       f"targets: use the sequential sweep for those); "
                       f"unknown: {unknown[:5]}")
    cb = list(wq.candidate_bits)
    bad = [b for b in bits if b not in cb]
    if bad:
        raise ValueError(f"sweep bits {bad} not in candidate_bits {cb}: no "
                         "calibrated qparams exist for them")


def _sweep(point_fn, layer_names, bits, mesh, tag: str, every: int
           ) -> Dict[str, List[float]]:
    """``{name: [point_fn(name, b) for b in bits]}``; over a mesh, each dp
    rank runs its share of the points and the values are gathered."""
    points = [(n, b) for n in layer_names for b in bits]
    local = points if mesh is None else pmesh.dp_points(mesh, points)
    vals = []
    for i, (name, b) in enumerate(local):
        vals.append(point_fn(name, b))
        if i % every == 0:
            logger.info("%s sweep point %d/%d %s @%d -> %.3f", tag, i,
                        len(local), name, b, vals[-1])
    if mesh is not None:
        vals = pmesh.gather_points(mesh, points, vals)
    nb = len(bits)
    return {n: vals[i * nb:(i + 1) * nb] for i, n in enumerate(layer_names)}


def sweep_sqnr(model, qparams, layer_names: Sequence[str],
               all_names: Sequence[str], calib_batch: Tuple,
               fp_outputs: torch.Tensor, wq, aq, which: str = "weight",
               bits: Sequence[int] = (2, 4, 8)) -> Dict[str, List[float]]:
    """SQNR (dB) of ``model(*calib_batch)`` against ``fp_outputs`` with
    each target (an exact layer name or a dotted block prefix) quantized
    alone at each of ``bits``: ``{target: [one value a bit]}``."""
    return _sqnr_points(model, qparams, layer_names, all_names, calib_batch,
                        fp_outputs, wq, aq, which, bits, None)


@torch.inference_mode()
def _sqnr_points(model, qparams, layer_names, all_names, calib_batch,
                 fp_outputs, wq, aq, which, bits, mesh):
    def point(name, b):
        ctrl = group_ctrl(all_names, [name], which, b,
                          candidate_bits=wq.candidate_bits)
        y = model(*calib_batch, ctx=_fake_ctx(qparams, ctrl, wq, aq))
        return float(sqnr(fp_outputs, y))

    return _sweep(point, layer_names, bits, mesh, "sqnr", 20)


def sweep_sqnr_batched(model, qparams, layer_names: Sequence[str],
                       all_names: Sequence[str], calib_batch: Tuple,
                       fp_outputs: torch.Tensor, wq, aq,
                       which: str = "weight", bits: Sequence[int] = (2, 4, 8),
                       chunk: int = 8, mesh=None) -> Dict[str, List[float]]:
    """``sweep_sqnr`` over exact layer names at candidate bits, with the
    JAX batched sweep's checks; its points run one after another, shared
    out over dp on a ``mesh``."""
    _check_points("sweep_sqnr_batched", layer_names, all_names, wq, bits)
    return _sqnr_points(model, qparams, layer_names, all_names, calib_batch,
                        fp_outputs, wq, aq, which, bits, mesh)


def _ssim_win(h: int, ssim_win: int) -> int:
    """The SSIM window: at most ``h - 1``, odd."""
    win = min(ssim_win, h - 1)
    return win - 1 if win % 2 == 0 else win


def images_ssim(fp_imgs: torch.Tensor, q_imgs: torch.Tensor,
                win: int) -> float:
    """The mean over a batch of each image pair's SSIM."""
    return float(torch.stack([ssim(a, b, win_size=win)
                              for a, b in zip(fp_imgs, q_imgs)]).mean())


def generate(pipe, prompts: Sequence[str], seed: int,
             num_steps: Optional[int], ctx=None) -> torch.Tensor:
    """``pipe``'s images ``[B, H, W, 3]`` (f32, in [0, 1]) for ``prompts``
    with the noise of ``seed`` under ``ctx`` (FP when None)."""
    kw = {} if ctx is None else {"ctx": ctx}
    out = pipe(list(prompts), seed=seed, num_inference_steps=num_steps, **kw)
    return torch.from_numpy(out.images).float()


def sweep_ssim(pipe, qparams, layer_names: Sequence[str],
               all_names: Sequence[str], prompts: Sequence[str], seed: int,
               wq, aq, which: str = "weight", bits: Sequence[int] = (2, 4, 8),
               num_steps: Optional[int] = None,
               ssim_win: int = 511) -> Dict[str, List[float]]:
    """SSIM of the images ``pipe`` generates with each target (an exact
    name or a dotted prefix; one that matches no layer raises) quantized
    alone at each of ``bits`` against the FP images of the same noise
    (``seed``). The window is ``ssim_win`` (the reference's 511 on 512 px
    images), at most the height less one, odd."""
    for name in layer_names:
        if not any(n == name or n.startswith(name + ".") for n in all_names):
            raise KeyError(f"sweep_ssim target {name!r} matches no layer "
                           "(exact or dotted prefix) in all_names")
    return _ssim_points(pipe, qparams, layer_names, all_names, prompts, seed,
                        wq, aq, which, bits, num_steps, ssim_win, None)


def _ssim_points(pipe, qparams, layer_names, all_names, prompts, seed, wq,
                 aq, which, bits, num_steps, ssim_win, mesh):
    fp_imgs = generate(pipe, prompts, seed, num_steps)
    win = _ssim_win(fp_imgs.shape[1], ssim_win)

    def point(name, b):
        ctrl = group_ctrl(all_names, [name], which, b,
                          candidate_bits=wq.candidate_bits)
        q_imgs = generate(pipe, prompts, seed, num_steps,
                          _fake_ctx(qparams, ctrl, wq, aq))
        return images_ssim(fp_imgs, q_imgs, win)

    return _sweep(point, layer_names, bits, mesh, "ssim", 10)


def sweep_ssim_batched(pipe, qparams, layer_names: Sequence[str],
                       all_names: Sequence[str], prompts: Sequence[str],
                       seed: int, wq, aq, which: str = "weight",
                       bits: Sequence[int] = (2, 4, 8),
                       num_steps: Optional[int] = None, ssim_win: int = 511,
                       chunk: int = 4, mesh=None) -> Dict[str, List[float]]:
    """``sweep_ssim`` over exact layer names at candidate bits, with the
    JAX batched sweep's checks; its points run one after another, shared
    out over dp on a ``mesh``."""
    _check_points("sweep_ssim_batched", layer_names, all_names, wq, bits)
    return _ssim_points(pipe, qparams, layer_names, all_names, prompts, seed,
                        wq, aq, which, bits, num_steps, ssim_win, mesh)
