"""Candidate election (port of ``mixdq_tpu/mixed_precision/election.py``):
the bit config whose images are closest (pixel MSE) to the FP images of
the same noise wins (the reference's ``quant_inference_mp.py:211-270``:
weights first, then acts with the weight config fixed)."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

from ..quant.state import QuantCtx, apply_bitwidth_config, uniform_ctrl
from ..utils.metrics import pixel_mse
from .sensitivity import generate

logger = logging.getLogger(__name__)


def elect(pipe, qparams, all_names: Sequence[str],
          candidates: Sequence[Dict[str, int]], which: str,
          prompts: Sequence[str], seed: int, wq, aq, base_ctrl=None,
          num_steps: Optional[int] = None
          ) -> Tuple[Dict[str, int], int, List[float]]:
    """(winner, its index, every candidate's pixel MSE): each candidate's
    bit map applied to ``which`` ('weight' / 'act') over ``base_ctrl``
    (the other tensor's fixed config; default every layer at 8 bits) in
    fake mode, its images generated with the FP images' noise
    (``seed``); the first of equal MSEs wins."""
    fp_imgs = generate(pipe, prompts, seed, num_steps)
    mses = []
    for ci, cand in enumerate(candidates):
        ctrl = dict(base_ctrl) if base_ctrl is not None else uniform_ctrl(
            all_names, candidate_bits=wq.candidate_bits)
        ctrl = apply_bitwidth_config(ctrl, cand, which, wq.candidate_bits)
        ctx = QuantCtx(qparams=qparams, ctrl=ctrl, mode="fake", wq=wq, aq=aq)
        m = float(pixel_mse(generate(pipe, prompts, seed, num_steps, ctx),
                            fp_imgs))
        mses.append(m)
        logger.info("candidate %d/%d pixel-MSE %.6f", ci + 1,
                    len(candidates), m)
    best = min(range(len(mses)), key=mses.__getitem__)
    return candidates[best], best, mses
