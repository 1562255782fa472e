"""Pipelines and quantizer specs from a config (port of
``mixdq_tpu/pipelines/loader.py``), shared by the CLIs under
``scripts/``."""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from ..quant.core import QuantSpec
from ..utils.config import Config
from .txt2img import Text2ImgPipeline

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def specs_from_config(cfg: Config
                      ) -> Tuple[QuantSpec, QuantSpec, Optional[QuantSpec]]:
    """(weight, activation, softmax) ``QuantSpec``s of the ``quant:``
    stanza; the softmax spec (asymmetric, always-zero, ``softmax.n_bits``)
    only under ``softmax.enabled: true``, else None."""
    q = cfg.quant
    cb = tuple(q.get("candidate_bits", [2, 4, 8]))
    w = q.weight
    wq = QuantSpec(
        n_bits=w.get("n_bits", 8), sym=w.get("sym", True),
        channel_wise=w.get("channel_wise", True),
        scale_method=w.get("scale_method", "min_max"),
        round_mode=w.get("round_mode", "nearest"), candidate_bits=cb)
    a = q.activation
    aq = QuantSpec(
        n_bits=a.get("n_bits", 8), sym=a.get("sym", False),
        channel_wise=False,
        scale_method=a.get("scale_method", "min_max"),
        round_mode=a.get("round_mode", "nearest_ste"),
        running_stat=a.get("running_stat", True), candidate_bits=cb)
    sm = q.get("softmax")
    softmax_aq = None
    if sm is not None and sm.get("enabled", False):
        softmax_aq = QuantSpec(
            n_bits=sm.get("n_bits", 8), sym=False, channel_wise=False,
            round_mode="nearest_ste", always_zero=True, candidate_bits=cb)
    return wq, aq, softmax_aq


def build_pipeline(cfg: Config, device=None, seed: int = 0
                   ) -> Text2ImgPipeline:
    """The ``model:`` stanza's pipeline on ``device`` (CUDA unless
    ``'cpu'`` is asked for) in ``model.dtype``, with the params of
    ``model.params_path`` (a flax msgpack file: ``quant.checkpoint``) or
    random weights from ``seed`` (the repo holds no real weights)."""
    m = cfg.model
    pipe = Text2ImgPipeline(m.family, dtype=_DTYPES[m.get("dtype",
                                                          "float32")],
                            device=device,
                            tokenizer_path=m.get("tokenizer_path"))
    path = m.get("params_path")
    if path:
        from ..quant.checkpoint import load_params

        logger.info("loading model params from %s", path)
        load_params(pipe, path)
    else:
        pipe.init_weights(seed)
    return pipe
