"""Int8 VAE decoder (port of ``mixdq_tpu/quant/vae_quant.py``).

In few-step generation (SDXL-Turbo at one step) the VAE decode is a large
share of a request, so the decoder runs W8A8 through the UNet's own
calibrate -> deploy machinery, over the ``decoder.*`` layers of
``models.vae.AutoencoderKL``: every 3x3 conv on ``qconv2d`` (at every
level: the port has no shape gate), every 1x1 shortcut and attention
projection on ``qmatmul``. The GroupNorms stay plain.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Tuple

import torch

from .calibrate import calibrate
from .core import QuantSpec
from .deploy import deploy_unet_ctx, prune_deployed_weights
from .state import QuantCtx, quantizable_layers, uniform_ctrl


class _DecodeAdapter:
    """``calibrate``'s view of the VAE: its layers, and a call that
    decodes."""

    def __init__(self, vae):
        self._vae = vae

    def named_modules(self):
        return self._vae.named_modules()

    def __call__(self, z, ctx):
        return self._vae.decode(z, ctx)


def quantize_vae_decoder(vae, latent_batches: Iterable[torch.Tensor],
                         wq: QuantSpec = None, aq: QuantSpec = None,
                         deploy_compute: str = "int8_sec"
                         ) -> Tuple[torch.nn.Module, QuantCtx]:
    """Calibrate the VAE on ``latent_batches`` (scaled latents ``[B, h, w,
    4]`` as ``decode`` takes them: sampler outputs, say) and deploy its
    decoder W8A8 (no BoS protection). Returns ``(pruned, ctx)``: a copy of
    ``vae`` whose decoder layers hold no fp weight (``vae`` is left as it
    is), which decodes under ``ctx`` (``pruned.decode(z, ctx)``; its
    encoder stays FP), as the JAX function returns pruned params."""
    wq = wq or QuantSpec(sym=True, channel_wise=True, round_mode="nearest")
    aq = aq or QuantSpec(running_stat=True)
    qparams = calibrate(_DecodeAdapter(vae), [(z,) for z in latent_batches],
                        wq, aq)
    names = [n for n in quantizable_layers(vae) if n.startswith("decoder.")]
    ctrl = uniform_ctrl(names, w_bits=8, a_bits=8)
    ctx = deploy_unet_ctx(vae, qparams, ctrl, wq, bos_aware=False,
                          deploy_compute=deploy_compute)
    pruned = copy.deepcopy(vae)
    prune_deployed_weights(pruned, ctx.deploy)
    return pruned, ctx


def decoder_kernel_calls(ctx: QuantCtx) -> Dict[str, int]:
    """Kernel calls of one int8 decode under ``ctx`` (an ``int8_sec``
    deploy of ``quantize_vae_decoder``): ``qconv2d`` for each 3x3 conv,
    ``qmatmul`` for each 1x1 shortcut and attention projection; every
    other kernel 0 (the GroupNorms stay plain)."""
    from ..pipeline import KERNELS

    calls = dict.fromkeys(KERNELS, 0)
    for e in ctx.deploy.values():
        one = e.kind == "linear" or tuple(e.w_int.shape[:2]) == (1, 1)
        calls["qmatmul" if one else "qconv2d"] += 1
    return calls
