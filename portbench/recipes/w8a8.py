"""The W8A8 deploy (MixDQ's uniform baseline) through the program's own
entry points: calibrate every UNet layer on the calibration batch and
deploy it int8 (``int8_sec``, fused QKV / KV, BoS-aware, ``attn_impl
'auto'``), then drop the fp weights the deploy replaced, as a served
int8 replica holds them. Returns the UNet's context and the VAE's."""


def deploy(pipe, calib):
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.deploy import prune_deployed_weights
    from mixdq_tpu_torch.quant.state import FP_CTX

    ctx = pipeline.quantize_w8a8(pipe.unet, calib)
    prune_deployed_weights(pipe.unet, ctx.deploy)
    return ctx, FP_CTX
