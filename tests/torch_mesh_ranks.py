"""Rank bodies of ``tests/test_torch_port_mesh.py``: each runs on every
rank of a gloo world (``mixdq_tpu_torch.parallel.launch.spawn``) and
imports only ``torch`` and the port. Each check computes the unsharded
result on the rank itself (the ranks' thread counts differ from the test
process's) and returns both sides for the test to compare.
"""

import dataclasses

import torch
from torch.nn.utils import parametrize

from mixdq_tpu_torch import convert, pipeline
from mixdq_tpu_torch.mixed_precision import sensitivity
from mixdq_tpu_torch.ops.attention import quantize_sym_dynamic
from mixdq_tpu_torch.parallel import mesh as pmesh
from mixdq_tpu_torch.pipelines.serving import ServingEngine
from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline
from mixdq_tpu_torch.quant import qat
from mixdq_tpu_torch.quant.calibrate import calibrate
from mixdq_tpu_torch.quant.state import (QuantCtx, quantizable_layers,
                                         uniform_ctrl)
from mixdq_tpu_torch.scripts import mixed_precision_search

FAMILY = "tiny-sdxl"
PROMPTS = ["a red cube", "a blue sphere"]
#: the swept layers: a spatial conv, a dense layer, a 1x1 conv
SWEPT = ("conv_in", "down_blocks.1.attentions.0.transformer_blocks.0."
         "attn1.to_q", "down_blocks.1.resnets.0.conv_shortcut")


def _unet(dtype=torch.float32):
    return pipeline.build_unet(FAMILY, 0, dtype, "cpu")


def _calib(batch=2, dtype=torch.float32):
    return pipeline.example_inputs(FAMILY, batch, 0, dtype, "cpu")


def _qat_step(mesh, B, dtype):
    """One QAT step of the tiny UNet at W8A8 on a batch of ``B`` in
    ``dtype`` (over ``mesh``: this rank's share, the model and qparams
    sharded): (loss, each parameter's gradient and new value, whole)."""
    unet = _unet(dtype)
    calib = _calib(B, dtype)
    qparams = calibrate(unet, [calib], pipeline.WQ, pipeline.AQ)
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=8, a_bits=8)
    target = torch.zeros_like(calib[0])
    batch = calib
    if mesh is not None:
        pmesh.shard_module(unet, mesh)
        qparams = pmesh.shard_tree(mesh, qparams)
        batch, target = pmesh.shard_batch_tree(mesh, (calib, target))
    init, step = qat.make_qat_train_step(unet, pipeline.WQ, pipeline.AQ,
                                         ctrl, lr=1e-4, mesh=mesh)
    params = dict(unet.named_parameters())
    opt = init(params, qparams)
    _, _, _, loss = step(params, qparams, opt, batch, target)
    grads, new = {}, {}
    with torch.no_grad():
        for name, p in params.items():
            g = p.grad
            if ".parametrizations." in name:  # a tp shard
                name = name.replace(".parametrizations.", ".")[
                    :-len(".original")]
                g, p = pmesh.tp_gather(g, mesh), pmesh.tp_gather(p, mesh)
            grads[name], new[name] = g.clone(), p.detach().clone()
    return float(loss), grads, new


def run_checks(search_argv):
    """Every mesh check of the test module on this rank;
    ``search_argv``: a ``mixed_precision_search`` command line, run with
    ``--dp_mesh 2`` and (rank 0) without."""
    torch.manual_seed(0)
    out = {"rank": torch.distributed.get_rank()}
    dp2 = pmesh.make_mesh(2, tp=1)
    tp2 = pmesh.make_mesh(2)
    out["meshes"] = (tuple(dp2.shape), tuple(tp2.shape))
    out["plan_params"] = pmesh.make_param_shardings(tp2, _unet())
    try:
        pmesh.make_mesh(4)
        out["more_ranks"] = None
    except ValueError as e:
        out["more_ranks"] = str(e)

    # the dp sweep: points shared out over dp, values gathered
    unet = _unet()
    calib = _calib()
    qparams = calibrate(unet, [calib], pipeline.WQ, pipeline.AQ)
    names = sorted(quantizable_layers(unet))
    with torch.inference_mode():
        fp = unet(*calib)
    args = (unet, qparams, list(SWEPT), names, calib, fp, pipeline.WQ,
            pipeline.AQ)
    out["sweep"] = (sensitivity.sweep_sqnr(*args, bits=(4, 8)),
                    sensitivity.sweep_sqnr_batched(*args, bits=(4, 8),
                                                   mesh=dp2))

    # the tp W8A8 step: deploy and params sharded, gathered at each read
    ctx = pipeline.quantize_w8a8(unet, calib)
    out["plan_deploy"] = pmesh.make_param_shardings(tp2, ctx.deploy)
    out["qparams"] = convert.qparams_to_numpy(qparams)
    with torch.inference_mode():
        ref = unet(*calib, ctx=ctx)
        pmesh.shard_module(unet, tp2)
        sctx = dataclasses.replace(ctx, deploy=pmesh.shard_tree(
            tp2, ctx.deploy))
        got = unet(*calib, ctx=sctx)
    out["w8a8"] = (ref, got, type(sctx.deploy).__name__,
                   sum(t.numel() for t in unet.parameters()))

    # the bf16 step, tp-sharded
    unet = _unet(torch.bfloat16)
    calib16 = _calib(dtype=torch.bfloat16)
    with torch.inference_mode():
        ref = unet(*calib16)
        # twice: the second call leaves the first's shards as they are
        pmesh.shard_module(pmesh.shard_module(unet, tp2), tp2)
        out["bf16"] = (ref, unet(*calib16))

    # a batch-wide statistic over dp: the int8 flash kernels' scale
    x = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(1))
    local = pmesh.shard_batch_tree(dp2, x)
    out["dynamic"] = (quantize_sym_dynamic(x),
                      quantize_sym_dynamic(local, dp2.get_group("dp")),
                      pmesh.dp_slice(dp2, 4))

    # the dp engine (and its int8 flash statistics, all-reduced over dp)
    pipe = Text2ImgPipeline(FAMILY, torch.float32, "cpu").init_weights(0)
    fl = QuantCtx(attn_impl="int8_flash")
    ref = [ServingEngine(pipe, c, batch_size=2, steps=1).generate(PROMPTS, 3)
           for c in (QuantCtx(), fl)]
    got = [ServingEngine(pipe, c, batch_size=2, steps=1, mesh=dp2).generate(
        PROMPTS, 3) for c in (QuantCtx(), fl)]
    out["engine"] = (ref, got)
    # two tp engines on one pipeline: each shards its own copy of the
    # modules, and the caller's pipeline stays whole and runs alone
    held = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    out["engine_tp"] = [ServingEngine(pipe, batch_size=2, steps=1,
                                      mesh=tp2).generate(PROMPTS, 3)
                        for _ in range(2)]
    with torch.inference_mode():
        after = pipe.unet.state_dict()
        out["pipe_whole"] = (
            not any(parametrize.is_parametrized(m)
                    for m in pipe.unet.modules())
            and held.keys() == after.keys()
            and all(torch.equal(held[k], after[k]) for k in held))
    if torch.distributed.get_rank() == 0:  # no collective: rank 0 alone
        out["pipe_alone"] = ServingEngine(pipe, batch_size=2,
                                          steps=1).generate(PROMPTS, 3)

    # QAT: the dryrun's (1, 2) mesh at batch dp = 1 in f32, and dp = 2 in
    # f64 (a batch of 1 against 2 moves a GEMM's f32 last bits, and fake
    # quantization divides by delta: one code at a rounding edge flips)
    out["qat"] = {shape: (_qat_step(None, B, dt), _qat_step(m, B, dt))
                  for shape, m, B, dt in (("1x2", tp2, 1, torch.float32),
                                          ("2x1", dp2, 2, torch.float64))}

    # the search CLI: its batched sweeps' points over dp
    dp = mixed_precision_search.main(search_argv + ["--dp_mesh", "2"])
    out["search"] = (dp, dp and mixed_precision_search.main(search_argv))
    return out
