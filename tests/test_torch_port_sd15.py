"""The SD1.5 family of the port against the JAX package, on the CPU: the
``sd15`` / ``tiny-sd15`` configurations, SD1.5's 282 layer names and its
mixed-precision maps, the conv ``proj_in`` / ``proj_out`` spatial
transformer, the ``tiny-sd15`` UNet step (FP and W8A8 ``int8_sec``) on
the JAX params converted by ``mixdq_tpu_torch.convert``, the
``tiny-sd15`` LCM 4-step pipeline with the JAX pipeline's noise, and the
deploy's structure at full width (up-block splits over four levels, the
time-embedding bank, the 768-wide fused cross-attention k/v). Inputs come
from numpy seeds; the JAX int8 path takes its plain XLA route on the
CPU (its Pallas kernels' references).

Tolerances: FP modules and steps in f32 rel 1e-5 (the transformer) and
1e-4 (the UNet: other summation orders over more layers); W8A8 modules
as ``tests/test_torch_port_model.py`` (rel 1e-2, max 0.3); the pipeline's
latents and images rel 1e-2 (``tests/test_torch_port_txt2img.py``).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flax import linen as nn  # noqa: E402

from mixdq_tpu.models import attention as jattn  # noqa: E402
from mixdq_tpu.models import resnet as jresnet  # noqa: E402
from mixdq_tpu.models.configs import get_family as jfamily  # noqa: E402
from mixdq_tpu.models.unet import conv_shortcut_splits as jsplits  # noqa: E402
from mixdq_tpu.pipelines.txt2img import (  # noqa: E402
    Text2ImgPipeline as JPipeline)
from mixdq_tpu.quant.deploy import (deploy_unet_ctx as jdeploy,  # noqa: E402
                                    deployed_params)
from mixdq_tpu.quant.state import LayerQParams as JQParams  # noqa: E402
from mixdq_tpu.quant.state import canonical_name as jcanonical  # noqa: E402
from mixdq_tpu.quant.state import (quantizable_layers as jlayers,  # noqa: E402
                                   uniform_ctrl as juniform)

from mixdq_tpu_torch import convert, ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models.attention import Transformer2DModel  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.unet import (  # noqa: E402
    UNet2DConditionModel, conv_shortcut_splits)
from mixdq_tpu_torch.pipelines import samplers  # noqa: E402
from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline  # noqa: E402
from mixdq_tpu_torch.quant import bitmaps  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.checkpoint import module_params  # noqa: E402
from mixdq_tpu_torch.quant.deploy import (bank_group_sizes,  # noqa: E402
                                          deploy_unet_ctx)
from mixdq_tpu_torch.quant.state import (quantizable_layers,  # noqa: E402
                                         uniform_ctrl)
from tests.test_torch_port_model import (JAQ, JWQ, T,  # noqa: E402
                                         assert_int8_close, load, np_tree,
                                         perturb)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a red fox in the snow", "a lighthouse at dusk"]


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["sd15", "tiny-sd15"])
def test_sd15_families_equal_jax(name):
    """Every field of the port's family, UNet, VAE and text tower equals
    the JAX package's (``attention_head_dim=0``: channels // heads)."""
    j, t = jfamily(name), get_family(name)
    for part in ("unet", "vae", "text_encoder"):
        jd = dataclasses.asdict(getattr(j, part))
        td = dataclasses.asdict(getattr(t, part))
        assert td == jd, part
    assert j.text_encoder_2 is None and t.text_encoder_2 is None
    for f in ("name", "is_sdxl", "default_steps", "guidance_scale",
              "default_deploy_compute"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.default_steps, t.guidance_scale, t.vae.scaling_factor) == (
        4, 1.0, 0.18215 if name == "sd15" else t.vae.scaling_factor)


def test_sd15_layer_names_and_maps():
    """The full-width port UNet, built on the meta device, has exactly the
    282 layers of ``tests/fixtures_sd15_layers.txt``; every layer that the
    repo's SD1.5 mixed-precision maps name is one of them; its conv
    ``proj_in`` / ``proj_out`` are 1x1 convs."""
    want = open(os.path.join(ROOT, "tests",
                             "fixtures_sd15_layers.txt")).read().split()
    m = UNet2DConditionModel(get_family("sd15").unet, torch.bfloat16,
                             device="meta")
    layers = quantizable_layers(m)
    assert len(layers) == 282 and sorted(layers) == sorted(want)
    mp = os.path.join(ROOT, "configs", "mp", "sd15")
    for path in ("final_config/weight/5.02.yaml",
                 "final_config/act/7.70.yaml"):
        names = bitmaps.load_bit_map(os.path.join(mp, path))
        assert names and set(names) <= set(layers), path
    protect = bitmaps.load_layer_list(os.path.join(mp, "act_protect.yaml"))
    assert protect and set(protect) <= set(layers)
    proj = [n for n in layers if n.endswith((".proj_in", ".proj_out"))]
    assert len(proj) == 32
    assert all(tuple(layers[n].weight.shape[:2]) == (1, 1) for n in proj)


def test_sd15_deploy_structure():
    """At full width: the up blocks' conv_shortcut splits over four levels
    equal the JAX package's; the 22 ``time_emb_proj`` GEMMs run as 3 bank
    launches (N = 320 / 640 / 1280); the 16 BoS-aware fused attn2 ``to_kv``
    entries take the 768-wide text; ``small-sd15``'s 64x64 level runs
    flash at d = 40 under ``'auto'``."""
    cfg = get_family("sd15").unet
    assert conv_shortcut_splits(cfg) == jsplits(jfamily("sd15").unet)
    assert len(conv_shortcut_splits(cfg)) == 12
    layout = pipeline.w8a8_layout(cfg)
    sizes = bank_group_sizes(layout, ".time_emb_proj", cfg.time_embed_dim)
    assert sizes == ((320, 8, 5), (640, 8, 5), (1280, 8, 12))
    kv = {n: e for n, e in layout.items() if n.endswith(".attn2.to_kv")}
    assert len(kv) == 16 and all(e.w_int.shape[0] == 768
                                 for e in kv.values())
    small = get_family("small-sd15").unet
    assert pipeline._site_shape(
        small, "down_blocks.0.attentions.0.transformer_blocks.0") == (
        4096, 2, 40)
    assert pipeline.expected_kernel_calls(small, "auto")[
        "flash_attention"] == 3


def test_conv_transformer_parity():
    """``Transformer2DModel(use_linear_projection=False)`` (GroupNorm, 1x1
    conv ``proj_in``, blocks, 1x1 conv ``proj_out``, residual) on the
    JAX module's params: FP in f32 against the JAX module, rel 1e-5; its
    W8A8 ``int8_sec`` deploy runs the 1x1 convs on ``qmatmul`` with no
    GroupNorm producer for ``proj_in`` (against JAX, teacher-forced, in
    ``test_tiny_sd15_w8a8_step``)."""
    rng = np.random.default_rng(80)
    jm = jattn.Transformer2DModel(in_channels=64, heads=2, head_dim=32,
                                  num_layers=1, cross_attention_dim=48,
                                  use_linear_projection=False,
                                  norm_num_groups=16)
    x = rng.standard_normal((1, 4, 6, 64)).astype(np.float32)
    ehs = (rng.standard_normal((1, 77, 48)) * 2).astype(np.float32)
    ehs[:, 0] *= 20  # a BoS-like outlier token
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                        jnp.asarray(ehs))
    params = perturb(np_tree(variables["params"]), rng)
    assert params["proj_in"]["kernel"].shape == (1, 1, 64, 64)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tm = load(Transformer2DModel(64, 2, 32, 1, 48,
                                 use_linear_projection=False,
                                 norm_num_groups=16), params)
    args = (T(x), T(ehs))
    with torch.no_grad():
        assert rel(tm(*args), jm.apply(variables, jnp.asarray(x),
                                       jnp.asarray(ehs))) < 1e-5
    qparams = calibrate(tm, [args], pipeline.WQ, pipeline.AQ)
    ctrl = uniform_ctrl(list(quantizable_layers(tm)))
    ctx = deploy_unet_ctx(tm, qparams, ctrl, pipeline.WQ, fuse_qkv=True)
    assert {ctx.deploy[n].kind for n in ("proj_in", "proj_out")} == {"conv"}
    ops.reset_counts()
    with torch.no_grad():
        y = tm(*args, ctx=ctx)
        assert rel(y, tm(*args)) < 0.1
    calls = ops.call_counts()
    assert calls["gn_silu_quantize"] == 0 and calls["ln_quantize"] == 3
    # proj_in, to_qkv, to_q, to_kv, to_out x 2, ff.net.2, proj_out
    assert calls["qmatmul"] == 8 and calls["geglu_qmatmul"] == 1


@pytest.fixture(scope="module")
def pipes():
    """tiny-sd15 on both sides, on one set of weights (the port's from a
    seed, biases and norm scales perturbed, carried into the JAX tree by
    ``quant.checkpoint.module_params``): the port's pipeline, the JAX
    pipeline's 4-step LCM generation (g = 1) with its trajectory, and the
    JAX W8A8 ``int8_sec`` step (its plain XLA route) on a numpy-seeded
    request, deployed from the port's calibration on it, with each
    resnet's and spatial transformer's inputs and output."""
    p = Text2ImgPipeline("tiny-sd15", torch.float32, "cpu").init_weights(3)
    rng = np.random.default_rng(82)
    tree = {part: perturb(jax.tree_util.tree_map(
        lambda x: x.numpy().copy(), module_params(getattr(p, part))), rng)
        for part in ("unet", "vae", "text_encoder")}
    for part, params in tree.items():
        getattr(p, part).load_state_dict(
            convert.params_to_state_dict(params), strict=True)
    assert p.text_encoder_2 is None
    jp = JPipeline("tiny-sd15", dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    key = jax.random.PRNGKey(9)
    out = jp(jparams, PROMPTS, key, num_inference_steps=4,
             guidance_scale=1.0, capture_trajectory=True)
    req = (rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
           np.float32(999.0),
           rng.standard_normal((1, 77, 64)).astype(np.float32))
    jreq = tuple(map(jnp.asarray, req)) + (None,)
    variables = {"params": jparams["unet"]}
    # the port's calibration, carried into the JAX package's qparams
    qparams = convert.qparams_to_numpy(calibrate(
        p.unet, [tuple(map(T, req)) + (None,)], pipeline.WQ, pipeline.AQ))
    jqp = {n: JQParams(**{f: None if v is None else jnp.asarray(v)
                          for f, v in fields.items()})
           for n, fields in qparams.items()}
    ctrl = juniform(jlayers(variables["params"]), w_bits=8, a_bits=8)
    jctx = jdeploy(jp.unet, variables, jqp, ctrl, JWQ, JAQ,
                   fuse_qkv=True).replace(deploy_compute="int8_sec")
    splits = {}

    def run(v, c, *a):
        """The W8A8 step, and each resnet's and spatial transformer's
        tensor inputs and output (``nn.intercept_methods``)."""
        seen = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            m = context.module
            if context.method_name == "__call__" and isinstance(
                    m, (jresnet.ResnetBlock2D, jattn.Transformer2DModel)):
                name = jcanonical(m.path)
                seen[name] = (args[0], args[1], out)
                splits[name] = kwargs.get("split", 0)
            return out
        with nn.intercept_methods(record):
            return jp.unet.apply(v, *a, c), seen
    q, seen = jax.jit(run)(deployed_params(variables, jctx), jctx, *jreq)
    return dict(pipe=p, out=out, key=key, req=req, int8=np.asarray(q),
                modules={n: tuple(map(np.asarray, t)) for n, t in
                         seen.items()}, splits=splits, qparams=qparams,
                deploy=jctx.deploy)


def _step_args(out, i):
    return (T(out.trajectory[i]), T(out.timesteps[i]), T(out.text_emb), None)


def test_tiny_sd15_fp_steps(pipes):
    """The port's UNet on each LCM step's input of the JAX generation
    against the JAX UNet's output there."""
    m, out = pipes["pipe"].unet, pipes["out"]
    for i in range(4):
        with torch.no_grad():
            assert rel(m(*_step_args(out, i)), out.unet_outputs[i]) < 1e-4


def test_tiny_sd15_w8a8_step(pipes):
    """One calibration deployed by both packages: the same entries (the
    conv ``proj_in`` / ``proj_out`` as 1x1 ``conv`` entries); each
    resnet and spatial transformer of the W8A8 step, teacher-forced on
    the input it had in JAX's step, within the W8A8 tolerance; the whole
    step finite, launching what ``ctx_kernel_calls`` gives. The whole
    step is held module by module: it amplifies one act code that lands
    apart (a plain GroupNorm before each conv ``proj_in``, summed in
    another order than flax's): an input change of 1e-5 moves the port's
    own W8A8 step by ~3 % here."""
    m = pipes["pipe"].unet
    qparams = convert.qparams_from_numpy(pipes["qparams"])
    ctrl = uniform_ctrl(list(quantizable_layers(m)))
    ctx = deploy_unet_ctx(m, qparams, ctrl, pipeline.WQ, fuse_qkv=True)
    assert set(ctx.deploy) == set(pipes["deploy"])
    for name, e in pipes["deploy"].items():
        got = ctx.deploy[name]
        assert got.kind == e.kind, name
        if e.kind in ("fused_away", "conv_split"):
            continue
        np.testing.assert_array_equal(got.w_int.numpy(), np.asarray(e.w_int))
    assert ctx.deploy["down_blocks.0.attentions.0.proj_in"].kind == "conv"
    mods = pipes["modules"]
    assert sum(".attentions." in n for n in mods) == 4 and len(mods) == 12
    with torch.no_grad():
        for name, (x, y, want) in sorted(mods.items()):
            mod = m.get_submodule(name)
            if ".attentions." in name:
                got = mod(T(x), T(y), ctx)
            else:
                got = mod(T(x), T(y), ctx, split=pipes["splits"][name])
            assert_int8_close(got, want)
    ops.reset_counts()
    out = pipeline.unet_step(m, tuple(map(T, pipes["req"])) + (None,), ctx)
    assert out.shape == pipes["int8"].shape and torch.isfinite(out).all()
    assert ops.call_counts() == pipeline.ctx_kernel_calls(m.config, ctx)


def test_tiny_sd15_lcm_pipeline_parity(pipes):
    """``Text2ImgPipeline('tiny-sd15')`` (one text tower, no pooled
    conditions, the LCM 4-step loop at g = 1, the VAE) on the JAX
    pipeline's noise: prompt embeddings rel 1e-4, latents and images rel
    1e-2."""
    p, out = pipes["pipe"], pipes["out"]
    k_noise, k_lcm = jax.random.split(pipes["key"])
    noise = jax.random.normal(k_noise, (2, 16, 16, 4), jnp.float32)
    lcm = jax.random.normal(k_lcm, (4, 2, 16, 16, 4), jnp.float32)
    emb, pooled = p.encode_prompt(p.tokens(PROMPTS))
    added = p.added_conds(pooled, p.default_time_ids(2, 128, 128))
    assert added is None and emb.shape == (2, 77, 64)
    assert rel(emb, out.text_emb) < 1e-4
    latents, traj = p.sample_latents(emb, added, T(noise),
                                     samplers.make_lcm_schedule(4), 1.0,
                                     lcm_noise=T(lcm), capture=True)
    np.testing.assert_array_equal(traj["timesteps"].numpy(),
                                  np.asarray(out.timesteps))
    images = p.decode(latents).float().numpy()
    assert rel(latents, out.latents) <= 1e-2
    assert images.shape == (2, 128, 128, 3)
    assert rel(images, out.images) <= 1e-2


def test_sd15_lcm_config_through_the_clis(tmp_path):
    """``configs/sd15_lcm.yaml`` with its family cut to ``tiny-sd15`` (and
    a smaller calibration set, 128 px) through the CLIs on the CPU, as on
    the card: ``gen_calib_data`` (the 4 LCM steps' inputs, the 64-wide
    text), ``ptq`` (the up blocks' channel splits),
    ``quant_txt2img --backend int8 --fuse_qkv`` (its deploy's conv
    ``proj_in`` entries), ``serve_bench`` (4 steps, g = 1) and
    ``memory_compare --family tiny-sd15``."""
    import logging

    from mixdq_tpu_torch.scripts import (gen_calib_data, memory_compare, ptq,
                                         quant_txt2img, serve_bench)
    from mixdq_tpu_torch.utils.config import load_config, merge, save_config

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    cfg = merge(load_config(os.path.join(ROOT, "configs", "sd15_lcm.yaml")),
                {"model": {"family": "tiny-sd15", "dtype": "float32"},
                 "calib_data": {"path": str(tmp_path / "calib.npz"),
                                "n_samples": 4, "batch_size": 2},
                 "inference": {"height": 128, "width": 128}})
    assert (cfg.calib_data.n_steps, cfg.inference.num_steps,
            cfg.inference.guidance_scale) == (4, 4, 1.0)
    path, exp = str(tmp_path / "sd15.yaml"), str(tmp_path / "exp")
    save_config(cfg, path)
    try:
        gen_calib_data.main(["--config", path, "--device", "cpu"])
        with np.load(cfg.calib_data.path) as f:
            assert f["xs"].shape == (4, 4, 16, 16, 4)
            assert f["text_embs"].shape == (4, 77, 64)
            assert "text_embeds" not in f.files
        res = ptq.main(["--config", path, "--outdir", exp, "--device", "cpu"])
        splits = sorted(n for n, q in res["qparams"].items()
                        if q.w0_delta is not None)
        assert splits == sorted(conv_shortcut_splits(
            get_family("tiny-sd15").unet))
        out = quant_txt2img.main([
            "--base_path", exp, "--backend", "int8", "--fuse_qkv",
            "--n_images", "2", "--batch_size", "2", "--device", "cpu",
            "--outdir", str(tmp_path / "img")])
        assert len(out["paths"]) == 2
        assert out["ctx"].deploy[
            "down_blocks.0.attentions.0.proj_in"].kind == "conv"
        bench = serve_bench.main(["--base_path", exp, "--steps", "4",
                                  "--batch_size", "2", "--device", "cpu"])
        assert bench["result"]["family"] == "tiny-sd15"
        assert bench["result"]["steps"] == 4
        mem = memory_compare.main(["--family", "tiny-sd15", "--json",
                                   "--device", "cpu"])
        assert mem["static_saving"] > 1
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
