"""The port's UNet modules against the JAX package's, on the same weights
(flax params converted by ``mixdq_tpu_torch.convert``) and the same
numpy-seeded inputs, in float32 on the CPU.

The JAX int8 path runs with ``MIXDQ_PALLAS_INTERPRET=1`` so it takes the
same graph as on the TPU (Pallas kernels in interpret mode); without it
the CPU runs XLA fallbacks. Tolerances: FP outputs rel 1e-4 (same math,
other summation order); int8 outputs ``|d|/|ref| <= 1e-2`` and
``max |d| < 0.3`` (a float difference upstream can flip an act code by
one; tests/test_pallas_qmatmul.py:299).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import attention as jattn  # noqa: E402
from mixdq_tpu.models import resnet as jresnet  # noqa: E402
from mixdq_tpu.models.configs import get_family as jfamily  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.quant import calibrate as jcal  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402
from mixdq_tpu.quant.deploy import (deploy_unet_ctx as jdeploy,  # noqa: E402
                                    deployed_params)
from mixdq_tpu.quant.state import (FP_CTX as J_FP,  # noqa: E402
                                   quantizable_layers as jlayers,
                                   uniform_ctrl as juniform)

from mixdq_tpu_torch import convert, ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models.attention import Transformer2DModel  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.resnet import ResnetBlock2D  # noqa: E402
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.deploy import (deploy_unet_ctx,  # noqa: E402
                                          prune_deployed_weights)
from mixdq_tpu_torch.quant.state import (quantizable_layers,  # noqa: E402
                                         uniform_ctrl)

JWQ = JSpec(sym=True, channel_wise=True, round_mode="nearest")
JAQ = JSpec(running_stat=True)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(tree, rng):
    """Non-trivial biases and norm scales (flax inits them to 0 / 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(v.dtype)
        elif k == "scale":
            out[k] = (1 + rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
        else:
            out[k] = v
    return out


def qparams_np(qparams):
    return {n: {f.name: (None if getattr(qp, f.name) is None
                         else np.asarray(getattr(qp, f.name)))
                for f in dataclasses.fields(qp)}
            for n, qp in qparams.items()}


def load(module, params_np):
    module.load_state_dict(convert.params_to_state_dict(params_np),
                           strict=True)
    return module


def T(a):
    return torch.from_numpy(np.array(a))


def assert_fp_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel


def assert_int8_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel
    assert np.abs(got - want).max() < 0.3, np.abs(got - want).max()


def jax_int8(model, variables, args, fuse_qkv=True):
    """Calibrate + deploy + int8_sec apply on the JAX side; returns
    (output, qparams, deploy ctx)."""
    qparams = jcal.calibrate(model, variables, [args], JWQ, JAQ)
    ctrl = juniform(jlayers(variables["params"]), w_bits=8, a_bits=8)
    ctx = jdeploy(model, variables, qparams, ctrl, JWQ, JAQ,
                  fuse_qkv=fuse_qkv).replace(deploy_compute="int8_sec")
    pruned = deployed_params(variables, ctx)
    out = jax.jit(lambda v, c, *a: model.apply(v, *a, c))(pruned, ctx, *args)
    return np.asarray(out), qparams, ctx


def port_int8(module, jqparams, args, fuse_qkv=True):
    qparams = convert.qparams_from_numpy(qparams_np(jqparams))
    ctrl = uniform_ctrl(list(quantizable_layers(module)))
    ctx = deploy_unet_ctx(module, qparams, ctrl, pipeline.WQ,
                          fuse_qkv=fuse_qkv)
    with torch.no_grad():
        return module(*args, ctx=ctx), ctx


def test_sdxl_turbo_layer_names_meta():
    """The full-width port UNet (built on the meta device) has exactly the
    794 quantizable layers of the SDXL-Turbo reference, and the kernel
    calls per step of both attention paths follow from its structure
    (``auto``: norm2 folds into ``sec_attention_q_out``; ``to_qkv``,
    ``to_q`` and attn2's ``to_out`` leave ``qmatmul``)."""
    import os

    fixture = os.path.join(os.path.dirname(__file__),
                           "fixtures_sdxl_turbo_layers.txt")
    want = open(fixture).read().split()
    m = UNet2DConditionModel(get_family("sdxl-turbo").unet, torch.bfloat16,
                             device="meta")
    names = sorted(quantizable_layers(m))
    assert len(names) == 794
    assert names == sorted(want)
    common = {"qconv2d": 38, "qconv2d_s2": 2, "gn_silu_quantize": 46,
              "geglu_qmatmul": 70, "flash_attention": 0, "sec_attention": 0,
              "sec_attention_q": 0, "wq4_matmul": 0, "wq_matmul": 0,
              "sec_attention_qkv_out": 0, "geglu_out_qmatmul": 0,
              "int8_flash_attention": 0, "int8qkv_flash_attention": 0,
              "qmatmul_fused": 0, "qmatmul_fused2": 0}
    # the 17 time_emb_proj GEMMs run as 3 launches of the time-embedding
    # bank (N = 320 / 640 / 1280), on by default as in the JAX package
    assert pipeline.expected_kernel_calls(m.config, "einsum") == {
        **common, "ln_quantize": 210, "qmatmul": 474 - 17 + 3,
        "sec_attention_qkv": 0, "sec_attention_q_out": 0}
    assert pipeline.expected_kernel_calls(m.config, "auto") == {
        **common, "ln_quantize": 140, "qmatmul": 264 - 17 + 3,
        "sec_attention_qkv": 70, "sec_attention_q_out": 70}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")


def test_resnet_block_parity(interpret):
    rng = np.random.default_rng(0)
    jm = jresnet.ResnetBlock2D(32, 64, 48, groups=8)
    x = rng.standard_normal((1, 8, 8, 32)).astype(np.float32)
    temb = rng.standard_normal((1, 48)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(temb))
    params = perturb(np_tree(variables["params"]), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jargs = (jnp.asarray(x), jnp.asarray(temb))

    tm = load(ResnetBlock2D(32, 64, 48, groups=8), params)
    with torch.no_grad():
        assert_fp_close(tm(T(x), T(temb)), jm.apply(variables, *jargs))
    want, jqp, _ = jax_int8(jm, variables, jargs)
    ops.reset_counts()
    got, _ = port_int8(tm, jqp, (T(x), T(temb)))
    assert_int8_close(got, want)
    assert ops.call_counts()["qconv2d"] == 2
    assert ops.call_counts()["gn_silu_quantize"] == 2


@pytest.mark.parametrize("fuse_qkv", [True, False])
def test_transformer_parity(interpret, fuse_qkv):
    rng = np.random.default_rng(1)
    jm = jattn.Transformer2DModel(in_channels=64, heads=2, head_dim=16,
                                  num_layers=2, cross_attention_dim=48,
                                  norm_num_groups=16)
    x = rng.standard_normal((1, 4, 6, 64)).astype(np.float32)
    ehs = (rng.standard_normal((1, 77, 48)) * 2).astype(np.float32)
    ehs[:, 0] *= 20  # a BoS-like outlier token
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(ehs))
    params = perturb(np_tree(variables["params"]), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jargs = (jnp.asarray(x), jnp.asarray(ehs))

    tm = load(Transformer2DModel(64, 2, 16, 2, 48, norm_num_groups=16),
              params)
    with torch.no_grad():
        assert_fp_close(tm(T(x), T(ehs)), jm.apply(variables, *jargs))
    want, jqp, _ = jax_int8(jm, variables, jargs, fuse_qkv)
    ops.reset_counts()
    got, ctx = port_int8(tm, jqp, (T(x), T(ehs)), fuse_qkv)
    assert_int8_close(got, want)
    # norm1 feeds ln_quantize only through the fused to_qkv entry
    assert ops.call_counts()["ln_quantize"] == (6 if fuse_qkv else 4)
    assert ops.call_counts()["geglu_qmatmul"] == 2
    # the int8 path never reads a deployed fp weight
    prune_deployed_weights(tm, ctx.deploy)
    with torch.no_grad():
        np.testing.assert_array_equal(tm(T(x), T(ehs), ctx=ctx).numpy(),
                                      got.numpy())


@pytest.fixture(scope="module")
def tiny():
    """tiny-sdxl on both sides: weights, inputs, and the JAX FP output,
    calibration, deploy entries and int8_sec output."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MIXDQ_PALLAS_INTERPRET", "1")
        rng = np.random.default_rng(2)
        cfg = jfamily("tiny-sdxl").unet
        jm = JUNet(cfg)
        H = cfg.sample_size
        inputs = {
            "sample": rng.standard_normal((1, H, H, 4)).astype(np.float32),
            "t": np.float32(999.0),
            "ehs": rng.standard_normal((1, 77, cfg.cross_attention_dim)
                                       ).astype(np.float32),
            "text_embeds": rng.standard_normal((1, 64)).astype(np.float32),
            "time_ids": np.array([[128, 128, 0, 0, 128, 128]], np.float32),
        }
        jargs = (jnp.asarray(inputs["sample"]), jnp.asarray(inputs["t"]),
                 jnp.asarray(inputs["ehs"]),
                 {"text_embeds": jnp.asarray(inputs["text_embeds"]),
                  "time_ids": jnp.asarray(inputs["time_ids"])})
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs)
        params = perturb(np_tree(variables["params"]), rng)
        variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
        fp = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, J_FP))(
            variables, *jargs))
        q, jqp, jctx = jax_int8(jm, variables, jargs)
        yield dict(params=params, inputs=inputs, fp=fp, int8=q,
                   qparams=qparams_np(jqp), deploy=jctx.deploy)


def _port_tiny(tiny):
    m = load(UNet2DConditionModel(get_family("tiny-sdxl").unet), tiny["params"])
    i = tiny["inputs"]
    args = (T(i["sample"]), torch.tensor(999.0), T(i["ehs"]),
            {"text_embeds": T(i["text_embeds"]), "time_ids": T(i["time_ids"])})
    return m, args


def test_tiny_sdxl_fp_and_calibration(tiny):
    m, args = _port_tiny(tiny)
    with torch.no_grad():
        assert_fp_close(m(*args), tiny["fp"])
    qp = convert.qparams_to_numpy(calibrate(m, [args], pipeline.WQ,
                                            pipeline.AQ))
    want = tiny["qparams"]
    assert set(qp) == set(want)
    for name, fields in want.items():
        for f, v in fields.items():
            got = qp[name][f]
            assert (got is None) == (v is None), (name, f)
            if v is None:
                continue
            if f.endswith("zp"):
                assert np.abs(got - v).max() <= 1, (name, f)
            elif f.startswith("w"):
                # XLA may turn the division by n_levels into a multiply
                np.testing.assert_allclose(got, v, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(got, v, rtol=1e-4, err_msg=name)


def test_tiny_sdxl_deploy_entries(tiny):
    m, _ = _port_tiny(tiny)
    qparams = convert.qparams_from_numpy(tiny["qparams"])
    ctrl = uniform_ctrl(list(quantizable_layers(m)))
    deploy = deploy_unet_ctx(m, qparams, ctrl, pipeline.WQ,
                             fuse_qkv=True).deploy
    want = tiny["deploy"]
    assert set(deploy) == set(want)
    for name, e in want.items():
        got = deploy[name]
        assert got.kind == e.kind, name
        if e.kind == "fused_away":
            continue
        np.testing.assert_array_equal(got.w_int.numpy(), np.asarray(e.w_int))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(e.scale))
        np.testing.assert_array_equal(got.bias0.numpy(), np.asarray(e.bias0))
        assert got.scale_inv == float(e.scale_inv), name
        assert got.zp_shifted == float(e.zp_shifted), name


def test_tiny_sdxl_int8_step(tiny):
    m, args = _port_tiny(tiny)
    qparams = convert.qparams_from_numpy(tiny["qparams"])
    ctrl = uniform_ctrl(list(quantizable_layers(m)))
    ctx = deploy_unet_ctx(m, qparams, ctrl, pipeline.WQ, fuse_qkv=True)
    ops.reset_counts()
    got = pipeline.unet_step(m, args, ctx)
    assert_int8_close(got, tiny["int8"])
    want_calls = pipeline.expected_kernel_calls(m.config, "einsum")
    # the 12 time_emb_proj GEMMs run as 2 launches of the time-embedding
    # bank (N = 32 / 64), on by default as in the JAX package
    assert want_calls == {"qconv2d": 27, "qconv2d_s2": 1,
                          "gn_silu_quantize": 31, "ln_quantize": 36,
                          "geglu_qmatmul": 12, "qmatmul": 107 - 12 + 2,
                          "sec_attention_qkv": 0, "sec_attention_q_out": 0,
                          "flash_attention": 0, "sec_attention": 0,
                          "sec_attention_q": 0, "wq4_matmul": 0,
                          "wq_matmul": 0, "sec_attention_qkv_out": 0,
                          "geglu_out_qmatmul": 0, "int8_flash_attention": 0,
                          "int8qkv_flash_attention": 0, "qmatmul_fused": 0,
                          "qmatmul_fused2": 0}
    assert ops.call_counts() == want_calls
    assert set(ops.launch_counts().values()) == {0}  # CPU: plain versions


def load_smoke():
    """``chip_smoke.py`` as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_layer_check(dtype):
    """``chip_smoke.py``'s per-layer check on tiny-sdxl: every deploy
    entry passes it, and each injected one-layer fault fails it."""
    smoke = load_smoke()
    dt = getattr(torch, dtype)
    unet = pipeline.build_unet("tiny-sdxl", 0, dt, "cpu")
    calib = pipeline.example_inputs("tiny-sdxl", 1, 0, dt, "cpu")
    ctx = pipeline.quantize_w8a8(unet, calib)
    req = pipeline.example_inputs("tiny-sdxl", 1, 100, dt, "cpu")
    smoke.phase_layers(torch, unet, ctx, calib, req)
