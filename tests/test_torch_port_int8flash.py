"""The int8 flash attention of the port (``QuantCtx.int8_flash``) against
the JAX package, on the CPU: ``quantize_sym_dynamic`` bit for bit, the
plain versions of ``int8_flash_attention`` and
``int8qkv_flash_attention`` (which the wrappers run for CPU tensors)
against ``int8_mha`` / ``int8qkv_mha`` with the Pallas kernels in
interpret mode at their 512-key blocks, and the port's ``Attention`` at a
T=4096 self-attention site. The JAX model reaches these kernels only off
the CPU (``mixdq_tpu/models/attention.py:499-500``), so its projections
followed by ``int8_mha`` / ``int8qkv_mha`` and its ``to_out`` are the
reference of the whole path here. Inputs come from numpy seeds.

Tolerances: f32 outputs ``|d| <= 1e-5``; bf16 max ``|d|`` <= 2 bf16 ulps
of max ``|ref|`` and ``|d|/|ref| <= 1e-2`` (as the flash test:
``p`` rounds to bf16, or to 7-bit codes, against a running max that
``exp`` of two libraries reaches one f32 ulp apart); the module as
``tests/test_torch_port_model.py`` (rel 1e-2, max 0.3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import attention as jattn  # noqa: E402
from mixdq_tpu.models.layers import deploy_linear as jdeploy_linear  # noqa: E402
from mixdq_tpu.ops import pallas_attention as jpa  # noqa: E402

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models import routing  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.ops import attention as tfa  # noqa: E402
from tests.test_torch_port_flash import DTYPES, _jnp, _tensor  # noqa: E402
from tests.test_torch_port_model import (JAQ, JWQ, T,  # noqa: E402
                                         assert_int8_close, load_smoke)
from tests.test_torch_port_sec import (_transformer_pair,  # noqa: E402
                                       port_auto_ctx)

#: QuantCtx.int8_flash -> (the port's kernel, the JAX wrapper)
MODES = {"qk": ("int8_flash_attention", jpa.int8_mha),
         "qkv": ("int8qkv_flash_attention", jpa.int8qkv_mha)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((2, 300, 128), 1.5),
                                         ((1, 77, 64), 40.0),
                                         ((3, 4, 5), 1e-3)])
def test_quantize_sym_dynamic_matches_jax(shape, scale, dtype):
    rng = np.random.default_rng(50)
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal(shape) * scale
    x.flat[7] = -3 * scale  # a negative extreme
    codes, s = tfa.quantize_sym_dynamic(_tensor(x, tdt))
    jcodes, js = jpa.quantize_sym_dynamic(_jnp(x, jdt))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert s.dtype == torch.float32 and s.item() == float(js)
    assert codes.abs().max().item() == 127  # +-127, never -128


def _heads(a, heads):
    """[B, T, heads * d] -> [B, T, heads, d] (what ``int8_mha`` takes)."""
    B, T_, C = a.shape
    return a.reshape(B, T_, heads, C // heads)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("Tq,Tk,heads,d", [
    (1024, 1024, 2, 64),   # two 512-key blocks
    (256, 700, 2, 64),     # ragged: the second block masked past 700
    (128, 77, 2, 32),      # one block of 128, masked past 77
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_flash_plain_vs_pallas(mode, Tq, Tk, heads, d, dtype):
    rng = np.random.default_rng(51)
    B, C = 2, heads * d
    tdt, jdt = DTYPES[dtype]
    name, jfn = MODES[mode]
    q = rng.standard_normal((B, Tq, C)) * 1.5
    kv = rng.standard_normal((B, Tk, 2 * C))
    want = jfn(_jnp(_heads(q, heads), jdt),
               _jnp(_heads(kv[..., :C], heads), jdt),
               _jnp(_heads(kv[..., C:], heads), jdt), d ** -0.5, bk=512,
               out_dtype=jdt, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, Tq, C)
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0, v_off=C)
    ops.reset_counts()
    got = getattr(tfa, name)(_tensor(q, tdt), _tensor(kv, tdt),
                             _tensor(kv, tdt), **kw)
    assert ops.call_counts()[name] == 1 and ops.launch_counts()[name] == 0
    assert got.dtype == tdt and got.shape == (B, Tq, C)
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-2, rel


def test_int8_block_keys():
    """The JAX wrappers' key blocks: 512, clipped to Tk rounded up to
    128."""
    assert [tfa.int8_block_keys(t) for t in (77, 128, 300, 512, 700, 4096)] \
        == [128, 128, 384, 512, 512, 512]


def test_int8_flash_routes():
    """``int8_flash`` moves only int8-mode self-attention flash sites: the
    bf16 UNet, cross-attention and sites below 2^22 keep their kernels;
    SDXL 1024 trades its 10 flash launches per step."""
    kw = dict(attn_impl="auto", fused=True, heads=10, head_dim=64,
              C_in=640)
    for mode, (name, _) in MODES.items():
        assert routing.attention_route(
            mode="int8", cross=False, Tq=4096, Tk=4096, int8_flash=mode,
            **kw).kernel == name
        assert routing.attention_route(
            mode="fp", cross=False, Tq=4096, Tk=4096, int8_flash=mode,
            **dict(kw, fused=False)).kernel == routing.FLASH
        assert routing.attention_route(
            mode="int8", cross=False, Tq=1024, Tk=1024, int8_flash=mode,
            **dict(kw, heads=20, C_in=1280)).kernel == routing.SEC
        smoke = load_smoke()
        assert pipeline.expected_kernel_calls(
            get_family("sdxl").unet, "auto", int8_flash=mode) == \
            smoke.SDXL_CALLS[f"int8_{mode}"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    for k in ("MIXDQ_SEC_OUTFUSE", "MIXDQ_SEC_LNFOLD", "MIXDQ_INT8_FLASH"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def site_4096():
    """A Transformer2DModel on a 64x64 map (T=4096, C=64 as one head of
    64, fused QKV) in both packages, the JAX W8A8 deploy, and attn1's
    input stream in the JAX int8 run."""
    from mixdq_tpu.quant import calibrate as jcal
    from mixdq_tpu.quant.deploy import deploy_unet_ctx, deployed_params
    from mixdq_tpu.quant.state import quantizable_layers, uniform_ctrl

    mp = pytest.MonkeyPatch()
    mp.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    try:
        rng = np.random.default_rng(52)
        jm, variables, tm, x, ehs = _transformer_pair(rng, 64, 1, 64, 1, 64,
                                                      64, 64, 10)
        args = (jnp.asarray(x), jnp.asarray(ehs))
        jqp = jcal.calibrate(jm, variables, [args], JWQ, JAQ)
        ctrl = uniform_ctrl(quantizable_layers(variables["params"]),
                            w_bits=8, a_bits=8)
        jctx = deploy_unet_ctx(jm, variables, jqp, ctrl, JWQ, JAQ,
                               fuse_qkv=True).replace(
                                   deploy_compute="int8_sec",
                                   attn_impl="auto")
        pruned = deployed_params(variables, jctx)
        _, state = jax.jit(lambda v, c, *a: jm.apply(
            v, *a, c, capture_intermediates=True,
            mutable=["intermediates"]))(pruned, jctx, *args)
        stream = state["intermediates"]["proj_in"]["__call__"][0]
    finally:
        mp.undo()
    return jctx, variables["params"], tm, jqp, np.asarray(stream)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_attention_int8_flash_site(interpret, site_4096, mode):
    """attn1 at T=4096 under ``int8_flash``: the port's module (norm1
    codes, fused QKV GEMM, int8 flash, to_out, residual) against the JAX
    package's pieces of the same path (``ln_quantize``, the fused QKV
    ``deploy_linear``, ``int8_mha`` / ``int8qkv_mha`` in interpret mode,
    ``to_out``), from the same calibration."""
    jctx, params, tm, jqp, stream = site_4096
    name, jfn = MODES[mode]
    blk = "transformer_blocks.0"
    p = params["transformer_blocks_0"]
    dp_f = jctx.deploy[f"{blk}.attn1.to_qkv"]
    dp_o = jctx.deploy[f"{blk}.attn1.to_out.0"]
    s = jnp.asarray(stream)
    codes = jattn.materialize_ln_codes(
        s, (p["norm1"]["scale"], p["norm1"]["bias"], dp_f))
    y = jdeploy_linear(codes, dp_f, "int8", jnp.float32)
    B, T_, C = s.shape
    q, k, v = (a.reshape(B, T_, 1, C) for a in jnp.split(y, 3, axis=-1))
    o = jfn(q, k, v, C ** -0.5, out_dtype=jnp.float32,
            interpret=True).reshape(B, T_, C)
    want = s + jdeploy_linear(o, dp_o, "int8", jnp.float32) + \
        p["attn1"]["to_out_0"]["bias"]
    ctx = dataclasses.replace(port_auto_ctx(tm, jqp), int8_flash=mode)
    ops.reset_counts()
    got = load_smoke().attention_site(torch, tm, f"{blk}.attn1", T(stream),
                                      None, ctx)
    calls = ops.call_counts()
    assert calls[name] == 1 and calls["flash_attention"] == 0
    assert calls["ln_quantize"] == 1
    assert_int8_close((got - T(stream)).numpy(),
                      np.asarray(want) - stream)


def test_chip_smoke_int8_flash_sites():
    """``chip_smoke.py``'s per-site int8 flash check on a one-level UNet
    whose 64x64 map (C=128 as two heads of 64) takes flash attention at
    attn1 under the W8A8 deploy: every int8 flash site, in both modes,
    passes against the bf16 flash site on its input, and one whose q
    scale is doubled fails."""
    from mixdq_tpu_torch.models.configs import UNetConfig
    from mixdq_tpu_torch.models.unet import UNet2DConditionModel

    cfg = UNetConfig(
        sample_size=64, block_out_channels=(128,),
        down_block_types=("CrossAttnDownBlock2D",),
        up_block_types=("CrossAttnUpBlock2D",), layers_per_block=1,
        transformer_layers_per_block=(1,), num_attention_heads=(2,),
        attention_head_dim=64, cross_attention_dim=64,
        addition_time_embed_dim=16,
        projection_class_embeddings_input_dim=16 * 6 + 32,
        norm_num_groups=16)
    bf16 = torch.bfloat16
    unet = UNet2DConditionModel(cfg, bf16, "cpu").init_weights(0).eval()
    rng = np.random.default_rng(53)

    def request():
        return (_tensor(rng.standard_normal((1, 64, 64, 4)), bf16),
                torch.tensor(999.0),
                _tensor(rng.standard_normal((1, 77, 64)), bf16),
                {"text_embeds": _tensor(rng.standard_normal((1, 32)), bf16),
                 "time_ids": torch.tensor([[512.0, 512, 0, 0, 512, 512]],
                                          dtype=bf16)})

    ctx = pipeline.quantize_w8a8(unet, request())
    load_smoke().phase_int8_flash_sites(torch, unet, ctx, request())
