"""The ``attn_impl='auto'`` slice of the port against the JAX package, on
the CPU: ``qmatmul``, ``sec_attention_qkv`` and ``sec_attention_q_out``
(the port's plain versions, which its wrappers run for CPU tensors)
against the JAX ops and Pallas kernels in interpret mode, then a
transformer and a whole small UNet under ``'auto'`` in both packages.
Inputs come from numpy seeds.

The JAX side runs with ``MIXDQ_PALLAS_INTERPRET=1`` and without
``MIXDQ_SEC_OUTFUSE`` / ``MIXDQ_SEC_LNFOLD``, so it takes its default
routing (out-fusion at attn2 only, LN folded), which the port hard-codes.

Tolerances: bf16 outputs of the same integer sums within one bf16 ulp;
int8 codes max |diff| <= 1 on < 1% (other float summation orders);
``sec_attention_q_out`` outputs and their deltas ``|d|/|ref| <= 1e-2``;
whole modules as ``tests/test_torch_port_model.py`` (rel 1e-2, max 0.3).
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import attention as jattn  # noqa: E402
from mixdq_tpu.models.configs import UNetConfig as JUNetConfig  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.ops import pallas_qmatmul as jpq  # noqa: E402
from mixdq_tpu.ops import pallas_sec_attention as jsa  # noqa: E402
from mixdq_tpu.ops import qops as jq  # noqa: E402

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models.attention import Transformer2DModel  # noqa: E402
from mixdq_tpu_torch.models.configs import (UNetConfig,  # noqa: E402
                                            get_family)
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.ops import qops as tq  # noqa: E402
from mixdq_tpu_torch.ops import sec_attention as tsa  # noqa: E402
from tests.test_torch_port_model import (JAQ, JWQ, T,  # noqa: E402
                                         assert_int8_close, load, load_smoke,
                                         np_tree, perturb, qparams_np)

AUTO = dict(deploy_compute="int8_sec", attn_impl="auto")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("MIXDQ_SEC_OUTFUSE", raising=False)
    monkeypatch.delenv("MIXDQ_SEC_LNFOLD", raising=False)


def codes(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def f32(a):
    return np.asarray(a).astype(np.float32)


def assert_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of want (8 significant bits)."""
    got, want = f32(got), f32(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def assert_codes_close(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, f"max code diff {diff.max()}"
    assert (diff > 0).mean() < 0.01, f"{(diff > 0).mean():.4f} differ"


@pytest.mark.parametrize("M,K,N,with_bias", [
    (1, 64, 48, True),      # time_emb_proj-like, M=1
    (77, 128, 96, False),   # to_kv-like, M=77
    (256, 40, 40, True),    # ragged K = N = 40 (tiny-sdxl)
    (33, 72, 20, False),
])
def test_qmatmul_plain_vs_jax(M, K, N, with_bias):
    rng = np.random.default_rng(10)
    x, w = codes(rng, M, K), codes(rng, K, N)
    scale = (rng.random(N).astype(np.float32) + 0.5) * 1e-4
    bias0 = (rng.integers(-30, 30) * w.astype(np.int32).sum(0)).astype(
        np.float32)
    bias = rng.standard_normal(N).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else T(bias)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        ops.reset_counts()
        got = tq.qlinear(T(x), T(w), T(scale), T(bias0), tb, out_dtype=tdt)
        assert ops.call_counts()["qmatmul"] == 1  # qlinear runs qmatmul
        assert got.dtype == tdt
        args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                jnp.asarray(bias0), jb)
        for want in (jq.qlinear(*args, out_dtype=jdt),
                     jpq.qmatmul(*args, out_dtype=jdt, interpret=True)):
            assert_bf16_ulp(got.float().numpy(), want)


def _qkv_inputs(rng, B, T_, heads, d):
    C = heads * d
    x, w = codes(rng, B, T_, C), codes(rng, C, 3 * C)
    # q/k/v of about unit size (random codes sum to ~5500 sqrt(C))
    scale = ((rng.random(3 * C) + 0.5) / (5500.0 * C ** 0.5)).astype(
        np.float32)
    bias0 = (4.0 * w.astype(np.int32).sum(0)).astype(np.float32)
    return x, w, scale, bias0


@pytest.mark.parametrize("B,T_", [(1, 64), (1, 256), (2, 64)])
def test_sec_attention_qkv_plain_vs_pallas(B, T_):
    rng = np.random.default_rng(11)
    heads, d = 2, 64
    x, w, scale, bias0 = _qkv_inputs(rng, B, T_, heads, d)
    want = jsa.sec_attention_qkv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias0), jnp.float32(100.0), jnp.float32(-3.0),
        heads=heads, head_dim=d, scale=d ** -0.5, interpret=True)
    ops.reset_counts()
    got = tsa.sec_attention_qkv(T(x), T(w), T(scale), T(bias0), 100.0, -3.0,
                                heads=heads, head_dim=d, scale=d ** -0.5)
    assert ops.call_counts()["sec_attention_qkv"] == 1
    assert got.dtype == torch.int8 and got.shape == (B, T_, heads * d)
    # codes spread over the range, few at the clip bounds
    assert (np.abs(got.numpy().astype(np.int32)) >= 127).mean() < 0.01
    assert_codes_close(got.numpy(), want)


def _q_out_inputs(rng, B, Tq, heads, d, C_in, ln, np_dt):
    """One attn2 site: raw stream (LN-folded) or to_q codes + residual, a
    fused to_kv output [B, 77, 2C] with a BoS-like first row."""
    C = heads * d
    wq, wout = codes(rng, C_in, C), codes(rng, C, C_in)
    stream = (rng.standard_normal((B, Tq, C_in)) * 2).astype(np_dt)
    y = rng.standard_normal((B, 77, 2 * C)).astype(np.float32)
    y[:, 0] *= 8
    arrays = dict(
        x=stream if ln else codes(rng, B, Tq, C_in),
        wq=wq, sq=((rng.random(C) + 0.5) / (3000.0 * C_in ** 0.5)).astype(
            np.float32),
        b0q=(3.0 * wq.astype(np.int32).sum(0)).astype(np.float32),
        y=y.astype(np_dt), wout=wout,
        so=((rng.random(C_in) + 0.5) * 2e-5).astype(np.float32),
        b0o=(-6.0 * wout.astype(np.int32).sum(0)).astype(np.float32),
        bo=(rng.standard_normal(C_in) * 0.1).astype(np.float32),
        res=None if ln else stream)
    gamma = (rng.random(C_in) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(C_in) * 0.2).astype(np.float32)
    fold = (gamma, beta, 25.0, 2.0, (-128.0, 127.0), 1e-5) if ln else None
    return arrays, fold


@pytest.mark.parametrize("Tq,C_in", [(64, 128), (256, 128), (64, 256)])
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sec_attention_q_out_plain_vs_pallas(Tq, C_in, ln, dtype):
    import ml_dtypes

    rng = np.random.default_rng(12)
    heads, d, B = 2, 64, 1
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    a, fold = _q_out_inputs(rng, B, Tq, heads, d, C_in, ln, np_dt)
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0,
              v_off=heads * d)

    def arg_list(conv):
        return (conv(a["x"]), conv(a["wq"]), conv(a["sq"]), conv(a["b0q"]),
                conv(a["y"]), conv(a["y"]), 100.0, -2.0, conv(a["wout"]),
                conv(a["so"]), conv(a["b0o"]), conv(a["bo"]),
                None if a["res"] is None else conv(a["res"]))

    def jconv(v):
        return jnp.asarray(v)

    def tconv(v):
        if v.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return T(v)

    jfold = None if fold is None else (jnp.asarray(fold[0]),
                                       jnp.asarray(fold[1])) + fold[2:]
    tfold = None if fold is None else (T(fold[0]), T(fold[1])) + fold[2:]
    want = jsa.sec_attention_q_out(
        *arg_list(jconv), **kw, out_dtype=jnp.dtype(np_dt), interpret=True,
        ln_args=jfold)
    ops.reset_counts()
    got = tsa.sec_attention_q_out(*arg_list(tconv), **kw,
                                  out_dtype=getattr(torch, dtype), ln=tfold)
    assert ops.call_counts()["sec_attention_q_out"] == 1
    assert got.dtype == getattr(torch, dtype)
    got, want = got.float().numpy(), f32(want)
    res = f32(a["x"] if ln else a["res"])
    for g, w in ((got, want), (got - res, want - res)):  # output and delta
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-2, rel


def test_sec_attention_head_dim_guard():
    """Only head_dim in {16, 32, 64, 128}: others raise on any device."""
    x = torch.zeros(1, 8, 48, dtype=torch.int8)
    w = torch.zeros(48, 144, dtype=torch.int8)
    with pytest.raises(ValueError, match="head_dim"):
        tsa.sec_attention_qkv(x, w, torch.ones(144), torch.zeros(144), 1.0,
                              0.0, heads=2, head_dim=24, scale=0.2)


def test_attn_impl_values():
    from mixdq_tpu_torch.quant.state import QuantCtx

    assert QuantCtx().attn_impl == "einsum"  # the JAX package's default
    with pytest.raises(ValueError, match="attn_impl"):
        QuantCtx(attn_impl="flash")


def _port_transformer(seed=0):
    """A port-only Transformer2DModel (C=128, 2 heads of 64, 1 layer),
    random weights from ``seed``, calibrated and deployed W8A8 under
    ``'auto'``; returns (model, ctx, encoder states, rng)."""
    from mixdq_tpu_torch.models.layers import lecun_normal_
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    tm = Transformer2DModel(128, 2, 64, 1, 64, norm_num_groups=16)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, m in sorted(quantizable_layers(tm).items()):
            lecun_normal_(m.weight, m.fan_in(), gen)
    rng = np.random.default_rng(seed)
    x = T(rng.standard_normal((1, 8, 8, 128)).astype(np.float32))
    ehs = T(rng.standard_normal((1, 77, 64)).astype(np.float32))
    qp = calibrate(tm, [(x, ehs)], pipeline.WQ, pipeline.AQ)
    ctx = deploy_unet_ctx(tm, qp, uniform_ctrl(list(quantizable_layers(tm))),
                          pipeline.WQ, fuse_qkv=True)
    return tm, dataclasses.replace(ctx, attn_impl="auto"), ehs, rng


def test_attn2_pre_coded_matches_ln_folded():
    """attn2 under ``'auto'``: to_q's codes plus an explicit residual (the
    LayerNorm materialized first) give what the LN-folded call gives."""
    from mixdq_tpu_torch.models.attention import materialize_ln_codes

    tm, ctx, ehs, rng = _port_transformer()
    blk = tm.transformer_blocks[0]
    x = T((rng.standard_normal((1, 64, 128)) * 2).astype(np.float32))
    h, ln = blk._ln(x, blk.norm2, f"{blk.qname}.attn2.to_q", ctx)
    assert ln is not None
    ops.reset_counts()
    with torch.no_grad():
        folded = blk.attn2(h, ehs, ctx, residual=x, ln=ln)
        pre = blk.attn2(materialize_ln_codes(x, ln), ehs, ctx, residual=x)
    calls = ops.call_counts()
    assert calls["sec_attention_q_out"] == 2 and calls["ln_quantize"] == 1
    torch.testing.assert_close(pre, folded, rtol=0, atol=0)


def _transformer_pair(rng, in_ch, heads, head_dim, layers, cross_dim, H,
                      W, seed, bos=1.0):
    """The same Transformer2DModel in both packages (perturbed flax
    params converted for the port), an input map ``[1, H, W, in_ch]`` and
    unit encoder states whose first token is ``bos`` times larger;
    returns (JAX module, its variables, port module, input, encoder
    states). Over thousands of tokens an act code one apart somewhere
    upstream is all but sure, and a BoS-sized outlier makes to_out's act
    step, and so what one such code moves, large; the maps that large use
    ``bos=1``."""
    jm = jattn.Transformer2DModel(in_channels=in_ch, heads=heads,
                                  head_dim=head_dim, num_layers=layers,
                                  cross_attention_dim=cross_dim,
                                  norm_num_groups=16)
    x = rng.standard_normal((1, H, W, in_ch)).astype(np.float32)
    ehs = rng.standard_normal((1, 77, cross_dim)).astype(np.float32)
    ehs[:, 0] *= bos
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        jnp.asarray(ehs))
    params = perturb(np_tree(variables["params"]), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tm = load(Transformer2DModel(in_ch, heads, head_dim, layers, cross_dim,
                                 norm_num_groups=16), params)
    return jm, variables, tm, x, ehs


def test_auto_routes_flash_shapes(interpret):
    """The input that the port refused before flash attention was ported
    (a 32x64 map, C=128 as 2 heads of 64: Tq * Tk = 2^22 at attn1) now
    runs attn1 on flash attention and matches the JAX package (which, on
    the CPU, takes its einsum chain at flash sites)."""
    rng = np.random.default_rng(15)
    jm, variables, tm, x, ehs = _transformer_pair(rng, 128, 2, 64, 1, 64,
                                                  32, 64, 4)
    want, jqp, jaxpr = _jax_auto(jm, variables,
                                 (jnp.asarray(x), jnp.asarray(ehs)))
    assert "sec_attention_q_lnout" in jaxpr
    got, calls = _port_auto(tm, jqp, (T(x), T(ehs)))
    assert calls["flash_attention"] == calls["sec_attention_q_out"] == 1
    assert calls["sec_attention_qkv"] == calls["sec_attention"] == 0
    assert_int8_close(got, want)


def port_auto_ctx(module, jqparams, fuse_qkv=True):
    """The port's W8A8 deploy of ``module`` on the JAX calibration, under
    ``'auto'``."""
    from mixdq_tpu_torch import convert
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    qp = convert.qparams_from_numpy(qparams_np(jqparams))
    ctx = deploy_unet_ctx(module, qp, uniform_ctrl(list(
        quantizable_layers(module))), pipeline.WQ, fuse_qkv=fuse_qkv)
    return dataclasses.replace(ctx, attn_impl="auto")


def _port_auto(module, jqparams, args, fuse_qkv=True):
    """Port module under ``'auto'`` on the JAX calibration; returns
    (output, the kernel call counts)."""
    ctx = port_auto_ctx(module, jqparams, fuse_qkv)
    ops.reset_counts()
    with torch.no_grad():
        out = module(*args, ctx=ctx)
    return out, ops.call_counts()


def _jax_auto(model, variables, args, fuse_qkv=True, capture=False):
    """JAX int8 output under ``'auto'`` (fused QKV/KV unless told not),
    its calibration and its jaxpr; with ``capture``, also every module's
    output by its canonical name."""
    from mixdq_tpu.quant import calibrate as jcal
    from mixdq_tpu.quant.deploy import deploy_unet_ctx, deployed_params
    from mixdq_tpu.quant.state import quantizable_layers, uniform_ctrl

    jqp = jcal.calibrate(model, variables, [args], JWQ, JAQ)
    ctrl = uniform_ctrl(quantizable_layers(variables["params"]), w_bits=8,
                        a_bits=8)
    ctx = deploy_unet_ctx(model, variables, jqp, ctrl, JWQ, JAQ,
                          fuse_qkv=fuse_qkv).replace(**AUTO)
    pruned = deployed_params(variables, ctx)

    def run(v, c, *a):
        return model.apply(v, *a, c)

    jaxpr = repr(jax.make_jaxpr(run)(pruned, ctx, *args))
    out = np.asarray(jax.jit(run)(pruned, ctx, *args))
    if not capture:
        return out, jqp, jaxpr
    from mixdq_tpu.quant.state import canonical_name

    _, state = jax.jit(lambda v, c, *a: model.apply(
        v, *a, c, capture_intermediates=True, mutable=["intermediates"]))(
            pruned, ctx, *args)
    flat = jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]
    outs = {canonical_name(tuple(k.key for k in path[:-2])): np.asarray(v)
            for path, v in flat
            if getattr(path[-2], "key", None) == "__call__"}
    return out, jqp, jaxpr, outs


def test_transformer_auto_parity(interpret):
    """Transformer2DModel, C=128 as 2 heads of 64, 2 layers: the JAX graph
    runs sec_attention_qkv and the LN-folded sec_attention_q_out; the
    port runs its kernels' counterparts as often and agrees."""
    rng = np.random.default_rng(13)
    jm = jattn.Transformer2DModel(in_channels=128, heads=2, head_dim=64,
                                  num_layers=2, cross_attention_dim=64,
                                  norm_num_groups=16)
    x = rng.standard_normal((1, 8, 8, 128)).astype(np.float32)
    ehs = (rng.standard_normal((1, 77, 64)) * 2).astype(np.float32)
    ehs[:, 0] *= 20  # a BoS-like outlier token
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                        jnp.asarray(ehs))
    params = perturb(np_tree(variables["params"]), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    want, jqp, jaxpr = _jax_auto(jm, variables,
                                 (jnp.asarray(x), jnp.asarray(ehs)))
    assert "sec_attention_qkv" in jaxpr
    assert "sec_attention_q_lnout" in jaxpr
    tm = load(Transformer2DModel(128, 2, 64, 2, 64, norm_num_groups=16),
              params)
    got, calls = _port_auto(tm, jqp, (T(x), T(ehs)))
    assert calls["sec_attention_qkv"] == calls["sec_attention_q_out"] == 2
    assert calls["ln_quantize"] == 4  # norm1 and norm3; norm2 folds
    assert_int8_close(got, want)


#: the ``small-sdxl`` UNet: its cross-attention level is C=128 as two heads
#: of 64, so the JAX package's gates let its kernels run
SMALL = dataclasses.asdict(get_family("small-sdxl").unet)


def test_small_unet_auto_parity(interpret):
    rng = np.random.default_rng(14)
    jm = JUNet(JUNetConfig(**SMALL))
    inputs = (rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
              np.float32(999.0),
              rng.standard_normal((1, 77, 64)).astype(np.float32),
              rng.standard_normal((1, 32)).astype(np.float32),
              np.array([[128, 128, 0, 0, 128, 128]], np.float32))
    jargs = (jnp.asarray(inputs[0]), jnp.asarray(inputs[1]),
             jnp.asarray(inputs[2]), {"text_embeds": jnp.asarray(inputs[3]),
                                      "time_ids": jnp.asarray(inputs[4])})
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), *jargs)
    params = perturb(np_tree(variables["params"]), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    want, jqp, jaxpr = _jax_auto(jm, variables, jargs)
    assert "sec_attention_qkv" in jaxpr
    assert "sec_attention_q_lnout" in jaxpr
    cfg = UNetConfig(**SMALL)
    tm = load(UNet2DConditionModel(cfg), params)
    targs = (T(inputs[0]), torch.tensor(999.0), T(inputs[2]),
             {"text_embeds": T(inputs[3]), "time_ids": T(inputs[4])})
    got, calls = _port_auto(tm, jqp, targs)
    assert calls == pipeline.expected_kernel_calls(cfg, "auto")
    assert calls["sec_attention_qkv"] == calls["sec_attention_q_out"] == 4
    assert_int8_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_attention_sites(dtype):
    """``chip_smoke.py``'s per-site check on the ``small-sdxl`` UNet, whose
    sites take ``sec_attention_qkv`` and ``sec_attention_q_out`` under
    ``'auto'`` (``tiny-sdxl``'s 2 heads of 16 route every site to the
    einsum chain, as in the JAX package): every attention module passes
    it against ``'einsum'``, and each injected to_out zero-point fault
    fails it."""
    smoke = load_smoke()
    dt = getattr(torch, dtype)
    unet = pipeline.build_unet("small-sdxl", 0, dt, "cpu")
    calib = pipeline.example_inputs("small-sdxl", 1, 0, dt, "cpu")
    ctx = pipeline.quantize_w8a8(unet, calib)
    assert ctx.attn_impl == "auto"
    req = pipeline.example_inputs("small-sdxl", 1, 100, dt, "cpu")
    kernels = smoke.phase_attention_sites(torch, unet, ctx, req)
    assert collections.Counter(kernels.values()) == {
        "sec_attention_qkv": 4, "sec_attention_q_out": 4}
