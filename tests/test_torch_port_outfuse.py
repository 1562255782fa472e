"""The out-fused ``int8_sec`` / ``'auto'`` deploy of the port against the JAX
package, on the CPU: ``sec_attention_qkv_out`` and ``geglu_out_qmatmul``
(the port's plain versions, which its wrappers run for CPU tensors)
against the JAX Pallas kernels in interpret mode, the router's copies of
their shape gates, and a transformer and the ``small-sdxl`` UNet under
``QuantCtx.out_fuse`` / ``ln_fold`` against the JAX package with its
``MIXDQ_SEC_OUTFUSE`` / ``MIXDQ_SEC_LNFOLD`` knobs set (before its model
is traced; every JAX run traces anew). Inputs come from numpy seeds.

Tolerances: the whole-block outputs and their deltas ``|d|/|ref| <=
1e-2`` (as ``sec_attention_q_out``'s test); modules and UNets as
``tests/test_torch_port_model.py`` (rel 1e-2, max 0.3).
"""

import dataclasses
import itertools

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

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models import routing  # noqa: E402
from mixdq_tpu_torch.models.attention import Transformer2DModel  # noqa: E402
from mixdq_tpu_torch.models.configs import UNetConfig, get_family  # noqa: E402
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.ops import qmatmul as tq  # noqa: E402
from mixdq_tpu_torch.ops import sec_attention as tsa  # noqa: E402
from mixdq_tpu_torch.quant.state import QuantCtx  # noqa: E402
from tests.test_torch_port_model import (T, assert_int8_close,  # noqa: E402
                                         load, load_smoke, np_tree, perturb)
from tests.test_torch_port_sec import (SMALL, _jax_auto,  # noqa: E402
                                       _qkv_inputs, codes, f32,
                                       port_auto_ctx)

ALL = frozenset({"attn1", "attn2", "ff"})
#: the contexts of the path: QuantCtx options and the JAX knobs they map to
CONTEXTS = {
    "all": (dict(out_fuse=ALL), {"MIXDQ_SEC_OUTFUSE": "1"}),
    "all_nofold": (dict(out_fuse=ALL, ln_fold=False),
                   {"MIXDQ_SEC_OUTFUSE": "1", "MIXDQ_SEC_LNFOLD": "0"}),
    "none": (dict(out_fuse=frozenset()), {"MIXDQ_SEC_OUTFUSE": "0"}),
}


@pytest.fixture
def knobs(monkeypatch):
    """Pallas in interpret mode; returns a setter of the JAX knobs."""
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    for k in ("MIXDQ_SEC_OUTFUSE", "MIXDQ_SEC_LNFOLD", "MIXDQ_INT8_FLASH"):
        monkeypatch.delenv(k, raising=False)

    def set_knobs(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_knobs


def _np_dtype(dtype):
    import ml_dtypes

    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _tconv(v):
    import ml_dtypes

    if isinstance(v, np.ndarray) and v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return T(v)


def _fold(fold, conv):
    return None if fold is None else (conv(fold[0]), conv(fold[1])) + fold[2:]


def _assert_out_and_delta(got, want, res):
    got, want, res = got.float().numpy(), f32(want), f32(res)
    for g, w in ((got, want), (got - res, want - res)):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-2, rel


@pytest.mark.parametrize("B,T_,ln,with_bias,with_res", [
    (1, 64, True, True, None),     # LN-folded (the raw input is the residual)
    (2, 64, False, True, True),    # pre-coded + residual
    (1, 256, True, False, None),
    (1, 64, False, False, False),  # pre-coded, no residual
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sec_attention_qkv_out_plain_vs_pallas(B, T_, ln, with_bias,
                                               with_res, dtype):
    rng = np.random.default_rng(40)
    heads, d = 2, 64
    C = heads * d
    np_dt = _np_dtype(dtype)
    x, w, scale, bias0 = _qkv_inputs(rng, B, T_, heads, d)
    wout = codes(rng, C, C)
    stream = (rng.standard_normal((B, T_, C)) * 2).astype(np_dt)
    a = [stream if ln else x, w, scale, bias0, 100.0, -3.0, wout,
         ((rng.random(C) + 0.5) * 2e-5).astype(np.float32),
         (-6.0 * wout.astype(np.int32).sum(0)).astype(np.float32),
         (rng.standard_normal(C) * 0.1).astype(np.float32) if with_bias
         else None,
         stream if with_res else None]
    fold = ((rng.random(C) + 0.5).astype(np.float32),
            (rng.standard_normal(C) * 0.2).astype(np.float32), 25.0, 2.0,
            (-128.0, 127.0), 1e-5) if ln else None
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5)
    want = jsa.sec_attention_qkv_out(
        *[None if v is None else v if isinstance(v, float) else
          jnp.asarray(v) for v in a], **kw, out_dtype=jnp.dtype(np_dt),
        interpret=True, ln_args=_fold(fold, jnp.asarray))
    ops.reset_counts()
    got = tsa.sec_attention_qkv_out(
        *[None if v is None else v if isinstance(v, float) else _tconv(v)
          for v in a], **kw, out_dtype=getattr(torch, dtype),
        ln=_fold(fold, T))
    assert ops.call_counts()["sec_attention_qkv_out"] == 1
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T_, C)
    _assert_out_and_delta(got, want, stream if ln or with_res
                          else np.zeros_like(f32(stream)))


@pytest.mark.parametrize("M,K,H,C,ln,with_bias,with_res", [
    (64, 128, 512, 128, True, True, None),      # small-sdxl ff, LN-folded
    (40, 128, 100, 128, False, True, True),     # ragged H, M < 64
    (130, 64, 200, 128, False, False, False),   # K != C, ragged, no residual
    (256, 256, 1024, 256, True, False, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_out_plain_vs_pallas(M, K, H, C, ln, with_bias, with_res,
                                   dtype):
    rng = np.random.default_rng(41)
    np_dt = _np_dtype(dtype)
    w, w2 = codes(rng, K, 2 * H), codes(rng, H, C)
    stream = (rng.standard_normal((M, C)) * 2).astype(np_dt)
    a = [stream if ln else codes(rng, M, K), w,
         ((rng.random(2 * H) + 0.5) / (2500.0 * K ** 0.5)).astype(np.float32),
         (5.0 * w.astype(np.int32).sum(0)).astype(np.float32), 25.0, 4.0, w2,
         ((rng.random(C) + 0.5) / (4e3 * H ** 0.5)).astype(np.float32),
         (-4.0 * w2.astype(np.int32).sum(0)).astype(np.float32)]
    kw = dict(bias=(rng.standard_normal(2 * H) * 0.3).astype(np.float32)
              if with_bias else None,
              out_bias=(rng.standard_normal(C) * 0.1).astype(np.float32),
              residual=stream if with_res else None)
    fold = ((rng.random(K) + 0.5).astype(np.float32),
            (rng.standard_normal(K) * 0.2).astype(np.float32), 25.0, 2.0,
            (-128.0, 127.0), 1e-5) if ln else None

    def conv(c):
        return [None if v is None else v if isinstance(v, float) else c(v)
                for v in a], {k: None if v is None else c(v)
                              for k, v in kw.items()}

    ja, jkw = conv(jnp.asarray)
    want = jpq.geglu_out_qmatmul(*ja, **jkw, out_dtype=jnp.dtype(np_dt),
                                 interpret=True,
                                 ln_args=_fold(fold, jnp.asarray))
    ta, tkw = conv(_tconv)
    ops.reset_counts()
    got = tq.geglu_out_qmatmul(*ta, **tkw, out_dtype=getattr(torch, dtype),
                               ln=_fold(fold, T))
    assert ops.call_counts()["geglu_out_qmatmul"] == 1
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, C)
    _assert_out_and_delta(got, want, stream if ln or with_res
                          else np.zeros_like(f32(stream)))


#: the attention levels of sdxl-turbo (T=1024 C=640, T=256 C=1280) and
#: sdxl (T=4096 C=640, T=1024 C=1280), d=64, and a grid around them
LEVELS = [(10, 1024, 640), (20, 256, 1280), (10, 4096, 640),
          (20, 1024, 1280)]


def test_outfuse_gates_match_jax():
    """The router's copies of ``sec_attention_qkv_out_ok`` and
    ``geglu_out_ok`` give the JAX package's answer over a grid of shapes;
    at the SDXL levels: attn1 out-fusion at both SDXL-Turbo levels and at
    no SDXL 1024 level, the whole FF at every level of both."""
    n_qkv, n_ff = {True: 0, False: 0}, {True: 0, False: 0}
    for heads, d, T_, C in itertools.product(
            (1, 2, 5, 10, 20), (16, 32, 64, 128),
            (64, 72, 100, 256, 1024, 2048, 4096), (128, 320, 640, 1280)):
        for args in ((heads, d, T_, C), (C // d, d, T_, C)):
            want = jsa.sec_attention_qkv_out_ok(*args)
            assert routing.sec_attention_qkv_out_ok(*args) == want, args
            n_qkv[want] += 1
    for M, K, C in itertools.product((1, 8, 40, 64, 256, 1024, 4096, 8192),
                                     (64, 320, 640, 1280), (100, 128, 640,
                                                            1280)):
        for H in (4 * K, 100):
            want = jpq.geglu_out_ok(M, K, H, C)
            assert routing.geglu_out_ok(M, K, H, C) == want, (M, K, H, C)
            n_ff[want] += 1
    assert min(n_qkv.values()) and min(n_ff.values())  # both answers
    turbo, sdxl = LEVELS[:2], LEVELS[2:]
    assert all(routing.sec_attention_qkv_out_ok(h, 64, t, c)
               for h, t, c in turbo)
    assert not any(routing.sec_attention_qkv_out_ok(h, 64, t, c)
                   for h, t, c in sdxl)
    assert all(routing.geglu_out_ok(t, c, 4 * c, c) for _, t, c in LEVELS)


def test_quant_ctx_kernel_options():
    """The three options default to the JAX knobs' defaults and refuse
    anything else."""
    ctx = QuantCtx()
    assert (ctx.out_fuse, ctx.ln_fold, ctx.int8_flash) == (
        frozenset({"attn2"}), True, "off")
    for bad in (dict(out_fuse={"attn1"}), dict(out_fuse=frozenset({"ff2"})),
                dict(ln_fold=1), dict(int8_flash="1")):
        with pytest.raises(ValueError):
            QuantCtx(**bad)


def test_expected_calls_outfuse_sdxl_turbo():
    """SDXL-Turbo launches per step under each out-fusion context, the
    counts ``chip_smoke.py`` holds the card to; the default context keeps
    its counts."""
    smoke = load_smoke()
    cfg = get_family("sdxl-turbo").unet
    assert pipeline.expected_kernel_calls(cfg, "auto") == smoke.TURBO_CALLS
    for tag, (opts, _) in CONTEXTS.items():
        assert smoke.OUTFUSE_PATHS[tag] == opts
        got = pipeline.expected_kernel_calls(cfg, "auto", **opts)
        assert got == smoke.OUTFUSE_CALLS[tag], tag
    whole = smoke.OUTFUSE_CALLS["all"]
    assert whole["qmatmul"] == 264 - 70 - 70 and whole["ln_quantize"] == 0
    assert whole["geglu_qmatmul"] == whole["sec_attention_qkv"] == 0


def _port_ctx(module, jqp, opts):
    return dataclasses.replace(port_auto_ctx(module, jqp), **opts)


def _names(jaxpr):
    import collections
    import re

    return collections.Counter(re.findall(r"name=(\w+)", jaxpr))


@pytest.mark.parametrize("tag", sorted(CONTEXTS))
def test_transformer_outfuse_parity(knobs, tag):
    """Transformer2DModel, C=128 as 2 heads of 64, 2 layers, under each
    context in both packages: the same whole-block kernels run as often
    and the outputs agree."""
    from tests.test_torch_port_sec import _transformer_pair

    opts, env = CONTEXTS[tag]
    knobs(env)
    rng = np.random.default_rng(42)
    jm, variables, tm, x, ehs = _transformer_pair(rng, 128, 2, 64, 2, 64, 8,
                                                  8, 9, bos=20.0)
    want, jqp, jaxpr = _jax_auto(jm, variables,
                                 (jnp.asarray(x), jnp.asarray(ehs)))
    names = _names(jaxpr)
    ctx = _port_ctx(tm, jqp, opts)
    ops.reset_counts()
    with torch.no_grad():
        got = tm(T(x), T(ehs), ctx=ctx)
    calls = ops.call_counts()
    if tag == "none":
        assert names["sec_attention_q"] == calls["sec_attention_q"] == 2
        assert calls["sec_attention_qkv"] == calls["geglu_qmatmul"] == 2
    else:
        fold = "ln" if opts.get("ln_fold", True) else ""
        assert names[f"sec_attention_qkv_{fold}out"] == 2
        assert names[f"geglu_{fold}out_qmatmul"] == 2
        assert calls["sec_attention_qkv_out"] == calls[
            "geglu_out_qmatmul"] == calls["sec_attention_q_out"] == 2
        assert calls["ln_quantize"] == (0 if fold else 6)
    assert_int8_close(got, want)


@pytest.mark.parametrize("tag", sorted(CONTEXTS))
def test_small_unet_outfuse_parity(knobs, tag):
    """The ``small-sdxl`` UNet under each context in both packages: the
    port launches what ``expected_kernel_calls`` derives for the context,
    and the outputs agree at ``test_small_unet_auto_parity``'s
    tolerance."""
    opts, env = CONTEXTS[tag]
    knobs(env)
    rng = np.random.default_rng(43)
    jm = JUNet(JUNetConfig(**SMALL))
    inputs = (rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
              np.float32(999.0),
              rng.standard_normal((1, 77, 64)).astype(np.float32),
              rng.standard_normal((1, 32)).astype(np.float32),
              np.array([[128, 128, 0, 0, 128, 128]], np.float32))
    jargs = (jnp.asarray(inputs[0]), jnp.asarray(inputs[1]),
             jnp.asarray(inputs[2]), {"text_embeds": jnp.asarray(inputs[3]),
                                      "time_ids": jnp.asarray(inputs[4])})
    variables = jax.jit(jm.init)(jax.random.PRNGKey(5), *jargs)
    params = perturb(np_tree(variables["params"]), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    want, jqp, jaxpr = _jax_auto(jm, variables, jargs)
    cfg = UNetConfig(**SMALL)
    tm = load(UNet2DConditionModel(cfg), params)
    ctx = _port_ctx(tm, jqp, opts)
    targs = (T(inputs[0]), torch.tensor(999.0), T(inputs[2]),
             {"text_embeds": T(inputs[3]), "time_ids": T(inputs[4])})
    ops.reset_counts()
    with torch.no_grad():
        got = tm(*targs, ctx=ctx)
    calls = ops.call_counts()
    assert calls == pipeline.ctx_kernel_calls(cfg, ctx)
    if tag == "none":
        assert "sec_attention_q_lnout" not in jaxpr
        assert calls["sec_attention_q"] == 4
    else:
        assert calls["sec_attention_qkv_out"] == calls[
            "geglu_out_qmatmul"] == 4
        assert ("geglu_lnout_qmatmul" in jaxpr) == opts.get("ln_fold", True)
    assert_int8_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_outfuse_checks(dtype):
    """``chip_smoke.py``'s out-fusion checks on ``small-sdxl``: every attn1
    and ff module under every site out-fused (LN folded or not) passes
    against the same module on the default route, and each planted fault
    (a whole-block mid act zero point shifted by 8 codes) fails; a site
    that drops its residual moves the whole step below its gate."""
    smoke = load_smoke()
    dt = getattr(torch, dtype)
    unet = pipeline.build_unet("small-sdxl", 0, dt, "cpu")
    calib = pipeline.example_inputs("small-sdxl", 1, 0, dt, "cpu")
    ctx = pipeline.quantize_w8a8(unet, calib)
    req = pipeline.example_inputs("small-sdxl", 1, 100, dt, "cpu")
    faults = ("down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0",
              "down_blocks.1.attentions.0.transformer_blocks.0.ff.net.2")
    kernels = smoke.phase_outfuse_sites(torch, unet, ctx, req, faults)
    assert set(kernels.values()) == {"sec_attention_qkv_out",
                                     "geglu_out_qmatmul"}
    ref = pipeline.unet_step(unet, req, ctx)
    whole = dataclasses.replace(ctx, out_fuse=ALL)
    assert smoke.sqnr_db(ref, pipeline.unet_step(unet, req, whole)) >= \
        smoke.OUTFUSE_STEP_SQNR_DB
    with smoke.whole_block_drops_residual():
        bad = pipeline.unet_step(unet, req, whole)
    assert smoke.sqnr_db(ref, bad) < smoke.OUTFUSE_STEP_SQNR_DB
