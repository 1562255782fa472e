"""The port's fake quantization (``mixdq_tpu_torch/quant/core.py``), its
controls (``quant/state.py``) and its explicit attention routes against
the JAX package's, on the CPU, inputs from numpy seeds.

Tolerances: ``fake_quant`` (2/4/8 bits, symmetric and not, ties at .5,
per-tensor and per-channel), hard AdaRound, the grid-search fit,
``fake_quant_channelwise``, ``quantize_*_int`` and ``ema_minmax`` equal
bit for bit in f32, and in bf16 within one bf16 ulp; ``lp_loss``, a
float sum that the two packages add in other orders, at rtol 1e-6 (its
elementwise terms are the same). Soft AdaRound runs
``torch.sigmoid``, which is an f32 ulp from XLA's logistic on about 0.4%
of inputs, so it is held at rtol 1e-6. Gradients (straight-through
rounding in x and delta, soft AdaRound in alpha) within a relative 1e-5
of ``jax.grad``. ``stochastic_round`` draws from a ``torch.Generator``
and is held by statistics: the share rounded up within 6 standard
deviations of the fraction. Controls equal JAX's field by field.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.quant import core as jcore  # noqa: E402
from mixdq_tpu.quant import state as jstate  # noqa: E402

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models import routing  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.quant import core  # noqa: E402
from mixdq_tpu_torch.quant import state  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import (  # noqa: E402
    collect_act_stats)
from mixdq_tpu_torch.quant.core import QuantSpec  # noqa: E402
from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx  # noqa: E402


def T(a):
    return torch.from_numpy(np.array(a))


def with_ties(rng, shape, delta):
    """Normal values about 40 codes wide, every fifth one moved onto a
    half-code edge (``(k + 0.5) * delta``)."""
    x = rng.standard_normal(shape).astype(np.float32) * 40 * delta
    flat = x.reshape(-1)
    k = rng.integers(-60, 60, flat[::5].shape)
    flat[::5] = (k + 0.5) * delta
    return x


def bf16_close(got, want):
    """Within one bf16 ulp of ``want``."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_matches_jax(bits, sym, dtype):
    rng = np.random.default_rng(bits * 10 + sym)
    delta = np.float32(0.0173)
    x = with_ties(rng, (64, 48), delta)
    zp = np.float32(0.0 if sym else 2 ** (bits - 1))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jcore.fake_quant(jnp.asarray(x, jdt), jnp.asarray(delta),
                                       jnp.asarray(zp), bits, sym=sym)
                      .astype(jnp.float32))
    for n_bits in (bits, torch.tensor(bits)):
        got = core.fake_quant(T(x).to(tdt), T(delta), T(zp), n_bits, sym=sym)
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            bf16_close(got, want)
    # per-channel deltas and zero points broadcast along the last axis
    d = (rng.uniform(0.5, 2.0, 48) * delta).astype(np.float32)
    z = rng.integers(0, 2 ** bits, 48).astype(np.float32) * (not sym)
    want = np.asarray(jcore.fake_quant_channelwise(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(z), bits, sym=sym))
    got = core.fake_quant_channelwise(T(x), T(d), T(z), bits, sym=sym)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("sym", [True, False])
def test_fake_quant_adaround_matches_jax(hard, sym):
    rng = np.random.default_rng(5 + hard)
    delta = (rng.uniform(0.5, 2.0, 32) * 0.01).astype(np.float32)
    x = rng.standard_normal((3, 3, 16, 32)).astype(np.float32) * 0.5
    alpha = rng.standard_normal(x.shape).astype(np.float32) * 3
    zp = np.zeros(32, np.float32) if sym else np.full(32, 7.0, np.float32)
    for bits in (4, 8):
        want = np.asarray(jcore.fake_quant_adaround(
            jnp.asarray(x), jnp.asarray(delta), jnp.asarray(zp), bits,
            jnp.asarray(alpha), sym=sym, hard=hard))
        got = core.fake_quant_adaround(T(x), T(delta), T(zp), bits, T(alpha),
                                       sym=sym, hard=hard).numpy()
        if hard:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        core.adaround_h(T(alpha)).numpy(),
        np.asarray(jcore.adaround_h(jnp.asarray(alpha))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("channel_wise", [False, True])
@pytest.mark.parametrize("always_zero", [False, True])
def test_grid_search_matches_jax(bits, channel_wise, always_zero,
                                 monkeypatch):
    rng = np.random.default_rng(bits + 3 * channel_wise)
    w = rng.standard_normal((24, 3, 3, 8)).astype(np.float32)
    w[0, 0, 0, 0] = 6.0  # an outlier the scan clips
    if always_zero:
        w = np.abs(w)  # softmax-like: non-negative
    jd, jz = jcore.fit_qparams_grid_search_lp(
        jnp.asarray(w), bits, channel_wise=channel_wise,
        always_zero=always_zero)
    d, z = core.fit_qparams_grid_search_lp(T(w), bits,
                                           channel_wise=channel_wise,
                                           always_zero=always_zero)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    # the scan in chunks of a few steps gives the same fit
    monkeypatch.setattr(core, "GRID_CHUNK_ELEMS", 7 * w.size)
    d2, z2 = core.fit_qparams_grid_search_lp(T(w), bits,
                                             channel_wise=channel_wise,
                                             always_zero=always_zero)
    assert torch.equal(d, d2) and torch.equal(z, z2)


@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (40, 24)])
def test_fit_weight_qparams_grid_search_matches_jax(shape):
    """``fit_weight_qparams``' dispatch on ``scale_method``: the channel
    axis (last, HWIO / ``[K, N]``) moved first, every candidate bit
    width."""
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    for channel_wise in (True, False):
        kw = dict(sym=True, channel_wise=channel_wise,
                  scale_method="grid_search_lp")
        jd, jz = jcore.fit_weight_qparams(jnp.asarray(w), jcore.QuantSpec(**kw))
        d, z = core.fit_weight_qparams(T(w), core.QuantSpec(**kw))
        assert d.shape == jd.shape
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    with pytest.raises(ValueError):
        core.fit_weight_qparams(T(w), core.QuantSpec(scale_method="mse"))


def test_integer_codes_ema_and_loss_match_jax():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    d = (rng.uniform(0.5, 2, 16) * 0.02).astype(np.float32)
    for bits in (4, 8):
        np.testing.assert_array_equal(
            core.quantize_weight_int(T(w), T(d), n_bits=bits).numpy(),
            np.asarray(jcore.quantize_weight_int(jnp.asarray(w),
                                                 jnp.asarray(d),
                                                 n_bits=bits)))
    np.testing.assert_array_equal(
        core.quantize_weight_int(T(w), T(np.float32(0.05))).numpy(),
        np.asarray(jcore.quantize_weight_int(jnp.asarray(w),
                                             jnp.asarray(np.float32(0.05)))))
    x = with_ties(rng, (4, 50), np.float32(0.03))
    np.testing.assert_array_equal(
        core.quantize_act_int(T(x), T(np.float32(0.03)),
                              T(np.float32(121.0))).numpy(),
        np.asarray(jcore.quantize_act_int(jnp.asarray(x),
                                          jnp.asarray(np.float32(0.03)),
                                          jnp.asarray(np.float32(121.0)))))
    a = rng.standard_normal((2, 5)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    for got, want in zip(core.ema_minmax(*map(T, (a[0], a[1], b[0], b[1]))),
                         jcore.ema_minmax(*map(jnp.asarray,
                                               (a[0], a[1], b[0], b[1])))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p, q = (rng.standard_normal((4, 3, 5)).astype(np.float32)
            for _ in range(2))
    for reduction in ("none", "all"):
        for pp, qq in ((p, q), (p[0, 0], q[0, 0])):
            np.testing.assert_allclose(
                core.lp_loss(T(pp), T(qq), p=2.0, reduction=reduction)
                .numpy(),
                np.asarray(jcore.lp_loss(jnp.asarray(pp), jnp.asarray(qq),
                                         p=2.0, reduction=reduction)),
                rtol=1e-6, atol=0)


@pytest.mark.parametrize("sym", [True, False])
def test_fake_quant_gradients_match_jax(sym):
    """Straight-through rounding: the gradient of a weighted sum of
    ``fake_quant`` in x and in delta, values on the clamp bounds
    included (half the gradient there, as ``jnp.clip``'s)."""
    rng = np.random.default_rng(11 + sym)
    bits = 4
    delta = np.float32(0.05)
    x = with_ties(rng, (32, 16), delta) * 0.3
    x[0, :4] = (np.array([7, -8, 15, 0]) - (0 if sym else 8)) * delta
    zp = np.float32(0 if sym else 8)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x, d):
        return jnp.sum(jcore.fake_quant(x, d, jnp.asarray(zp), bits, sym=sym)
                       * g)
    jgx, jgd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(delta))
    tx = T(x).requires_grad_()
    td = T(delta).requires_grad_()
    (core.fake_quant(tx, td, T(zp), bits, sym=sym) * T(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), rtol=1e-5)


def test_soft_adaround_gradient_matches_jax():
    rng = np.random.default_rng(13)
    delta = (rng.uniform(0.5, 2.0, 8) * 0.01).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32) * 0.3
    alpha = rng.standard_normal(x.shape).astype(np.float32) * 2
    zp = np.zeros(8, np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(a):
        return jnp.sum(jcore.fake_quant_adaround(
            jnp.asarray(x), jnp.asarray(delta), jnp.asarray(zp), 4, a,
            sym=True) * g)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(alpha)))
    ta = T(alpha).requires_grad_()
    (core.fake_quant_adaround(T(x), T(delta), T(zp), 4, ta, sym=True)
     * T(g)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), want, rtol=1e-5, atol=1e-9)
    assert (want != 0).any()


def test_stochastic_round_statistics():
    """Each value rounds to its floor or its ceiling, up with probability
    its fraction: over N draws the share rounded up lies within 6
    standard deviations (``sqrt(p (1 - p) / N)``) of p; the same
    generator seed gives the same draws."""
    N = 200_000
    for p in (0.1, 0.5, 0.83):
        x = torch.full((N,), 3.0 + p)
        g = torch.Generator().manual_seed(17)
        r = core.stochastic_round(x, g)
        assert set(r.unique().tolist()) <= {3.0, 4.0}
        up = (r == 4.0).float().mean().item()
        assert abs(up - p) <= 6 * (p * (1 - p) / N) ** 0.5, (p, up)
        assert torch.equal(r, core.stochastic_round(
            x, torch.Generator().manual_seed(17)))
    # through fake_quant: unbiased in expectation, on the code grid
    x = torch.full((N,), 0.37)
    y = core.fake_quant(x, torch.tensor(0.1), torch.tensor(0.0), 8, sym=True,
                        rng=torch.Generator().manual_seed(3))
    assert set(torch.round(y / 0.1).unique().tolist()) <= {3.0, 4.0}
    assert abs(y.mean().item() - 0.37) <= 6 * 0.1 * (0.7 * 0.3 / N) ** 0.5


def jctrl_tuple(c):
    return (bool(c.w_on), bool(c.a_on), int(c.w_idx), int(c.a_idx))


def assert_ctrl_equal(got, want):
    assert set(got) == set(want)
    for n in want:
        assert dataclasses.astuple(got[n]) == jctrl_tuple(want[n]), n


NAMES = ["conv_in", "down_blocks.0.resnets.0.conv1",
         "down_blocks.0.resnets.0.conv2", "down_blocks.1.attentions.0.proj_in",
         "down_blocks.10.resnets.0.conv1", "mid_block.resnets.0.conv1",
         "conv_out"]


@pytest.mark.parametrize("which", ["weight", "act", "both"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_controls_match_jax(which, bits):
    targets = ["down_blocks.0", "conv_out"]
    assert_ctrl_equal(state.group_ctrl(NAMES, targets, which, bits),
                      jstate.group_ctrl(NAMES, targets, which, bits))
    for k in (0, 3, len(NAMES)):
        assert_ctrl_equal(state.quant_till_ctrl(NAMES, k, which, bits),
                          jstate.quant_till_ctrl(NAMES, k, which, bits))
    if which != "both":
        assert_ctrl_equal(
            state.solo_layer_ctrl(NAMES, NAMES[2], which, bits),
            jstate.solo_layer_ctrl(NAMES, NAMES[2], which, bits))
    base = state.uniform_ctrl(NAMES, w_bits=bits, a_bits=4)
    jbase = jstate.uniform_ctrl(NAMES, w_bits=bits, a_bits=4)
    assert_ctrl_equal(state.protect_layers(base, NAMES[:3], which),
                      jstate.protect_layers(jbase, NAMES[:3], which))
    with pytest.raises(KeyError):
        state.protect_layers(base, ["nope"], which)


def test_quant_ctx_surface():
    """The modes, attention routes, computes and gates the context admits;
    ``quant_weight`` / ``quant_act`` are the identity outside fake mode and
    where a layer has no qparams or its control is off."""
    for kw in ([dict(mode=m) for m in ("fp", "fake", "int8")]
               + [dict(attn_impl=a) for a in ("einsum", "auto", "flash",
                                               "int8_flash", "int8qkv_flash")]
               + [dict(deploy_compute=c) for c in ("int8", "int8_sec",
                                                   "dequant", "pallas_dequant")]
               + [dict(gelu=g) for g in ("tanh", "exact", "sigmoid")]):
        state.QuantCtx(**kw)
    for kw in (dict(mode="w8"), dict(attn_impl="sdpa"), dict(gelu="relu"),
               dict(deploy_compute="fp8")):
        with pytest.raises(ValueError):
            state.QuantCtx(**kw)
    assert state.QuantCtx().deploy_compute == "int8_sec"
    qp = state.LayerQParams(w_delta=torch.full((3, 4), 0.1),
                            w_zp=torch.zeros(3, 4),
                            a_delta=torch.full((3,), 0.1),
                            a_zp=torch.full((3,), 5.0))
    w = torch.randn(6, 4)
    ctrl = {"a": state.make_ctrl(w_bits=4, a_bits=2)}
    fake = state.QuantCtx(mode="fake", qparams={"a": qp}, ctrl=ctrl)
    assert not torch.equal(fake.quant_weight("a", w), w)
    assert fake.quant_act("a", w).unique().numel() <= 4
    for ctx, name in ((dataclasses.replace(fake, mode="fp"), "a"),
                      (fake, "b"),
                      (dataclasses.replace(fake, ctrl={"a": state.make_ctrl(
                          w_on=False, a_on=False)}), "a")):
        assert ctx.quant_weight(name, w) is w
        assert ctx.quant_act(name, w) is w
    # the split twins: none here, so the second half passes through
    assert fake.quant_weight("a", w, split_part=1) is w


def test_capture_acts(small):
    """``capture_acts``: the input of every quantizable layer in one
    forward, the q/k/v/softmax act quantizers' too when the context turns
    them on; the same tensors the calibration hooks read."""
    m, inputs, _, fake = small
    seen = state.capture_acts(m, inputs)
    layers = state.quantizable_layers(m)
    assert set(seen) == set(layers)
    stats = collect_act_stats(m, inputs)
    for n in ("conv_in", "mid_block.resnets.0.conv2"):
        assert stats[n][1] == seen[n].float().max().clamp(min=0)
    qkv = state.QuantCtx(qkv_quant=True, softmax_aq=QuantSpec(
        always_zero=True))
    seen = state.capture_acts(m, inputs, qkv)
    qacts = set(state.act_quantizers(m))
    assert set(seen) == set(layers) | qacts and len(qacts) % 4 == 0
    assert set(state.capture_acts(m, inputs, names=["conv_in"])) == {
        "conv_in"}


def _small_unet():
    torch.manual_seed(0)
    m = UNet2DConditionModel(get_family("small-sdxl").unet)
    m.init_weights(4)
    inputs = pipeline.example_inputs("small-sdxl", 1, 3, torch.float32,
                                     "cpu")
    return m, inputs


@pytest.fixture(scope="module")
def small():
    """small-sdxl, one input, its fake context (``fake_quant_ctx``) and
    the W8A8 deploy of the same qparams as ``quantize_w8a8`` makes it."""
    m, inputs = _small_unet()
    fake = pipeline.fake_quant_ctx(m, inputs)
    ctx = dataclasses.replace(deploy_unet_ctx(
        m, fake.qparams, fake.ctrl, pipeline.WQ, fuse_qkv=True),
        attn_impl="auto")
    return m, inputs, ctx, fake


@pytest.mark.parametrize("impl", sorted(routing.EXPLICIT_ATTN))
def test_explicit_attn_impl_routes_every_site(small, impl):
    """At the small-sdxl shapes each explicit ``attn_impl`` sends every
    attention site to its kernel and never to a ``sec_attention*``
    kernel, in the int8_sec deploy and in fake mode; the calls equal
    ``ctx_kernel_calls``. Fake mode with ``qkv_quant`` runs the einsum
    chain at every site."""
    m, inputs, ctx, fake = small
    kernel = routing.EXPLICIT_ATTN[impl]
    sites = 2 * sum(1 for n, _ in m.named_modules()
                    if n.endswith(".attn1"))
    assert sites > 0
    sec = [k for k in routing.KERNELS if k.startswith("sec_attention")]
    assert routing.attention_route(
        mode="fp", attn_impl=impl, fused=False, cross=True, heads=2,
        head_dim=64, Tq=64, Tk=77, C_in=128).kernel == kernel
    for c in (ctx, fake):
        c = dataclasses.replace(c, attn_impl=impl)
        ops.reset_counts()
        out = pipeline.unet_step(m, inputs, c)
        calls = ops.call_counts()
        assert torch.isfinite(out).all()
        assert calls[kernel] == sites, (c.mode, calls)
        assert all(calls[k] == 0 for k in sec)
        assert calls == pipeline.ctx_kernel_calls(m.config, c)
    c = dataclasses.replace(fake, attn_impl=impl, qkv_quant=True)
    assert pipeline.ctx_kernel_calls(m.config, c)[kernel] == 0


def test_fake_and_int8_compute_kernel_counts(small):
    """A fake step launches no kernel under ``'auto'`` at these shapes,
    nor with the q/k/v quantizers under an explicit ``attn_impl`` (einsum
    at every site); the ``deploy_compute='int8'`` deploy runs the act
    quantize on its own, ``qmatmul`` and the conv kernels, no GN/LN
    producer and no whole-attention kernel, as ``ctx_kernel_calls``
    counts."""
    m, inputs, ctx, fake = small
    for c in (fake, dataclasses.replace(fake, attn_impl="flash",
                                        qkv_quant=True)):
        ops.reset_counts()
        pipeline.unet_step(m, inputs, c)
        assert set(ops.call_counts().values()) == {0}
        assert pipeline.ctx_kernel_calls(m.config, c) == ops.call_counts()
    c8 = deploy_unet_ctx(m, fake.qparams, fake.ctrl, pipeline.WQ,
                         fuse_qkv=True, deploy_compute="int8")
    c8 = dataclasses.replace(c8, attn_impl="auto")
    ops.reset_counts()
    out = pipeline.unet_step(m, inputs, c8)
    calls = ops.call_counts()
    assert calls == pipeline.ctx_kernel_calls(m.config, c8)
    assert calls["qmatmul"] > 0 and calls["qconv2d"] > 0
    assert calls["qconv2d_s2"] == 1
    for k in ("gn_silu_quantize", "ln_quantize", "geglu_qmatmul",
              "geglu_out_qmatmul") + routing.KERNELS:
        assert calls[k] == 0, k
    # the BoS-aware cross-attention k/v runs its FP row in int8 compute
    assert all(e.bos_w is not None for n, e in c8.deploy.items()
               if n.endswith(".attn2.to_kv"))
    sec = pipeline.unet_step(m, inputs, ctx)
    rel = ((out - sec).norm() / sec.norm()).item()
    assert rel < 0.1, rel


def test_chip_smoke_phase11_checks(small, monkeypatch):
    """``chip_smoke.py`` phase 11's checks, rehearsed on the CPU at
    small-sdxl (kernel wrappers run their plain versions): the module gate
    passes fake against the ``deploy_compute='int8'`` deploy in float32
    and fails its planted fault (``FAKE_FAULT_LAYER``'s act delta
    doubled); the int8 entries, held without their residual, pass against
    fake quantization."""
    from tests.test_torch_port_model import load_smoke

    sm = load_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    m, inputs, ctx, fake = small
    qp = fake.qparams
    ctrl = state.uniform_ctrl(list(state.quantizable_layers(m)))
    c8 = deploy_unet_ctx(m, qp, ctrl, pipeline.WQ, fuse_qkv=True,
                         deploy_compute="int8")
    sm.module_gate(torch, m, fake, c8, inputs, "small-sdxl fake")
    seen = sm.layer_inputs_without_residual(torch, m, inputs)
    assert all("residual" not in kw for _, kw in seen.values())
    names = [n for n, e in c8.deploy.items()
             if e.kind not in ("fused_away", "conv_split")]
    s = sm.layer_sqnrs(torch, m, c8, qp, seen, names)
    assert min(s.values()) >= sm.LAYER_SQNR_DB
