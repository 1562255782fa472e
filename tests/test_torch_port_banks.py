"""The port's BoS outputs, shared-input banks and small-M hybrid on the
CPU (``mixdq_tpu_torch/quant/deploy.py``, ``models/``), against the JAX
package's functions on the same deploy entries and against the port's
own per-layer path. No JAX UNet runs here: the JAX side is
``precompute_bos_outputs`` / ``apply_bos_outputs`` / the two banks on
entries converted from the port's, and ``QDense`` / ``QConv`` one module
at a time.

* ``bos_out`` of every cross-attention k/v entry equals JAX's
  ``emb0 @ W_fp`` (f32, rel 1e-6), fused and unfused, ``fused_away``
  skipped.
* Each bank's output equals the per-layer path bit for bit (``atol=0``,
  as ``tests/test_cross_kv_bank.py`` holds JAX's), with BoS protection on
  and off and with packed W4; each gate returns None where JAX's does.
* The small-M hybrid at module level equals the JAX route of
  ``tests/test_qops.py:457-490`` (``int8_sec``, a threshold), and the
  step's calls equal ``ctx_kernel_calls``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as jnn  # noqa: E402

from mixdq_tpu.models.layers import QConv as JQConv  # noqa: E402
from mixdq_tpu.models.layers import QDense as JQDense  # noqa: E402
from mixdq_tpu.quant import deploy as jdeploy  # noqa: E402
from mixdq_tpu.quant.state import QuantCtx as JCtx  # noqa: E402

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.layers import QConv, QDense  # noqa: E402
from mixdq_tpu_torch.ops import qops  # noqa: E402
from mixdq_tpu_torch.ops.qmatmul import qmatmul  # noqa: E402
from mixdq_tpu_torch.quant import checkpoint, deploy  # noqa: E402
from mixdq_tpu_torch.quant.state import QuantCtx  # noqa: E402

FAMILY = "tiny-sdxl"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the tier-1 run's
    workers share the cores, and small eager ops contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax_entry(e):
    """The JAX package's ``DeployEntry`` of a port entry (f32 / int8 /
    uint8 arrays, the same static fields)."""
    if e is None:
        return None

    def a(t):
        return None if t is None else jnp.asarray(t.cpu().numpy())
    return jdeploy.DeployEntry(
        w_int=a(e.w_int), w_packed=a(e.w_packed), bos_out=a(e.bos_out),
        scale=a(e.scale), bias0=a(e.bias0),
        scale_inv=None if e.scale_inv is None else jnp.float32(e.scale_inv),
        zp_shifted=None if e.zp_shifted is None else jnp.float32(
            e.zp_shifted), part0=to_jax_entry(e.part0),
        part1=to_jax_entry(e.part1), kind=e.kind, split=e.split,
        a_bits=e.a_bits, act_off=e.act_off)


@pytest.fixture(scope="module")
def tiny():
    """A tiny-sdxl UNet in f32 on the CPU, its request and its W8A8
    deploy (fused QKV/KV, BoS-aware)."""
    torch.manual_seed(0)
    unet = pipeline.build_unet(FAMILY, dtype=torch.float32, device="cpu")
    req = pipeline.example_inputs(FAMILY, dtype=torch.float32, device="cpu")
    ctx = pipeline.quantize_w8a8(unet, req)
    return dict(unet=unet, req=req, ctx=ctx)


def test_bos_outputs_match_jax(tiny):
    """Fused ``to_kv`` entries take their members' weights side by side,
    unfused ``to_k`` / ``to_v`` their own, ``fused_away`` entries stay
    as they are; ``bos_w`` goes."""
    unet, ctx = tiny["unet"], tiny["ctx"]
    unfused = deploy.deploy_unet_ctx(
        unet, *_qparams_ctrl(tiny), pipeline.WQ, fuse_qkv=False).deploy
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    checkpoint.module_params(unet))
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal(
        128).astype(np.float32))
    for dep, kinds in ((ctx.deploy, {"to_kv"}), (unfused, {"to_k", "to_v"})):
        got = deploy.precompute_bos_outputs(dep, unet, emb)
        want = jdeploy.precompute_bos_outputs(
            {n: jdeploy.DeployEntry(kind=e.kind) for n, e in dep.items()},
            params, jnp.asarray(emb.numpy()))
        seen = set()
        for n, e in got.items():
            if want[n].bos_out is None:
                assert e.bos_out is None and (e is dep[n]), n
                continue
            seen.add(n.rsplit(".", 1)[-1])
            ref = np.asarray(want[n].bos_out)
            np.testing.assert_allclose(e.bos_out.numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
            assert e.bos_w is None and e.bos_out.shape == (1, ref.shape[1])
        assert seen == kinds
        assert all(got[n] is dep[n] for n in dep
                   if dep[n].kind == "fused_away")


def _qparams_ctrl(tiny):
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    unet = tiny["unet"]
    if "qparams" not in tiny:
        tiny["qparams"] = calibrate(unet, [tiny["req"]], pipeline.WQ,
                                    pipeline.AQ)
    return tiny["qparams"], uniform_ctrl(list(quantizable_layers(unet)))


def test_apply_bos_outputs_synthetic():
    """``apply_bos_outputs`` on a synthetic dict, as
    ``tests/test_reference_artifacts.py`` holds JAX's: a fused entry only
    with both members' rows, an unfused one from its own, others as
    they were."""
    rng = np.random.default_rng(0)
    names = ("down.attn2.to_kv", "down.attn2.to_k", "down.attn2.to_v",
             "up.attn2.to_k", "up.attn2.to_v", "mid.attn2.to_kv",
             "up.attn1.to_q")
    dep = {n: deploy.DeployEntry(kind="fused_away" if n.startswith(
        "down.attn2.to_") and not n.endswith("kv") else "linear",
        scale=torch.ones(4)) for n in names}
    rows = {n: rng.standard_normal((1, 4)).astype(np.float32) for n in (
        "down.attn2.to_k", "down.attn2.to_v", "up.attn2.to_k",
        "mid.attn2.to_k")}
    got = deploy.apply_bos_outputs(dep, rows)
    want = jdeploy.apply_bos_outputs(
        {n: jdeploy.DeployEntry(kind=e.kind) for n, e in dep.items()}, rows)
    for n in names:
        if want[n].bos_out is None:
            assert got[n].bos_out is None, n
        else:
            np.testing.assert_array_equal(got[n].bos_out.numpy(),
                                          np.asarray(want[n].bos_out))
    assert got["down.attn2.to_kv"].bos_out.shape == (1, 8)
    assert got["mid.attn2.to_kv"].bos_out is None


@pytest.mark.parametrize("variant", ["bos", "no_bos", "packed_w4"])
def test_banks_match_per_layer_path(tiny, variant):
    """The step with both banks on equals the step with both off bit for
    bit, and each bank output equals its layer's per-layer product."""
    unet, req = tiny["unet"], tiny["req"]
    if variant == "packed_w4":
        qparams, ctrl = _qparams_ctrl(tiny)
        ctrl4 = {n: dataclasses.replace(c, w_idx=1) for n, c in ctrl.items()}
        ctx = deploy.deploy_unet_ctx(unet, qparams, ctrl4, pipeline.WQ,
                                     fuse_qkv=True, pack_w4=True)
        assert any(e.w_packed is not None for n, e in ctx.deploy.items()
                   if n.endswith((".to_kv", ".time_emb_proj")))
    else:
        ctx = dataclasses.replace(tiny["ctx"], bos_aware=variant == "bos")
    ctx = dataclasses.replace(ctx, deploy_compute="int8")
    on = dataclasses.replace(ctx, cross_kv=True, linear_bank=True)
    off = dataclasses.replace(ctx, cross_kv=False, linear_bank=False)
    y_on = pipeline.unet_step(unet, req, on)
    y_off = pipeline.unet_step(unet, req, off)
    torch.testing.assert_close(y_on, y_off, rtol=0, atol=0)
    sample, t, ehs, added = req
    with torch.no_grad():
        cross = deploy.precompute_cross_kv(ehs, on, torch.float32)
        kv = sorted(n for n in ctx.deploy if n.endswith(".attn2.to_kv"))
        assert cross is not None and sorted(cross) == kv
        x = torch.randn(2, unet.config.time_embed_dim)
        lin = deploy.precompute_linear_bank(x, on, torch.float32)
        names = sorted(n for n in ctx.deploy if n.endswith(".time_emb_proj"))
        assert lin is not None and sorted(lin) == names
        for n in names:
            e = ctx.deploy[n]
            want = qops.qlinear(qops.quantize_per_tensor(
                x, e.scale_inv, e.zp_shifted), e.codes(), e.scale, e.bias0,
                out_dtype=torch.float32)
            torch.testing.assert_close(lin[n], want, rtol=0, atol=0)


def test_bank_gates(tiny):
    """None where JAX's banks return None (``tests/test_cross_kv_bank.py:
    105-121``): the cross-k/v bank off by default, fake mode, a
    weight-only compute, the small-M hybrid; the time-embedding bank on
    by default, off with ``linear_bank=False``."""
    ctx = tiny["ctx"]
    ehs = tiny["req"][2]
    x = torch.randn(1, get_family(FAMILY).unet.time_embed_dim)
    assert QuantCtx().linear_bank and not QuantCtx().cross_kv
    assert deploy.precompute_cross_kv(ehs, ctx, torch.float32) is None
    on = dataclasses.replace(ctx, cross_kv=True)
    for bad in (dict(mode="fake"), dict(deploy_compute="dequant"),
                dict(deploy_compute="pallas_dequant"),
                dict(dequant_small_m=256), dict(fuse_qkv=False)):
        c = dataclasses.replace(on, **bad)
        assert deploy.precompute_cross_kv(ehs, c, torch.float32) is None, bad
        if "fuse_qkv" not in bad:
            assert deploy.precompute_linear_bank(x, c, torch.float32) \
                is None, bad
    assert deploy.precompute_cross_kv(ehs, on, torch.float32) is not None
    assert deploy.precompute_linear_bank(x, ctx, torch.float32) is not None
    assert deploy.precompute_linear_bank(
        x, dataclasses.replace(ctx, linear_bank=False), torch.float32) is None


@pytest.mark.parametrize("bos_aware", [True, False])
def test_bank_functions_match_jax(tiny, bos_aware, monkeypatch):
    """The port's banks against JAX's ``precompute_cross_kv`` /
    ``precompute_linear_bank`` on the same entries (``deploy_compute=
    'int8'``, f32): the int8 rows equal, the BoS rows (a precomputed
    ``bos_out`` on half the entries, the dequantized fallback on the
    rest) to f32 rounding."""
    monkeypatch.setenv("MIXDQ_CROSS_KV", "1")
    ctx = dataclasses.replace(tiny["ctx"], deploy_compute="int8",
                              bos_aware=bos_aware, cross_kv=True)
    dep = dict(ctx.deploy)
    for i, n in enumerate(sorted(n for n in dep if n.endswith(".to_kv"))):
        if i % 2:
            dep[n] = dep[n].replace(bos_out=torch.randn(
                1, dep[n].scale.shape[0]), bos_w=None)
    ctx = dataclasses.replace(ctx, deploy=dep)
    jctx = JCtx(mode="int8", deploy={n: to_jax_entry(e)
                                     for n, e in dep.items()},
                fuse_qkv=True, bos_aware=bos_aware, deploy_compute="int8")
    rng = np.random.default_rng(1)
    ehs = rng.standard_normal((2, 77, 128)).astype(np.float32)
    x = rng.standard_normal((2, get_family(FAMILY).unet.time_embed_dim)
                            ).astype(np.float32)
    for port_fn, jax_fn, inp in (
            (deploy.precompute_cross_kv, jdeploy.precompute_cross_kv, ehs),
            (deploy.precompute_linear_bank, jdeploy.precompute_linear_bank,
             x)):
        with torch.no_grad():
            got = port_fn(torch.from_numpy(inp), ctx, torch.float32)
        want = jax_fn(jnp.asarray(inp), jctx, jnp.float32)
        assert sorted(got) == sorted(want)
        for n in want:
            g, w = got[n].numpy(), np.asarray(want[n])
            if g.ndim == 3 and bos_aware:
                np.testing.assert_allclose(g[:, :1], w[:, :1], rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max())
                g, w = g[:, 1:], w[:, 1:]
            np.testing.assert_array_equal(g, w)


def test_qmatmul_layer_axis_plain():
    """``qmatmul`` over a layer axis on the CPU: each member equals its
    own ``qmatmul`` bit for bit."""
    g = torch.Generator().manual_seed(0)
    L, M, K, N = 3, 5, 64, 48
    x = torch.randint(-128, 128, (L, M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (L, K, N), generator=g, dtype=torch.int8)
    scale = torch.rand(L, N, generator=g) * 1e-3
    bias0 = -3.0 * w.int().sum(1).float()
    y = qmatmul(x, w, scale, bias0, out_dtype=torch.float32)
    assert y.shape == (L, M, N)
    for i in range(L):
        torch.testing.assert_close(
            y[i], qmatmul(x[i], w[i], scale[i], bias0[i],
                          out_dtype=torch.float32), rtol=0, atol=0)


class _Wrap(jnn.Module):
    """One JAX layer named ``lin`` (so its deploy entry's key is
    ``lin``)."""
    features: int
    conv: bool = False

    @jnn.compact
    def __call__(self, x, ctx):
        if self.conv:
            return JQConv(self.features, (1, 1), name="lin")(x, ctx)
        return JQDense(self.features, name="lin")(x, ctx)


@pytest.mark.parametrize("conv", [False, True])
@pytest.mark.parametrize("rows", [64, 300])
def test_small_m_module_matches_jax(conv, rows):
    """A dense layer and a 1x1 conv under ``int8_sec`` with
    ``dequant_small_m=256`` (``tests/test_qops.py:457-490``'s route):
    weight-only at 64 rows, act-quantized int8 at 300, in both packages
    (f32, rel 1e-5)."""
    rng = np.random.default_rng(7)
    K, N = 48, 40
    w = rng.standard_normal((K, N)).astype(np.float32) / 7
    b = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal((1, rows, K) if not conv else
                            (1, rows // 4, 4, K)).astype(np.float32)
    wt = torch.from_numpy(w if not conv else w.reshape(1, 1, K, N))
    prep = (qops.prepare_qconv_params if conv else
            qops.prepare_qlinear_params)(
        wt, torch.full((N,), float(np.abs(w).max() / 127)),
        torch.tensor(0.02), torch.tensor(120.0))
    e = deploy.DeployEntry(kind="conv" if conv else "linear",
                           **{k: v for k, v in prep.items() if k != "bias"})
    m = (QConv(K, N, (1, 1)) if conv else QDense(K, N)).eval()
    m.qname = "lin"
    with torch.no_grad():
        m.weight.copy_(wt)
        m.bias.copy_(torch.from_numpy(b))
    ctx = QuantCtx(mode="int8", deploy={"lin": e}, dequant_small_m=256)
    ops.reset_counts()
    with torch.no_grad():
        got = m(torch.from_numpy(x), ctx).numpy()
    assert ops.call_counts()["qmatmul"] == (rows > 256)
    jctx = JCtx(mode="int8", deploy={"lin": to_jax_entry(e)},
                deploy_compute="int8_sec", dequant_small_m=256)
    want = np.asarray(_Wrap(N, conv).apply(
        {"params": {"lin": {"bias": jnp.asarray(b)}}}, jnp.asarray(x), jctx))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    full = np.asarray(_Wrap(N, conv).apply(
        {"params": {"lin": {"bias": jnp.asarray(b)}}}, jnp.asarray(x),
        jctx.replace(dequant_small_m=0)))
    assert (rows > 256) == np.array_equal(want, full)


@pytest.mark.parametrize("small_m", [16, 77, 300])
def test_small_m_step_calls(tiny, small_m):
    """The tiny step under the small-M hybrid: every wrapper call as
    ``ctx_kernel_calls`` counts it, no LayerNorm producer, GEGLU or
    ``sec_attention*`` call, and neither bank."""
    unet, req = tiny["unet"], tiny["req"]
    ctx = dataclasses.replace(tiny["ctx"], dequant_small_m=small_m,
                              cross_kv=True)
    ops.reset_counts()
    y = pipeline.unet_step(unet, req, ctx)
    calls = ops.call_counts()
    assert calls == pipeline.ctx_kernel_calls(unet.config, ctx)
    assert torch.isfinite(y).all()
    for k in ("ln_quantize", "geglu_qmatmul", "sec_attention_qkv",
              "sec_attention_q_out", "sec_attention", "sec_attention_q"):
        assert calls[k] == 0, k


def test_sdxl_turbo_bank_and_small_m_counts():
    """SDXL-Turbo's counts a 512 step: the time-embedding bank's three
    groups (5 / 5 / 7 layers at N = 320 / 640 / 1280) turn 264 ``qmatmul``
    into 250, the cross-k/v bank's two (10 at N = 1280, 60 at 2560) 250
    into 182; ``dequant_small_m=256`` leaves 77, and no producer before
    ``proj_in``, LayerNorm or ``sec_attention*`` launch."""
    cfg = get_family("sdxl-turbo").unet
    layout = pipeline.w8a8_layout(cfg)
    assert deploy.bank_group_sizes(layout, ".time_emb_proj", 1280) == (
        (320, 8, 5), (640, 8, 5), (1280, 8, 7))
    assert deploy.bank_group_sizes(layout, ".attn2.to_kv", 2048) == (
        (1280, 8, 10), (2560, 8, 60))
    calls = {kw: pipeline.expected_kernel_calls(cfg, "auto", **dict([kw]))
             for kw in (("linear_bank", False), ("linear_bank", True),
                        ("cross_kv", True), ("small_m", 256))}
    assert calls[("linear_bank", False)]["qmatmul"] == 264
    assert calls[("linear_bank", True)]["qmatmul"] == 250
    assert calls[("cross_kv", True)]["qmatmul"] == 182
    sm = calls[("small_m", 256)]
    assert sm["qmatmul"] == 77 and sm["gn_silu_quantize"] == 46 - 11
    assert sm["ln_quantize"] == sm["geglu_qmatmul"] == 0
    assert sum(sm[k] for k in ("sec_attention_qkv", "sec_attention_q_out",
                               "sec_attention", "sec_attention_q")) == 0
