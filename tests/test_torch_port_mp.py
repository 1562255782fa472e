"""The mixed-precision slice of the port against the JAX package, on the
CPU: the halves-packed int4 layout, the flat bit-map reader, the per-layer
bit controls, ``wq4_matmul`` / ``wq_matmul`` (the port's plain versions,
which its wrappers run for CPU tensors) against the JAX Pallas kernels in
interpret mode, the deploy entries of a mixed map with an act-protect
list, and the ``small-sdxl`` step under the mixed ``int8_sec`` deploy
(``'auto'``) and both weight-only computes. Inputs come from numpy seeds.

Tolerances: wq kernels f32 out |d| <= 1e-5 max |ref| (the same bf16
products summed in f32 in other orders), bf16 out <= 2 bf16 ulps of
max |ref|; weight codes and packed bytes exact (the deploy rounds w /
delta in f32 on both sides, with the 1-ulp watch item of
``tests/test_torch_port_model.py`` never seen here); whole steps as
``tests/test_torch_port_model.py`` (|d|/|ref| <= 1e-2, max |d| < 0.3),
except the weight-only steps against the JAX package's CPU route, see
``WEIGHT_ONLY_REL``.
"""

import collections
import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from mixdq_tpu.models.configs import UNetConfig as JUNetConfig  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.ops import pallas_wq_matmul as jw  # noqa: E402
from mixdq_tpu.quant import calibrate as jcal  # noqa: E402
from mixdq_tpu.quant import deploy as jdeploy  # noqa: E402
from mixdq_tpu.quant import state as jstate  # noqa: E402

from mixdq_tpu_torch import convert, ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models.configs import (UNetConfig,  # noqa: E402
                                            get_family)
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.ops import wq_matmul as twq  # noqa: E402
from mixdq_tpu_torch.quant import bitmaps, deploy, state  # noqa: E402
from tests.test_torch_port_model import (JAQ, JWQ, T,  # noqa: E402
                                         assert_int8_close, load, np_tree,
                                         perturb, qparams_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP = os.path.join(ROOT, "configs", "mp")
TURBO = os.path.join(MP, "sdxl_turbo")

#: |d| / |ref| of a whole weight-only step against the JAX package on the
#: CPU, where it takes its XLA route (codes times the input, then the
#: scale: ``mixdq_tpu/models/layers.py:131-140, :156-157``) while the
#: port runs its kernels' plain versions (x and the dequantized weight
#: rounded to bf16, as the TPU kernels do): each rounding moves a layer's
#: output by about 2^-9 of its size; 4e-3 on small-sdxl under 'dequant'
WEIGHT_ONLY_REL = 2e-2


# ---------------------------------------------------------------------------
# packed int4 layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N", [(2, 1), (64, 48), (300, 130)])
def test_pack_w4_halves_matches_jax(K, N):
    rng = np.random.default_rng(30)
    w = rng.integers(-8, 8, (K, N)).astype(np.int8)
    got = twq.pack_w4_halves(torch.from_numpy(w))
    assert got.dtype == torch.uint8 and got.shape == (K // 2, N)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jw.pack_w4_halves(jnp.asarray(w))))
    np.testing.assert_array_equal(twq.unpack_w4_halves(got).numpy(), w)
    with pytest.raises(ValueError, match="odd"):
        twq.pack_w4_halves(torch.zeros(3, 2, dtype=torch.int8))


def test_unpack_packed_entries_round_trip():
    rng = np.random.default_rng(31)
    w = torch.from_numpy(rng.integers(-8, 8, (64, 32)).astype(np.int8))
    packed = deploy.DeployEntry(w_packed=twq.pack_w4_halves(w),
                                scale=torch.ones(32), scale_inv=1.0)
    plain = deploy.DeployEntry(w_int=w.clone(), scale=torch.ones(32),
                               scale_inv=1.0)
    out = deploy.unpack_packed_entries({"a": packed, "b": plain,
                                        "c": deploy.DeployEntry(
                                            kind="fused_away")})
    assert out["a"].w_packed is None and torch.equal(out["a"].w_int, w)
    assert out["b"] is plain and out["c"].kind == "fused_away"
    jpacked = jdeploy.DeployEntry(w_packed=jw.pack_w4_halves(jnp.asarray(
        w.numpy())))
    np.testing.assert_array_equal(
        np.asarray(jdeploy.unpack_packed_entries({"a": jpacked})["a"].w_int),
        out["a"].w_int.numpy())


# ---------------------------------------------------------------------------
# flat bit maps and per-layer controls
# ---------------------------------------------------------------------------

FLAT = sorted(
    glob.glob(os.path.join(MP, "*", "final_config", "**", "*.yaml"),
              recursive=True)
    + glob.glob(os.path.join(TURBO, "reference_final", "weight_*.yaml"))
    + glob.glob(os.path.join(TURBO, "reference_final", "act_*.yaml"))
    + glob.glob(os.path.join(MP, "*", "act_protect*.yaml")))


@pytest.mark.parametrize("path", FLAT, ids=lambda p: os.path.relpath(p, MP))
def test_bit_map_reader_matches_yaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    if isinstance(want, dict):
        assert bitmaps.load_bit_map(path) == {
            k[len("model."):] if k.startswith("model.") else k: int(v)
            for k, v in want.items()}
        assert bitmaps.load_layer_list(path) == list(want)
    else:
        assert bitmaps.load_layer_list(path) == [str(n) for n in want]
        with pytest.raises(ValueError, match="not a bit map"):
            bitmaps.load_bit_map(path)


def test_bit_map_reader_covers_the_repo_and_refuses_nested(tmp_path):
    """Every flat file the deploy reads is in ``FLAT``; the nested files
    (sensitivity logs, ``validation.yaml``) raise, as does a mixed file."""
    assert len(FLAT) == 16
    assert {os.path.basename(p) for p in FLAT} >= {
        "5.04.yaml", "7.43.yaml", "act_protect.yaml",
        "act_protect_reference.yaml"}
    nested = glob.glob(os.path.join(MP, "*", "sensitivity_log", "*.yaml")) + [
        os.path.join(TURBO, "reference_final", "validation.yaml")]
    for path in nested:
        with pytest.raises(ValueError, match="flat"):
            bitmaps.load_bit_map(path)
    mixed = tmp_path / "mixed.yaml"
    mixed.write_text("# a comment\n\nmodel.conv_in: 8\n- conv_out\n")
    with pytest.raises(ValueError, match="mixed.yaml:4"):
        bitmaps.load_bit_map(str(mixed))
    one = tmp_path / "one.yaml"
    one.write_text("# a comment\n\nmodel.conv_in: 8\n")
    assert bitmaps.load_bit_map(str(one)) == {"conv_in": 8}


def _turbo_maps():
    return (bitmaps.load_bit_map(os.path.join(
                TURBO, "final_config", "weight", "5.04.yaml")),
            bitmaps.load_bit_map(os.path.join(
                TURBO, "final_config", "act", "7.43.yaml")),
            bitmaps.load_layer_list(os.path.join(TURBO, "act_protect.yaml")))


def _jax_layer_bits(ctrl, cb=(2, 4, 8)):
    return {n: (cb[int(c.w_idx)], cb[int(c.a_idx)] if bool(c.a_on) else None)
            for n, c in sorted(ctrl.items()) if bool(c.w_on)}


def test_bitwidth_config_matches_jax():
    """W map, then the protect list, then the A map (``bench.py:133-145``)
    on the 794 SDXL-Turbo layers: the same (w_bits, a_bits) per layer in
    both packages; the elected map's counts; unknown names raise."""
    names = open(os.path.join(ROOT, "tests",
                              "fixtures_sdxl_turbo_layers.txt")).read().split()
    wmap, amap, protect = _turbo_maps()
    ctrl = state.uniform_ctrl(names)
    ctrl = state.apply_bitwidth_config(ctrl, wmap, "weight")
    ctrl = state.protect_layers(ctrl, protect)
    ctrl = state.apply_bitwidth_config(ctrl, amap, "act")
    got = deploy.layer_bits_from_ctrl(ctrl)
    jctrl = jstate.uniform_ctrl(names)
    jctrl = jstate.apply_bitwidth_config(jctrl, wmap, "weight")
    jctrl = jstate.protect_layers(jctrl, protect, "act")
    jctrl = jstate.apply_bitwidth_config(jctrl, amap, "act")
    assert got == _jax_layer_bits(jctrl)
    assert len(got) == 794
    assert collections.Counter(w for w, _ in got.values()) == {
        8: 394, 4: 372, 2: 28}
    assert collections.Counter(a for _, a in got.values()) == {
        8: 691, 4: 88, 2: 6, None: 9}
    assert sorted(n for n, (_, a) in got.items() if a is None) == \
        sorted(protect)
    # bits 0/16/32 leave a tensor FP; unknown layers raise
    off = state.apply_bitwidth_config(ctrl, {names[0]: 16}, "weight")
    assert names[0] not in deploy.layer_bits_from_ctrl(off)
    with pytest.raises(KeyError):
        state.apply_bitwidth_config(ctrl, {"no.such.layer": 8}, "act")
    with pytest.raises(KeyError):
        state.protect_layers(ctrl, ["no.such.layer"])


def test_deploy_compute_values():
    assert state.QuantCtx().deploy_compute == "int8_sec"
    for c in state.DEPLOY_COMPUTE:
        state.QuantCtx(deploy_compute=c)
    with pytest.raises(ValueError, match="deploy_compute"):
        state.QuantCtx(deploy_compute="int8")


# ---------------------------------------------------------------------------
# wq4_matmul / wq_matmul plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _assert_wq_close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    err, vmax = np.abs(got - want).max(), np.abs(want).max()
    if dtype == "float32":
        assert err <= 1e-5 * vmax, (err, vmax)
    else:
        assert err <= 2 * 2.0 ** (np.floor(np.log2(vmax)) - 7), (err, vmax)


@pytest.mark.parametrize("M,K,N", [(64, 256, 384), (77, 300, 130),
                                   (17, 300, 130), (1, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wq_plain_vs_pallas(M, K, N, dtype):
    rng = np.random.default_rng(32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w8 = rng.integers(-128, 128, (K, N)).astype(np.int8)
    w4 = rng.integers(-8, 8, (K, N)).astype(np.int8)
    s = ((rng.random(N) + 0.1) * 0.01).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    kw = dict(bm=32, bn=128, bk=128, out_dtype=jdt, interpret=True)
    ops.reset_counts()
    got = twq.wq_matmul(T(x), T(w8), T(s), T(bias), out_dtype=tdt)
    assert got.dtype == tdt
    _assert_wq_close(got, jw.wq_matmul(jnp.asarray(x), jnp.asarray(w8),
                                       jnp.asarray(s), jnp.asarray(bias),
                                       **kw), dtype)
    packed = twq.pack_w4_halves(T(w4))
    got = twq.wq4_matmul(T(x), packed, T(s), out_dtype=tdt)
    _assert_wq_close(got, jw.wq4_matmul(jnp.asarray(x),
                                        jnp.asarray(packed.numpy()),
                                        jnp.asarray(s), **kw), dtype)
    assert ops.call_counts()["wq_matmul"] == ops.call_counts()[
        "wq4_matmul"] == 1
    assert ops.launch_counts()["wq_matmul"] == 0  # CPU: plain versions


# ---------------------------------------------------------------------------
# small-sdxl: a mixed map with an act-protect list
# ---------------------------------------------------------------------------

SMALL = dataclasses.asdict(get_family("small-sdxl").unet)
#: one protected layer of each kind: attn2 to_k (its to_kv stays
#: unfused) and to_q, the two ff layers (no GEGLU kernel, no LN deferral
#: there), a 1x1 and a 3x3 conv
PROTECT = ["down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k",
           "mid_block.attentions.0.transformer_blocks.0.attn2.to_q",
           "up_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj",
           "up_blocks.0.attentions.1.transformer_blocks.0.ff.net.2",
           "up_blocks.0.resnets.1.conv_shortcut",
           "up_blocks.0.upsamplers.0.conv"]


def small_maps(names):
    """A seeded mixed map over ``names``: W 8/4/2 (every attn1 of the down
    block W4, so its fused to_qkv is re-packed), A 8/4/2 for every layer
    the protect list leaves quantized."""
    rng = np.random.default_rng(33)
    wmap = {n: int(rng.choice([8, 4, 2], p=[0.5, 0.4, 0.1])) for n in names}
    for m in ("to_q", "to_k", "to_v"):
        wmap[f"down_blocks.1.attentions.0.transformer_blocks.0.attn1.{m}"] = 4
    # the protected layers: packed and int8 weight-only dense entries
    wmap.update(zip(PROTECT, (8, 4, 4, 2, 8, 4)))
    amap = {n: int(rng.choice([8, 4, 2], p=[0.75, 0.2, 0.05]))
            for n in names if n not in PROTECT}
    for m in ("to_q", "to_k", "to_v"):  # one act scale: the triplet fuses
        amap[f"down_blocks.1.attentions.0.transformer_blocks.0.attn1.{m}"] = 8
    return wmap, amap


@pytest.fixture(scope="module")
def small():
    """small-sdxl in both packages: perturbed flax params, numpy inputs,
    the JAX calibration and the mixed controls."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MIXDQ_PALLAS_INTERPRET", "1")
        mp.delenv("MIXDQ_SEC_OUTFUSE", raising=False)
        mp.delenv("MIXDQ_SEC_LNFOLD", raising=False)
        rng = np.random.default_rng(34)
        jm = JUNet(JUNetConfig(**SMALL))
        inputs = (rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
                  np.float32(999.0),
                  rng.standard_normal((1, 77, 64)).astype(np.float32),
                  rng.standard_normal((1, 32)).astype(np.float32),
                  np.array([[128, 128, 0, 0, 128, 128]], np.float32))
        jargs = (jnp.asarray(inputs[0]), jnp.asarray(inputs[1]),
                 jnp.asarray(inputs[2]),
                 {"text_embeds": jnp.asarray(inputs[3]),
                  "time_ids": jnp.asarray(inputs[4])})
        variables = jax.jit(jm.init)(jax.random.PRNGKey(4), *jargs)
        params = perturb(np_tree(variables["params"]), rng)
        variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
        jqp = jcal.calibrate(jm, variables, [jargs], JWQ, JAQ)
        names = sorted(jstate.quantizable_layers(variables["params"]))
        wmap, amap = small_maps(names)
        jctrl = jstate.uniform_ctrl(names)
        jctrl = jstate.apply_bitwidth_config(jctrl, wmap, "weight")
        jctrl = jstate.protect_layers(jctrl, PROTECT, "act")
        jctrl = jstate.apply_bitwidth_config(jctrl, amap, "act")
        yield dict(jm=jm, variables=variables, jargs=jargs, params=params,
                   inputs=inputs, jqp=jqp, qp=qparams_np(jqp), names=names,
                   wmap=wmap, amap=amap, jctrl=jctrl)


def _jax_ctx(small, compute):
    """The JAX package's mixed deploy as ``bench.py`` builds it."""
    sec = compute == "int8_sec"
    ctx = jdeploy.deploy_unet_ctx(
        small["jm"], small["variables"], small["jqp"], small["jctrl"], JWQ,
        JAQ, skip_spatial_convs=not sec, pack_w4=True, fuse_qkv=sec)
    if sec:
        ctx = ctx.replace(deploy=jdeploy.unpack_packed_entries(ctx.deploy))
    return ctx.replace(deploy_compute=compute, attn_impl="auto")


def _port_ctx(small, compute, unpack=True):
    """The port's deploy of the same map on the JAX calibration (what
    ``pipeline.quantize_mixed`` builds after its own calibration)."""
    sec = compute == "int8_sec"
    m = load(UNet2DConditionModel(UNetConfig(**SMALL)), small["params"])
    ctrl = state.uniform_ctrl(small["names"])
    ctrl = state.apply_bitwidth_config(ctrl, small["wmap"], "weight")
    ctrl = state.protect_layers(ctrl, PROTECT)
    ctrl = state.apply_bitwidth_config(ctrl, small["amap"], "act")
    ctx = deploy.deploy_unet_ctx(
        m, convert.qparams_from_numpy(small["qp"]), ctrl, pipeline.WQ,
        fuse_qkv=sec, pack_w4=True, skip_spatial_convs=not sec,
        deploy_compute=compute)
    if sec and unpack:
        ctx = dataclasses.replace(
            ctx, deploy=deploy.unpack_packed_entries(ctx.deploy))
    return m, dataclasses.replace(ctx, attn_impl="auto")


@pytest.mark.parametrize("compute", ["int8_sec", "dequant"])
def test_mixed_deploy_entries_match_jax(small, compute):
    """Every entry of the mixed deploy (packed, before the int8_sec
    unpack): the same names, kinds, act_off and act bits; the same codes,
    packed bytes, scales and constants."""
    sec = compute == "int8_sec"
    want = jdeploy.deploy_unet_ctx(
        small["jm"], small["variables"], small["jqp"], small["jctrl"], JWQ,
        JAQ, skip_spatial_convs=not sec, pack_w4=True, fuse_qkv=sec).deploy
    _, ctx = _port_ctx(small, compute, unpack=False)
    got = ctx.deploy
    assert set(got) == set(want)
    seen = collections.Counter()
    for name, e in want.items():
        g = got[name]
        assert (g.kind, g.act_off) == (e.kind, e.act_off), name
        if e.kind == "fused_away":
            continue
        assert g.a_bits == e.a_bits, name
        assert (g.w_packed is None) == (e.w_packed is None), name
        if e.w_packed is not None:
            np.testing.assert_array_equal(g.w_packed.numpy(),
                                          np.asarray(e.w_packed), name)
        else:
            np.testing.assert_array_equal(g.w_int.numpy(),
                                          np.asarray(e.w_int), name)
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(e.scale))
        np.testing.assert_array_equal(g.bias0.numpy(), np.asarray(e.bias0))
        assert g.scale_inv == float(e.scale_inv), name
        assert g.zp_shifted == float(e.zp_shifted), name
        seen[(e.kind, e.w_packed is not None, e.act_off,
              name.rsplit(".", 1)[-1])] += 1
    # the map reaches every kind of entry: packed weight-only (proj, to_q,
    # ff.net.2), int8 weight-only (to_k, a 1x1 conv, the 3x3 conv under
    # int8_sec)
    assert seen[("linear", True, True, "proj")] == 1
    assert seen[("linear", False, True, "to_k")] == 1
    assert seen[("conv", False, True, "conv_shortcut")] == 1
    assert sum(v for k, v in seen.items() if k[1]) > 10
    assert sum(v for k, v in seen.items() if k[2]) == (6 if sec else 5)
    if sec:
        # every member W4: the fused entry is packed again
        assert got["down_blocks.1.attentions.0.transformer_blocks.0.attn1"
                   ".to_qkv"].w_packed is not None
        # the protected to_k keeps its triplet unfused
        assert ("down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_kv"
                not in got)
    else:
        assert not any(n.endswith(("to_qkv", "to_kv")) for n in got)
        assert not any(e.kind == "conv" and e.w_int.shape[0] > 1
                       for e in got.values())


def _count_jax_kernels(monkeypatch):
    """Count each JAX Pallas kernel call while the graph is traced (the
    JAX package imports them when its modules run)."""
    from mixdq_tpu.ops import pallas_gn_quant, pallas_ln_quant
    from mixdq_tpu.ops import pallas_qmatmul, pallas_sec_attention

    counts = collections.Counter()
    for mod, name in [(pallas_sec_attention, "sec_attention"),
                      (pallas_sec_attention, "sec_attention_q"),
                      (pallas_sec_attention, "sec_attention_qkv"),
                      (pallas_sec_attention, "sec_attention_q_out"),
                      (pallas_ln_quant, "ln_quantize"),
                      (pallas_gn_quant, "gn_silu_quantize"),
                      (pallas_qmatmul, "geglu_qmatmul")]:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("compute", ["int8_sec", "dequant",
                                     "pallas_dequant"])
def test_small_sdxl_mixed_step(small, compute, monkeypatch):
    """The whole small-sdxl step under the mixed deploy: the JAX package
    and the port take the same kernel at every site (each JAX Pallas call
    counted while its graph is traced), the port launches what
    ``expected_kernel_calls`` derives from its deploy, and the outputs
    agree. Under ``int8_sec`` the protect list sends attn2 of the down
    block (unfused to_k) and of the mid block (protected to_q) to
    ``sec_attention``."""
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    counts = _count_jax_kernels(monkeypatch)
    jctx = _jax_ctx(small, compute)
    pruned = jdeploy.deployed_params(small["variables"], jctx)

    def run(v, c, *a):
        return small["jm"].apply(v, *a, c)

    jax.make_jaxpr(run)(pruned, jctx, *small["jargs"])
    jcounts = dict(counts)
    want = np.asarray(jax.jit(run)(pruned, jctx, *small["jargs"]))

    m, ctx = _port_ctx(small, compute)
    i = small["inputs"]
    args = (T(i[0]), torch.tensor(999.0), T(i[2]),
            {"text_embeds": T(i[3]), "time_ids": T(i[4])})
    deploy.prune_deployed_weights(m, ctx.deploy)
    ops.reset_counts()
    got = pipeline.unet_step(m, args, ctx)
    calls = ops.call_counts()
    assert calls == pipeline.expected_kernel_calls(
        m.config, "auto", deploy=ctx.deploy, compute=compute)
    for k in ("sec_attention", "sec_attention_q", "sec_attention_qkv",
              "sec_attention_q_out", "ln_quantize", "gn_silu_quantize",
              "geglu_qmatmul"):
        assert calls[k] == jcounts.get(k, 0), (k, calls[k], jcounts)
    if compute == "int8_sec":
        # the protected to_k and to_q sites, and any whose to_k and to_v
        # differ in act bits
        assert calls["sec_attention"] >= 2
        assert sum(calls[k] for k in ("sec_attention", "sec_attention_qkv",
                                      "sec_attention_q_out")) == 8
        assert calls["wq4_matmul"] == calls["wq_matmul"] == 0
    else:
        packed = sum(e.w_packed is not None for e in ctx.deploy.values())
        assert calls["wq4_matmul"] == packed > 10
        assert calls["wq_matmul"] == (0 if compute == "dequant" else sum(
            e.kind == "linear" and e.w_packed is None and not e.act_off
            for e in ctx.deploy.values()))
    got = got.numpy()
    if compute == "int8_sec":
        assert_int8_close(got, want)
    elif compute == "dequant":
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= WEIGHT_ONLY_REL, rel
        assert np.abs(got - want).max() < 0.3
    else:
        # the act-quantized 1x1 convs (one at A4) see inputs that the bf16
        # roundings upstream moved, and one code apart there moves the
        # whole step by 5.7e-2: each module is held alone instead
        _hold_modules(small, m, ctx, jctx, args)


def _hold_modules(small, m, ctx, jctx, args):
    """Each resnet and transformer of the port's step, on the input it had
    there, against the JAX module (its params, its deploy entries) on the
    same input: |d| / |ref| <= ``WEIGHT_ONLY_REL``, max |d| < 0.3."""
    from mixdq_tpu.models import attention as jattn
    from mixdq_tpu.models import resnet as jresnet
    from mixdq_tpu_torch.models.attention import Transformer2DModel
    from mixdq_tpu_torch.models.resnet import ResnetBlock2D

    seen = {}

    def hook(mod, a, kw):
        seen[mod.qname] = (mod, a[:2], kw)

    handles = [mm.register_forward_pre_hook(hook, with_kwargs=True)
               for mm in m.modules()
               if isinstance(mm, (ResnetBlock2D, Transformer2DModel))]
    try:
        pipeline.unet_step(m, args, ctx)
    finally:
        for h in handles:
            h.remove()
    params = jdeploy.deployed_params(small["variables"], jctx)["params"]
    assert len(seen) == 12  # 8 resnets, 4 transformers
    for name, (mod, a, kw) in sorted(seen.items()):
        path = []
        for part in name.split("."):  # flax names: resnets_0, not resnets.0
            if part.isdigit():
                path[-1] += f"_{part}"
            else:
                path.append(part)
        sub = params
        for part in path:
            sub = sub[part]
        dep = {k[len(name) + 1:]: v for k, v in jctx.deploy.items()
               if k.startswith(name + ".")}
        if isinstance(mod, ResnetBlock2D):
            jm = jresnet.ResnetBlock2D(
                mod.conv1.weight.shape[2], mod.conv1.weight.shape[3],
                m.config.time_embed_dim, groups=mod.norm1.num_groups,
                eps=mod.norm1.eps)
        else:
            blk = mod.transformer_blocks[0]
            jm = jattn.Transformer2DModel(
                in_channels=mod.in_channels, heads=blk.attn1.heads,
                head_dim=blk.attn1.head_dim,
                num_layers=len(mod.transformer_blocks),
                cross_attention_dim=m.config.cross_attention_dim,
                norm_num_groups=mod.norm.num_groups)
        with torch.no_grad():
            got = mod(*a, ctx=ctx, **kw).numpy()
        want = np.asarray(jm.apply({"params": sub},
                                   *(jnp.asarray(t.numpy()) for t in a),
                                   jctx.replace(deploy=dep)))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= WEIGHT_ONLY_REL and np.abs(got - want).max() < 0.3, (
            name, rel)


def test_quantize_mixed_small_sdxl():
    """``pipeline.quantize_mixed`` end to end on the CPU: the three deploys
    of one map, each step's kernel calls as ``expected_kernel_calls``
    derives them, finite outputs of the right shape; weight-only deploys
    keep their W<=4 dense weights packed."""
    unet = pipeline.build_unet("small-sdxl", 0, torch.float32, "cpu")
    calib = pipeline.example_inputs("small-sdxl", 1, 0, torch.float32, "cpu")
    names = sorted(state.quantizable_layers(unet))
    wmap, amap = small_maps(names)
    for compute in ("int8_sec", "dequant", "pallas_dequant"):
        ctx = pipeline.quantize_mixed(unet, calib, wmap, amap, PROTECT,
                                      deploy_compute=compute)
        assert (ctx.deploy_compute, ctx.attn_impl) == (compute, "auto")
        assert ctx.fuse_qkv == (compute == "int8_sec")
        packed = [n for n, e in ctx.deploy.items() if e.w_packed is not None]
        assert (len(packed) > 10) == (compute != "int8_sec")
        assert sorted(n for n, e in ctx.deploy.items() if e.act_off) == \
            sorted(p for p in PROTECT if compute == "int8_sec"
                   or not p.endswith("upsamplers.0.conv"))
        ops.reset_counts()
        out = pipeline.unet_step(unet, calib, ctx)
        assert out.shape == calib[0].shape and torch.isfinite(out).all()
        assert ops.call_counts() == pipeline.expected_kernel_calls(
            unet.config, "auto", deploy=ctx.deploy, compute=compute)


def _mp_layout(cfg, layer_bits, compute):
    """The entries of ``quantize_mixed``'s deploy of ``layer_bits`` under
    ``compute``, kinds and shapes only (meta tensors), from the rules of
    ``mixdq_tpu/quant/deploy.py:71-285`` written out again: packed dense
    W<=4 entries with even K, weight-only entries for act-protected
    layers, spatial convs skipped by the weight-only deploys, fused
    QKV/KV under ``int8_sec`` (no weight-only member, one act bit-width),
    then unpacked."""
    def meta(shape, dt=torch.int8):
        return torch.empty(shape, dtype=dt, device="meta")

    sec = compute == "int8_sec"
    shapes = dict(pipeline._layer_shapes(cfg))
    out = {}
    for n, (wb, ab) in layer_bits.items():
        sh = shapes[n]
        if len(sh) == 4 and not sec and sh[0] * sh[1] > 1:
            continue
        kw = dict(scale_inv=1.0, act_off=ab is None,
                  a_bits=8 if ab is None else ab)
        if len(sh) == 2 and max(wb, 4) == 4 and sh[0] % 2 == 0:
            out[n] = deploy.DeployEntry(
                w_packed=meta((sh[0] // 2, sh[1]), torch.uint8), **kw)
        else:
            out[n] = deploy.DeployEntry(
                w_int=meta(sh), kind="linear" if len(sh) == 2 else "conv",
                **kw)
    for n in [n for n in out if sec and n.endswith(".to_q")]:
        pre = n[:-len(".to_q")]
        mem = ["to_q", "to_k", "to_v"] if pre.endswith("attn1") else [
            "to_k", "to_v"]
        es = [out[f"{pre}.{m}"] for m in mem]
        if any(e.act_off for e in es) or len({e.a_bits for e in es}) != 1:
            continue
        K = shapes[f"{pre}.{mem[0]}"][0]
        N = sum(shapes[f"{pre}.{m}"][1] for m in mem)
        out[pre + ".to_" + "".join(m[-1] for m in mem)] = deploy.DeployEntry(
            w_int=meta((K, N)), scale_inv=1.0, a_bits=es[0].a_bits)
        for m in mem:
            out[f"{pre}.{m}"] = deploy.DeployEntry(kind="fused_away")
    if sec:
        out = {k: (e.replace(w_int=meta((2 * e.w_packed.shape[0],
                                         e.w_packed.shape[1])),
                             w_packed=None) if e.w_packed is not None else e)
               for k, e in out.items()}
    return out


def test_expected_calls_sdxl_turbo_mixed():
    """``chip_smoke.py``'s launch counts of the three SDXL-Turbo paths
    (``MP_CALLS``, which the card's launches are held to), from the
    repo's elected maps and a layout of each deploy: one ``wq4_matmul``
    per packed dense entry, one ``wq_matmul`` per act-quantized W8 dense
    entry (the two protected W8 to_k run weight-only outside any
    kernel), ``qmatmul`` for the act-quantized 1x1 convs of
    ``pallas_dequant``; under ``int8_sec`` the 22 attn2 sites whose to_k
    and to_v have different act bits, or whose to_k is protected, stay
    unfused and run ``sec_attention``, and the protected ``to_q`` one
    more."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_family("sdxl-turbo").unet
    wmap, amap, protect = _turbo_maps()
    ctrl = state.uniform_ctrl([n for n, _ in pipeline._layer_shapes(cfg)])
    ctrl = state.apply_bitwidth_config(ctrl, wmap, "weight")
    ctrl = state.protect_layers(ctrl, protect)
    ctrl = state.apply_bitwidth_config(ctrl, amap, "act")
    bits = deploy.layer_bits_from_ctrl(ctrl)
    for compute, want in smoke.MP_CALLS.items():
        got = pipeline.expected_kernel_calls(
            cfg, "auto", deploy=_mp_layout(cfg, bits, compute),
            compute=compute)
        assert got == want, compute
    assert smoke.MP_CALLS["dequant"]["wq4_matmul"] == 376
    assert smoke.MP_CALLS["pallas_dequant"]["wq_matmul"] == 365


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_mixed_checks(dtype):
    """``chip_smoke.py``'s checks of its mixed-precision phase on
    small-sdxl: every entry of the three deploys passes the per-entry check
    at its bits, and so does every attention site of the int8_sec deploy;
    a packed entry with swapped nibble halves, an A4 entry clipped at A8
    and a zero-point fault at a protected sec_attention site each fail."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dt = getattr(torch, dtype)
    unet = pipeline.build_unet("small-sdxl", 0, dt, "cpu")
    calib = pipeline.example_inputs("small-sdxl", 1, 0, dt, "cpu")
    req = pipeline.example_inputs("small-sdxl", 1, 100, dt, "cpu")
    names = sorted(state.quantizable_layers(unet))
    wmap, amap = small_maps(names)
    ctrl = state.apply_bitwidth_config(state.uniform_ctrl(names), wmap,
                                       "weight")
    ctrl = state.apply_bitwidth_config(state.protect_layers(ctrl, PROTECT),
                                       amap, "act")
    bits = deploy.layer_bits_from_ctrl(ctrl)
    qparams = pipeline.calibrate(unet, [calib], pipeline.WQ, pipeline.AQ)
    seen = smoke.record_layer_inputs(torch, unet, req)
    for compute in ("int8_sec", "dequant", "pallas_dequant"):
        ctx = pipeline.quantize_mixed(unet, calib, wmap, amap, PROTECT,
                                      deploy_compute=compute)
        entries = [n for n, e in ctx.deploy.items() if e.kind != "fused_away"]
        s = smoke.layer_sqnrs(torch, unet, ctx, qparams, seen, entries, bits)
        assert min(s.values()) >= smoke.LAYER_SQNR_DB, min(s.items(),
                                                           key=lambda kv:
                                                           kv[1])
        if compute == "pallas_dequant":
            name = next(n for n, e in sorted(ctx.deploy.items())
                        if e.w_packed is not None)
            bad = smoke.nibble_swapped_ctx(ctx, name)
        elif compute == "int8_sec":
            name = next(n for n, e in sorted(ctx.deploy.items())
                        if e.kind == "linear" and e.a_bits == 4
                        and not n.endswith(("to_qkv", "to_kv",
                                            ".ff.net.0.proj")))
            bad = smoke.a8_clip_ctx(ctx, name)
            site = "mid_block.attentions.0.transformer_blocks.0.attn2"
            kernels = smoke.phase_attention_sites(
                torch, unet, ctx, req, (f"{site}.to_out.0",))
            assert kernels[site] == "sec_attention"  # its to_q is protected
        else:
            continue
        f = smoke.layer_sqnrs(torch, unet, bad, qparams, seen, [name],
                              bits)[name]
        assert f < smoke.LAYER_SQNR_DB, (compute, name, f)


def test_int8_sec_keeps_packed_entries(small):
    """``int8_sec`` on a deploy whose W<=4 entries stay packed: the router
    keeps packed fused / to_q / proj entries off the whole-attention and
    GEGLU kernels (they read codes themselves), weight-only packed entries
    run ``wq4_matmul``, and ``deploy_linear`` unpacks every act-quantized
    packed entry to the very output of its unpacked twin. (The whole step
    is not held against the unpacked deploy's: other kernels at the same
    sites sum in other orders, and one act code apart moves the output
    past 1e-2.)"""
    from mixdq_tpu_torch.models.layers import deploy_linear

    m, packed = _port_ctx(small, "int8_sec", unpack=False)
    unpacked = deploy.unpack_packed_entries(packed.deploy)
    i = small["inputs"]
    args = (T(i[0]), torch.tensor(999.0), T(i[2]),
            {"text_embeds": T(i[3]), "time_ids": T(i[4])})
    ops.reset_counts()
    got = pipeline.unet_step(m, args, packed)
    calls = ops.call_counts()
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    assert calls == pipeline.expected_kernel_calls(
        m.config, "auto", deploy=packed.deploy, compute="int8_sec")
    assert calls["wq4_matmul"] == sum(
        e.act_off and e.w_packed is not None for e in packed.deploy.values())
    # the packed fused to_qkv of the down block leaves sec_attention_qkv
    assert calls["sec_attention_qkv"] < pipeline.expected_kernel_calls(
        m.config, "auto", deploy=unpacked, compute="int8_sec")[
            "sec_attention_qkv"]
    gen = torch.Generator().manual_seed(35)
    n = 0
    for name, e in packed.deploy.items():
        if e.w_packed is None or e.act_off:
            continue
        x = torch.randn(5, 2 * e.w_packed.shape[0], generator=gen)
        torch.testing.assert_close(
            deploy_linear(x, e, "int8", torch.float32),
            deploy_linear(x, unpacked[name], "int8", torch.float32),
            rtol=0, atol=0)
        n += 1
    assert n > 10
