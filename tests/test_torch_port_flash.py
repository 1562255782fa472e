"""The SDXL 1024 px slice of the port against the JAX package, on the CPU:
``flash_attention``, ``sec_attention`` and ``sec_attention_q`` (the
port's plain versions, which its wrappers run for CPU tensors) against
the JAX Pallas kernels in interpret mode; the router's copies of the JAX
shape gates and its routes against the JAX package's; transformers that
take each new route under ``'auto'`` in both packages; and the ``sdxl``
family's structure. Inputs come from numpy seeds.

Tolerances: int8 codes max |diff| <= 1 on < 1% (another float summation
order); flash f32 |d| <= 1e-5; flash bf16 at the same key blocks (the
cases at ``Tk > 1024``: ``mha``'s 1024-key blocks, the port's default)
max |d| <= 2 bf16 ulps of max |v| (``p`` rounds to bf16 relative to a
running max the two reach by other sum orders) and |d| / |ref| <= 1e-2;
modules as
``tests/test_torch_port_model.py`` (rel 1e-2, max 0.3).
"""

import collections
import itertools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import attention as jattn  # noqa: E402
from mixdq_tpu.ops import pallas_attention as jpa  # noqa: E402
from mixdq_tpu.ops import pallas_sec_attention as jsa  # noqa: E402

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models import routing  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.ops import attention as tfa  # noqa: E402
from mixdq_tpu_torch.ops import sec_attention as tsa  # noqa: E402
from mixdq_tpu_torch.quant.state import quantizable_layers  # noqa: E402
from tests.test_torch_port_model import (T, assert_int8_close,  # noqa: E402
                                         load_smoke)
from tests.test_torch_port_sec import (_jax_auto, _port_auto,  # noqa: E402
                                       _transformer_pair, assert_codes_close,
                                       codes, port_auto_ctx)
from tests.test_torch_port_sec import interpret  # noqa: E402,F401 fixture


def _tensor(a, dtype):
    return T(a.astype(np.float32)).to(dtype)


def _jnp(a, dtype):
    return jnp.asarray(a.astype(np.float32)).astype(dtype)


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _heads_major(a, heads):
    """[B, T, heads * d] -> [B * heads, T, d] (what ``mha`` feeds the
    Pallas kernel)."""
    B, T_, C = a.shape
    return a.reshape(B, T_, heads, C // heads).transpose(0, 2, 1, 3).reshape(
        B * heads, T_, C // heads)


@pytest.mark.parametrize("Tq,Tk,heads,d,bk", [
    (256, 256, 2, 64, 64),   # self, four key blocks
    (128, 77, 2, 64, 64),    # cross, ragged (masked) last block
    (64, 200, 1, 128, 32),   # d=128, masked tail
    (128, 384, 2, 32, 128),  # three blocks of 128
    # mha's partition (bk=1024), the port's default: two full blocks, and
    # a 1024-key block then a masked ragged one (round_up(1100, 128) = 1152)
    (64, 2048, 2, 64, 1024),
    (128, 2048, 1, 32, 1024),
    (128, 1100, 2, 64, 1024),
    (64, 1100, 1, 32, 1024),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas(Tq, Tk, heads, d, bk, dtype):
    rng = np.random.default_rng(20)
    B, C = 2, heads * d
    tdt, jdt = DTYPES[dtype]
    q = rng.standard_normal((B, Tq, C)) * 1.5
    kv = rng.standard_normal((B, Tk, 2 * C))
    want = jpa.flash_attention(
        _jnp(_heads_major(q, heads), jdt),
        _jnp(_heads_major(kv[..., :C], heads), jdt),
        _jnp(_heads_major(kv[..., C:], heads), jdt), d ** -0.5, bk=bk,
        interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, heads, Tq, d)
    want = want.transpose(0, 2, 1, 3).reshape(B, Tq, C)
    ops.reset_counts()
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0, v_off=C)
    got = tfa.flash_attention_plain(_tensor(q, tdt), _tensor(kv, tdt),
                                    _tensor(kv, tdt), bk=bk, **kw)
    assert got.dtype == tdt and got.shape == (B, Tq, C)
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        vmax = np.abs(_tensor(kv[..., C:], tdt).float().numpy()).max()
        assert err <= 2 * 2.0 ** (np.floor(np.log2(vmax)) - 7), err
        rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-2, rel
        if bk == 1024:  # mha's partition: p rounds against the same maxima
            assert (got.float().numpy() != want).mean() < 0.01
            # which 64-key blocks do not: the check tells partitions apart
            off = tfa.flash_attention_plain(_tensor(q, tdt), _tensor(kv, tdt),
                                            _tensor(kv, tdt), bk=64, **kw)
            assert (off.float().numpy() != want).mean() > 0.05
    if bk == tfa.flash_block_keys(Tk):  # the default: the wrapper's CPU path
        wrapped = tfa.flash_attention(_tensor(q, tdt), _tensor(kv, tdt),
                                      _tensor(kv, tdt), **kw)
        torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
        assert ops.call_counts()["flash_attention"] == 1


def test_chip_smoke_flash_checks():
    """``chip_smoke.py``'s two checks of flash attention fail on a kernel
    that drops the last 64 keys: its comparison with the plain version
    (phase 1 and the card tests), and its ``flash_drops_key_block`` fault,
    which the model's flash sites call in the 1024 px phase."""
    from mixdq_tpu_torch.models import attention as mattn

    smoke = load_smoke()
    g = torch.Generator().manual_seed(0)
    srcs, kw = smoke.attn_case(torch, g, "cpu", 1, 1024, 1024, 2, 64,
                               torch.bfloat16, False)
    want = tfa.flash_attention_plain(*srcs, **kw)
    assert tfa.flash_block_keys(1024) == 1024  # one block by default
    # the same attention summed in other key blocks: sound
    assert smoke.flash_err(torch, tfa.flash_attention_plain(
        *srcs, bk=32, **kw), want) <= 2 ** -6
    sound = mattn.flash_attention
    with smoke.flash_drops_key_block():
        bad = mattn.flash_attention(*srcs, **kw)
    assert mattn.flash_attention is sound
    y, n = srcs[0], 1024 - smoke.FLASH_DROPPED_KEYS
    torch.testing.assert_close(bad, tfa.flash_attention_plain(
        y, y[:, :n], y[:, :n], **kw), rtol=0, atol=0)
    with pytest.raises(AssertionError, match="limit"):
        smoke.flash_err(torch, bad, want)


def test_chip_smoke_flash_sites():
    """``chip_smoke.py``'s per-site flash check on a one-level UNet whose
    64x64 map (C=128 as two heads of 64) takes flash attention at attn1
    in bf16 under ``'auto'``: every flash site passes against the einsum
    chain, and one whose last key block is dropped fails."""
    import dataclasses

    from mixdq_tpu_torch.models.configs import UNetConfig
    from mixdq_tpu_torch.quant.state import FP_CTX

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
    rng = np.random.default_rng(26)
    req = (_tensor(rng.standard_normal((1, 64, 64, 4)), bf16),
           torch.tensor(999.0), _tensor(rng.standard_normal((1, 77, 64)), bf16),
           {"text_embeds": _tensor(rng.standard_normal((1, 32)), bf16),
            "time_ids": torch.tensor([[512.0, 512, 0, 0, 512, 512]],
                                     dtype=bf16)})
    load_smoke().phase_flash_sites(
        torch, unet, dataclasses.replace(FP_CTX, attn_impl="auto"), req)


def _sec_sources(rng, B, Tq, Tk, C, cross):
    """Self: one fused [B, T, 3C] source at 0/C/2C; cross: q [B, Tq, C]
    and a fused to_kv output [B, Tk, 2C] at 0/C with a BoS-like row."""
    if not cross:
        y = rng.standard_normal((B, Tq, 3 * C)) * 1.5
        return (y, y, y), (0, C, 2 * C)
    y = rng.standard_normal((B, Tk, 2 * C))
    y[:, 0] *= 2
    return (rng.standard_normal((B, Tq, C)) * 1.5, y, y), (0, 0, C)


@pytest.mark.parametrize("cross,Tq", [(False, 64), (False, 256),
                                      (True, 128), (True, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sec_attention_plain_vs_pallas(cross, Tq, dtype):
    rng = np.random.default_rng(21)
    B, heads, d = 2, 2, 64
    C = heads * d
    tdt, jdt = DTYPES[dtype]
    srcs, offs = _sec_sources(rng, B, Tq, 77, C, cross)
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, q_off=offs[0],
              k_off=offs[1], v_off=offs[2])
    want = jsa.sec_attention(*(_jnp(a, jdt) for a in srcs),
                             jnp.float32(40.0), jnp.float32(-3.0),
                             interpret=True, **kw)
    ops.reset_counts()
    got = tsa.sec_attention(*(_tensor(a, tdt) for a in srcs), 40.0, -3.0,
                            **kw)
    assert ops.call_counts()["sec_attention"] == 1
    assert got.dtype == torch.int8 and got.shape == (B, Tq, C)
    assert (np.abs(got.numpy().astype(np.int32)) >= 127).mean() < 0.01
    assert_codes_close(got.numpy(), want)


@pytest.mark.parametrize("Tq,C_in,heads", [(64, 128, 2), (256, 256, 4),
                                           (128, 128, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sec_attention_q_plain_vs_pallas(Tq, C_in, heads, dtype):
    rng = np.random.default_rng(22)
    B, d = 2, 64
    C = heads * d
    tdt, jdt = DTYPES[dtype]
    x, wq = codes(rng, B, Tq, C_in), codes(rng, C_in, C)
    # q of about unit size (random codes sum to ~5500 sqrt(C_in))
    sq = ((rng.random(C) + 0.5) / (3000.0 * C_in ** 0.5)).astype(np.float32)
    b0q = (3.0 * wq.astype(np.int32).sum(0)).astype(np.float32)
    y = rng.standard_normal((B, 77, 2 * C))
    y[:, 0] *= 2
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0, v_off=C)
    want = jsa.sec_attention_q(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sq), jnp.asarray(b0q),
        _jnp(y, jdt), _jnp(y, jdt), jnp.float32(40.0), jnp.float32(-2.0),
        interpret=True, **kw)
    ops.reset_counts()
    got = tsa.sec_attention_q(T(x), T(wq), T(sq), T(b0q), _tensor(y, tdt),
                              _tensor(y, tdt), 40.0, -2.0, **kw)
    assert ops.call_counts()["sec_attention_q"] == 1
    assert got.dtype == torch.int8 and got.shape == (B, Tq, C)
    assert (np.abs(got.numpy().astype(np.int32)) >= 127).mean() < 0.01
    assert_codes_close(got.numpy(), want)


#: every attention site of sdxl-turbo (T=1024 C=640, T=256 C=1280) and
#: sdxl (T=4096 C=640, T=1024 C=1280), d=64, Tk=77 at attn2
SDXL_SITES = [(10, 1024, 640), (20, 256, 1280), (10, 4096, 640),
              (20, 1024, 1280)]
GRID = sorted(set(
    [(h, 64, T_, h * 64) for h, T_, _ in SDXL_SITES]
    + [(C // d, d, T_, C) for d, T_, C in itertools.product(
        (16, 32, 64, 128), (256, 1024, 2048, 4096),
        (128, 256, 320, 384, 640, 768, 1024, 1280)) if C % d == 0]
    + [(h, d, T_, 128) for h, d, T_ in itertools.product(
        (1, 2, 3, 5), (32, 64, 80), (72, 100, 4096))]))


@pytest.mark.parametrize("gate", ["sec_attention_ok", "sec_attention_q_ok",
                                  "sec_attention_qkv_ok",
                                  "sec_attention_q_out_ok"])
def test_router_gates_match_jax(gate):
    """The router's copies of the shape gates give the JAX package's
    answer at every shape of the grid, for self (Tk = Tq) and cross
    (Tk = 77) sites, C_in = C and C_in = 2C, fused offsets."""
    mine, theirs = getattr(routing, gate), getattr(jsa, gate)
    n_true = 0
    for heads, d, T_, C in GRID:
        for Tk, C_in in itertools.product((T_, 77), (C, 2 * C)):
            if gate == "sec_attention_ok":
                args = [(heads, d, T_, Tk, *o) for o in
                        ((0, C, 2 * C), (0, 0, C), (0, 0, 0))]
            elif gate == "sec_attention_qkv_ok":
                args = [(heads, d, T_, C_in)]
            else:
                args = [(heads, d, T_, Tk, C_in, 0, C)]
            for a in args:
                want = theirs(*a)
                assert mine(*a) == want, (gate, a)
                n_true += want
    assert n_true > 0  # the grid reaches both answers


def _jax_route(mode, impl, fused, cross, heads, d, Tq, Tk, C_in):
    """The JAX package's choice for one site, in the order its
    ``Attention.__call__`` takes (``mixdq_tpu/models/attention.py``
    :219-279 fused self, :325-395 fused cross, :426-449 sec_attention,
    :474-478 flash), with the gates of ``pallas_sec_attention``."""
    C = heads * d
    offs = ((0, C, 2 * C) if fused and not cross
            else (0, 0, C) if fused else (0, 0, 0))
    int8, auto = mode == "int8", impl == "auto"
    if int8 and auto and fused and not cross and jsa.sec_attention_qkv_ok(
            heads, d, Tq, C_in):
        return "sec_attention_qkv"
    if int8 and auto and fused and cross:
        if jsa.sec_attention_q_out_ok(heads, d, Tq, Tk, C_in, 0, C):
            return "sec_attention_q_out"
        if jsa.sec_attention_q_ok(heads, d, Tq, Tk, C_in, 0, C):
            return "sec_attention_q"
    if int8 and auto and jsa.sec_attention_ok(heads, d, Tq, Tk, *offs):
        return "sec_attention"
    return "flash_attention" if auto and Tq * Tk >= 2 ** 22 else "einsum"


def test_router_routes_match_jax():
    """``attention_route`` against the JAX package's decision over the
    grid, every (mode, attn_impl, fused, self/cross) combination."""
    seen = set()
    for (heads, d, T_, C), mode, impl, fused, cross in itertools.product(
            GRID, ("int8", "fp"), ("auto", "einsum"), (True, False),
            (False, True)):
        if mode == "fp" and fused:
            continue  # the FP UNet has no fused entries
        Tk = 77 if cross else T_
        r = routing.attention_route(mode=mode, attn_impl=impl, fused=fused,
                                    cross=cross, heads=heads, head_dim=d,
                                    Tq=T_, Tk=Tk, C_in=C)
        want = _jax_route(mode, impl, fused, cross, heads, d, T_, Tk, C)
        assert r.kernel == want, (mode, impl, fused, cross, heads, d, T_, C)
        seen.add(r.kernel)
    assert seen == {"sec_attention_qkv", "sec_attention_q_out",
                    "sec_attention_q", "sec_attention", "flash_attention",
                    "einsum"}


def _names(jaxpr):
    """How often each named call (jitted op, named Pallas kernel) appears
    in a printed jaxpr."""
    return collections.Counter(re.findall(r"name=(\w+)", jaxpr))


def test_transformer_auto_sdxl_32x32(interpret):
    """(a) SDXL 1024's 32x32 level: C=1280 as 20 heads of 64, fused. The
    JAX graph runs sec_attention at attn1 and sec_attention_q at attn2;
    the port launches the same two, once each. Each attention module
    runs on the input it had in the JAX run and agrees with its output.
    The whole output is not held: at this width an act code one apart
    upstream (the GroupNorm and LayerNorm codes of two implementations)
    grows through the 5120-wide GEGLU past the tolerance (rel 1.9e-2 in
    a debug run, where each module alone on the JAX input agreed within
    8e-4)."""
    smoke = load_smoke()
    rng = np.random.default_rng(23)
    jm, variables, tm, x, ehs = _transformer_pair(rng, 1280, 20, 64, 1, 64,
                                                  32, 32, 5)
    _, jqp, jaxpr, inter = _jax_auto(jm, variables,
                                     (jnp.asarray(x), jnp.asarray(ehs)),
                                     capture=True)
    names = _names(jaxpr)
    assert names["sec_attention"] == names["sec_attention_q"] == 1
    assert "sec_attention_qkv" not in jaxpr and "lnout" not in jaxpr
    got, calls = _port_auto(tm, jqp, (T(x), T(ehs)))
    assert calls["sec_attention"] == calls["sec_attention_q"] == 1
    assert calls["sec_attention_qkv"] == calls["sec_attention_q_out"] == 0
    assert calls["ln_quantize"] == 3
    ctx = port_auto_ctx(tm, jqp)
    stream = "proj_in"
    for site, enc in (("attn1", None), ("attn2", T(ehs))):
        name = f"transformer_blocks.0.{site}"
        ops.reset_counts()
        out = smoke.attention_site(torch, tm, name, T(inter[stream]), enc,
                                   ctx)
        assert ops.call_counts()["sec_attention" + ("_q" if enc is not None
                                                    else "")] == 1
        assert_int8_close(out - T(inter[stream]), inter[name] - inter[stream])
        stream = name


def test_transformer_auto_flash_64x64(interpret):
    """(b) A 64x64 map at C=128 (2 heads of 64), fused: attn1 runs flash
    attention (T^2 = 2^24) and attn2 the LN-folded sec_attention_q_out.
    The JAX package takes its einsum chain at flash sites on the CPU, so
    this holds the port's flash against that chain, in f32."""
    rng = np.random.default_rng(24)
    jm, variables, tm, x, ehs = _transformer_pair(rng, 128, 2, 64, 1, 64,
                                                  64, 64, 6)
    want, jqp, jaxpr = _jax_auto(jm, variables,
                                 (jnp.asarray(x), jnp.asarray(ehs)))
    assert "sec_attention_q_lnout" in jaxpr
    got, calls = _port_auto(tm, jqp, (T(x), T(ehs)))
    assert calls["flash_attention"] == calls["sec_attention_q_out"] == 1
    assert calls["sec_attention"] == calls["sec_attention_qkv"] == 0
    assert_int8_close(got, want)


def test_transformer_auto_unfused(interpret):
    """(c) ``fuse_qkv=False`` under ``'auto'``: to_q/to_k/to_v, then
    sec_attention at offsets 0/0/0, at both sites, in both packages."""
    rng = np.random.default_rng(25)
    jm, variables, tm, x, ehs = _transformer_pair(rng, 128, 2, 64, 1, 64,
                                                  8, 8, 7, bos=20.0)
    want, jqp, jaxpr = _jax_auto(jm, variables,
                                 (jnp.asarray(x), jnp.asarray(ehs)),
                                 fuse_qkv=False)
    assert _names(jaxpr)["sec_attention"] == 2
    got, calls = _port_auto(tm, jqp, (T(x), T(ehs)), fuse_qkv=False)
    assert calls["sec_attention"] == 2
    assert calls["qmatmul"] == 1 + 4 + 4 + 1 + 1  # proj_in/out, q/k/v/out
    assert_int8_close(got, want)


@pytest.mark.parametrize("tag,impl,mode", [
    ("auto", "auto", "int8"), ("einsum", "einsum", "int8"),
    ("bf16", "auto", "fp")])
def test_sdxl_expected_kernel_calls(tag, impl, mode):
    """SDXL at 1024 px, B=1: 70 transformer blocks, 10 at T=4096 and 60 at
    T=1024; every norm materializes (nothing folds at these shapes) and
    the 60 to_q of the 32x32 level run inside sec_attention_q. The
    counts are ``chip_smoke.py``'s table, which the card's launches are
    held to."""
    cfg = get_family("sdxl").unet
    assert pipeline.expected_kernel_calls(cfg, impl, mode=mode) == \
        load_smoke().SDXL_CALLS[tag]


def test_sdxl_layer_names_meta():
    """The ``sdxl`` family is the SDXL-Turbo UNet at sample_size 128: the
    same 794 quantizable layers."""
    fixture = os.path.join(os.path.dirname(__file__),
                           "fixtures_sdxl_turbo_layers.txt")
    m = UNet2DConditionModel(get_family("sdxl").unet, torch.bfloat16,
                             device="meta")
    assert m.config.sample_size == 128
    assert sorted(quantizable_layers(m)) == sorted(open(fixture).read().split())


def test_sdxl_convert_covers_jax_params():
    """``convert.py`` needs nothing new for ``sdxl``: the JAX package's
    ``sdxl`` UNet params (shapes only, ``jax.eval_shape``) name exactly
    the port's parameters, each at the port's shape."""
    from mixdq_tpu.models.configs import get_family as jax_family
    from mixdq_tpu.models.unet import UNet2DConditionModel as JaxUNet

    from mixdq_tpu_torch import convert

    cfg = jax_family("sdxl").unet
    S = cfg.sample_size
    args = (jnp.zeros((1, S, S, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 77, cfg.cross_attention_dim)),
            {"text_embeds": jnp.zeros((1, get_family("sdxl").pooled_dim)),
             "time_ids": jnp.zeros((1, 6))})
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), *args)
    # one-element leaves, each holding its leaf's index: the converter's
    # names without the 2.6 G values
    leaves, tree = jax.tree_util.tree_flatten(shapes["params"])
    idx = jax.tree_util.tree_unflatten(
        tree, [np.full(1, i, np.float32) for i in range(len(leaves))])
    converted = {k: tuple(leaves[int(v)].shape) for k, v in
                 convert.params_to_state_dict(idx).items()}
    m = UNet2DConditionModel(get_family("sdxl").unet, torch.bfloat16,
                             device="meta")
    assert converted == {k: tuple(v.shape) for k, v in
                         m.state_dict().items()}
