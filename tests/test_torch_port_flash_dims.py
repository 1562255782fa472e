"""The flash kernels of the port at SD1.5's head dims 40 / 80 / 160, on
the CPU: the plain versions of ``flash_attention``,
``int8_flash_attention`` and ``int8qkv_flash_attention`` (which the
wrappers run for CPU tensors) against the JAX package's
``flash_attention`` / ``int8_mha`` / ``int8qkv_mha`` with the Pallas
kernels in interpret mode (which zero-pad d to 128 lanes); the int8
kernels' plan at the padded depths (``int8_flash_plan``, mirror of
``csrc/int8_flash.cu``); the admitted head dims, in the wrappers and in
the CUDA sources; and the router, which sends no SD1.5 site to a
``sec_attention*`` kernel. Inputs come from numpy seeds.

Tolerances: as ``tests/test_torch_port_flash.py`` and
``tests/test_torch_port_int8flash.py``: f32 ``|d| <= 1e-5``; bf16 max
``|d|`` <= 2 bf16 ulps of max ``|ref|`` and ``|d|/|ref| <= 1e-2``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.ops import pallas_attention as jpa  # noqa: E402

from mixdq_tpu_torch import ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models import routing  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.ops import attention as tfa  # noqa: E402
from mixdq_tpu_torch.ops import sec_attention as tsa  # noqa: E402
from tests.test_torch_port_flash import (DTYPES, _heads_major,  # noqa: E402
                                         _jnp, _tensor)

SD15_DIMS = (40, 80, 160)
CSRC = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc")
#: shared memory of one H100 SM, and what one block may take
SM_SMEM, BLOCK_SMEM = 233_472, 232_448
RESERVED = 1024


def _bf16_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7), err
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (Tq, Tk, heads, d): self and cross (the text's 77 keys) at each of
#: SD1.5's head dims, small T
CASES = [(256, 256, 2, 40), (128, 77, 2, 40), (128, 128, 2, 80),
         (64, 77, 1, 80), (64, 64, 1, 160), (64, 77, 2, 160)]


@pytest.mark.parametrize("Tq,Tk,heads,d", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas_sd15_dims(one_thread, Tq, Tk, heads, d,
                                         dtype):
    """``flash_attention`` at d = 40 / 80 / 160 (the wrapper's CPU path,
    its default key blocks) against the Pallas kernel, which pads d to
    128 lanes, at ``mha``'s block of the same keys."""
    rng = np.random.default_rng(60 + d)
    B, C = 2, heads * d
    tdt, jdt = DTYPES[dtype]
    q = rng.standard_normal((B, Tq, C)) * 1.5
    kv = rng.standard_normal((B, Tk, 2 * C))
    bk = tfa.flash_block_keys(Tk)
    want = jpa.flash_attention(
        _jnp(_heads_major(q, heads), jdt),
        _jnp(_heads_major(kv[..., :C], heads), jdt),
        _jnp(_heads_major(kv[..., C:], heads), jdt), d ** -0.5, bk=bk,
        interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, heads, Tq, d)
    want = want.transpose(0, 2, 1, 3).reshape(B, Tq, C)
    ops.reset_counts()
    got = tfa.flash_attention(_tensor(q, tdt), _tensor(kv, tdt),
                              _tensor(kv, tdt), heads=heads, head_dim=d,
                              scale=d ** -0.5, k_off=0, v_off=C)
    assert ops.call_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention"] == 0  # CPU: plain
    assert got.dtype == tdt and got.shape == (B, Tq, C)
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5
    else:
        _bf16_close(got, want)


MODES = {"qk": ("int8_flash_attention", jpa.int8_mha),
         "qkv": ("int8qkv_flash_attention", jpa.int8qkv_mha)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("Tq,Tk,heads,d", [CASES[0], CASES[2], CASES[5]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_flash_plain_vs_pallas_sd15_dims(one_thread, mode, Tq, Tk,
                                              heads, d, dtype):
    """``int8_flash_attention`` / ``int8qkv_flash_attention`` at d = 40 /
    80 / 160 against ``int8_mha`` / ``int8qkv_mha`` (512-key blocks, d
    padded to 128 lanes)."""
    rng = np.random.default_rng(70 + d)
    B, C = 2, heads * d
    tdt, jdt = DTYPES[dtype]
    name, jfn = MODES[mode]
    q = rng.standard_normal((B, Tq, C)) * 1.5
    kv = rng.standard_normal((B, Tk, 2 * C))

    def heads4(a):
        return a.reshape(a.shape[0], a.shape[1], heads, d)
    want = jfn(_jnp(heads4(q), jdt), _jnp(heads4(kv[..., :C]), jdt),
               _jnp(heads4(kv[..., C:]), jdt), d ** -0.5, bk=512,
               out_dtype=jdt, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, Tq, C)
    ops.reset_counts()
    got = getattr(tfa, name)(_tensor(q, tdt), _tensor(kv, tdt),
                             _tensor(kv, tdt), heads=heads, head_dim=d,
                             scale=d ** -0.5, k_off=0, v_off=C)
    assert ops.call_counts()[name] == 1 and ops.launch_counts()[name] == 0
    assert got.dtype == tdt and got.shape == (B, Tq, C)
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("d", SD15_DIMS)
@pytest.mark.parametrize("int8_v", [False, True])
def test_int8_flash_plan_padded_depths(d, int8_v):
    """At d = 40 / 80 / 160 the k code rows are d padded to the m16n8k32
    step (64 / 96 / 160) + 16 bytes, the v rows d padded to 16 (48 / 80
    / 160: codes at k's stride, or bf16 + 8): every row starts on 16 bytes
    an odd multiple of 16 apart (ldmatrix's 8 rows in distinct banks),
    the ring fits a block and the build's blocks fit an SM."""
    dp, dv = tfa.int8_flash_depths(d)
    assert (dp, dv) == {40: (64, 48), 80: (96, 80), 160: (160, 160)}[d]
    plan = tfa.int8_flash_plan(d, int8_v)
    ldk = dp + 16
    ldv = ldk if int8_v else (dv + 8) * 2
    assert plan.stage_bytes == plan.stage_keys * (ldk + ldv)
    assert plan.ring_bytes == plan.stages * plan.stage_bytes <= BLOCK_SMEM
    assert plan.blocks_per_sm * (plan.ring_bytes + RESERVED) <= SM_SMEM
    for ld in (ldk, ldv):
        assert ld % 16 == 0 and (ld // 16) % 2 == 1
        assert len({(r * ld // 16) % 8 for r in range(8)}) == 8
    assert plan.blocks_per_sm == tfa.INT8_FLASH_BLOCKS[d][int(int8_v)]


@pytest.mark.parametrize("d", SD15_DIMS)
def test_padded_output_columns(d):
    """The kernels' stores over the padded PV depth: the bf16 PV's (tile
    dt, columns 2t, 2t+1) and the s8 PV's (``int8_flash.cu``: tile dt the
    even or odd columns of group dt / 2) name each of a row's d columns
    exactly once over the lanes once the pad's columns (>= d) are
    skipped, and the pad's columns are the last DV - d."""
    dv = tfa.int8_flash_depths(d)[1]
    for s8 in (False, True):
        for half in (0, 2):  # rows g and g + 8
            cols = sorted(
                ((dt >> 1) * 16 + 4 * t + 2 * (r & 1) + (dt & 1)) if s8
                else dt * 8 + 2 * t + (r & 1)
                for t in range(4) for dt in range(dv // 8)
                for r in (half, half + 1))
            assert cols == list(range(dv))
            assert [c for c in cols if c < d] == list(range(d))


def test_head_dims_admitted():
    """The flash kernels take ``FLASH_HEAD_DIMS``, and each is a case of
    both CUDA sources' switch; any other d raises, never falls back; the
    ``sec_attention*`` kernels keep their powers of two."""
    assert tfa.FLASH_HEAD_DIMS == (16, 32, 40, 64, 80, 128, 160)
    assert tsa.HEAD_DIMS == (16, 32, 64, 128)
    for src in ("flash_attention.cu", "int8_flash.cu"):
        text = open(os.path.join(CSRC, src)).read()
        cases = tuple(int(x) for x in re.findall(r"case (\d+): return launch",
                                                 text))
        assert cases == tfa.FLASH_HEAD_DIMS, src
    x = torch.zeros(1, 64, 3 * 2 * 48)
    for fn in (tfa.flash_attention, tfa.int8_flash_attention,
               tfa.int8qkv_flash_attention):
        with pytest.raises(ValueError, match="head_dim 48"):
            fn(x, x, x, heads=2, head_dim=48, scale=1.0, k_off=96,
               v_off=192)
    with pytest.raises(ValueError, match="head_dim 48"):
        tfa.int8_flash_plan(48, False)
    y = torch.zeros(1, 64, 3 * 80)
    with pytest.raises(ValueError, match="head_dim 40"):
        tsa.sec_attention(y, y, y, 1.0, 0.0, heads=2, head_dim=40,
                          scale=1.0, k_off=80, v_off=160)


def _sd15_sites():
    cfg = get_family("sd15").unet
    shapes = dict(pipeline._layer_shapes(cfg))
    blocks = sorted({n[:n.index(".", n.index(".transformer_blocks.") + 20)]
                     for n in shapes if ".transformer_blocks." in n})
    return cfg, [(b,) + pipeline._site_shape(cfg, b) for b in blocks]


def test_sd15_sites_never_route_to_sec_attention():
    """Every SD1.5 512 attention site (16 blocks, self and cross; heads of
    40 / 80 / 160, which do not divide 128: ``routing._lanes``) routes to
    flash or einsum under ``'auto'`` for any deploy options; only the
    five attn1 sites of the 64x64 level (T = 4096) run flash, and they
    run int8 flash under ``int8_flash``."""
    cfg, sites = _sd15_sites()
    assert len(sites) == 16
    assert sorted({d for *_, d in sites}) == [40, 80, 160]
    flash = []
    for b, T, heads, d in sites:
        assert not routing._lanes(d, heads)
        for cross in (False, True):
            for out_fuse in (routing.DEFAULT_OUT_FUSE, frozenset(),
                             frozenset({"attn1", "attn2", "ff"})):
                for mode in ("int8", "fp"):
                    r = routing.attention_route(
                        mode=mode, attn_impl="auto", fused=True, cross=cross,
                        heads=heads, head_dim=d, Tq=T,
                        Tk=77 if cross else T, C_in=heads * d,
                        out_fuse=out_fuse)
                    assert r.kernel in (routing.FLASH, routing.EINSUM), r
            if not cross and r.kernel == routing.FLASH:
                flash.append(b)
    assert len(flash) == 5 and all(
        pipeline._site_shape(cfg, b)[0] == 4096 for b in flash)
    sec = {routing.QKV, routing.Q_OUT, routing.SEC_Q, routing.SEC,
           routing.QKV_OUT}
    for kw in ({}, dict(out_fuse=frozenset({"attn1", "attn2", "ff"})),
               dict(mode="fp"), dict(int8_flash="qk"),
               dict(int8_flash="qkv")):
        calls = pipeline.expected_kernel_calls(cfg, "auto", **kw)
        assert not any(calls[k] for k in sec), kw


def test_sd15_w8a8_step_launches():
    """One ``sd15`` 512 W8A8 ``'auto'`` step (``quantize_w8a8``'s deploy):
    5 flash_attention, 49 qconv2d, 3 qconv2d_s2, 45 gn_silu_quantize (no
    producer for the conv proj_in), 48 ln_quantize, 16 geglu_qmatmul, 147
    qmatmul (the 1x1 proj_in / proj_out among them; the 22
    time_emb_proj GEMMs as 3 bank launches), nothing else; the bf16 step
    5 flash; ``int8_flash`` moves the 5 to the int8 kernels."""
    cfg = get_family("sd15").unet
    zero = dict.fromkeys(pipeline.KERNELS, 0)
    want = dict(zero, flash_attention=5, qconv2d=49, qconv2d_s2=3,
                gn_silu_quantize=45, ln_quantize=48, geglu_qmatmul=16,
                qmatmul=147)
    assert pipeline.expected_kernel_calls(cfg, "auto") == want
    assert pipeline.expected_kernel_calls(cfg, "auto", mode="fp") == dict(
        zero, flash_attention=5)
    for mode, k in (("qk", "int8_flash_attention"),
                    ("qkv", "int8qkv_flash_attention")):
        assert pipeline.expected_kernel_calls(
            cfg, "auto", int8_flash=mode) == dict(want, flash_attention=0,
                                                  **{k: 5})
    # explicit attn_impl='flash': every one of the 32 sites
    assert pipeline.expected_kernel_calls(cfg, "flash")[
        "flash_attention"] == 32
