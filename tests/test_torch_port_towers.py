"""The port's CLIP text towers, VAE (fp and the int8 decoder), samplers and
tokenizer against the JAX package's, on the same weights (flax params
converted by ``mixdq_tpu_torch.convert``) and the same numpy-seeded
inputs, in float32 on the CPU.

Tolerances: fp towers rel 1e-4 (same math, other summation order); the
int8 decoder: weight codes |diff| <= 1 on < 1%, decode rel <= 1e-2; the
schedules' tables equal in float32, a sampler step within 1e-6. The JAX
int8 decoder runs its plain XLA int8 convs (no interpret mode): the same
conv as its Pallas kernel, on every level.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import configs as jconfigs  # noqa: E402
from mixdq_tpu.models.clip import CLIPTextModel as JCLIP  # noqa: E402
from mixdq_tpu.models.vae import AutoencoderKL as JVAE  # noqa: E402
from mixdq_tpu.pipelines import samplers as jsamplers  # noqa: E402
from mixdq_tpu.quant.state import quantizable_layers as jlayers  # noqa: E402
from mixdq_tpu.quant.vae_quant import (  # noqa: E402
    quantize_vae_decoder as jquantize_vae)
from mixdq_tpu.utils import tokenizer as jtok  # noqa: E402

from mixdq_tpu_torch import convert, ops  # noqa: E402
from mixdq_tpu_torch.models import configs  # noqa: E402
from mixdq_tpu_torch.models.clip import CLIPTextModel  # noqa: E402
from mixdq_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from mixdq_tpu_torch.pipelines import samplers  # noqa: E402
from mixdq_tpu_torch.quant.state import quantizable_layers  # noqa: E402
from mixdq_tpu_torch.quant.vae_quant import (  # noqa: E402
    decoder_kernel_calls, quantize_vae_decoder)
from mixdq_tpu_torch.utils import prompts, tokenizer  # noqa: E402


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


def jvars(params):
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def load(module, params_np):
    module.load_state_dict(convert.params_to_state_dict(params_np),
                           strict=True)
    return module


def T(a):
    return torch.from_numpy(np.array(a))


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# CLIP text towers
# ---------------------------------------------------------------------------

#: a two-layer tower with bigG's activation (exact erf gelu) and projection
GELU_CLIP = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=256, max_position_embeddings=77,
                 projection_dim=48, hidden_act="gelu")
CLIP_CASES = {
    "tiny_clip_quick_gelu": dict(vars(jconfigs.TINY_CLIP)),
    "tiny_clip_2_projection": dict(vars(jconfigs.TINY_CLIP_2)),
    "gelu_projection": GELU_CLIP,
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_clip_text_model_parity(case):
    kw = CLIP_CASES[case]
    rng = np.random.default_rng(0)
    jm = JCLIP(jconfigs.CLIPTextConfig(**kw))
    ids = rng.integers(0, kw["vocab_size"] - 1, (3, 77)).astype(np.int32)
    ids[:, 0] = kw["vocab_size"] - 2
    for b, n in enumerate((5, 30, 76)):  # EOS, then EOS padding
        ids[b, n:] = kw["vocab_size"] - 1
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    params = perturb(np_tree(variables["params"]), rng)
    want = jm.apply(jvars(params), jnp.asarray(ids))

    tm = load(CLIPTextModel(configs.CLIPTextConfig(**kw)), params)
    with torch.no_grad():
        got = tm(T(ids))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-4


def test_sdxl_tower_configs_match_jax():
    """The port's towers and VAE have the JAX package's configurations in
    every family both packages hold."""
    for name in ("sdxl-turbo", "sdxl", "tiny-sdxl"):
        jf, f = jconfigs.get_family(name), configs.get_family(name)
        for field in ("text_encoder", "text_encoder_2", "vae"):
            assert vars(getattr(f, field)) == vars(getattr(jf, field))
        assert (f.is_sdxl, f.default_steps, f.guidance_scale) == (
            jf.is_sdxl, jf.default_steps, jf.guidance_scale)
        assert f.pooled_dim == jf.text_encoder_2.projection_dim
    small = configs.get_family("small-sdxl")
    assert (small.text_encoder.hidden_size
            + small.text_encoder_2.hidden_size
            == small.unet.cross_attention_dim)
    assert (small.pooled_dim + 6 * small.unet.addition_time_embed_dim
            == small.unet.projection_class_embeddings_input_dim)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae():
    """(JAX module, numpy params, port module) of ``TINY_VAE``."""
    rng = np.random.default_rng(1)
    jm = JVAE(jconfigs.TINY_VAE)
    variables = jm.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 32, 32, 3), jnp.float32))
    params = perturb(np_tree(variables["params"]), rng)
    tm = load(AutoencoderKL(configs.TINY_VAE), params)
    return jm, params, tm


def test_vae_layer_names_match_jax(tiny_vae):
    """Every JAX quantizable layer of the VAE is a port quantizable layer
    of the same name, but ``quant_conv`` / ``post_quant_conv``: plain convs
    in both packages (the JAX deploy filters them out by name)."""
    jm, params, tm = tiny_vae
    want = set(jlayers(params)) - {"quant_conv", "post_quant_conv"}
    assert set(quantizable_layers(tm)) == want
    assert "decoder.up_blocks_0_resnets_0.conv1" in want
    assert "decoder.mid_block.attentions.0.to_out.0" in want


def test_vae_decode_encode_parity(tiny_vae):
    jm, params, tm = tiny_vae
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 4, 6, 4)).astype(np.float32) * 0.5
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    want_dec = jm.apply(jvars(params), jnp.asarray(z), method="decode")
    want_enc = jm.apply(jvars(params), jnp.asarray(x), method="encode")
    with torch.no_grad():
        got_dec = tm.decode(T(z))
        got_enc = tm.encode(T(x))
        got_full = tm(T(x))
    assert got_dec.shape == (2, 32, 48, 3)
    assert rel(got_dec, want_dec) < 1e-4
    assert rel(got_enc, want_enc) < 1e-4
    assert rel(got_full, jm.apply(jvars(params), jnp.asarray(x))) < 1e-4


def test_vae_encode_sample_draws_from_generator(tiny_vae):
    _, _, tm = tiny_vae
    x = torch.rand(1, 16, 16, 3) * 2 - 1
    with torch.no_grad():
        a = tm.encode(x, torch.Generator().manual_seed(3))
        b = tm.encode(x, torch.Generator().manual_seed(3))
        mean = tm.encode(x)
    assert torch.equal(a, b) and not torch.equal(a, mean)


def test_quantize_vae_decoder_parity(tiny_vae):
    """The int8 decoder against the JAX one calibrated on the same latents:
    the same layers deployed, weight codes within one code on under 1%,
    the int8 decode within rel 1e-2 of JAX's."""
    jm, params, tm = tiny_vae
    rng = np.random.default_rng(4)
    lat = [rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
           for _ in range(2)]
    z = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jpruned, jctx = jquantize_vae(jm, jvars(params),
                                  [jnp.asarray(x) for x in lat])
    want = jm.apply(jpruned, jnp.asarray(z), jctx, method="decode")

    pruned, ctx = quantize_vae_decoder(tm, [T(x) for x in lat])
    assert sorted(ctx.deploy) == sorted(jctx.deploy)
    assert all(n.startswith("decoder.") for n in ctx.deploy)
    assert ctx.deploy_compute == "int8_sec" and not ctx.bos_aware
    for n, e in ctx.deploy.items():
        d = np.abs(e.w_int.numpy().astype(np.int32)
                   - np.asarray(jctx.deploy[n].w_int).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, n
        assert pruned.get_submodule(n).weight is None
        assert tm.get_submodule(n).weight is not None  # left as it was
    ops.reset_counts()
    with torch.no_grad():
        got = pruned.decode(T(z), ctx)
    assert rel(got, want) <= 1e-2
    calls = decoder_kernel_calls(ctx)
    assert ops.call_counts() == calls
    assert calls["qconv2d"] == sum(e.kind == "conv" and e.w_int.shape[0] == 3
                                   for e in ctx.deploy.values()) > 0


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 4, 30])
def test_euler_schedule_matches_jax(steps):
    js, s = jsamplers.make_euler_schedule(steps), \
        samplers.make_euler_schedule(steps)
    np.testing.assert_array_equal(s.timesteps_array().numpy(),
                                  np.asarray(js.timesteps_array()))
    np.testing.assert_array_equal(s.sigmas_array().numpy(),
                                  np.asarray(js.sigmas_array()))
    assert np.float32(s.init_noise_sigma) == np.float32(js.init_noise_sigma)
    assert s.num_steps == js.num_steps == steps
    if steps == 1:
        assert s.timesteps == (999.0,)


def test_lcm_schedule_matches_jax():
    js, s = jsamplers.make_lcm_schedule(4), samplers.make_lcm_schedule(4)
    np.testing.assert_array_equal(s.timesteps_array().numpy(),
                                  np.asarray(js.timesteps_array()))
    np.testing.assert_array_equal(
        s.alphas_cumprod_array().numpy(),
        np.asarray(js.alphas_cumprod, np.float32))
    np.testing.assert_array_equal(
        s.alphas_cumprod_prev_array().numpy(),
        np.asarray(js.alphas_cumprod_prev, np.float32))
    assert (s.timestep_scaling, s.sigma_data) == (js.timestep_scaling,
                                                  js.sigma_data)


def test_euler_step_matches_jax():
    rng = np.random.default_rng(5)
    x, eps = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
              for _ in range(2))
    js = jsamplers.make_euler_schedule(4)
    sig = np.asarray(js.sigmas_array())
    for i in range(4):
        a, b = jnp.asarray(sig[i]), jnp.asarray(sig[i + 1])
        want_in = jsamplers.euler_scale_model_input(jnp.asarray(x), a)
        want = jsamplers.euler_step(jnp.asarray(x), jnp.asarray(eps), a, b)
        ta, tb = T(sig[i]), T(sig[i + 1])
        got_in = samplers.euler_scale_model_input(T(x), ta)
        got = samplers.euler_step(T(x), T(eps), ta, tb)
        np.testing.assert_allclose(got_in.numpy(), want_in, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, float(sig[i])))


@pytest.mark.parametrize("is_last", [False, True])
def test_lcm_step_matches_jax(is_last):
    rng = np.random.default_rng(6)
    x, eps, nz = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                  for _ in range(3))
    js = jsamplers.make_lcm_schedule(4)
    for i in range(4):
        args = [np.float32(v) for v in (js.alphas_cumprod[i],
                                        js.alphas_cumprod_prev[i],
                                        js.timesteps[i])]
        want = jsamplers.lcm_step(jnp.asarray(x), jnp.asarray(eps),
                                  *map(jnp.asarray, args), jnp.asarray(nz),
                                  is_last=is_last)
        got = samplers.lcm_step(T(x), T(eps), *map(T, args), T(nz),
                                is_last=is_last)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Tokenizer and prompts
# ---------------------------------------------------------------------------


def test_hash_tokenizer_matches_jax():
    texts = prompts.BUILTIN_PROMPTS[:6] + ["", "one"]
    for v in (1000, 49408):
        got = tokenizer.HashTokenizer(vocab_size=v)(texts)
        want = jtok.HashTokenizer(vocab_size=v)(texts)
        assert got.dtype == np.int32 and got.shape == (8, 77)
        np.testing.assert_array_equal(got, want)
    assert isinstance(tokenizer.load_tokenizer(None, 1000),
                      tokenizer.HashTokenizer)


def test_clip_tokenizer_bpe(tmp_path):
    """CLIP BPE on a small vocabulary: the port's ids equal JAX's, BOS /
    EOS framing and EOS padding, merges applied in rank order."""
    vocab = ["<|startoftext|>", "<|endoftext|>", "a</w>", "c", "at</w>",
             "cat</w>", "d", "o", "g</w>", "og</w>", "dog</w>", "!</w>",
             "t</w>", "a"]
    (tmp_path / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\na t</w>\nc at</w>\no g</w>\nd og</w>\n")
    tok = tokenizer.load_tokenizer(str(tmp_path))
    assert isinstance(tok, tokenizer.CLIPTokenizer)
    texts = ["A cat!", "dog  cat", "a " * 100]
    got = tok(texts)
    want = jtok.load_tokenizer(str(tmp_path))(texts)
    np.testing.assert_array_equal(got, want)
    assert got[0, :5].tolist() == [0, 2, 5, 11, 1]
    assert got[1, :4].tolist() == [0, 10, 5, 1]
    assert (got[0, 5:] == 1).all() and got[2, -1] == 1


def test_prompts_match_jax(tmp_path):
    from mixdq_tpu.utils import prompts as jprompts

    assert prompts.BUILTIN_PROMPTS == jprompts.BUILTIN_PROMPTS
    assert prompts.load_prompts(None, 40) == jprompts.load_prompts(None, 40)
    p = tmp_path / "p.txt"
    p.write_text("first\n\nsecond\n")
    assert prompts.load_prompts(str(p)) == ["first", "second"]
