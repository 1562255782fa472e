"""The search's evaluation half against the JAX package, on the CPU: the
FID / CLIP-score math (``utils/fid.py``), the CLIP image tower
(``preprocess_images``, ``CLIPVisionModel``), InceptionV3 (each block and
the whole model) and the two state-dict readers of
``utils/torch_convert.py`` against the JAX converters.

Weights are random from a seed (the repository holds no Inception or CLIP
weights): the JAX params are drawn with numpy at the shapes of
``jax.eval_shape(model.init, ...)`` (a jitted ``init`` of InceptionV3
takes ~20 s here, its ``apply`` ~2 s) and carried into the port by
``convert.params_to_state_dict``. Tolerances: the distance rel 1e-3,
``clip_score`` abs 1e-4, ``preprocess_images`` max |d| <= 1e-5, the CLIP
tower rel 1e-5, each Inception block rel 1e-4, the whole model rel 1e-3
(rel: max |d| / max |ref|); the readers' state dicts equal the JAX
converters' bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import clip as jclip  # noqa: E402
from mixdq_tpu.models import inception as jinc  # noqa: E402
from mixdq_tpu.models.configs import CLIPVisionConfig as JVisionCfg  # noqa
from mixdq_tpu.utils import fid as jfid  # noqa: E402
from mixdq_tpu.utils import torch_convert as jtc  # noqa: E402

from mixdq_tpu_torch.convert import params_to_state_dict  # noqa: E402
from mixdq_tpu_torch.models import clip, inception  # noqa: E402
from mixdq_tpu_torch.models.configs import CLIPVisionConfig  # noqa: E402
from mixdq_tpu_torch.utils import fid  # noqa: E402
from mixdq_tpu_torch.utils.torch_convert import (  # noqa: E402
    load_clip_vision_state_dict, load_inception_state_dict)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the tier-1 run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def numpy_params(model, *args, seed=0, scale=None):
    """Params at the shapes of ``model.init`` (no compile), normal draws
    from ``seed``: kernels N(0, 1/fan_in) (``scale`` overrides), biases
    and raw params N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            std = scale or (1.0 / np.prod(s.shape[:-1])) ** 0.5
            return rng.normal(0, std, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + rng.normal(0, 0.1, s.shape)).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- fid


@pytest.mark.parametrize("n,d", [(200, 64), (16, 64)])
def test_fid_matches_jax(n, d):
    """N = 200 > D and N = 16 < D (rank-deficient covariances, as
    ``evaluate``'s few images give): the distance rel 1e-3, the Gaussians'
    fit and ``clip_score`` against JAX's."""
    rng = np.random.default_rng(n)
    a = rng.normal(0, 1, (n, d)).astype(np.float32)
    b = (rng.normal(0.3, 1.2, (n, d))
         + 0.5 * rng.normal(0, 1, (n, 1))).astype(np.float32)
    want = float(jfid.fid_from_features(jnp.asarray(a), jnp.asarray(b)))
    got = fid.fid_from_features(a, b)
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)
    mu, cov = fid.fit_gaussian(torch.from_numpy(a))
    jmu, jcov = jfid.fit_gaussian(jnp.asarray(a))
    assert rel(mu, jmu) <= 1e-5 and rel(cov, jcov) <= 1e-5
    mu2, cov2 = fid.fit_gaussian(torch.from_numpy(b))
    jd = float(jfid.frechet_distance(jmu, jcov, *jfid.fit_gaussian(
        jnp.asarray(b))))
    assert abs(float(fid.frechet_distance(mu, cov, mu2, cov2)) - jd) <= \
        1e-3 * abs(jd)
    assert abs(fid.clip_score(a, b) - jfid.clip_score(
        jnp.asarray(a), jnp.asarray(b))) <= 1e-4


def test_fid_of_identical_features_is_near_zero():
    feats = np.random.default_rng(1).normal(0, 1, (200, 32)).astype(
        np.float32)
    assert abs(fid.fid_from_features(feats, feats)) < 1e-2


# ---------------------------------------------------------- CLIP tower


@pytest.mark.parametrize("size", [512, 32])
def test_preprocess_images_matches_jax(size):
    """512 -> 224 (antialiased downsampling) and 32 -> 224: max |d| <=
    1e-5."""
    imgs = np.random.default_rng(size).uniform(
        0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jclip.preprocess_images(jnp.asarray(imgs), 224))
    got = clip.preprocess_images(torch.from_numpy(imgs), 224).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    assert np.abs(got - want).max() <= 1e-5


SMALL_VISION = dict(image_size=28, patch_size=14, hidden_size=32,
                    num_layers=2, num_heads=2, intermediate_size=64)


@pytest.mark.parametrize("proj", [16, None])
def test_clip_vision_model_matches_jax(proj):
    """Image 28, patch 14, hidden 32, 2 layers of 2 heads, with and without
    the projection; weights carried from JAX params by
    ``params_to_state_dict``: hidden states and pooled rel 1e-5 (f32)."""
    jm = jclip.CLIPVisionModel(JVisionCfg(**SMALL_VISION,
                                          projection_dim=proj))
    px = np.random.default_rng(3).normal(0, 1, (2, 28, 28, 3)).astype(
        np.float32)
    params = numpy_params(jm, jnp.asarray(px), seed=4)
    want_x, want_p = jm.apply({"params": params}, jnp.asarray(px))
    m = clip.CLIPVisionModel(CLIPVisionConfig(**SMALL_VISION,
                                              projection_dim=proj))
    m.load_state_dict(params_to_state_dict(to_numpy_tree(params)),
                      strict=True)
    with torch.no_grad():
        x, pooled = m(torch.from_numpy(px))
    assert pooled.shape == (2, proj or 32)
    assert rel(x, want_x) <= 1e-5 and rel(pooled, want_p) <= 1e-5


def hf_vision_state_dict(cfg, seed):
    """A random HF ``CLIPVisionModelWithProjection`` state dict of ``cfg``
    (torch layouts), with the ``position_ids`` buffer."""
    g = torch.Generator().manual_seed(seed)
    c, i = cfg.hidden_size, cfg.intermediate_size
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    p = cfg.patch_size

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1
    sd = {"vision_model.embeddings.class_embedding": r(c),
          "vision_model.embeddings.patch_embedding.weight": r(c, 3, p, p),
          "vision_model.embeddings.position_embedding.weight": r(n_pos, c),
          "vision_model.embeddings.position_ids": torch.arange(n_pos)[None],
          "vision_model.pre_layrnorm.weight": 1 + r(c),
          "vision_model.pre_layrnorm.bias": r(c),
          "vision_model.post_layernorm.weight": 1 + r(c),
          "vision_model.post_layernorm.bias": r(c),
          "visual_projection.weight": r(cfg.projection_dim, c)}
    for li in range(cfg.num_layers):
        pre = f"vision_model.encoder.layers.{li}."
        for proj in ("q", "k", "v", "out"):
            sd[pre + f"self_attn.{proj}_proj.weight"] = r(c, c)
            sd[pre + f"self_attn.{proj}_proj.bias"] = r(c)
        sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"] = r(i, c), r(i)
        sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"] = r(c, i), r(c)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = 1 + r(c), r(c)
    return sd


def test_clip_vision_reader_matches_jax_converter():
    """``load_clip_vision_state_dict`` equals ``params_to_state_dict`` of
    JAX's ``convert_clip_vision_state_dict`` bit for bit (the index buffer
    ``position_ids`` skipped by both), and the tower's pooled embedding
    equals JAX's on those params; an unknown leaf raises."""
    cfg = CLIPVisionConfig(**SMALL_VISION, projection_dim=16)
    sd = hf_vision_state_dict(cfg, 5)
    got = load_clip_vision_state_dict(sd)
    params = jtc.convert_clip_vision_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    want = params_to_state_dict(params)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in got)
    m = clip.CLIPVisionModel(cfg)
    m.load_state_dict(got, strict=True)
    px = np.random.default_rng(6).normal(0, 1, (2, 28, 28, 3)).astype(
        np.float32)
    _, want_p = jclip.CLIPVisionModel(JVisionCfg(
        **SMALL_VISION, projection_dim=16)).apply(
        {"params": params}, jnp.asarray(px))
    with torch.no_grad():
        pooled = m(torch.from_numpy(px))[1]
    assert rel(pooled, want_p) <= 1e-5
    with pytest.raises(KeyError, match="logit_scale"):
        load_clip_vision_state_dict({**sd, "logit_scale": torch.ones(())})


# ----------------------------------------------------------- Inception


BLOCKS = [  # (JAX block, port block, input channels)
    ("A", lambda: jinc.InceptionA(32),
     lambda c: inception.InceptionA(c, 32), 16),
    ("B", lambda: jinc.InceptionB(), lambda c: inception.InceptionB(c), 16),
    ("C", lambda: jinc.InceptionC(24),
     lambda c: inception.InceptionC(c, 24), 16),
    ("D", lambda: jinc.InceptionD(), lambda c: inception.InceptionD(c), 16),
    ("E avg", lambda: jinc.InceptionE("avg"),
     lambda c: inception.InceptionE(c, "avg"), 16),
    ("E max", lambda: jinc.InceptionE("max"),
     lambda c: inception.InceptionE(c, "max"), 16),
]


@pytest.mark.parametrize("tag,jblock,block,c", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_inception_block_matches_jax(tag, jblock, block, c):
    """Each block on a [2, 9, 9, 16] input (odd, so the stride-2 branches
    and the pools' borders count) against the JAX block: rel 1e-4."""
    x = np.random.default_rng(7).normal(0, 1, (2, 9, 9, c)).astype(
        np.float32)
    jm = jblock()
    params = numpy_params(jm, jnp.asarray(x), seed=8)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = block(c)
    m.load_state_dict(params_to_state_dict(to_numpy_tree(params)),
                      strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-4


def torchvision_inception_state_dict(seed):
    """A random torchvision ``Inception3`` state dict: every conv of the
    feature path (OIHW, He-scaled) with its BatchNorm's weight, bias and
    running statistics and ``num_batches_tracked``, plus the ``fc`` head
    and an ``AuxLogits`` conv, which the readers skip."""
    shapes = jax.eval_shape(jinc.InceptionV3Features().init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.default_rng(seed)
    sd = {}

    def walk(tree, path):
        if "conv" in tree and "kernel" in tree["conv"]:
            kh, kw, ci, co = tree["conv"]["kernel"].shape
            pre = ".".join(path)
            sd[pre + ".conv.weight"] = rng.normal(
                0, (2.0 / (kh * kw * ci)) ** 0.5, (co, ci, kh, kw))
            sd[pre + ".bn.weight"] = rng.uniform(0.5, 1.5, co)
            sd[pre + ".bn.bias"] = rng.normal(0, 0.1, co)
            sd[pre + ".bn.running_mean"] = rng.normal(0, 0.1, co)
            sd[pre + ".bn.running_var"] = rng.uniform(0.5, 1.5, co)
            return
        for k, v in tree.items():
            walk(v, path + [k])
    walk(shapes, [])
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    for k in [k for k in sd if k.endswith("bn.running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(1)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    return sd


@pytest.fixture(scope="module")
def inception_ref():
    """(torchvision state dict, JAX params from JAX's converter, a [1, 64,
    64, 3] image, the JAX model's features)."""
    sd = torchvision_inception_state_dict(9)
    params = jtc.convert_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    img = np.random.default_rng(10).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    feats = np.asarray(jax.jit(jinc.InceptionV3Features().apply)(
        {"params": params}, jnp.asarray(img)))
    return sd, params, img, feats


def test_inception_features_match_jax(inception_ref):
    """``InceptionV3Features`` whole at B = 1 from a 64x64 input, weights
    carried from the JAX params by ``params_to_state_dict``: [1, 2048],
    rel 1e-3."""
    _, params, img, want = inception_ref
    m = inception.InceptionV3Features()
    m.load_state_dict(params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(img)).numpy()
    assert got.shape == (1, 2048) and np.isfinite(got).all()
    assert rel(got, want) <= 1e-3


def test_inception_reader_matches_jax_converter(inception_ref):
    """``load_inception_state_dict`` folds each conv + bn pair as JAX's
    ``convert_inception_state_dict`` does, bit for bit (``fc``,
    ``AuxLogits`` and ``num_batches_tracked`` skipped by both), so the
    features are the same; an unknown leaf raises."""
    sd, params, img, want = inception_ref
    got = load_inception_state_dict(sd)
    ref = params_to_state_dict(params)
    assert sorted(got) == sorted(ref) and len(got) == 94 * 2
    assert all(torch.equal(got[k], ref[k]) for k in got)
    m = inception.InceptionV3Features()
    m.load_state_dict(got, strict=True)
    with torch.no_grad():
        assert rel(m(torch.from_numpy(img)), want) <= 1e-3
    with pytest.raises(KeyError, match="Mixed_5b.branch1x1.conv.bias"):
        load_inception_state_dict(
            {**sd, "Mixed_5b.branch1x1.conv.bias": torch.zeros(64)})
