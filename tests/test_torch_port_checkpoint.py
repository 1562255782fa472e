"""The port's checkpoint files (``mixdq_tpu_torch/quant/checkpoint.py`` on
its own msgpack codec, ``utils/msgpack.py``) against flax's and the JAX
package's, on the CPU.

* qparams of a tiny-sdxl calibration with channel splits: flax's file
  reads in the port equal bit for bit, the port writes the same bytes as
  ``mixdq_tpu.quant.checkpoint.save_qparams``, and JAX reads the port's
  file equal;
* leaves flax writes: a bfloat16 array, numpy scalars, chunked arrays
  (``MAX_CHUNK_SIZE`` set small inside the test), both ways, same bytes;
* params of the tiny pipeline both ways: JAX's file loads into the port's
  pipeline, whose images match JAX's within rel 1e-2 (the pipelines'
  tolerance, PERF.md section 2); the port's file restores in JAX's
  ``load_params`` leaf for leaf and is the file JAX writes for the same
  params, byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from mixdq_tpu.models.configs import TINY_SDXL_UNET  # noqa: E402
from mixdq_tpu.models.unet import conv_shortcut_splits  # noqa: E402
from mixdq_tpu.pipelines.txt2img import (  # noqa: E402
    Text2ImgPipeline as JPipeline)
from mixdq_tpu.quant import calibrate as jcal  # noqa: E402
from mixdq_tpu.quant import checkpoint as jck  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402
from mixdq_tpu.quant.state import quantizable_layers as jlayers  # noqa: E402

from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline  # noqa: E402
from mixdq_tpu_torch.quant import checkpoint as ck  # noqa: E402
from mixdq_tpu_torch.quant.state import LayerQParams  # noqa: E402
from mixdq_tpu_torch.utils import msgpack  # noqa: E402

FIELDS = [f for f in LayerQParams.__dataclass_fields__]


@pytest.fixture(scope="module")
def jax_pipeline():
    """The JAX tiny-sdxl pipeline (float32) and its params."""
    jp = JPipeline("tiny-sdxl", dtype=jnp.float32)
    return jp, jp.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_qparams(jax_pipeline):
    """A calibration of the pipeline's tiny-sdxl UNet with the channel
    splits (JAX)."""
    jp, params = jax_pipeline
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    b0 = (jax.random.normal(k[0], (1, 16, 16, 4)), jnp.full((1,), 999.0),
          jax.random.normal(k[1], (1, 77, 128)),
          {"text_embeds": jax.random.normal(k[2], (1, 64)),
           "time_ids": jnp.ones((1, 6))})
    names = jlayers(params["unet"])
    splits = {n: s for n, s in conv_shortcut_splits(TINY_SDXL_UNET).items()
              if n in names}
    q = jcal.calibrate(jp.unet, {"params": params["unet"]}, [b0],
                       JSpec(sym=True, channel_wise=True, round_mode="nearest"),
                       JSpec(running_stat=True), splits=splits)
    assert sum(q[n].w0_delta is not None for n in splits) == len(splits) == 6
    return q


def to_port(jq):
    """The JAX qparams as the port's, fields as CPU tensors, same order."""
    return {n: LayerQParams(**{f: (None if getattr(qp, f) is None else
                                   torch.from_numpy(np.array(getattr(qp, f))))
                               for f in FIELDS})
            for n, qp in jq.items()}


def assert_qparams_bits(got, jq):
    assert list(got) == list(jq)
    for n, qp in jq.items():
        for f in FIELDS:
            want, g = getattr(qp, f), getattr(got[n], f)
            assert (want is None) == (g is None), (n, f)
            if want is not None:
                want = np.asarray(want)
                assert g.dtype == torch.float32 and tuple(g.shape) == \
                    want.shape, (n, f)
                assert g.numpy().tobytes() == want.tobytes(), (n, f)


def test_flax_qparams_file_reads_bit_for_bit(jax_qparams, tmp_path):
    path = str(tmp_path / "q.msgpack")
    jck.save_qparams(jax_qparams, path)
    got = ck.load_qparams(path)
    want = {n: jax_qparams[n] for n in sorted(jax_qparams)}  # flax sorts
    assert_qparams_bits(got, want)
    twins = [n for n, q in got.items() if q.w0_delta is not None]
    assert len(twins) == 6 and all(got[n].a0_delta is not None
                                   for n in twins)


def test_port_qparams_file_is_flax_bytes(jax_qparams, tmp_path):
    jpath, ppath = str(tmp_path / "j.msgpack"), str(tmp_path / "p.msgpack")
    jck.save_qparams(jax_qparams, jpath)
    ck.save_qparams(to_port(jax_qparams), ppath)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    # and JAX reads the port's file back equal
    back = jck.load_qparams(ppath)
    assert_qparams_bits(to_port(back), {n: jax_qparams[n] for n in back})
    assert set(back) == set(jax_qparams)


def _port_tree(tree):
    """A flax-side tree with its arrays as CPU tensors (bfloat16 through
    its int16 bits), its maps in sorted key order as ``msgpack_serialize``
    writes them."""
    if isinstance(tree, dict):
        return {k: _port_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_port_tree(v) for v in tree]
    if isinstance(tree, jax.Array):
        a = np.asarray(tree)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


def _packed(tree):
    out = []
    msgpack.pack(tree, out.append)
    return b"".join(bytes(b) for b in out)


@pytest.mark.parametrize("case", ["bfloat16", "np_scalar", "chunked"])
def test_msgpack_leaves_both_ways(case, monkeypatch):
    rng = np.random.default_rng(4)
    if case == "bfloat16":
        tree = {"w": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
                "b": np.arange(4, dtype=np.int8)}
    elif case == "np_scalar":
        tree = {"s": np.float32(1.25), "i": np.int32(-7),
                "v": np.array(3.0, np.float32)}
    else:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 16)
        tree = {"big": rng.standard_normal((7, 5)).astype(np.float32),
                "small": rng.standard_normal(3).astype(np.float32),
                "nest": {"w": np.arange(50, dtype=np.int16)}}
    data = serialization.msgpack_serialize(tree)
    got = msgpack.unpack(data)
    for k, want in tree.items():
        g = got[k]
        if isinstance(want, dict):
            want, g = want["w"], g["w"]
        assert isinstance(g, torch.Tensor)
        a = np.asarray(want)
        if a.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert tuple(g.shape) == a.shape and np.array_equal(g.numpy(), a)
    assert _packed(_port_tree(tree)) == data
    back = serialization.msgpack_restore(_packed(_port_tree(tree)))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, tree))


def test_msgpack_base_types_are_flax_bytes():
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                     -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
            "floats": [0.5, -1e300], "none": None, "flags": [True, False],
            "s": "x" * 31, "t": "y" * 40, "u": "z" * 300, "bin": b"ab",
            "map": {str(i): i for i in range(17)}}
    data = serialization.msgpack_serialize(tree)
    assert _packed(_port_tree(tree)) == data
    assert msgpack.unpack(data) == tree


def test_jax_params_load_into_port_pipeline(jax_pipeline, tmp_path):
    jp, params = jax_pipeline
    path = str(tmp_path / "params.msgpack")
    jck.save_params(params, path)
    p = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu")
    ck.load_params(p, path)
    prompts = ["a red cube on a table", "a cat"]
    key = jax.random.PRNGKey(5)
    want = jp(params, prompts, key, num_inference_steps=1,
              guidance_scale=0.0)
    noise = jax.random.normal(jax.random.split(key)[0], (2, 16, 16, 4),
                              jnp.float32)
    got = p(prompts, num_inference_steps=1, guidance_scale=0.0,
            noise=torch.from_numpy(np.array(noise)))
    assert got.images.shape == (2, 128, 128, 3)
    rel = (np.linalg.norm(got.images - want.images)
           / np.linalg.norm(want.images))
    assert rel <= 1e-2, rel


def test_port_params_restore_in_jax(jax_pipeline, tmp_path):
    jp, template = jax_pipeline
    p = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu").init_weights(7)
    path = str(tmp_path / "port.msgpack")
    ck.save_params(p, path)
    restored = jck.load_params(template, path)
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        want = ck.module_params(getattr(p, part))
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_r = dict(jax.tree_util.tree_leaves_with_path(restored[part]))
        assert len(flat_w) == len(flat_r)
        for k, v in flat_w:
            r = np.asarray(flat_r[k])
            assert r.dtype == np.float32 and np.array_equal(r, v.numpy()), k
    jpath = str(tmp_path / "jax.msgpack")
    jck.save_params(restored, jpath)
    assert open(jpath, "rb").read() == open(path, "rb").read()
