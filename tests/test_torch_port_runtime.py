"""The port's native host runtime and deploy container
(``mixdq_tpu_torch/runtime/``) against the JAX package's
(``mixdq_tpu/runtime/``) on the CPU:

* the native ``pack_int4`` / ``unpack_int4`` / ``quantize_per_channel``
  (built with g++ into ``runtime/build/``) equal their numpy plain
  versions and JAX's, byte for byte; a build that fails raises (JAX falls
  back to numpy);
* ``save_tensors`` writes the bytes JAX's writes for the same tensors
  (f32, int8 packed and not, 0-d), and each package reads the other's
  file; bf16 round-trips in the port (JAX's writer cannot take it);
* the deploy container: the port's tiny-sdxl W8A8 deploy (fused QKV /
  KV, split convs, a W4 layer packed) round-trips field for field,
  ``bos_w`` attached again, and its step equals the in-memory step bit
  for bit; JAX reads the port's file and the port JAX's (its int4 fields
  as int8 codes); an entry with a field the format cannot hold raises,
  naming the layer and the field.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mixdq_tpu import runtime as jruntime  # noqa: E402
from mixdq_tpu.quant.deploy import DeployEntry as JEntry  # noqa: E402
from mixdq_tpu.runtime import tensorstore as jts  # noqa: E402

from mixdq_tpu_torch import pipeline, runtime  # noqa: E402
from mixdq_tpu_torch.models.unet import conv_shortcut_splits  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.deploy import (DeployEntry,  # noqa: E402
                                          deploy_unet_ctx)
from mixdq_tpu_torch.quant.state import (quantizable_layers,  # noqa: E402
                                         uniform_ctrl)
from mixdq_tpu_torch.runtime import tensorstore  # noqa: E402


@pytest.mark.parametrize("n", [16, 17, 1023])
def test_pack_unpack_int4_match_plain_and_jax(n):
    codes = np.random.default_rng(n).integers(-8, 8, n).astype(np.int8)
    packed = runtime.pack_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.numel() == (n + 1) // 2
    assert np.array_equal(packed.numpy(), runtime.pack_int4_plain(codes))
    assert np.array_equal(packed.numpy(), jruntime.pack_int4(codes))
    back = runtime.unpack_int4(packed, n)
    assert np.array_equal(back.numpy(), codes)
    assert np.array_equal(runtime.unpack_int4_plain(packed.numpy(), n), codes)
    assert np.array_equal(jruntime.unpack_int4(packed.numpy(), n), codes)


@pytest.mark.parametrize("n_bits", [8, 4])
def test_quantize_per_channel_matches_plain_and_jax(n_bits):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32)
    delta = ((rng.random(32) + 0.5) * 0.05).astype(np.float32)
    # values on the rounding edges: half to even, as np.round
    w[0, 0, 0, :4] = delta[:4] * np.float32(2.5)
    got = runtime.quantize_per_channel(torch.from_numpy(w),
                                       torch.from_numpy(delta), n_bits)
    assert got.shape == w.shape and got.dtype == torch.int8
    want = runtime.quantize_per_channel_plain(w, delta, n_bits)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jruntime.quantize_per_channel(w, delta,
                                                              n_bits))
    assert np.array_equal(got[0, 0, 0, :4].numpy(), [2] * 4)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SRC", str(bad))
    monkeypatch.setattr(runtime, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.pack_int4(torch.zeros(4, dtype=torch.int8))


def _tensors():
    rng = np.random.default_rng(3)
    return {
        "a::w_int": rng.integers(-8, 8, (5, 7)).astype(np.int8),
        "b::scale": rng.random(7).astype(np.float32),
        "c": rng.standard_normal((3, 3, 2)).astype(np.float32),
        "d::scale_inv": np.asarray(np.float32(10.5)),
        "f::w_int": rng.integers(-128, 128, (9,)).astype(np.int8),
    }


def test_tensorstore_same_bytes_both_ways(tmp_path):
    tensors = _tensors()
    jp, tp = str(tmp_path / "jax.mixdq"), str(tmp_path / "port.mixdq")
    jts.save_tensors(tensors, jp, pack4_names={"a::w_int"})
    tensorstore.save_tensors({k: torch.from_numpy(v) for k, v in
                              tensors.items()}, tp, pack4_names={"a::w_int"})
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    for mmap in (True, False):
        got = tensorstore.load_tensors(jp, mmap=mmap)
        assert list(got) == list(tensors)
        for k, v in tensors.items():
            assert torch.equal(got[k], torch.from_numpy(v)), k
    back = jts.load_tensors(tp)
    for k, v in tensors.items():
        assert np.array_equal(np.asarray(back[k]), v), k
    # bf16 (which JAX's writer cannot take: ``memoryview`` of ml_dtypes)
    bf = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tensorstore.save_tensors({"e": bf}, tp)
    assert torch.equal(tensorstore.load_tensors(tp)["e"], bf)


@pytest.fixture(scope="module")
def tiny_deploy():
    """The tiny UNet, its calibration batch and its W8A8 deploy with
    fused QKV / KV and split convs, ``bos_w`` attached."""
    torch.manual_seed(0)
    unet = pipeline.build_unet("tiny-sdxl", 0, torch.float32, "cpu")
    calib = pipeline.example_inputs("tiny-sdxl", 1, 0, torch.float32, "cpu")
    splits = conv_shortcut_splits(unet.config)
    qparams = calibrate(unet, [calib], pipeline.WQ, pipeline.AQ,
                        splits=splits)
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=8, a_bits=8)
    ctx = deploy_unet_ctx(unet, qparams, ctrl, pipeline.WQ, fuse_qkv=True,
                          splits=splits)
    return unet, calib, dataclasses.replace(ctx, attn_impl="auto")


def _fields(e, prefix=""):
    out = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, DeployEntry):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def test_deploy_round_trip(tiny_deploy, tmp_path):
    unet, calib, ctx = tiny_deploy
    deploy = ctx.deploy
    kinds = {e.kind for e in deploy.values()}
    assert {"linear", "conv", "conv_split", "fused_away"} <= kinds
    assert any(e.bos_w is not None for e in deploy.values())
    # a 4-bit layer stored packed
    w4 = "down_blocks.1.resnets.0.conv1"
    deploy = dict(deploy)
    deploy[w4] = deploy[w4].replace(w_int=deploy[w4].w_int.clamp(-8, 7))
    p = str(tmp_path / "deploy.mixdq")
    tensorstore.save_deploy_ckpt(deploy, p, w4_layers={w4})
    index = tensorstore.load_tensors(p)
    assert index[f"{w4}::w_int"].dtype == torch.int8
    back = tensorstore.load_deploy_ckpt(p)
    assert list(back) == list(deploy)
    for name, e in deploy.items():
        a, b = _fields(e), _fields(back[name])
        assert a.keys() == b.keys()
        for f, v in a.items():
            w = b[f]
            if isinstance(v, torch.Tensor):
                assert w.dtype == v.dtype and torch.equal(w, v), (name, f)
            else:
                assert w == v and type(w) is type(v), (name, f)
    # the loaded deploy's step equals the in-memory one's
    with torch.inference_mode():
        want = unet(*calib, ctx=dataclasses.replace(ctx, deploy=deploy))
        got = unet(*calib, ctx=dataclasses.replace(ctx, deploy=back))
    assert torch.equal(got, want)


def test_deploy_files_between_packages(tiny_deploy, tmp_path):
    """JAX reads the port's deploy file; the port reads JAX's, int4 codes
    back as int8."""
    deploy = tiny_deploy[2].deploy
    p = str(tmp_path / "port.mixdq")
    tensorstore.save_deploy_ckpt(deploy, p)
    jback = jts.load_deploy_ckpt(p)
    assert list(jback) == list(deploy)
    for name, e in deploy.items():
        je = jback[name]
        assert (je.kind, je.split) == (e.kind, e.split)
        parts = [(e, je)] + ([(e.part0, je.part0), (e.part1, je.part1)]
                             if e.part0 is not None else [])
        for pe, pj in parts:
            for f in tensorstore.DEPLOY_FIELDS:
                v = getattr(pe, f)
                if v is None:
                    assert getattr(pj, f) is None
                    continue
                v = np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                               else np.float32(v))
                assert np.array_equal(np.asarray(getattr(pj, f)), v), (name,
                                                                       f)

    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (16, 8)).astype(np.int8)
    e = JEntry(kind="linear", w_int=jnp.asarray(codes, jnp.int4),
               scale=jnp.ones(8), bias0=jnp.zeros(8),
               scale_inv=jnp.float32(10.0), zp_shifted=jnp.float32(-3.0))
    sp = JEntry(kind="conv_split", split=4, part0=e, part1=e)
    jp = str(tmp_path / "jax.mixdq")
    jts.save_deploy_ckpt({"lin": e, "conv": sp}, jp)
    back = tensorstore.load_deploy_ckpt(jp)
    assert back["lin"].w_int.dtype == torch.int8
    assert np.array_equal(back["lin"].w_int.numpy(), codes)
    assert back["lin"].scale_inv == 10.0 and back["lin"].zp_shifted == -3.0
    assert back["conv"].kind == "conv_split" and back["conv"].split == 4
    assert np.array_equal(back["conv"].part1.w_int.numpy(), codes)


@pytest.mark.parametrize("field, value", [
    ("w_packed", torch.zeros(4, 8, dtype=torch.uint8)),
    ("bos_out", torch.zeros(1, 8)),
    ("a_bits", 4),
    ("act_off", True),
])
def test_fields_the_format_cannot_hold_raise(tmp_path, field, value):
    e = DeployEntry(w_int=torch.zeros(8, 8, dtype=torch.int8),
                    scale=torch.ones(8), bias0=torch.zeros(8),
                    scale_inv=1.0, zp_shifted=0.0)
    sp = DeployEntry(kind="conv_split", split=4, part0=e,
                     part1=e.replace(**{field: value}))
    with pytest.raises(ValueError, match=f"blocks.0.conv::part1: field "
                                         f"{field}"):
        tensorstore.save_deploy_ckpt({"blocks.0.conv": sp},
                                     str(tmp_path / "x.mixdq"))
