"""The checkpoint converters against the JAX package, on the CPU:
``mixdq_tpu_torch/utils/torch_convert.py`` against
``mixdq_tpu/utils/torch_convert.py`` and the port's
``scripts/convert_checkpoints.py`` against ``scripts/convert_checkpoints.py``.

Synthetic HF state dicts (diffusers / transformers names and layouts:
OIHW convs, ``[out, in]`` linears, norm ``weight``) are made from the
port's own modules' names and shapes at the widths of ``tiny-sdxl`` and
``tiny-sd15`` (UNets), ``tiny-sdxl``'s second text tower (CLIP with its
projection) and its VAE, values drawn with numpy from a seed; each holds
one leaf neither converter knows (logged and skipped by both). Held bit
for bit: each port converter against the JAX converter followed by
``convert.params_to_state_dict`` (and the result loads strictly into the
port's module), ``convert_reference_qparams`` and
``convert_bos_precomputed``, the CLI's output files against the JAX CLI's
byte for byte (a ``.pt`` input and a ``.safetensors`` input written with
``safetensors.numpy``), and the port's ``.safetensors`` reader against
``safetensors``' own. ``fuse_lora_state_dict`` (peft and kohya keys, with
and without ``.alpha``) within rel 1e-6 (the products' sums run in
another order).
"""

import importlib.util
import logging
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safetensors.numpy import load_file as st_load_numpy  # noqa: E402
from safetensors.numpy import save_file as st_save_numpy  # noqa: E402
from safetensors.torch import load_file as st_load_torch  # noqa: E402
from safetensors.torch import save_file as st_save_torch  # noqa: E402

from mixdq_tpu.utils import torch_convert as jtc  # noqa: E402

from mixdq_tpu_torch import convert  # noqa: E402
from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline  # noqa: E402
from mixdq_tpu_torch.quant.checkpoint import (  # noqa: E402
    load_module_params, load_qparams)
from mixdq_tpu_torch.scripts import convert_checkpoints  # noqa: E402
from mixdq_tpu_torch.utils import torch_convert as tc  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")


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


# ------------------------------------------------------ synthetic HF dicts

_VAE_RESNET = re.compile(r"^(encoder|decoder)\.(up|down)_blocks_(\d+)_"
                         r"resnets_(\d+)\.(.+)$")
_VAE_SAMPLER = re.compile(r"^(encoder|decoder)\.(up|down)_blocks_(\d+)_"
                          r"(up|down)sampler\.(weight|bias)$")


def hf_name(kind, name):
    """The public name of the port's parameter ``name``."""
    if kind == "vae":
        m = _VAE_RESNET.match(name)
        if m:
            return "{}.{}_blocks.{}.resnets.{}.{}".format(*m.groups())
        m = _VAE_SAMPLER.match(name)
        if m:
            return "{}.{}_blocks.{}.{}samplers.0.conv.{}".format(*m.groups())
    if kind == "clip":
        if name == "position_embedding":
            return "text_model.embeddings.position_embedding.weight"
        if name.startswith("token_embedding."):
            return "text_model.embeddings." + name
        if name.startswith("final_layer_norm."):
            return "text_model." + name
        m = re.match(r"^layers\.(\d+)\.(fc1|fc2)\.(.+)$", name)
        if m:
            return "text_model.encoder.layers.{}.mlp.{}.{}".format(
                *m.groups())
        if name.startswith("layers."):
            return "text_model.encoder." + name
    return name


def hf_state_dict(kind, module, seed, dtype=np.float32):
    """{public name: numpy array in the public layout}, normal draws, plus
    one leaf no converter knows."""
    rng = np.random.default_rng(seed)
    embeddings = {n for n, m in module.named_modules()
                  if isinstance(m, torch.nn.Embedding)}
    out = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        mod = name.rsplit(".", 1)[0]
        if len(shape) == 4:  # HWIO -> OIHW
            shape = (shape[3], shape[2], shape[0], shape[1])
        elif len(shape) == 2 and mod not in embeddings and \
                name != "position_embedding":
            shape = shape[::-1]  # [in, out] -> [out, in]
        out[hf_name(kind, name)] = rng.normal(0, 0.1, shape).astype(dtype)
    extra = {"unet": "conv_in.running_mean",
             "clip": "text_model.embeddings.position_ids",
             "vae": "decoder.conv_in.num_batches_tracked"}[kind]
    out[extra] = np.arange(4).astype(dtype)
    return out


@pytest.fixture(scope="module")
def modules():
    sdxl = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu")
    sd15 = Text2ImgPipeline("tiny-sd15", torch.float32, "cpu")
    return {"tiny-sdxl unet": ("unet", sdxl.unet),
            "tiny-sd15 unet": ("unet", sd15.unet),
            "tiny-sdxl clip": ("clip", sdxl.text_encoder_2),
            "tiny-sdxl vae": ("vae", sdxl.vae)}


PORT = {"unet": tc.convert_unet_state_dict, "clip": tc.convert_clip_state_dict,
        "vae": tc.convert_vae_state_dict}
JAX = {"unet": jtc.convert_unet_state_dict,
       "clip": jtc.convert_clip_state_dict,
       "vae": jtc.convert_vae_state_dict}


@pytest.mark.parametrize("which", ["tiny-sdxl unet", "tiny-sd15 unet",
                                   "tiny-sdxl clip", "tiny-sdxl vae"])
def test_state_dict_converters_match_jax(modules, which, caplog):
    kind, module = modules[which]
    sd = hf_state_dict(kind, module, seed=len(which))
    want = convert.params_to_state_dict(JAX[kind](sd))
    with caplog.at_level(logging.WARNING):
        got = PORT[kind]({k: torch.from_numpy(v) for k, v in sd.items()})
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].is_contiguous()
        assert torch.equal(got[k], want[k]), k
    assert any("unhandled" in r.getMessage() for r in caplog.records)
    module.load_state_dict(got, strict=True)


# ---------------------------------------------------------------- LoRA


def test_fuse_lora_matches_jax():
    """Peft pairs with and without ``.alpha``, kohya pairs with and
    without, a pair whose base weight is missing, an f16 base weight."""
    rng = np.random.default_rng(0)

    def n(*s, dtype=np.float32):
        return rng.normal(0, 0.1, s).astype(dtype)

    sd = {"a.to_q.weight": n(32, 24), "a.to_k.weight": n(32, 24),
          "b.proj.weight": n(48, 32),
          "b.fc.weight": n(16, 32, dtype=np.float16),
          "c.bias": n(16)}
    lora = {"a.to_q.lora_A.weight": n(4, 24), "a.to_q.lora_B.weight": n(32, 4),
            "a.to_q.alpha": np.float32(8.0),
            "a.to_k.lora_A.weight": n(2, 24), "a.to_k.lora_B.weight": n(32, 2),
            "b.proj.lora_down.weight": n(8, 32),
            "b.proj.lora_up.weight": n(48, 8), "b.proj.alpha": np.float32(4.0),
            "b.fc.lora_down.weight": n(4, 32), "b.fc.lora_up.weight": n(16, 4),
            "d.missing.lora_A.weight": n(4, 8),
            "d.missing.lora_B.weight": n(8, 4)}
    for scale in (1.0, 0.5):
        want = jtc.fuse_lora_state_dict(sd, lora, scale)
        got = tc.fuse_lora_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()},
            {k: torch.as_tensor(v) for k, v in lora.items()}, scale)
        assert list(got) == list(want)
        for k in want:
            g = got[k]
            assert g.dtype == torch.from_numpy(np.asarray(want[k])).dtype, k
            if k == "c.bias":
                assert torch.equal(g, torch.from_numpy(sd[k]))
            else:
                assert rel(g, want[k]) <= 1e-6, k
                assert rel(g, sd[k]) > 1e-3, k  # the pair was fused


# ------------------------------------------------- reference qparams, BoS


def reference_ckpt(rng):
    """A reference ``ckpt.pth`` in miniature: multi-bit weight / act
    quantizers, a split conv's ``_0`` twins, a bare attention quantizer
    with single-bit buffers, and an entry without a delta."""
    def t(*s):
        return torch.from_numpy(rng.uniform(0.01, 0.1, s).astype(np.float32))

    return {
        "model.conv_in.weight_quantizer": [
            {"delta_list": t(3, 8, 1, 1, 1),
             "zero_point_list": torch.zeros(3, 8, 1, 1, 1)}, {}],
        "model.conv_in.act_quantizer": [
            {"delta_list": t(3, 1), "zero_point_list": t(3, 1) * 1000}, {}],
        "model.up_blocks.0.resnets.0.conv_shortcut.weight_quantizer": [
            {"delta_list": t(3, 16, 1, 1, 1),
             "zero_point_list": torch.zeros(3, 16, 1, 1, 1)}, {}],
        "model.up_blocks.0.resnets.0.conv_shortcut.weight_quantizer_0": [
            {"delta_list": t(3, 16, 1, 1, 1),
             "zero_point_list": torch.zeros(3, 16, 1, 1, 1)}, {}],
        "model.up_blocks.0.resnets.0.conv_shortcut.act_quantizer": [
            {"delta_list": t(3, 1), "zero_point_list": t(3, 1) * 1000}, {}],
        "model.up_blocks.0.resnets.0.conv_shortcut.act_quantizer_0": [
            {"delta_list": t(3, 1), "zero_point_list": t(3, 1) * 1000}, {}],
        "model.mid_block.attentions.0.transformer_blocks.0.attn1."
        "act_quantizer_q": [{"delta": t(1), "zero_point": t(1) * 1000}, {}],
        "model.time_embedding.linear_1.act_quantizer": [{"x_min": t(1)}, {}],
    }


def test_reference_qparams_match_jax():
    ckpt = reference_ckpt(np.random.default_rng(1))
    jckpt = {k: [{b: v.numpy() for b, v in e[0].items()}, {}]
             for k, e in ckpt.items()}
    want = jtc.convert_reference_qparams(jckpt)
    got = tc.convert_reference_qparams(ckpt)
    assert list(got) == list(want) and len(got) == 3
    for n in want:
        for f in convert._QP_FIELDS:
            w, g = getattr(want[n], f), getattr(got[n], f)
            assert (w is None) == (g is None), (n, f)
            if w is not None:
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bos_precomputed_matches_jax():
    rng = np.random.default_rng(2)
    d = {f"model.down_blocks.1.attentions.0.transformer_blocks.0.attn2."
         f"to_{x}": torch.from_numpy(rng.normal(0, 1, (1, 1, 64)).astype(
             np.float16)) for x in "kv"}
    want = jtc.convert_bos_precomputed({k: v.numpy() for k, v in d.items()})
    got = tc.convert_bos_precomputed(d)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == (1, 64)
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    bad = {"model.mid_block.attentions.0.transformer_blocks.0.attn1.to_k":
           d[next(iter(d))]}
    with pytest.raises(ValueError, match="BoS"):
        tc.convert_bos_precomputed(bad)
    with pytest.raises(ValueError, match="BoS"):
        jtc.convert_bos_precomputed({k: v.numpy() for k, v in bad.items()})


# ---------------------------------------------------------------- .safetensors


def test_safetensors_reader(tmp_path):
    """The port's reader against ``safetensors``' own: every dtype the
    port reads (bf16 through ``safetensors.torch``), a 0-d and an empty
    tensor, the order of the data."""
    rng = np.random.default_rng(3)
    arrays = {"z.f32": rng.normal(0, 1, (3, 5)).astype(np.float32),
              "a.f16": rng.normal(0, 1, (7,)).astype(np.float16),
              "m.f64": rng.normal(0, 1, (2, 2)).astype(np.float64),
              "i64": np.arange(5, dtype=np.int64),
              "i32": np.arange(-3, 3, dtype=np.int32),
              "i16": np.arange(4, dtype=np.int16),
              "i8": np.arange(-4, 4, dtype=np.int8),
              "u8": np.arange(6, dtype=np.uint8),
              "flag": np.array([True, False, True]),
              "scalar": np.array(2.5, np.float32),
              "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "np.safetensors")
    st_save_numpy(arrays, path, metadata={"format": "np"})
    want = st_load_numpy(path)
    got = tc.load_safetensors(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].numpy().dtype == want[k].dtype, k
    path = str(tmp_path / "bf16.safetensors")
    st_save_torch({"w": torch.randn(4, 6, dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(
                                        0))}, path)
    got, want = tc.load_safetensors(path), st_load_torch(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            want["w"])


# ---------------------------------------------------------------- the CLI


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_convert_checkpoints",
        os.path.join(REPO, "scripts", "convert_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_both(monkeypatch, tmp_path, mode, inp):
    """The JAX CLI and the port's on ``inp``: (port result, port bytes,
    JAX bytes)."""
    jout, out = str(tmp_path / f"jax_{mode}.msgpack"), \
        str(tmp_path / f"port_{mode}.msgpack")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoints.py", "--mode",
                                      mode, "--input", inp, "--output", jout])
    _jax_cli().main()
    res = convert_checkpoints.main(["--mode", mode, "--input", inp,
                                    "--output", out])
    with open(out, "rb") as f, open(jout, "rb") as g:
        return res, f.read(), g.read()


def test_cli_matches_jax_bytes(modules, tmp_path, monkeypatch):
    """``--mode qparams`` from a ``.pt``; ``--mode unet`` from a ``.pt``
    (float32) and from a ``.safetensors`` (float16 kept); ``clip`` and
    ``vae`` from ``.safetensors``. Each file reads back into the port:
    ``load_qparams``, or ``load_module_params`` into the module (equal to
    the converter's state dict)."""
    pt = str(tmp_path / "ckpt.pth")
    ckpt = reference_ckpt(np.random.default_rng(4))
    torch.save(ckpt, pt)
    res, got, want = run_both(monkeypatch, tmp_path, "qparams", pt)
    assert got == want and res["n"] == 3
    back = load_qparams(res["output"])
    assert sorted(back) == sorted(res["qparams"])

    kind, unet = modules["tiny-sdxl unet"]
    sd = hf_state_dict(kind, unet, seed=5)
    pt = str(tmp_path / "unet.bin")
    torch.save({k: torch.from_numpy(v.astype(np.float16))
                for k, v in sd.items()}, pt)
    res, got, want = run_both(monkeypatch, tmp_path, "unet", pt)
    assert got == want
    for k, v in res["params"]["conv_in"].items():
        assert v.dtype == torch.float32, k

    for which, dtype in (("tiny-sdxl unet", np.float16),
                         ("tiny-sdxl clip", np.float32),
                         ("tiny-sdxl vae", np.float32)):
        kind, module = modules[which]
        sd = hf_state_dict(kind, module, seed=6, dtype=dtype)
        path = str(tmp_path / f"{kind}.safetensors")
        st_save_numpy(sd, path)
        res, got, want = run_both(monkeypatch, tmp_path, kind, path)
        assert got == want, which
        load_module_params(module, res["output"])
        ref = PORT[kind](st_load_numpy(path))
        for k, v in module.state_dict().items():
            assert torch.equal(v, ref[k].to(v.dtype)), (which, k)
