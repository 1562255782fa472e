"""The port's PTQ flow through files ending in the fake-quant simulation,
on the CPU: ``gen_calib_data`` -> ``ptq`` -> ``quant_txt2img`` (its
default ``--backend fake``) on ``configs/tiny.yaml`` (calibration data
in a temporary directory), then again on a copy of the config with
``quant.softmax.enabled: true`` (q/k/v/softmax act quantizers on).

Each run's PNGs are held against the JAX pipeline's sampler program on
the same weights, the same qparams file (read by the JAX package), the
same prompt embeddings and initial noise, under the context the JAX
script's ``build_quant_ctx`` builds, decoded by the port's VAE and
written to uint8 as the JAX script writes them (``(x * 255)``
truncated), by ``tests/test_torch_port_fake_model.py``'s code criterion:
the act codes of every quantized layer of the UNet step agree in call
order until the first layer where they differ, and there by at most 1 on
under 1% of them; where every code agrees, the images within rel 1e-2
(PERF.md section 2's pipeline tolerance). One flipped code moves the
tiny pipeline's images by about rel 1e-2 (its one Euler step from the
largest sigma subtracts two near values). The softmax run's qparams
file, ``act_quantizer_*`` entries included, equals byte for byte the JAX
package's ``save_qparams`` of the same values (its calibration is held
against JAX's in ``tests/test_torch_port_fake_model.py``).
"""

import argparse
import importlib.util
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.pipelines import samplers as jsamplers  # noqa: E402
from mixdq_tpu.pipelines.txt2img import (  # noqa: E402
    Text2ImgPipeline as JPipeline)
from mixdq_tpu.quant import checkpoint as jckpt  # noqa: E402
from mixdq_tpu.utils.config import load_config as jload_config  # noqa: E402

from mixdq_tpu_torch.quant import checkpoint, state  # noqa: E402
from mixdq_tpu_torch.scripts import (gen_calib_data, ptq,  # noqa: E402
                                     quant_txt2img)
from mixdq_tpu_torch.utils.config import (load_config, merge,  # noqa: E402
                                          save_config)
from mixdq_tpu_torch.utils.prompts import load_prompts  # noqa: E402
from tests.test_torch_port_fake_model import (  # noqa: E402
    first_code_difference, recorded_run)

REPO = os.path.join(os.path.dirname(__file__), "..")
N_IMAGES, BATCH, SEED = 2, 2, 42


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """Both runs of the three CLIs in one temporary directory; the root
    logger is put back as it was afterwards (the CLIs point it at their
    run.log)."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    tmp = tmp_path_factory.mktemp("fake_flow")
    cfg = merge(load_config(os.path.join(REPO, "configs", "tiny.yaml")),
                {"calib_data": {"path": str(tmp / "calib.npz")}})
    runs = {}
    try:
        for tag, extra in (("plain", {}),
                           ("softmax", {"quant": {"softmax": {
                               "enabled": True}}})):
            c = merge(cfg, extra)
            path = str(tmp / f"tiny_{tag}.yaml")
            save_config(c, path)
            if tag == "plain":
                gen_calib_data.main(["--config", path, "--device", "cpu"])
            exp = str(tmp / f"exp_{tag}")
            res = ptq.main(["--config", path, "--outdir", exp,
                            "--device", "cpu"])
            out = quant_txt2img.main([
                "--base_path", exp, "--device", "cpu", "--n_images",
                str(N_IMAGES), "--batch_size", str(BATCH), "--seed",
                str(SEED)])
            runs[tag] = dict(cfg=c, path=path, exp=exp, res=res, out=out)
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    return runs


@pytest.fixture(scope="module")
def jpipe():
    """One JAX tiny pipeline for both runs (its encode and decode
    programs compiled once)."""
    return JPipeline("tiny-sdxl", dtype=jnp.float32)


def jax_images(run, jp):
    """The images of the JAX pipeline's sampler program (the fake UNet
    step under the JAX script's ``build_quant_ctx`` of the run's qparams
    file) on the port pipeline's weights, prompt embeddings and initial
    noise (batch ``k`` from a generator seeded ``SEED + k``), decoded by
    the port's VAE (the towers and the VAE are held against JAX's by
    ``tests/test_torch_port_towers.py`` / ``test_torch_port_txt2img.py``):
    (images, context, the UNet's layers recorded over the last batch)."""
    pipe = run["out"]["pipe"]
    cfg = run["cfg"]
    params = {"unet": jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        checkpoint.module_params(pipe.unet))}
    qparams = jckpt.load_qparams(os.path.join(run["exp"], "qparams.msgpack"))
    args = argparse.Namespace(config_weight_mp=None, act_protect=None,
                              config_act_mp=None, backend="fake")
    ctx = _jax_script("quant_txt2img").build_quant_ctx(
        jload_config(os.path.join(run["exp"], "config.yaml")), jp, params,
        qparams, args)
    inf = cfg.inference
    h, w = inf.height, inf.width
    sched = jsamplers.make_euler_schedule(inf.num_steps)
    prompts = load_prompts(None, N_IMAGES)
    out, holder = [], {}
    for k, i in enumerate(range(0, N_IMAGES, BATCH)):
        batch = prompts[i:i + BATCH]
        noise = pipe.make_noise(len(batch), h, w,
                                torch.Generator().manual_seed(SEED + k))
        embeds, pooled = pipe.encode_prompt(pipe.tokens(batch))
        added = pipe.added_conds(pooled,
                                 pipe.default_time_ids(len(batch), h, w))
        lat = jnp.asarray(noise.numpy()) * sched.init_noise_sigma
        (lat, _), rec = recorded_run(
            jp._sampler_program(inf.num_steps, float(inf.guidance_scale),
                                False), holder, params,
            jnp.asarray(embeds.numpy()),
            {k_: jnp.asarray(v.numpy()) for k_, v in added.items()}, lat,
            None, None, ctx, jax.random.PRNGKey(0))
        out.append(pipe.decode(torch.from_numpy(np.array(lat))).numpy())
    return np.concatenate(out), ctx, rec


def port_calls(run):
    """The port pipeline's images of the run's last batch under the CLI's
    context (the CLI's generator seed) and its UNet's QDense / QConv /
    QAct calls in order."""
    pipe, ctx, cfg = run["out"]["pipe"], run["out"]["ctx"], run["cfg"]
    inf = cfg.inference
    calls = []
    mods = {**state.quantizable_layers(pipe.unet),
            **state.act_quantizers(pipe.unet)}
    hs = [m.register_forward_pre_hook(
        lambda mod, a, kw: calls.append((mod.qname, a[0], dict(kw))),
        with_kwargs=True) for m in mods.values()]
    k = (N_IMAGES - 1) // BATCH
    try:
        out = pipe(load_prompts(None, N_IMAGES)[k * BATCH:(k + 1) * BATCH],
                   seed=SEED + k, num_inference_steps=inf.num_steps,
                   guidance_scale=inf.guidance_scale, height=inf.height,
                   width=inf.width, ctx=ctx)
    finally:
        for h in hs:
            h.remove()
    return out.images, calls


@pytest.mark.parametrize("tag", ["plain", "softmax"])
def test_fake_cli_images_match_jax(flow, jpipe, tag):
    from PIL import Image

    run = flow[tag]
    ctx = run["out"]["ctx"]
    assert ctx.mode == "fake" and ctx.qkv_quant == (tag == "softmax")
    # the fake simulation keeps every fp weight
    assert all(p is not None for p in run["out"]["pipe"].unet.parameters())
    got = np.stack([np.asarray(Image.open(p), np.float32) / 255
                    for p in sorted(run["out"]["paths"])])
    want, jctx, rec = jax_images(run, jpipe)
    want = (want * 255).astype(np.uint8).astype(np.float32) / 255
    assert jctx.qkv_quant == ctx.qkv_quant and set(jctx.ctrl) == set(ctx.ctrl)
    assert got.shape == want.shape == (N_IMAGES, 128, 128, 3)
    images, calls = port_calls(run)
    last = (images * 255).astype(np.uint8).astype(np.float32) / 255
    np.testing.assert_array_equal(last, got[-len(images):])
    assert len(calls) == len({k[0] for k in rec}) > 0
    if first_code_difference(calls, rec, ctx, tag) is None:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-2, rel


def test_softmax_qparams_file_matches_jax(flow, tmp_path):
    run = flow["softmax"]
    path = os.path.join(run["exp"], "qparams.msgpack")
    mine = checkpoint.load_qparams(path)
    qact = sorted(n for n in mine if ".act_quantizer_" in n)
    assert qact and all(n.endswith(("_q", "_k", "_v", "_softmax"))
                        for n in qact)
    assert len(qact) % 4 == 0 and len(qact) == 4 * len(
        [n for n in qact if n.endswith("_softmax")])
    assert all((mine[n].a_zp == 0).all() for n in qact
               if n.endswith("_softmax"))  # the always-zero spec
    assert not [n for n in checkpoint.load_qparams(os.path.join(
        flow["plain"]["exp"], "qparams.msgpack")) if ".act_quantizer_" in n]
    # byte for byte: the JAX package's writer on the same values
    jqp = jckpt.load_qparams(path)
    other = str(tmp_path / "jax.msgpack")
    jckpt.save_qparams(jqp, other)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
