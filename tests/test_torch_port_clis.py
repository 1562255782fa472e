"""The port's root CLIs and ``evaluate`` on ``tiny-sdxl``, on the CPU
(``--device cpu``): ``evaluate``, ``txt2img``, ``serve``, ``serve_bench``,
``memory_compare`` and ``batch_sweep`` (``mixdq_tpu_torch/scripts/``).

* Each CLI's option set equals the JAX script's (read from its source with
  ``ast``, no JAX process), apart from ``--device``, which the port adds.
* ``evaluate``'s report keys and order equal the JAX script's, and its
  values equal the JAX metric functions (``ssim``, ``pixel_mse``,
  ``sqnr``, ``fid_from_features`` on the JAX Inception and CLIP towers
  with the same weights) applied to the images and latents the port's run
  returned.
* ``serve_bench``'s, ``batch_sweep``'s and ``memory_compare``'s JSON keys
  equal the JAX scripts'; ``serve --dp 2`` raises.
* ``memory_compare``'s static bytes on tiny-sdxl W8A8 against the JAX
  script's ``unet_mem`` static (its compiled ``argument_size_in_bytes``).
* ``txt2img`` writes ``n_images`` PNGs equal to the pipeline's images for
  the same seeds.

The experiment directory (``config.yaml``, ``qparams.msgpack``) is
written with the port's ``save_config`` / ``save_qparams`` after one
calibration on the pipeline's own trajectory.
"""

import ast
import json
import logging
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models import clip as jclip  # noqa: E402
from mixdq_tpu.models import configs as jax_configs  # noqa: E402
from mixdq_tpu.models import inception as jinc  # noqa: E402
from mixdq_tpu.models.configs import CLIPVisionConfig as JVisionCfg  # noqa
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.quant import deploy as jdeploy  # noqa: E402
from mixdq_tpu.quant import state as jstate  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402
from mixdq_tpu.quant.state import LayerQParams as JQParams  # noqa: E402
from mixdq_tpu.utils import fid as jfid  # noqa: E402
from mixdq_tpu.utils import metrics as jmetrics  # noqa: E402
from mixdq_tpu.utils import torch_convert as jtc  # noqa: E402

from mixdq_tpu_torch.convert import qparams_to_numpy  # noqa: E402
from mixdq_tpu_torch.models.configs import CLIPVisionConfig  # noqa: E402
from mixdq_tpu_torch.pipeline import AQ, WQ, build_unet  # noqa: E402
from mixdq_tpu_torch.pipelines.loader import (build_pipeline,  # noqa: E402
                                              specs_from_config)
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.checkpoint import save_qparams  # noqa: E402
from mixdq_tpu_torch.quant.state import quantizable_layers  # noqa: E402
from mixdq_tpu_torch.scripts import (batch_sweep, evaluate,  # noqa: E402
                                     memory_compare, serve, serve_bench,
                                     txt2img)
from mixdq_tpu_torch.utils.config import load_config, save_config  # noqa
from mixdq_tpu_torch.utils.prompts import BUILTIN_PROMPTS  # noqa: E402

from tests.test_torch_port_eval import (  # noqa: E402
    hf_vision_state_dict, torchvision_inception_state_dict)

REPO = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(REPO, "configs", "tiny.yaml")
PORT_CLIS = ("evaluate", "txt2img", "serve", "serve_bench",
             "memory_compare", "batch_sweep")
VISION = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=64,
                          num_layers=2, num_heads=1, intermediate_size=64,
                          projection_dim=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the tier-1 run's
    workers share the cores); the root logger restored after (the CLIs
    set up experiment logging)."""
    n = torch.get_num_threads()
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """An experiment directory on ``configs/tiny.yaml``: ``config.yaml``
    and ``qparams.msgpack`` from one calibration (with the channel
    splits) on the pipeline's trajectory for two prompts; mixed bit maps
    and an act-protect list over its layers; the two towers' state
    dicts."""
    tmp = tmp_path_factory.mktemp("clis")
    cfg = load_config(TINY)
    save_config(cfg, str(tmp / "config.yaml"))
    pipe = build_pipeline(cfg, device="cpu")
    rec = pipe(BUILTIN_PROMPTS[:2], seed=3, capture_trajectory=True,
               decode=False)
    wq, aq, _ = specs_from_config(cfg)
    qparams = calibrate(pipe.unet, [(rec.trajectory[0], rec.timesteps[0],
                                     rec.text_emb, rec.added_conds)],
                        wq, aq, splits=pipe.splits)
    save_qparams(qparams, str(tmp / "qparams.msgpack"))
    names = sorted(quantizable_layers(pipe.unet))
    with open(tmp / "w.yaml", "w") as f:
        f.writelines(f"{n}: {(4, 8)[i % 2]}\n" for i, n in enumerate(names))
    with open(tmp / "a.yaml", "w") as f:
        f.writelines(f"{n}: 8\n" for n in names)
    with open(tmp / "protect.yaml", "w") as f:
        f.writelines(f"- {n}\n" for n in names[::7])
    torch.save(hf_vision_state_dict(VISION, 11), tmp / "clip.pt")
    torch.save(torchvision_inception_state_dict(12), tmp / "inception.pt")
    return tmp


# ------------------------------------------------------------ options


def jax_script(name):
    return os.path.join(REPO, "scripts", f"{name}.py")


def options(path):
    """The ``--`` options of every ``add_argument`` call in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
            == "add_argument" and n.args
            and isinstance(n.args[0], ast.Constant)
            and n.args[0].value.startswith("--")}


def json_keys(path, var=None):
    """The keys of the dict literal assigned to ``var`` in ``path``, or of
    the one passed to ``json.dumps`` (the first, where there are more)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for n in ast.walk(tree):
        if var and isinstance(n, ast.Assign) and isinstance(
                n.value, ast.Dict) and getattr(n.targets[0], "id", "") == var:
            d = n.value
        elif not var and isinstance(n, ast.Call) and getattr(
                n.func, "attr", "") == "dumps" and n.args and isinstance(
                n.args[0], ast.Dict):
            d = n.args[0]
        else:
            continue
        return [k.value for k in d.keys if k is not None]  # no ``**``
    raise AssertionError(f"no dict in {path}")


@pytest.mark.parametrize("name", PORT_CLIS)
def test_cli_options_equal_jax(name):
    port = options(os.path.join(REPO, "mixdq_tpu_torch", "scripts",
                                f"{name}.py"))
    assert "--device" in port
    assert port - {"--device"} == options(jax_script(name))


# ----------------------------------------------------------- evaluate


#: the report's keys in the JAX script's order (scripts/evaluate.py:155-158
#: fields, :255-262, then per feature kind :270-282: clip before inception)
REPORT_TAIL = ["n_prompts", "ssim_mean", "pixel_mse_mean",
               "latent_sqnr_db_mean", "clip_fid", "clip_cosine_mean",
               "inception_fid"]
MP_FIELDS = ["config_weight_mp", "config_act_mp", "act_protect"]
#: a FID of 3 images against 3 (rank 2) in f32, held to the distance's
#: scale ``tr C_fp + tr C_q``: the clipped null eigenvalues of the
#: 2048-d square roots add f32 noise (a few 1e-3 of the scale, moving with
#: the thread count; ``tests/test_torch_port_eval.py`` holds the function
#: at rel 1e-3 where the covariances are well conditioned)
FID_TOL = 1e-2
INCEPTION_FID_ENTRIES = ("w4_sec", "mp_sec")


@pytest.fixture(scope="module")
def evaluated(exp):
    """``evaluate --matrix w8_int8,w8_sec,w4_sec,mp_sec`` with both towers
    (3 prompts at batch 2: batches of 2 and 1)."""
    return evaluate.main([
        "--base_path", str(exp), "--device", "cpu", "--n_prompts", "3",
        "--matrix", "w8_int8,w8_sec,w4_sec,mp_sec",
        "--config_weight_mp", str(exp / "w.yaml"),
        "--config_act_mp", str(exp / "a.yaml"),
        "--act_protect", str(exp / "protect.yaml"),
        "--clip_vision_ckpt", str(exp / "clip.pt"),
        "--inception_ckpt", str(exp / "inception.pt")])


def test_evaluate_report_keys_equal_jax(evaluated, exp):
    """Every entry's keys in the JAX order: the fields the JAX script
    writes (read from its source) then the metrics; the files read back
    equal."""
    fields = json_keys(jax_script("evaluate"), "fields")
    assert fields == ["backend", "deploy_compute", "fuse_qkv", "w_bits"]
    for name, report in evaluated["reports"].items():
        extra = MP_FIELDS if name == "mp_sec" else []
        assert list(report) == fields + extra + REPORT_TAIL, name
        assert all(np.isfinite(v) for k, v in report.items()
                   if k.endswith(("_mean", "_fid")))
        assert load_config(str(exp / f"eval_{name}.yaml")) == report
    r = evaluated["reports"]
    assert [r[n]["deploy_compute"] for n in r] == [
        "int8", "int8_sec", "int8_sec", "int8_sec"]
    assert [r[n]["w_bits"] for n in r] == [8, 8, 4, 8]


@pytest.fixture(scope="module")
def jax_towers(exp):
    """(JAX inception features, JAX CLIP pooled embedding) functions on
    the same state dicts through the JAX converters."""
    sd = torch.load(exp / "inception.pt", weights_only=True)
    iparams = jtc.convert_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    sd = torch.load(exp / "clip.pt", weights_only=True)
    cparams = jtc.convert_clip_vision_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    inc = jax.jit(lambda x: jinc.InceptionV3Features().apply(
        {"params": iparams}, x))
    vis = jclip.CLIPVisionModel(JVisionCfg(
        image_size=28, patch_size=14, hidden_size=64, num_layers=2,
        num_heads=1, intermediate_size=64, projection_dim=16))
    clip_fn = jax.jit(lambda x: vis.apply(
        {"params": cparams}, jclip.preprocess_images(x, 28))[1])
    return {"inception": inc, "clip": clip_fn}


def test_evaluate_values_equal_jax_metrics(evaluated, jax_towers):
    """Each entry's SSIM, pixel MSE and latent SQNR equal the JAX metric
    functions on the port's images and latents (rel 1e-5, SQNR abs 1e-4
    dB); each tower's features equal JAX's on the same images (rel 1e-4),
    each FID the JAX ``fid_from_features`` of JAX's features (within
    ``FID_TOL`` of the distance's scale) and the CLIP cosine JAX's (abs
    1e-5). The Inception FID is held on the entries that move the images
    past the f32 noise (``INCEPTION_FID_ENTRIES``): each costs two
    2048-d ``eigh`` and four 2048^3 products on the JAX side."""
    assert [len(b) for b in evaluated["fp"]["latents"]] == [2, 1]
    fp, entries = evaluated["fp"], evaluated["entries"]
    fpi = jnp.asarray(fp["images"])
    win = min(255, fpi.shape[1] - 1)
    win -= (win + 1) % 2
    # each JAX function jitted, each tower run once on every image it
    # reads (one XLA program a call: the tier-1 run's workers share the
    # cores)
    ssim = jax.jit(jmetrics.ssim, static_argnames="win_size")
    sqnr, pixel_mse = jax.jit(jmetrics.sqnr), jax.jit(jmetrics.pixel_mse)
    reads = {"clip": ["fp"] + list(entries),
             "inception": ["fp"] + list(INCEPTION_FID_ENTRIES)}
    jf = {}
    for kind, names in reads.items():
        imgs = [fp["images"]] + [entries[n]["images"] for n in names[1:]]
        feats = np.split(np.asarray(jax_towers[kind](jnp.asarray(
            np.concatenate(imgs)))), len(imgs))
        for n, f in zip(names, feats):
            got = fp if n == "fp" else entries[n]
            assert np.abs(got["features"][kind] - f).max() <= \
                1e-4 * np.abs(f).max(), (n, kind)
            jf[n, kind] = f
    for name, res in entries.items():
        report = evaluated["reports"][name]
        qi = jnp.asarray(res["images"])
        ssims = [float(ssim(fpi[b], qi[b], win_size=win))
                 for b in range(len(qi))]
        mses = [float(pixel_mse(fpi[i:i + 2], qi[i:i + 2]))
                for i in range(0, len(qi), 2)]
        sqnrs = [float(sqnr(jnp.asarray(f.numpy()), jnp.asarray(q.numpy())))
                 for f, q in zip(fp["latents"], res["latents"])]
        assert report["ssim_mean"] == pytest.approx(np.mean(ssims), rel=1e-5)
        assert report["pixel_mse_mean"] == pytest.approx(np.mean(mses),
                                                         rel=1e-5)
        assert report["latent_sqnr_db_mean"] == pytest.approx(
            np.mean(sqnrs), abs=1e-4)
        for kind in (k for k in reads if name in reads[k]):
            fa, qa = jf["fp", kind], jf[name, kind]
            want = float(jfid.fid_from_features(jnp.asarray(fa),
                                                jnp.asarray(qa)))
            scale = sum(f.var(0, ddof=1).sum() for f in (fa, qa))
            assert abs(report[f"{kind}_fid"] - want) <= FID_TOL * scale, (
                name, kind, report[f"{kind}_fid"], want, scale)
        fa, qa = jf["fp", "clip"], jf[name, "clip"]
        cos = np.sum(fa / np.linalg.norm(fa, axis=-1, keepdims=True)
                     * qa / np.linalg.norm(qa, axis=-1, keepdims=True), -1)
        assert report["clip_cosine_mean"] == pytest.approx(
            float(np.mean(cos)), abs=1e-5)


def test_evaluate_matrix_entries(evaluated):
    """Every entry ran its own deploy on the one FP pass: the W4 and mixed
    entries move the images more than W8 does; no kernel launched on the
    CPU (the plain versions ran)."""
    r = evaluated["reports"]
    assert r["w4_sec"]["latent_sqnr_db_mean"] < \
        r["w8_sec"]["latent_sqnr_db_mean"]
    assert r["mp_sec"]["latent_sqnr_db_mean"] < \
        r["w8_sec"]["latent_sqnr_db_mean"]
    for res in evaluated["entries"].values():
        assert not any(res["launches"].values())
        assert res["images"].shape == (3, 128, 128, 3)


# ---------------------------------------------------------- root CLIs


def read_png(path):
    """An 8-bit RGB PNG of unfiltered scanlines (``utils/images.py``'s)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[pos + 8:pos + 16])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_txt2img_writes_the_pipelines_images(tmp_path):
    """3 images at batch 2: batch k seeded 42 + k, each PNG the pipeline's
    image as ``(x * 255)`` truncated to uint8."""
    out = txt2img.main(["--config", TINY, "--outdir", str(tmp_path),
                        "--n_images", "3", "--device", "cpu"])
    assert len(out["paths"]) == 3
    pipe = build_pipeline(load_config(TINY), device="cpu")
    prompts = BUILTIN_PROMPTS[:3]
    want = np.concatenate([pipe(prompts[i:i + 2], seed=42 + k).images
                           for k, i in enumerate((0, 2))])
    got = np.stack([read_png(p) for p in out["paths"]])
    assert np.array_equal(got, (want * 255).astype(np.uint8))


def test_serve_int8_and_dp(exp, tmp_path):
    """``serve --backend int8`` writes batch x n_batches PNGs; so does
    ``--dp 2``, from rank 0 of a world of two gloo ranks (the dp engine
    against the unsharded one: ``tests/test_torch_port_mesh.py``)."""
    out = serve.main(["--base_path", str(exp), "--backend", "int8",
                      "--batch_size", "2", "--n_batches", "2",
                      "--outdir", str(tmp_path), "--device", "cpu"])
    assert len(out["paths"]) == 4 and len(out["batch_ms"]) == 2
    assert read_png(out["paths"][-1]).shape == (128, 128, 3)
    assert out["engine"].ctx.deploy_compute == "int8_sec"
    dp = serve.main(["--config", TINY, "--dp", "2", "--batch_size", "2",
                     "--n_batches", "1", "--outdir", str(tmp_path / "dp"),
                     "--device", "cpu"])
    assert dp["engine"] is None and len(dp["batch_ms"]) == 1
    assert [os.path.basename(p) for p in dp["paths"]] == [
        "serve_00000.png", "serve_00001.png"]
    assert read_png(dp["paths"][-1]).shape == (128, 128, 3)


def test_serve_bench_json_equals_jax(exp, capsys):
    """The JSON line (last stdout line) has the JAX script's keys in its
    order; with ``--quantize_vae`` the int8 engine decodes through the
    int8 decoder."""
    out = serve_bench.main(["--base_path", str(exp), "--steps", "2",
                            "--batch_size", "2", "--rounds", "1",
                            "--quantize_vae", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == json_keys(jax_script("serve_bench"), "out")
    assert line == out["result"] and line["quantize_vae"] is True
    assert 0 < line["ssim_vs_fp"] <= 1 and line["speedup"] > 0
    assert out["vae_ctx"].deploy


def test_batch_sweep_json_equals_jax(capsys):
    rows = batch_sweep.main(["--family", "tiny-sdxl", "--batches", "1,2",
                             "--rounds", "1", "--iters", "1", "--inner",
                             "1", "--device", "cpu"])["rows"]
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == rows and [r["B"] for r in rows] == [1, 2]
    for r in rows:
        assert list(r) == json_keys(jax_script("batch_sweep"))


def jax_memory_inputs(f):
    """The JAX script's zero request (``unet_mem``'s sample, t, ehs and
    micro-conditioning) at B = 1."""
    bf16 = jnp.bfloat16
    H = f.unet.sample_size
    added = {"text_embeds": jnp.zeros((1, f.text_encoder_2.projection_dim),
                                      bf16),
             "time_ids": jnp.zeros((1, 6), bf16)}
    return (jnp.zeros((1, H, H, 4), bf16), jnp.asarray(999.0),
            jnp.zeros((1, 77, f.unet.cross_attention_dim), bf16), added)


def jax_unet_mem_static(qparams):
    """The static MB of the JAX script's ``unet_mem("tiny-sdxl", 1,
    quant="int8")`` (``scripts/memory_compare.py:73-99``): its deploy
    (``deploy_unet_ctx`` of a W8A8 ``uniform_ctrl``, ``deployed_params``)
    and its program's compiled ``argument_size_in_bytes``. The params are
    drawn with numpy at ``jax.eval_shape(unet.init)``'s shapes and dtypes
    and the qparams are the port's calibration's (the script's jitted
    init and calibration take ~40 s here and decide no byte). Also the
    bf16 UNet's static MB: its params' bytes, the program's only
    argument."""
    f = jax_configs.get_family("tiny-sdxl")
    unet = JUNet(f.unet, dtype=jnp.bfloat16)
    inputs = jax_memory_inputs(f)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), shapes)
    bf16 = sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(variables))
    jqp = {n: JQParams(**{k: None if v is None else jnp.asarray(v)
                          for k, v in d.items()})
           for n, d in qparams_to_numpy(qparams).items()}
    wq = JSpec(sym=True, channel_wise=True, round_mode="nearest", n_bits=8)
    ctx = jdeploy.deploy_unet_ctx(
        unet, variables, jqp, jstate.uniform_ctrl(
            jstate.quantizable_layers(variables["params"]), w_bits=8,
            a_bits=8), wq, JSpec(running_stat=True))
    ctx = ctx.replace(deploy_compute="int8")
    variables = jax.device_put(jdeploy.deployed_params(variables, ctx))
    fn = jax.jit(lambda v, c: unet.apply(v, *inputs, c))
    ma = fn.lower(variables, ctx).compile().memory_analysis()
    return ma.argument_size_in_bytes / 1e6, bf16 / 1e6


def test_memory_compare_static_against_jax(capsys):
    """tiny-sdxl W8A8 (``--compute int8``): the port's static bytes equal
    the JAX script's ``unet_mem`` static (XLA's argument size of the
    pruned params and the context, ``jax_unet_mem_static``) once three
    differences are taken out, each counted entry by entry:

    * the port's deploy holds each cross-attention k/v entry's f32 BoS
      row ``bos_out`` ``[1, N]`` (computed once from the request's first
      token, as the int8 CLI does); the JAX step computes the row inside
      the program from the dequantized weight (a temporary);
    * the port's time-embedding bank stacks its members' codes, scales,
      biases and act constants once (``QuantCtx.bank_cache``); the JAX
      program stacks them each step (temporaries);
    * each JAX entry carries ``scale_inv`` and ``zp_shifted`` as f32
      device scalars (8 bytes), the port's as Python floats.

    The bf16 UNet's static bytes are equal outright; the JSON keys equal
    the JAX script's."""
    out = memory_compare.main(["--family", "tiny-sdxl", "--json",
                               "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == json_keys(jax_script("memory_compare"))
    assert line["quant"]["peak_mb"] is None and out["bf16"][2] is None

    unet, ctx, inputs = memory_compare.build("tiny-sdxl", 1, "int8",
                                             device="cpu")
    static = memory_compare.resident_bytes(unet, ctx)
    assert static == out["quant"][0] * memory_compare.MB
    bos = sum(e.bos_out.numel() * 4 for e in ctx.deploy.values()
              if e.bos_out is not None)
    assert not any(e.bos_w is not None for e in ctx.deploy.values())
    bank = sum(t.numel() * t.element_size()
               for _, groups in ctx.bank_cache.values()
               for g in groups for t in g[2:7])
    assert bos and bank
    unet_fp = build_unet("tiny-sdxl", 0, torch.bfloat16, "cpu")
    want, want_bf16 = jax_unet_mem_static(
        calibrate(unet_fp, [inputs], WQ, AQ))
    assert static - bos - bank + 8 * len(ctx.deploy) == round(want * 1e6)
    assert out["bf16"][0] * memory_compare.MB == round(want_bf16 * 1e6)
