"""The port's mixed-precision search on the CPU
(``mixdq_tpu_torch/mixed_precision/``, ``utils/metrics.py``) against the
JAX package's:

* metrics: ``sqnr`` / ``mse`` / ``pixel_mse`` (rel 1e-6) and ``ssim``
  (rel 1e-5; a separable f32 ``cumsum`` summed in another order), at
  ``win_size=511`` on 512 x 512 images too;
* the ILP and the loaders: the same maps from both repo sensitivity logs
  at several targets, the SDXL-Turbo candidate at k = 1.0 for 5.02 equal
  to ``final_config/weight/5.04.yaml`` on all 794 layers, every loader
  equal on every file under ``configs/mp/`` (or both raising);
* the SQNR sweep on tiny-sdxl in f32, weight fake quantization (bit for
  bit with JAX's since PR 16: rel 1e-4) and acts (rel 1e-3, and the
  targeted layers' act codes under PERF.md §2's code criterion), one JAX
  UNet program a sweep;
* one SSIM point and the election over two candidates: JAX's
  ``sweep_ssim`` and ``elect`` on the port's generated images (a pipeline
  shim: the same latents) against the port's functions;
* the batched sweeps equal the sequential ones (also with ``mesh=``, a
  world of one) and raise as JAX's do.
"""

import glob
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.mixed_precision import election as jelection  # noqa: E402
from mixdq_tpu.mixed_precision import ilp as jilp  # noqa: E402
from mixdq_tpu.mixed_precision import reference_data as jref  # noqa: E402
from mixdq_tpu.mixed_precision import sensitivity as jsens  # noqa: E402
from mixdq_tpu.models.configs import get_family as jfamily  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.quant import checkpoint as jckpt  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402
from mixdq_tpu.utils import metrics as jmetrics  # noqa: E402

from mixdq_tpu_torch import pipeline  # noqa: E402
from mixdq_tpu_torch.mixed_precision import (election, ilp,  # noqa: E402
                                             reference_data, sensitivity)
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline  # noqa: E402
from mixdq_tpu_torch.quant import checkpoint  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.state import (LayerCtrl, QuantCtx,  # noqa: E402
                                         capture_acts, quantizable_layers)
from mixdq_tpu_torch.utils import metrics  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MP = os.path.join(ROOT, "configs", "mp")
JWQ = JSpec(sym=True, channel_wise=True, round_mode="nearest")
JAQ = JSpec(running_stat=True)
#: the swept layers: a spatial conv and a dense layer
SWEPT = ("conv_in", "down_blocks.1.attentions.0.transformer_blocks.0."
         "attn1.to_q")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the tier-1 run's
    workers share the cores, and small eager ops contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 40, 40, 3)).astype(np.float32)
    b = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    for fn in ("sqnr", "mse", "pixel_mse"):
        got = float(getattr(metrics, fn)(torch.from_numpy(a),
                                         torch.from_numpy(b)))
        want = float(getattr(jmetrics, fn)(jnp.asarray(a), jnp.asarray(b)))
        assert got == pytest.approx(want, rel=1e-6), fn
    x = rng.random((512, 512, 3)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    for img0, img1, win in ((a[0], b[0], 7), (x, y, 7), (x, y, 511),
                            (x[:128, :128], y[:128, :128], 127)):
        got = float(metrics.ssim(torch.from_numpy(img0),
                                 torch.from_numpy(img1), win_size=win))
        want = float(jmetrics.ssim(jnp.asarray(img0), jnp.asarray(img1),
                                   win_size=win))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), win


def _log(family, which):
    return reference_data._load(os.path.join(
        MP, family, "sensitivity_log", f"sensitivity_{which}.yaml"))


def _sizes(family, names):
    """SDXL-Turbo: its weights' element counts (the layer shapes); SD1.5
    (no port UNet yet): seeded random sizes, the same for both
    packages."""
    if family == "sdxl_turbo":
        return {n: int(np.prod(s)) for n, s in pipeline._layer_shapes(
            get_family("sdxl-turbo").unet)}
    rng = np.random.default_rng(4)
    return {n: int(rng.integers(1, 10 ** 6)) for n in sorted(names)}


@pytest.mark.parametrize("family,which,targets", [
    ("sdxl_turbo", "weight", (4.0, 5.02)), ("sdxl_turbo", "act", (7.77,)),
    ("sd15", "weight", (5.0,)), ("sd15", "act", (7.7,))])
def test_ilp_matches_jax(family, which, targets):
    """``metric_decoupled_allocation`` (and so ``split_budget`` and
    ``allocate_bits``), ``solve_reference_point`` and the helpers give
    JAX's maps exactly."""
    log = _log(family, which)
    sc, sq = log["content"], log["quality"]
    frac = ilp.tensor_size_fractions(_sizes(family, list(sc) + list(sq)))
    for t in targets:
        got = ilp.metric_decoupled_allocation(sc, sq, frac, t)
        want = jilp.metric_decoupled_allocation(sc, sq, frac, t)
        assert len(got) == 5 and got == want, t
        assert [ilp.achieved_avg_bits(c, frac) for c in got] == [
            jilp.achieved_avg_bits(c, frac) for c in want]
    assert ilp.split_budget(5.02, 0.3, 0.9) == jilp.split_budget(5.02, 0.3,
                                                                  0.9)
    rows = {n: [v[0], v[0], v[1]] for n, v in sq.items()}
    ratio = {n: frac[n] for n in frac}
    for avg in ((4.0, 6.0), (5.5, 7.0)):
        got = reference_data.solve_reference_point(sc, rows, ratio, *avg)
        want = jref.solve_reference_point(sc, rows, ratio, *avg)
        assert got == want and got is not None
        assert reference_data.compare_configs(got, want, ratio) == \
            jref.compare_configs(got, want, ratio)
        assert reference_data.group_avg_bits(got, ratio, got) == \
            pytest.approx(jref.group_avg_bits(got, ratio, got), rel=1e-12)
    assert reference_data.reference_budget_split(0.4, 0.9, 5.0) == \
        jref.reference_budget_split(0.4, 0.9, 5.0)
    names = list(sc) + list(sq)
    assert [reference_data.is_content_layer(n) for n in names] == [
        jref.is_content_layer(n) for n in names]
    assert sensitivity.split_metric_groups(names) == \
        jsens.split_metric_groups(names)


def test_ilp_reproduces_final_weight_map():
    """The repo's weight log at 5.02 with SDXL-Turbo's weight sizes: the
    k = 1.0 candidate is ``final_config/weight/5.04.yaml``, all 794
    layers."""
    log = _log("sdxl_turbo", "weight")
    frac = ilp.tensor_size_fractions(_sizes("sdxl_turbo", ()))
    cands = ilp.metric_decoupled_allocation(log["content"], log["quality"],
                                            frac, 5.02)
    ref = reference_data.load_final_config(os.path.join(
        MP, "sdxl_turbo", "final_config", "weight", "5.04.yaml"))
    assert len(ref) == 794 and cands[3] == ref
    assert ilp.achieved_avg_bits(cands[3], frac) == pytest.approx(
        log["meta"]["achieved_avg_bits"], abs=1e-9)


def _same(port_fn, jax_fn, path):
    try:
        want = jax_fn(path)
    except Exception:
        with pytest.raises(Exception):
            port_fn(path)
        return False
    assert port_fn(path) == want, path
    return True


def test_loaders_match_jax():
    """Every loader on every file under ``configs/mp/``: equal where
    JAX's reads it, raising where JAX's raises. The one exception is
    ``reference_final/validation.yaml``, the report of the JAX
    ``validate_reference_mp.py`` (not ported: it reads a reference
    checkout outside the repository), whose multi-line scalars and lists
    of maps are outside the port's YAML subset: every port loader raises
    on it, naming the file and line."""
    files = sorted(glob.glob(os.path.join(MP, "**", "*.yaml"),
                             recursive=True))
    report = os.path.join(MP, "sdxl_turbo", "reference_final",
                          "validation.yaml")
    files.remove(os.path.normpath(report) if os.path.normpath(report) in
                 files else report)
    assert len(files) >= 20
    read = {}
    for fn in ("load_sensitivity_yaml", "load_ratio_config",
               "load_final_config", "load_act_protect"):
        read[fn] = sum(_same(getattr(reference_data, fn), getattr(jref, fn),
                             p) for p in files)
        with pytest.raises(ValueError, match="validation.yaml:2"):
            getattr(reference_data, fn)(report)
    # bit maps read as bit maps and size ratios, lists and maps as
    # act-protect lists; the nested logs only where they are flat
    assert read["load_final_config"] >= 13 and \
        read["load_act_protect"] == len(files)
    # the sensitivity logs' groups read as the JAX CLI's files do
    for path in glob.glob(os.path.join(MP, "*", "sensitivity_log", "*")):
        import yaml

        with open(path) as f:
            assert reference_data._load(path) == yaml.safe_load(f)


@pytest.fixture(scope="module")
def tiny():
    """tiny-sdxl in f32: the port's UNet (``init_weights(0)``), one
    request, its calibration and FP output; the JAX UNet on the same
    weights and the same qparams (through the qparams file)."""
    import tempfile

    unet = pipeline.build_unet("tiny-sdxl", dtype=torch.float32,
                               device="cpu")
    req = pipeline.example_inputs("tiny-sdxl", dtype=torch.float32,
                                  device="cpu")
    qparams = calibrate(unet, [req], pipeline.WQ, pipeline.AQ)
    fp = pipeline.unet_step(unet, req)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "qparams.msgpack")
        checkpoint.save_qparams(qparams, path)
        jqp = jckpt.load_qparams(path)
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    checkpoint.module_params(unet))
    s, t, e, a = req
    jbatch = (jnp.asarray(s.numpy()), jnp.asarray(t.numpy()),
              jnp.asarray(e.numpy()),
              {k: jnp.asarray(v.numpy()) for k, v in a.items()})
    return dict(unet=unet, req=req, qparams=qparams, fp=fp, jqp=jqp,
                jm=JUNet(jfamily("tiny-sdxl").unet), params=params,
                jbatch=jbatch, names=sorted(quantizable_layers(unet)))


@pytest.mark.parametrize("which", ["weight", "act"])
def test_sweep_sqnr_matches_jax(tiny, which):
    """Two layers at bits (4, 8): the port's SQNR sweep against JAX's on
    the same weights, qparams, inputs and FP output. Weights: rel 1e-4.
    Acts: rel 1e-3, and the targeted layers' codes on their FP inputs
    within one of each other on under 1% of the codes."""
    names = tiny["names"]
    got = sensitivity.sweep_sqnr(
        tiny["unet"], tiny["qparams"], SWEPT, names, tiny["req"], tiny["fp"],
        pipeline.WQ, pipeline.AQ, which=which, bits=(4, 8))
    want = jsens.sweep_sqnr(
        tiny["jm"], {"params": tiny["params"]}, tiny["jqp"], SWEPT, names,
        tiny["jbatch"], jnp.asarray(tiny["fp"].numpy()), JWQ, JAQ,
        which=which, bits=(4, 8))
    for n in SWEPT:
        np.testing.assert_allclose(got[n], want[n],
                                   rtol=1e-4 if which == "weight" else 1e-3)
        assert got[n][1] > got[n][0]
    if which == "act":
        seen = capture_acts(tiny["unet"], tiny["req"], names=list(SWEPT))
        for n in SWEPT:
            qp = tiny["qparams"][n]
            x = seen[n].float()
            codes = torch.round(x / qp.a_delta[2]) + qp.a_zp[2]
            jx = jnp.asarray(x.numpy())
            jq = tiny["jqp"][n]
            jcodes = np.asarray(jnp.round(jx / jq.a_delta[2]) + jq.a_zp[2])
            d = np.abs(codes.numpy() - jcodes)
            assert d.max() <= 1 and (d > 0).mean() < 0.01, n


def test_batched_sweeps_equal_sequential_and_raise(tiny):
    names = tiny["names"]
    args = (tiny["unet"], tiny["qparams"], list(SWEPT[:1]), names,
            tiny["req"], tiny["fp"], pipeline.WQ, pipeline.AQ)
    seq = sensitivity.sweep_sqnr(*args, bits=(2, 8))
    bat = sensitivity.sweep_sqnr_batched(*args, bits=(2, 8), chunk=3)
    assert bat == seq
    with pytest.raises(KeyError, match="exact layer names"):
        sensitivity.sweep_sqnr_batched(
            tiny["unet"], tiny["qparams"], ["down_blocks.1"], names,
            tiny["req"], tiny["fp"], pipeline.WQ, pipeline.AQ)
    with pytest.raises(ValueError, match="candidate_bits"):
        sensitivity.sweep_sqnr_batched(*args, bits=(3, 8))
    # ``mesh=`` runs: here a world of one (gloo, a ``HashStore``); a
    # world of two: tests/test_torch_port_mesh.py
    mesh = make_mesh(1, device="cpu")
    try:
        assert sensitivity.sweep_sqnr_batched(*args, bits=(2, 8),
                                              mesh=mesh) == seq
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(KeyError, match="exact layer names"):
        sensitivity.sweep_ssim_batched(None, None, ["nope"], names, ["a"],
                                       0, pipeline.WQ, pipeline.AQ)


def test_search_dp_mesh_needs_batched(capsys):
    """``--dp_mesh`` shares out the batched sweeps' points; with the
    sequential sweeps (``--batched 0``) every rank would run all of them,
    so the CLI refuses before it starts any rank."""
    from mixdq_tpu_torch.scripts import mixed_precision_search

    with pytest.raises(SystemExit):
        mixed_precision_search.main(["--base_path", "none", "--batched",
                                     "0", "--dp_mesh", "2"])
    assert "needs --batched CHUNK > 0" in capsys.readouterr().err


class _Shim:
    """The JAX pipeline's call (``pipe(params, prompts, key,
    num_inference_steps=, ctx=)``) on the port's pipeline: every call
    draws the noise of one seed, and a JAX fake context's controls run
    as a port context on the port's qparams."""

    def __init__(self, pipe, qparams, seed):
        self.pipe, self.qparams, self.seed = pipe, qparams, seed

    def __call__(self, params, prompts, key, num_inference_steps=None,
                 ctx=None):
        c = None
        if ctx is not None:
            c = QuantCtx(qparams=self.qparams, mode="fake", wq=pipeline.WQ,
                         aq=pipeline.AQ, ctrl={
                             n: LayerCtrl(bool(v.w_on), bool(v.a_on),
                                          int(v.w_idx), int(v.a_idx))
                             for n, v in ctx.ctrl.items()})
        imgs = sensitivity.generate(self.pipe, prompts, self.seed,
                                    num_inference_steps, c)
        return types.SimpleNamespace(images=imgs.numpy())


def test_ssim_point_and_election_match_jax():
    """One SSIM point (a content layer at bits 2 and 8) and the election
    over two candidates: the port's functions against JAX's on the port's
    images of the same noise (SSIM rel 1e-5, the winner and pixel MSEs
    rel 1e-6)."""
    pipe = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu").init_weights(0)
    req = pipeline.example_inputs("tiny-sdxl", dtype=torch.float32,
                                  device="cpu")
    sample, t, _, added = req
    embeds, pooled = pipe.encode_prompt(pipe.tokens(["a cat"]))
    qparams = calibrate(pipe.unet, [(sample, t, embeds, {
        "text_embeds": pooled, "time_ids": added["time_ids"]})],
        pipeline.WQ, pipeline.AQ)
    names = sorted(quantizable_layers(pipe.unet))
    content, _ = sensitivity.split_metric_groups(names)
    layer = [n for n in content if n.endswith("ff.net.2")][:1]
    shim = _Shim(pipe, qparams, seed=3)
    got = sensitivity.sweep_ssim(pipe, qparams, layer, names, ["a cat"], 3,
                                 pipeline.WQ, pipeline.AQ, bits=(2, 8),
                                 num_steps=1)
    want = jsens.sweep_ssim(shim, None, None, layer, names, ["a cat"],
                            jax.random.PRNGKey(0), JWQ, JAQ, bits=(2, 8),
                            num_steps=1)
    np.testing.assert_allclose(got[layer[0]], want[layer[0]], rtol=1e-5)
    assert got[layer[0]][0] < got[layer[0]][1]
    cands = [{n: 2 for n in content[:4]}, {n: 8 for n in content[:4]}]
    win, idx, mses = election.elect(pipe, qparams, names, cands, "weight",
                                    ["a cat"], 3, pipeline.WQ, pipeline.AQ,
                                    num_steps=1)
    jwin, jidx, jmses = jelection.elect(shim, None, None, names, cands,
                                        "weight", ["a cat"],
                                        jax.random.PRNGKey(0), JWQ, JAQ,
                                        num_steps=1)
    assert idx == jidx == 1 and win == jwin
    np.testing.assert_allclose(mses, jmses, rtol=1e-6)
