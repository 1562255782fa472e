"""Reconstruction and QAT against the JAX package, on the CPU:
``mixdq_tpu_torch/quant/recon.py`` and ``quant/qat.py`` against
``mixdq_tpu/quant/recon.py`` and ``quant/qat.py``, and ``ptq --recon`` /
``--adaround`` through its files.

The models are one tiny ``ResnetBlock2D`` (32 -> 64 channels, its 1x1
``conv_shortcut`` channel-split at 16, as the up blocks' concat-shortcut
convs are) and one tiny ``Transformer2DModel``, with the same weights in
both packages (numpy draws at the shapes of ``jax.eval_shape(init)``,
carried by ``convert.params_to_state_dict``), the same qparams (the
port's calibration, carried to JAX) and the same seeded batch. Each
reconstruction runs 3 Adam steps at lr 3e-3 and W4 in both packages,
JAX's with torch's ``exp`` / ``log`` (``torch_exp_log`` says why): the
intermediates counted as flax's ``capture_intermediates`` counts its
leaves, each step's
loss within rel 1e-5 and each step's gradients within rel 1e-4 (max |d|
/ max |ref|; JAX's read where its ``jax.value_and_grad`` returns them),
the returned ``w_delta`` rows within rel 1e-4, and the alphas within
1e-5 wherever the gradient agreed to 1e-3 of itself at every step (at
least 99 % of each: Adam moves an element by about lr whatever its
gradient, so a gradient near zero says nothing of the step). The QAT
step, in float64 in both packages: its loss rel 1e-5, the gradient of
every weight and every qparams tensor rel 1e-4, the updated tensors
within 1e-6 where |g| > 1e-6. The CLI: ``qparams.msgpack`` read by JAX's
``load_qparams``, ``alphas.msgpack`` by flax's ``msgpack_restore``, the
W4 fake SQNR rising, the AdaRound deploy's codes.
"""

import contextlib
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from flax import serialization  # noqa: E402

from mixdq_tpu.models.attention import (  # noqa: E402
    Transformer2DModel as JTransformer)
from mixdq_tpu.models.resnet import ResnetBlock2D as JResnet  # noqa: E402
from mixdq_tpu.quant import qat as jqat  # noqa: E402
from mixdq_tpu.quant import recon as jrecon  # noqa: E402
from mixdq_tpu.quant.checkpoint import load_qparams as jload_qparams  # noqa
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402
from mixdq_tpu.quant.state import LayerQParams as JLayerQParams  # noqa: E402
from mixdq_tpu.quant.state import QuantCtx as JCtx  # noqa: E402
from mixdq_tpu.quant.state import uniform_ctrl as juniform_ctrl  # noqa: E402

from mixdq_tpu_torch import convert, pipeline  # noqa: E402
from mixdq_tpu_torch.models.attention import Transformer2DModel  # noqa: E402
from mixdq_tpu_torch.models.layers import name_layers  # noqa: E402
from mixdq_tpu_torch.models.resnet import ResnetBlock2D  # noqa: E402
from mixdq_tpu_torch.quant import qat, recon  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.core import QuantSpec  # noqa: E402
from mixdq_tpu_torch.quant.core import fake_quant_adaround  # noqa: E402
from mixdq_tpu_torch.quant.deploy import build_deploy_params  # noqa: E402
from mixdq_tpu_torch.quant.state import (QuantCtx,  # noqa: E402
                                         quantizable_layers, uniform_ctrl)
from mixdq_tpu_torch.scripts import ptq  # noqa: E402
from mixdq_tpu_torch.utils.config import (load_config, merge,  # noqa: E402
                                          save_config)
from mixdq_tpu_torch.utils.metrics import sqnr  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
SPLIT = 16
ITERS, LR = 3, 3e-3
JWQ = JSpec(n_bits=4, sym=True, channel_wise=True, round_mode="nearest_ste")
JAQ = JSpec(running_stat=True)
WQ = QuantSpec(n_bits=4, sym=True, channel_wise=True,
               round_mode="nearest_ste")
AQ = QuantSpec(running_stat=True)


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


# ---------------------------------------------------------------- models


class JSplitResnet(fnn.Module):
    """The JAX block with its shortcut split, as an up block calls it."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, temb, ctx=JCtx()):
        return JResnet(32, 64, 64, groups=8, dtype=self.dtype, name="blk")(
            x, temb, ctx, split=SPLIT)


class SplitResnet(torch.nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.blk = ResnetBlock2D(32, 64, 64, groups=8, dtype=dtype)
        name_layers(self)

    def forward(self, x, temb, ctx=QuantCtx()):
        return self.blk(x, temb, ctx, split=SPLIT)


def numpy_params(model, args, seed):
    """Params at the shapes of ``model.init``: kernels N(0, 1/fan_in),
    biases N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            std = (1.0 / np.prod(s.shape[:-1])) ** 0.5
            return rng.normal(0, std, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + rng.normal(0, 0.1, s.shape)).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def to_jax_qparams(qparams):
    return {n: JLayerQParams(**{f: None if v is None else jnp.asarray(v)
                                for f, v in fields.items()})
            for n, fields in convert.qparams_to_numpy(qparams).items()}


class Case:
    """One block in both packages: weights, batch, port calibration."""

    def __init__(self, kind):
        rng = np.random.default_rng(7)
        if kind == "resnet":
            self.jmodel, self.model = JSplitResnet(), SplitResnet()
            args = (rng.normal(0, 1, (2, 8, 8, 32)),
                    rng.normal(0, 1, (2, 64)))
            splits = {"blk.conv_shortcut": SPLIT}
        else:
            self.jmodel = JTransformer(32, 2, 16, 1, 48, norm_num_groups=8)
            self.model = Transformer2DModel(32, 2, 16, 1, 48,
                                            norm_num_groups=8)
            args = (rng.normal(0, 1, (2, 8, 8, 32)),
                    rng.normal(0, 1, (2, 7, 48)))
            splits = {}
        args = tuple(a.astype(np.float32) for a in args)
        self.jargs = tuple(jnp.asarray(a) for a in args)
        self.args = tuple(torch.from_numpy(a) for a in args)
        self.params = numpy_params(self.jmodel, self.jargs, seed=3)
        self.model.load_state_dict(convert.params_to_state_dict(self.params))
        self.qparams = calibrate(self.model, [self.args], WQ, AQ,
                                 splits=splits)
        self.jqparams = to_jax_qparams(self.qparams)
        self.jvars = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                       self.params)}


@pytest.fixture(scope="module")
def cases():
    return {k: Case(k) for k in ("resnet", "transformer")}


def record_value_and_grad(monkeypatch):
    """Each (loss, grads) that JAX's ``jax.value_and_grad`` returns,
    inside ``jit`` or not, appended to the returned list as numpy."""
    rec = []
    orig = jax.value_and_grad

    def vag(fn, *a, **kw):
        g = orig(fn, *a, **kw)

        def wrapped(*args, **kwargs):
            loss, grads = g(*args, **kwargs)
            jax.debug.callback(
                lambda l, gr: rec.append(
                    (np.asarray(l), jax.tree_util.tree_map(np.asarray, gr))),
                loss, grads)
            return loss, grads
        return wrapped

    monkeypatch.setattr(jax, "value_and_grad", vag)
    return rec


def record_adam_grads(monkeypatch):
    """The gradient of each tensor at each ``torch.optim.Adam`` step, as
    numpy, appended to the returned list (one list a step)."""
    rec = []
    step = torch.optim.Adam.step

    def recording_step(self, *a, **kw):
        rec.append([p.grad.numpy().copy() for g in self.param_groups
                    for p in g["params"]])
        return step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", recording_step)
    return rec


def _via_torch(fn, dfn):
    """``fn`` of torch as a differentiable JAX function (a host callback;
    tangent ``dfn(x, y) * t``)."""

    @jax.custom_jvp
    def f(x):
        return jax.pure_callback(
            lambda a: fn(torch.from_numpy(np.array(a))).numpy(),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x)

    @f.defjvp
    def f_jvp(primals, tangents):
        (x,), (t,) = primals, tangents
        y = f(x)
        return y, dfn(x, y) * t
    return f


class _TorchExpLog:
    """``jax.numpy`` with torch's ``exp`` and ``log``."""

    exp = staticmethod(_via_torch(torch.exp, lambda x, y: y))
    log = staticmethod(_via_torch(torch.log, lambda x, y: 1.0 / x))

    def __getattr__(self, k):
        return getattr(jnp, k)


@pytest.fixture
def torch_exp_log(monkeypatch):
    """JAX's reconstruction with torch's ``exp`` / ``log``. Both packages
    train ``log(delta)`` and quantize with ``floor(w / exp(log(delta)))``
    under AdaRound, and the two libraries' ``exp`` and ``log`` differ by
    an ulp on about one channel in ten: the largest weight of a symmetric
    channel sits on ``w / delta`` = 2^(b-1) - 1 exactly, so that ulp moves
    its floor by one code, and the step's gradients with it. With the same
    ``exp`` and ``log`` values the two reconstructions are held tightly."""
    monkeypatch.setattr(jrecon, "jnp", _TorchExpLog())


# ---------------------------------------------------------------- helpers


def test_recon_helpers_match_jax():
    """``rect_sigmoid``, ``init_alpha``, ``round_reg`` and ``temp_decay``
    against JAX's at rel 1e-6."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 3, (64, 48)).astype(np.float32)
    assert rel(recon.rect_sigmoid(torch.from_numpy(a)),
               jrecon.rect_sigmoid(jnp.asarray(a))) <= 1e-6
    w = rng.normal(0, 0.2, (3, 3, 8, 16)).astype(np.float32)
    d = rng.uniform(0.01, 0.05, (1, 1, 1, 16)).astype(np.float32)
    assert rel(recon.init_alpha(torch.from_numpy(w), torch.from_numpy(d)),
               jrecon.init_alpha(jnp.asarray(w), jnp.asarray(d))) <= 1e-6
    alphas = {"b": a, "a": rng.normal(0, 1, (5,)).astype(np.float32)}
    for step in (0, 1, 7, 19):
        b = recon.temp_decay(step, 20)
        jb = jrecon.temp_decay(jnp.float32(step), 20)
        assert rel(b, jb) <= 1e-6, (step, b, jb)
        got = recon.round_reg({k: torch.from_numpy(v)
                               for k, v in alphas.items()}, b)
        want = jrecon.round_reg({k: jnp.asarray(v)
                                 for k, v in alphas.items()}, jb)
        assert rel(got, want) <= 1e-6, (step, got, want)


# ---------------------------------------------------------------- recon


def jax_intermediates(case, mode):
    filt = jrecon._intermediate_filter(mode)
    if filt is None:
        return 0
    _, st = jax.eval_shape(lambda v: case.jmodel.apply(
        v, *case.jargs, JCtx(), capture_intermediates=filt,
        mutable=["intermediates"]), case.jvars)
    return len(jax.tree_util.tree_leaves(st["intermediates"]))


#: every mode with and without AdaRound on the resnet block (its split
#: shortcut included), and the transformer at ``layer`` with AdaRound
#: (its attention and GEGLU layers; JAX compiles each reconstruction
#: anew, 8 s for this one alone, 25 s inside the tier-1 run)
RECON_CASES = [("resnet", m, a) for m in ("layer", "block", "model")
               for a in (False, True)] + [("transformer", "layer", True)]


@pytest.mark.parametrize("mode", ["layer", "block", "model"])
def test_transformer_intermediates_match_jax(cases, mode):
    """The transformer records as many intermediates in a forward as
    flax captures leaves, in every mode."""
    case = cases["transformer"]
    with recon.capture_intermediates(case.model, mode) as inter, \
            torch.no_grad():
        case.model(*case.args)
    assert len(inter) == jax_intermediates(case, mode)


@pytest.mark.parametrize(
    "kind,mode,adaround", RECON_CASES,
    ids=[f"{k}-{m}-{'adaround' if a else 'scales'}"
         for k, m, a in RECON_CASES])
def test_reconstruct_matches_jax(cases, kind, mode, adaround, monkeypatch,
                                 torch_exp_log):
    case = cases[kind]
    with recon.capture_intermediates(case.model, mode) as inter, \
            torch.no_grad():
        case.model(*case.args)
    assert len(inter) == jax_intermediates(case, mode)

    rec = record_value_and_grad(monkeypatch)
    jout = jrecon.reconstruct(case.jmodel, case.jvars, case.jqparams,
                              [case.jargs], JWQ, JAQ, mode=mode,
                              iters=ITERS, lr=LR, adaround=adaround,
                              return_alphas=True)
    jax.effects_barrier()
    grads = record_adam_grads(monkeypatch)
    losses = []
    out = recon.reconstruct(case.model, case.qparams, [case.args], WQ, AQ,
                            mode=mode, iters=ITERS, lr=LR,
                            adaround=adaround, return_alphas=True,
                            losses=losses)
    jlosses = [float(l) for l, _ in rec]
    assert len(losses) == len(jlosses) == ITERS
    for got, want in zip(losses, jlosses):
        assert abs(float(got) - want) <= 1e-5 * abs(want), (losses, jlosses)
    (qp, alphas), (jqp, jalphas) = out, jout
    # the port's Adam holds the log-deltas, then the alphas, by name
    trained = [(n, "log_delta") for n in sorted(qp)] + \
        [(n, "alpha") for n in sorted(alphas)]
    # elements whose gradient agrees to 1e-3 of itself at every step: Adam
    # moves them alike (the others' steps differ by up to 2 lr)
    held = {}
    for step, ((_, jg), g) in enumerate(zip(rec, grads)):
        assert len(g) == len(trained)
        for (n, k), got in zip(trained, g):
            want = jg[n][k]
            assert rel(got, want) <= 1e-4, (step, n, k, rel(got, want))
            held[n, k] = held.get((n, k), True) & (
                np.abs(got - want) <= 1e-3 * np.abs(want))
    assert sorted(qp) == sorted(jqp)
    bi = 1  # W4
    for n in qp:
        got = qp[n].w_delta[bi].numpy()
        want = np.asarray(jqp[n].w_delta[bi])
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want)), n
        # the split twin and the other rows stay as calibrated
        np.testing.assert_array_equal(qp[n].w_delta[0],
                                      case.qparams[n].w_delta[0])
        if qp[n].w0_delta is not None:
            assert qp[n].w0_delta is case.qparams[n].w0_delta
    # the calibrated qparams are left as they were
    assert not any(q.w_delta.requires_grad for q in case.qparams.values())
    assert sorted(alphas) == sorted(jalphas)
    assert bool(alphas) == adaround
    for n in alphas:
        assert alphas[n].shape == tuple(jalphas[n].shape)
        h = held[n, "alpha"]
        assert h.mean() >= 0.99, (n, h.mean())
        np.testing.assert_allclose(alphas[n].numpy()[h],
                                   np.asarray(jalphas[n])[h],
                                   rtol=0, atol=1e-5, err_msg=n)


# ---------------------------------------------------------------- QAT


@contextlib.contextmanager
def x64():
    """JAX in float64 for the whole process (``jax.enable_x64`` is
    thread-local, and the host callbacks run on another thread)."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def test_qat_step_matches_jax(cases, monkeypatch):
    """One step of ``make_qat_train_step`` on the split resnet block at
    W4A8, target the FP output plus noise, in float64 in both packages
    (the weights, qparams and batch of the float32 case widened): in
    float32 the gradient of a per-tensor act delta, a sum of STE
    residuals that cancel, agrees only to 5e-4 of itself."""
    case = cases["resnet"]
    names = sorted(case.qparams)
    lr = 1e-3
    with x64():
        model = SplitResnet(torch.float64)
        model.load_state_dict({k: v.double() for k, v in
                               case.model.state_dict().items()})
        qparams = {n: q.replace(**{f: getattr(q, f).double()
                                   for f in convert._QP_FIELDS
                                   if getattr(q, f) is not None})
                   for n, q in case.qparams.items()}
        args = tuple(a.double() for a in case.args)
        with torch.no_grad():
            target = model(*args) + 0.1 * torch.from_numpy(
                np.random.default_rng(5).normal(0, 1, (2, 8, 8, 64)))

        rec = record_value_and_grad(monkeypatch)
        jinit, jstep = jqat.make_qat_train_step(
            JSplitResnet(jnp.float64), JWQ, JAQ,
            juniform_ctrl(names, w_bits=4, a_bits=8), lr)
        jp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), case.params)
        jq = to_jax_qparams(qparams)
        jp2, jq2, _, jloss = jax.jit(jstep)(
            jp, jq, jinit(jp, jq), tuple(jnp.asarray(a.numpy())
                                         for a in args),
            jnp.asarray(target.numpy()))
        jax.effects_barrier()
        (_, (jgp, jgq)), = rec

        init, step = qat.make_qat_train_step(
            model, WQ, AQ, uniform_ctrl(names, w_bits=4, a_bits=8), lr)
        params = dict(model.named_parameters())
        params, qparams, _, loss = step(params, qparams,
                                        init(params, qparams), args, target)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)

    def check(name, t, g_want, new_want):
        g_want, new_want = np.asarray(g_want), np.asarray(new_want)
        assert g_want.dtype == np.float64, name
        g = np.zeros_like(g_want) if t.grad is None else t.grad.numpy()
        if not np.abs(g_want).max():
            assert not np.abs(g).max(), name
        else:
            assert rel(g, g_want) <= 1e-4, (name, rel(g, g_want))
        moved = np.abs(g_want) > 1e-6
        np.testing.assert_allclose(t.detach().numpy()[moved],
                                   new_want[moved], rtol=0, atol=1e-6,
                                   err_msg=name)

    sd_g = convert.params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jgp))
    sd_new = convert.params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jp2))
    assert sorted(sd_g) == sorted(params)
    for k, t in params.items():
        check(k, t, sd_g[k], sd_new[k])
    n_leaves = 0
    for n in names:
        for f in convert._QP_FIELDS:
            t = getattr(qparams[n], f)
            assert (t is None) == (getattr(jgq[n], f) is None), (n, f)
            if t is not None:
                n_leaves += 1
                check(f"{n}.{f}", t, getattr(jgq[n], f), getattr(jq2[n], f))
    # every field of every layer trains, the split conv's twins too
    assert n_leaves == 4 * len(names) + 4


# ---------------------------------------------------------------- the CLI


def fake_sqnr(unet, qparams, wq, aq, batches):
    """W4A8 fake quantization of the UNet against FP (dB), summed over
    ``batches``."""
    names = list(quantizable_layers(unet))
    ctx = QuantCtx(mode="fake", qparams=qparams, wq=wq, aq=aq,
                   ctrl=uniform_ctrl(names, w_bits=4, a_bits=8))
    with torch.no_grad():
        ref = torch.cat([unet(*b).flatten() for b in batches])
        got = torch.cat([unet(*b, ctx=ctx).flatten() for b in batches])
    return float(sqnr(ref, got))


@pytest.fixture(scope="module")
def w4_flow(tmp_path_factory):
    """``configs/tiny.yaml`` at W4, its calibration data written from a
    seed (``gen_calib_data``'s keys and shapes; its prompts go through the
    hash tokenizer, whose ids change with the process), then ``ptq``
    without ``--recon``."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    tmp = tmp_path_factory.mktemp("recon_flow")
    cfg = merge(load_config(os.path.join(REPO, "configs", "tiny.yaml")),
                {"calib_data": {"path": str(tmp / "calib.npz")},
                 "quant": {"weight": {"n_bits": 4}}})
    cfg_path = str(tmp / "tiny_w4.yaml")
    save_config(cfg, cfg_path)
    x, _, ehs, added = pipeline.example_inputs(
        cfg.model.family, batch=cfg.calib_data.n_samples,
        dtype=torch.float32, device="cpu")
    np.savez(cfg.calib_data.path, xs=x[None].numpy(),
             ts=np.array([999.0], np.float32),
             outputs=np.zeros_like(x[None].numpy()), text_embs=ehs.numpy(),
             text_embeds=added["text_embeds"].numpy(),
             time_ids=added["time_ids"].numpy())
    plain = ptq.main(["--config", cfg_path, "--outdir", str(tmp / "plain"),
                      "--device", "cpu"])
    yield {"tmp": tmp, "cfg": cfg, "cfg_path": cfg_path, "plain": plain}
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def run_ptq(flow, name, *opts):
    exp = str(flow["tmp"] / name)
    res = ptq.main(["--config", flow["cfg_path"], "--outdir", exp,
                    "--device", "cpu", *opts])
    return exp, res


def test_ptq_recon_layer_cli(w4_flow):
    """``ptq --recon layer``: JAX's ``load_qparams`` reads the file, equal
    to the returned qparams; only the W4 ``w_delta`` rows moved from the
    plain calibration's; no ``alphas.msgpack``."""
    exp, res = run_ptq(w4_flow, "layer", "--recon", "layer",
                       "--recon_iters", "2")
    assert res["alphas"] is None and res["seconds"]["recon"] > 0
    assert not os.path.exists(os.path.join(exp, "alphas.msgpack"))
    jq = jload_qparams(res["path"])
    plain = w4_flow["plain"]["qparams"]
    assert sorted(jq) == sorted(res["qparams"]) == sorted(plain)
    for n, qp in res["qparams"].items():
        for f in convert._QP_FIELDS:
            t = getattr(qp, f)
            if t is None:
                continue
            np.testing.assert_array_equal(np.asarray(getattr(jq[n], f)),
                                          t.numpy())
            p = getattr(plain[n], f).numpy()
            if f == "w_delta":
                assert not np.array_equal(t[1].numpy(), p[1]), n
                t, p = t.numpy()[[0, 2]], p[[0, 2]]
            np.testing.assert_array_equal(np.asarray(t), p)


def test_ptq_recon_model_raises_w4_sqnr(w4_flow):
    """``ptq --recon model --recon_iters 5``: the W4A8 fake SQNR of the
    tiny UNet against FP over the calibration batches rises (the loss is
    that output's MSE), as the JAX package's ``tests/test_recon.py``
    asserts of its reconstruction."""
    from mixdq_tpu_torch.pipelines.loader import (build_pipeline,
                                                  specs_from_config)

    _, res = run_ptq(w4_flow, "model", "--recon", "model",
                     "--recon_iters", "5")
    cfg = w4_flow["cfg"]
    unet = build_pipeline(cfg, device="cpu").unet
    data = dict(np.load(cfg.calib_data.path))
    batches = list(ptq.calib_batches_from_npz(
        data, cfg.calib_data.batch_size, np.random.RandomState(0)))
    wq, aq, _ = specs_from_config(cfg)
    before = fake_sqnr(unet, w4_flow["plain"]["qparams"], wq, aq, batches)
    after = fake_sqnr(unet, res["qparams"], wq, aq, batches)
    assert after > before, (before, after)


def test_ptq_recon_adaround_cli(w4_flow):
    """``ptq --recon model --adaround --recon_iters 3``: ``alphas.msgpack``
    read by flax's ``msgpack_restore`` equals the returned alphas, one of
    each kernel's shape; the deploy with the alphas folded gives the hard
    AdaRound fake-quant codes, layer by layer (split convs half by half)."""
    from mixdq_tpu_torch.pipelines.loader import build_pipeline

    exp, res = run_ptq(w4_flow, "adaround", "--recon", "model",
                       "--adaround", "--recon_iters", "3")
    alphas, qparams = res["alphas"], res["qparams"]
    with open(os.path.join(exp, "alphas.msgpack"), "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    pipe = build_pipeline(w4_flow["cfg"], device="cpu")
    unet, layers = pipe.unet, quantizable_layers(pipe.unet)
    assert list(restored) == sorted(layers) == sorted(alphas)
    for n, a in restored.items():
        assert a.dtype == np.float32 and a.shape == layers[n].weight.shape
        np.testing.assert_array_equal(a, alphas[n].numpy())
    bi = 1  # W4
    splits = {k: v for k, v in pipe.splits.items() if k in layers}
    deploy = build_deploy_params(unet, qparams, {n: (4, 8) for n in layers},
                                 splits=splits, alphas=alphas)
    n_split = 0
    for n, e in deploy.items():
        w, qp, a = layers[n].weight.detach(), qparams[n], alphas[n]
        parts = [(e, w, a, qp.w_delta[bi])]
        if e.kind == "conv_split":
            s, n_split = e.split, n_split + 1
            parts = [(e.part0, w[:, :, :s], a[:, :, :s], qp.w_delta[bi]),
                     (e.part1, w[:, :, s:], a[:, :, s:], qp.w0_delta[bi])]
        for part, wp, ap, d in parts:
            hard = fake_quant_adaround(wp, d, torch.zeros_like(d), 4, ap,
                                       sym=True, hard=True)
            codes = torch.round(hard / d).to(torch.int8)
            np.testing.assert_array_equal(part.w_int.numpy(),
                                          codes.numpy(), err_msg=n)
    assert n_split == len(splits) > 0
