"""Channel-split convs in the port (the up blocks' concat-shortcut convs:
``models/unet.py:conv_shortcut_splits``, twin qparams in
``quant/calibrate.py``, ``conv_split`` deploy entries in
``quant/deploy.py``, their forward in ``models/layers.py``) against the
JAX package's, on the tiny-sdxl UNet with the same weights and inputs,
in float32 on the CPU.

Each half is held on its own: in ``LayerQParams`` the plain fields hold
the first input-channel slice ``[..., :split]`` and the ``*0`` twins the
second; ``part0`` / ``part1`` of a deploy entry follow them. Tolerances:
the port's calibration parity test's (``tests/test_torch_port_model.py``:
zero points within 1, weight deltas rel 1e-6, act deltas rel 1e-4); deploy
entries equal; each split layer alone, on the input it sees in the FP
step, and in the whole step on the input the JAX step gave it, against
the JAX package's ``QConv`` on the same entry: rel 1e-5. The whole steps
(step inputs from ``STEP_SEEDS``) are held to PERF.md's code criterion:
the act codes of every quantized layer agree in call order until the
first layer where they differ, and there by at most 1 on under 1% of
them (float sums in another order put a value on the other side of a
rounding edge; the random tiny UNet then carries that one code far, to
rel ~0.03 at its output). Where every act code of the step agrees (and
under ``dequant``, which rounds no act), the outputs are held to
``|d|/|ref| <= 1e-2`` and ``max |d| < 0.3``. The JAX int8 path runs its
Pallas kernels in interpret mode. The weights and the calibration input
are seeded as ``tests/test_torch_port_model.py``'s tiny fixture (seed 2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as jnn  # noqa: E402

from mixdq_tpu.models.configs import get_family as jfamily  # noqa: E402
from mixdq_tpu.models.layers import QConv as JQConv  # noqa: E402
from mixdq_tpu.models.layers import QDense as JQDense  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.models.unet import (  # noqa: E402
    conv_shortcut_splits as jsplits)
from mixdq_tpu.quant import calibrate as jcal  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402
from mixdq_tpu.quant.deploy import (deploy_unet_ctx as jdeploy,  # noqa: E402
                                    deployed_params)
from mixdq_tpu.quant.state import FP_CTX as J_FP  # noqa: E402
from mixdq_tpu.quant.state import (quantizable_layers as jlayers,  # noqa: E402
                                   uniform_ctrl as juniform)

from mixdq_tpu_torch import convert, ops, pipeline  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.layers import codes_of  # noqa: E402
from mixdq_tpu_torch.models.unet import (  # noqa: E402
    UNet2DConditionModel, conv_shortcut_splits)
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.deploy import (DeployEntry,  # noqa: E402
                                          deploy_unet_ctx,
                                          prune_deployed_weights)
from mixdq_tpu_torch.quant.state import (canonical_name,  # noqa: E402
                                         quantizable_layers, uniform_ctrl)

JWQ = JSpec(sym=True, channel_wise=True, round_mode="nearest")
JAQ = JSpec(running_stat=True)
#: (deploy compute, fused QKV/KV) of the two steps held against JAX
COMPUTES = (("int8_sec", True), ("dequant", False))
#: seeds of the whole steps' inputs (2: the calibration input)
STEP_SEEDS = (2, 3, 4)


def T(a):
    return torch.from_numpy(np.array(a))


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


def step_inputs(rng, cfg):
    H = cfg.sample_size
    return {
        "sample": rng.standard_normal((1, H, H, 4)).astype(np.float32),
        "ehs": rng.standard_normal((1, 77, cfg.cross_attention_dim)
                                   ).astype(np.float32),
        "text_embeds": rng.standard_normal((1, 64)).astype(np.float32),
        "time_ids": np.array([[128, 128, 0, 0, 128, 128]], np.float32),
    }


def jax_args(i):
    return (jnp.asarray(i["sample"]), jnp.asarray(999.0),
            jnp.asarray(i["ehs"]),
            {"text_embeds": jnp.asarray(i["text_embeds"]),
             "time_ids": jnp.asarray(i["time_ids"])})


def recorder(rec, splits):
    """A flax method interceptor: the input of each ``QConv`` / ``QDense``
    call, and the output of each split layer, sent to the host into
    ``rec['cur']`` under ``('in' | 'out', port name)``."""

    def put(key):
        return lambda v: rec["cur"].__setitem__(key, np.asarray(v))

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if context.method_name == "__call__" and isinstance(
                mod, (JQConv, JQDense)):
            name = canonical_name(tuple(mod.path))
            jax.debug.callback(put(("in", name)), args[0])
            if name in splits:
                jax.debug.callback(put(("out", name)), out)
        return out

    return intercept


def qparams_np(qparams):
    return {n: {f.name: (None if getattr(qp, f.name) is None
                         else np.asarray(getattr(qp, f.name)))
                for f in dataclasses.fields(qp)}
            for n, qp in qparams.items()}


@pytest.fixture(scope="module")
def tiny():
    """tiny-sdxl on the JAX side: weights, inputs, the calibration with
    splits, the deploys under ``COMPUTES``, and their steps on the inputs
    of ``STEP_SEEDS`` with each quantized layer's input and each split
    layer's output recorded."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MIXDQ_PALLAS_INTERPRET", "1")
        rng = np.random.default_rng(2)
        cfg = jfamily("tiny-sdxl").unet
        jm = JUNet(cfg)
        inputs = step_inputs(rng, cfg)
        jargs = jax_args(inputs)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs)
        params = perturb(jax.tree_util.tree_map(np.asarray,
                                                variables["params"]), rng)
        variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
        names = jlayers(params)
        splits = {n: s for n, s in jsplits(cfg).items() if n in names}
        jqp = jcal.calibrate(jm, variables, [jargs], JWQ, JAQ, splits=splits)
        ctrl = juniform(names, w_bits=8, a_bits=8)
        outs, steps, rec = {}, {}, {}
        for compute, fuse in COMPUTES:
            ctx = jdeploy(jm, variables, jqp, ctrl, JWQ, JAQ, splits=splits,
                          fuse_qkv=fuse).replace(deploy_compute=compute)
            pruned = deployed_params(variables, ctx)
            step = jax.jit(lambda v, c, *a: jm.apply(v, *a, c))
            with jnn.intercept_methods(recorder(rec, splits)):
                for seed in STEP_SEEDS:
                    rec["cur"] = {}
                    i = (inputs if seed == 2 else
                         step_inputs(np.random.default_rng(seed), cfg))
                    y = np.asarray(step(pruned, ctx, *jax_args(i)))
                    jax.effects_barrier()
                    steps[compute, seed] = (i, y, rec["cur"])
            outs[compute] = (steps[compute, 2][1], ctx.deploy)
        yield dict(params=params, inputs=inputs, splits=splits,
                   qparams=qparams_np(jqp), outs=outs, steps=steps)


def port_unet(tiny, inputs=None):
    m = UNet2DConditionModel(get_family("tiny-sdxl").unet)
    m.load_state_dict(convert.params_to_state_dict(tiny["params"]),
                      strict=True)
    i = inputs or tiny["inputs"]
    args = (T(i["sample"]), torch.tensor(999.0), T(i["ehs"]),
            {"text_embeds": T(i["text_embeds"]), "time_ids": T(i["time_ids"])})
    return m, args


@pytest.mark.parametrize("family", ["tiny-sdxl", "sdxl-turbo"])
def test_conv_shortcut_splits_match_jax(family):
    cfg = get_family(family).unet
    got = conv_shortcut_splits(cfg)
    assert got == jsplits(jfamily(family).unet)
    m = UNet2DConditionModel(cfg, torch.bfloat16, device="meta")
    layers = quantizable_layers(m)
    for name, s in got.items():
        kh, kw, c, _ = layers[name].weight.shape
        assert (kh, kw) == (1, 1) and 0 < s < c, name
    if family == "sdxl-turbo":
        assert list(got.values()) == [1280, 1280, 1280, 1280, 640, 640,
                                      640, 320, 320]


def test_calibration_with_splits_matches_jax(tiny):
    m, args = port_unet(tiny)
    qp = convert.qparams_to_numpy(calibrate(m, [args], pipeline.WQ,
                                            pipeline.AQ,
                                            splits=tiny["splits"]))
    want = tiny["qparams"]
    assert set(qp) == set(want)
    for name, fields in want.items():
        for f, v in fields.items():
            got = qp[name][f]
            assert (got is None) == (v is None), (name, f)
            if v is None:
                continue
            if f.endswith("zp"):
                assert np.abs(got - v).max() <= 1, (name, f)
            elif f.startswith("w"):
                np.testing.assert_allclose(got, v, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(got, v, rtol=1e-4, err_msg=name)
    # each half apart: the twins differ, so a swap would not pass above
    for name in tiny["splits"]:
        f = want[name]
        assert f["w0_delta"] is not None and f["a0_delta"] is not None
        assert f["w_delta"].shape == f["w0_delta"].shape
        assert not np.allclose(f["a_delta"], f["a0_delta"]), name


@pytest.mark.parametrize("compute,fuse", COMPUTES)
def test_split_deploy_entries_match_jax(tiny, compute, fuse):
    m, _ = port_unet(tiny)
    qparams = convert.qparams_from_numpy(tiny["qparams"])
    ctx = deploy_unet_ctx(m, qparams, uniform_ctrl(list(quantizable_layers(m))),
                          pipeline.WQ, fuse_qkv=fuse, splits=tiny["splits"],
                          deploy_compute=compute)
    want = tiny["outs"][compute][1]
    assert set(ctx.deploy) == set(want)
    splits = sorted(n for n, e in ctx.deploy.items()
                    if e.kind == "conv_split")
    assert splits == sorted(tiny["splits"]) and len(splits) == 6
    for name in splits:
        got, w = ctx.deploy[name], want[name]
        assert w.kind == "conv_split" and got.split == w.split
        for part in ("part0", "part1"):
            g, e = getattr(got, part), getattr(w, part)
            assert g.kind == "conv" and g.w_int.shape[2] == (
                got.split if part == "part0"
                else m.get_submodule(name).weight.shape[2] - got.split)
            np.testing.assert_array_equal(g.w_int.numpy(), np.asarray(e.w_int))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(e.scale))
            np.testing.assert_array_equal(g.bias0.numpy(), np.asarray(e.bias0))
            assert g.scale_inv == float(e.scale_inv), (name, part)
            assert g.zp_shifted == float(e.zp_shifted), (name, part)


def first_code_divergence(seen, jseen, deploy):
    """The first quantized layer, in the port's call order, whose act
    codes differ between the two steps, and the |differences| of its
    codes; ``(None, None)`` if every code agrees. ``seen``: (name, input)
    of each call; ``jseen``: the JAX step's inputs by ``('in', name)``."""
    for name, x in seen:
        e = deploy.get(name)
        if e is None or e.kind == "fused_away" or e.act_off:
            continue
        xj = T(jseen["in", name])
        assert xj.dtype == x.dtype and xj.shape == x.shape, name
        parts = (((slice(None, e.split), e.part0),
                  (slice(e.split, None), e.part1))
                 if e.kind == "conv_split" else ((slice(None), e),))
        d = torch.cat([(codes_of(x[..., sl], p).int()
                        - codes_of(xj[..., sl], p).int()).abs().reshape(-1)
                       for sl, p in parts])
        if d.any():
            return name, d
    return None, None


@pytest.mark.parametrize("seed", STEP_SEEDS)
@pytest.mark.parametrize("compute,fuse", COMPUTES)
def test_split_step_matches_jax(tiny, compute, fuse, seed, monkeypatch):
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    inputs, want, jseen = tiny["steps"][compute, seed]
    m, args = port_unet(tiny, inputs)
    layers = quantizable_layers(m)
    qparams = convert.qparams_from_numpy(tiny["qparams"])
    ctx = deploy_unet_ctx(m, qparams, uniform_ctrl(list(layers)),
                          pipeline.WQ, fuse_qkv=fuse, splits=tiny["splits"],
                          deploy_compute=compute)
    prune_deployed_weights(m, ctx.deploy)
    seen = []
    handles = [lay.register_forward_pre_hook(
        lambda mod, a: seen.append((mod.qname, a[0]))) for lay in
        layers.values()]
    ops.reset_counts()
    with torch.no_grad():
        got = m(*args, ctx=ctx).numpy()
    for h in handles:
        h.remove()
    # the counts of the step: a conv_split entry is two qmatmul calls
    # (act-quantized) or none (weight-only)
    calls = pipeline.ctx_kernel_calls(m.config, ctx)
    assert ops.call_counts() == calls
    no_split = dataclasses.replace(ctx, deploy={
        n: (DeployEntry(kind="conv", scale_inv=1.0, w_int=e.part0.w_int)
            if e.kind == "conv_split" else e) for n, e in ctx.deploy.items()})
    assert calls["qmatmul"] - pipeline.ctx_kernel_calls(
        m.config, no_split)["qmatmul"] == (6 if compute == "int8_sec" else 0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert len(seen) == len({n for n, _ in seen}) == \
        len([k for k in jseen if k[0] == "in"])
    # each split entry on the input the JAX step gave it
    for name, s in tiny["splits"].items():
        with torch.no_grad():
            y = layers[name](T(jseen["in", name]), ctx, split=s).numpy()
        ref = jseen["out", name]
        rel = np.linalg.norm(y - ref) / np.linalg.norm(ref)
        assert rel <= 1e-5, (name, rel)
    name, d = ((None, None) if compute == "dequant"
               else first_code_divergence(seen, jseen, ctx.deploy))
    if name is None:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-2, rel
        assert np.abs(got - want).max() < 0.3
    else:
        frac = (d > 0).float().mean().item()
        assert d.max().item() <= 1 and frac < 0.01, (name, d.max(), frac)


class _Shortcut(jnn.Module):
    """One JAX ``QConv`` 1x1 named ``conv_shortcut`` (its deploy key)."""

    features: int

    @jnn.compact
    def __call__(self, x, ctx, split):
        return JQConv(self.features, kernel_size=(1, 1),
                      name="conv_shortcut")(x, ctx, split=split)


@pytest.mark.parametrize("compute,fuse", COMPUTES)
def test_split_layer_matches_jax(tiny, compute, fuse, monkeypatch):
    """Each conv_split entry alone: the port's layer on the input it sees
    in the port's FP step against the JAX ``QConv`` running the JAX
    deploy's entry on the same input; both halves (the second quantized
    with the ``*0`` twins) enter the sum, so a swapped half shows."""
    monkeypatch.setenv("MIXDQ_PALLAS_INTERPRET", "1")
    m, args = port_unet(tiny)
    seen = {}

    def hook(mod, a, kw):
        seen[mod.qname] = (a[0], kw)

    layers = quantizable_layers(m)
    handles = [layers[n].register_forward_pre_hook(hook, with_kwargs=True)
               for n in tiny["splits"]]
    with torch.no_grad():
        m(*args)
    for h in handles:
        h.remove()
    qparams = convert.qparams_from_numpy(tiny["qparams"])
    ctx = deploy_unet_ctx(m, qparams, uniform_ctrl(list(layers)),
                          pipeline.WQ, fuse_qkv=fuse, splits=tiny["splits"],
                          deploy_compute=compute)
    jdep = tiny["outs"][compute][1]
    for name, s in tiny["splits"].items():
        x, kw = seen[name]
        assert kw == {"split": s}
        with torch.no_grad():
            got = layers[name](x, ctx, **kw).numpy()
        jctx = J_FP.replace(mode="int8", deploy={"conv_shortcut": jdep[name]},
                            deploy_compute=compute)
        bias = np.asarray(layers[name].bias.detach())
        want = np.asarray(_Shortcut(got.shape[-1]).apply(
            {"params": {"conv_shortcut": {"bias": jnp.asarray(bias)}}},
            jnp.asarray(x.numpy()), jctx, s))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (name, rel)


def test_expected_kernel_calls_with_splits():
    """SDXL-Turbo's W8A8 layout with its 9 conv_split entries: 9 more
    ``qmatmul`` calls a step than without, nothing else moves; weight-only
    split entries add none."""
    cfg = get_family("sdxl-turbo").unet
    base = pipeline.w8a8_layout(cfg)
    layout = dict(base)
    for name, s in conv_shortcut_splits(cfg).items():
        w = base[name].w_int
        part = [DeployEntry(kind="conv", scale_inv=1.0, w_int=w[:, :, sl])
                for sl in (slice(None, s), slice(s, None))]
        layout[name] = DeployEntry(kind="conv_split", split=s, scale_inv=1.0,
                                   part0=part[0], part1=part[1])
    for attn in ("auto", "einsum"):
        want = pipeline.expected_kernel_calls(cfg, attn)
        got = pipeline.expected_kernel_calls(cfg, attn, deploy=layout)
        assert got == dict(want, qmatmul=want["qmatmul"] + 9)
    off = {n: (e.replace(act_off=True) if e.kind == "conv_split" else e)
           for n, e in layout.items()}
    want = pipeline.expected_kernel_calls(cfg, "auto")
    assert pipeline.expected_kernel_calls(cfg, "auto", deploy=off) == dict(
        want, qmatmul=want["qmatmul"] - 9)
