"""Fake-quant mode of the port's tiny-sdxl UNet against the JAX package's,
on the same weights, qparams, controls and inputs, in float32 on the
CPU; calibration with the softmax spec; the codes that a deploy with
AdaRound ``alphas`` folds in.

The steps (``STEPS``), on the JAX calibration with the channel splits'
twin qparams and the q/k/v/softmax act quantizers: uniform W8A8;
BoS-aware with soft AdaRound rounding; a mixed map built with
``group_ctrl`` (W2 weights in one level, W4A4 in another) with hard
AdaRound rounding; the q/k/v/softmax quantizers with the sigmoid GEGLU;
and the ``deploy_compute='int8'`` deploy (act-quantize, then ``qmatmul``
/ the conv kernels' plain versions, fused QKV/KV, ``conv_split``
entries). AdaRound alphas are random for every layer (a split conv's
halves skip them, as in JAX: they are fitted on the whole kernel).
Features share steps so that the JAX side compiles five programs.

Each step is held three ways:

* every quantized layer and act quantizer alone, teacher-forced on the
  input (and ``extra_bias`` / ``residual``) the JAX step gave it, against
  the JAX layer's output: rel 1e-5 (the same fake-quantized operands, a
  product summed in another order); the act quantizers bit for bit;
* the act codes of every quantized layer in the port's call order (fake
  mode: its act qparams; int8: its deploy entry's) agree with the JAX
  step's until the first layer where they differ, and there by at most
  1 on under 1% of them (PERF.md section 2's code criterion: a float sum
  in another order puts a value on the other side of a rounding edge,
  and the random tiny UNet carries that one code far: on the W8A8 step
  one flipped code at ``ff.net.0.proj`` moves the output by rel 0.03);
* where every code agrees, the outputs within rel 1e-2 (PERF.md section
  2's UNet tolerance) and max |d| < 0.3.

The port's calibration is held against JAX's at the port's calibration
tolerance (zero points within 1, weight deltas rel 1e-6, act deltas rel
1e-4).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as jnn  # noqa: E402

from mixdq_tpu.models.configs import get_family as jfamily  # noqa: E402
from mixdq_tpu.models.layers import QAct as JQAct  # noqa: E402
from mixdq_tpu.models.layers import QConv as JQConv  # noqa: E402
from mixdq_tpu.models.layers import QDense as JQDense  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.models.unet import (  # noqa: E402
    conv_shortcut_splits as jsplits)
from mixdq_tpu.quant import calibrate as jcal  # noqa: E402
from mixdq_tpu.quant import deploy as jdeploy  # noqa: E402
from mixdq_tpu.quant import state as jstate  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402

from mixdq_tpu_torch import convert, pipeline  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.models.layers import QAct  # noqa: E402
from mixdq_tpu_torch.models.unet import UNet2DConditionModel  # noqa: E402
from mixdq_tpu_torch.quant import checkpoint, state  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.core import QuantSpec  # noqa: E402
from mixdq_tpu_torch.quant.deploy import (build_deploy_params,  # noqa: E402
                                          deploy_unet_ctx)

JWQ = JSpec(sym=True, channel_wise=True, round_mode="nearest")
JAQ = JSpec(running_stat=True)
JSM = JSpec(running_stat=True, always_zero=True)
SM = QuantSpec(running_stat=True, always_zero=True)
#: the step configurations
STEPS = ("w8a8", "bos_alphas_soft", "mixed_alphas_hard", "qkv_sigmoid",
         "int8")


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


def qparams_np(qparams):
    return {n: {f.name: (None if getattr(qp, f.name) is None
                         else np.asarray(getattr(qp, f.name)))
                for f in dataclasses.fields(qp)}
            for n, qp in qparams.items()}


def recorder(holder):
    """A flax method interceptor: each ``QDense`` / ``QConv`` / ``QAct``
    call's input, array keyword arguments and output into
    ``holder['cur']`` under (port name, 'in' | 'out' | keyword) at run
    time (a compiled program reused from another step writes into the
    ``holder['cur']`` of its run), its static keywords into
    ``holder['static']`` at trace time."""

    def put(key):
        return lambda v: holder["cur"].__setitem__(key, np.asarray(v))

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if context.method_name == "__call__" and isinstance(
                mod, (JQConv, JQDense, JQAct)):
            name = jstate.canonical_name(tuple(mod.path))
            jax.debug.callback(put((name, "in")), args[0])
            jax.debug.callback(put((name, "out")), out)
            static = {}
            for k, v in kwargs.items():
                if isinstance(v, (jax.Array, np.ndarray)):
                    jax.debug.callback(put((name, k)), v)
                elif k in ("split", "bos_aware"):
                    static[k] = v
            holder.setdefault("static", {})[name] = static
        return out

    return intercept


def recorded_run(fn, holder, *args):
    """``fn(*args)`` under ``recorder(holder)``: (output, {key: value} of
    this run, the statics under (name, 'static'))."""
    holder["cur"] = {}
    with jnn.intercept_methods(recorder(holder)):
        y = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
    rec = dict(holder["cur"])
    rec.update({(n, "static"): v
                for n, v in holder.get("static", {}).items()
                if (n, "in") in rec})
    return y, rec


def build_reference(steps):
    """tiny-sdxl on the JAX side (inputs and perturbed biases and norm
    scales from seed 2, as ``tests/test_torch_port_model.py``'s fixture;
    the port's ``init_weights(0)`` kernels): weights, inputs, the JAX
    calibration with the splits and the softmax spec, random AdaRound
    alphas, and each configuration of ``steps`` run with its layers
    recorded. Returns a dict of numpy values."""
    rng = np.random.default_rng(2)
    cfg = jfamily("tiny-sdxl").unet
    jm = JUNet(cfg)
    H = cfg.sample_size
    inputs = {
        "sample": rng.standard_normal((1, H, H, 4)).astype(np.float32),
        "ehs": rng.standard_normal((1, 77, cfg.cross_attention_dim)
                                   ).astype(np.float32),
        "text_embeds": rng.standard_normal((1, 64)).astype(np.float32),
        "time_ids": np.array([[128, 128, 0, 0, 128, 128]], np.float32)}
    jargs = (jnp.asarray(inputs["sample"]), jnp.asarray(999.0),
             jnp.asarray(inputs["ehs"]),
             {"text_embeds": jnp.asarray(inputs["text_embeds"]),
              "time_ids": jnp.asarray(inputs["time_ids"])})
    # the port's random init in the JAX layout (no JAX init to compile)
    pm = UNet2DConditionModel(get_family("tiny-sdxl").unet).init_weights(0)
    params = perturb(jax.tree_util.tree_map(
        lambda t: np.array(t.numpy()), checkpoint.module_params(pm)), rng)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    layers = jstate.quantizable_layers(params)
    splits = {n: s for n, s in jsplits(cfg).items() if n in layers}
    arng = np.random.default_rng(5)
    alphas = {n: (arng.standard_normal(
        np.asarray(jstate.get_layer_kernel(params, p)).shape) * 2
    ).astype(np.float32) for n, p in sorted(layers.items())}
    jqp = jcal.calibrate(jm, variables, [jargs], JWQ, JAQ, softmax_aq=JSM,
                         splits=splits)
    out = dict(params=params, inputs=inputs, splits=splits, alphas=alphas,
               names=sorted(layers), qparams=qparams_np(jqp), steps={})
    fn = jax.jit(lambda v, c, *a: jm.apply(v, *a, c))
    holder = {}
    for step in steps:
        ctx = jax_ctx(step, jqp, out, jm, variables)
        v = (jdeploy.deployed_params(variables, ctx) if ctx.mode == "int8"
             else variables)
        out["steps"][step] = recorded_run(fn, holder, v, ctx, *jargs)
    return out


def mixed_targets():
    """(targets, which, bits) of the mixed map: W2 weights in the down
    blocks' second level, W4A4 in the first up block, W8A8 elsewhere."""
    return (["down_blocks.1"], "weight", 2), (["up_blocks.0"], "both", 4)


def ctrl_for(step, names, qparams_names, mod):
    """The controls of ``step`` from ``mod`` (the port's or the JAX
    package's ``state`` module)."""
    if step.startswith("qkv"):
        return mod.uniform_ctrl(sorted(qparams_names), w_bits=8, a_bits=8)
    ctrl = mod.uniform_ctrl(names, w_bits=8, a_bits=8)
    if step.startswith("mixed"):
        for targets, which, bits in mixed_targets():
            g = mod.group_ctrl(names, targets, which, bits)
            ctrl.update({n: g[n] for n in names
                         if any(n.startswith(t + ".") for t in targets)})
    return ctrl


def ctx_options(step):
    """The fake context's options of ``step``, by the port's field names
    (``softmax_aq`` / ``alphas`` as True where the step sets them)."""
    return {"bos_alphas_soft": dict(bos_aware=True, alphas=True,
                                    soft_round=True),
            "mixed_alphas_hard": dict(alphas=True),
            "qkv_sigmoid": dict(qkv_quant=True, softmax_aq=True,
                                gelu="sigmoid")}.get(step, {})


def jax_ctx(step, jqp, ref, jm, variables):
    ctrl = ctrl_for(step, ref["names"], jqp, jstate)
    if step == "int8":
        ctx = jdeploy.deploy_unet_ctx(jm, variables, jqp, ctrl, JWQ, JAQ,
                                      splits=ref["splits"], fuse_qkv=True)
        return ctx.replace(deploy_compute="int8")
    kw = ctx_options(step)
    if kw.get("softmax_aq"):
        kw["softmax_aq"] = JSM
    if kw.get("alphas"):
        kw["alphas"] = {n: jnp.asarray(a) for n, a in ref["alphas"].items()}
    return jstate.QuantCtx(qparams=jqp, ctrl=ctrl, mode="fake", wq=JWQ,
                           aq=JAQ, **kw)


def port_ctx(step, ref, m):
    qparams = convert.qparams_from_numpy(ref["qparams"])
    ctrl = ctrl_for(step, ref["names"], ref["qparams"], state)
    if step == "int8":
        return deploy_unet_ctx(m, qparams, ctrl, pipeline.WQ, fuse_qkv=True,
                               splits=ref["splits"], deploy_compute="int8")
    kw = ctx_options(step)
    if kw.get("softmax_aq"):
        kw["softmax_aq"] = SM
    if kw.get("alphas"):
        kw["alphas"] = {n: T(a) for n, a in ref["alphas"].items()}
    return state.QuantCtx(qparams=qparams, ctrl=ctrl, mode="fake", **kw)


def port_unet(ref):
    m = UNet2DConditionModel(get_family("tiny-sdxl").unet)
    m.load_state_dict(convert.params_to_state_dict(ref["params"]),
                      strict=True)
    i = ref["inputs"]
    args = (T(i["sample"]), torch.tensor(999.0), T(i["ehs"]),
            {"text_embeds": T(i["text_embeds"]),
             "time_ids": T(i["time_ids"])})
    return m.eval(), args


def port_calls(m, args, ctx):
    """(output, [(name, input, kwargs)] of every QDense / QConv / QAct
    call in order) of one step."""
    calls = []

    def hook(mod, a, kw):
        calls.append((mod.qname, a[0], dict(kw)))

    mods = {**state.quantizable_layers(m), **state.act_quantizers(m)}
    hs = [x.register_forward_pre_hook(hook, with_kwargs=True)
          for x in mods.values()]
    try:
        with torch.no_grad():
            y = m(*args, ctx=ctx)
    finally:
        for h in hs:
            h.remove()
    return y, calls


def act_codes(x, qp, idx, split=0, part=0):
    d = qp["a0_delta" if part else "a_delta"]
    z = qp["a0_zp" if part else "a_zp"]
    if d is None:
        return None
    x = np.asarray(x, np.float32)
    x = x[..., split:] if part else (x[..., :split] if split else x)
    return np.round(x / d[idx]) + z[idx]


def deploy_codes(x, e, split=0):
    """The act codes of deploy entry ``e`` for ``x``: ``round(x * (1 /
    delta)) + zp`` as the deploy rounds (each half of a ``conv_split``
    entry with its own); None for a weight-only entry."""
    if e is None or e.act_off:
        return None
    x = np.asarray(x, np.float32)
    if e.kind == "conv_split":
        return np.concatenate([deploy_codes(x[..., :e.split], e.part0).ravel(),
                               deploy_codes(x[..., e.split:], e.part1).ravel()])
    return np.round(x * np.float32(e.scale_inv)) + np.float32(e.zp_shifted)


def layer_codes(name, x, ctx, kw):
    """The act codes of layer ``name``'s input under ``ctx`` (fake mode:
    its act qparams at its control's bits, each half of a split conv with
    its own; int8 mode: its deploy entry's), or None where its acts are
    not quantized."""
    if ctx.mode == "int8":
        return deploy_codes(x, ctx.entry(name))
    qp, ct = ctx.layer(name)
    if qp is None or ct is None or not ct.a_on:
        return None
    qp = {f: (None if getattr(qp, f) is None else getattr(qp, f).numpy())
          for f in ("a_delta", "a_zp", "a0_delta", "a0_zp")}
    split = kw.get("split", 0)
    parts = [act_codes(x, qp, ct.a_idx, split, p) for p in
             ((0, 1) if split else (0,))]
    parts = [p for p in parts if p is not None]
    return None if not parts else np.concatenate([p.ravel() for p in parts])


def first_code_difference(calls, rec, ctx, what):
    """The first layer of ``calls`` (the port's, in call order) whose act
    codes under ``ctx`` differ from those of the JAX input in
    ``rec``, after asserting they differ there by at most 1 on under 1%;
    None where every code agrees."""
    for name, x, kw in calls:
        a = layer_codes(name, x.numpy(), ctx, kw)
        if a is None or (name, "in") not in rec:
            continue
        diff = np.abs(a - layer_codes(name, rec[(name, "in")], ctx, kw))
        if diff.max() > 0:
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (
                what, name, diff.max(), (diff > 0).mean())
            return name
    return None


def check_step(step, ref, m, args):
    """The three checks of the module docstring for one step."""
    want, rec = ref["steps"][step]
    ctx = port_ctx(step, ref, m)
    got, calls = port_calls(m, args, ctx)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    # 1. each layer alone on the JAX step's input
    for name, _, kw in calls:
        assert (name, "in") in rec, (step, name)
        mod = m.get_submodule(name)
        x = T(rec[(name, "in")])
        pkw = dict(rec[(name, "static")])
        for k in ("extra_bias", "residual"):
            if (name, k) in rec:
                pkw[k] = T(rec[(name, k)])
        with torch.no_grad():
            y = mod(x, ctx, **pkw).numpy()
        y_want = rec[(name, "out")]
        if isinstance(mod, QAct):
            np.testing.assert_array_equal(y, y_want, err_msg=name)
        else:
            r = np.linalg.norm(y - y_want) / max(np.linalg.norm(y_want),
                                                 1e-30)
            assert r <= 1e-5, (step, name, r)
    assert len(calls) == len({k[0] for k in rec}), step
    # 2. the code criterion in call order, 3. the output where codes agree
    first = first_code_difference(calls, rec, ctx, step)
    if first is not None:
        return f"codes first differ at {first}"
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, (step, rel)
    assert np.abs(got - want).max() < 0.3
    return "every code agrees"


@pytest.fixture(scope="module")
def ref():
    return build_reference(STEPS)


@pytest.mark.parametrize("step", STEPS)
def test_tiny_fake_step_matches_jax(ref, step):
    m, args = port_unet(ref)
    check_step(step, ref, m, args)


def test_calibration_with_softmax_matches_jax(ref):
    """The port's calibration with the channel splits and the softmax
    spec: JAX's qparams, every ``act_quantizer_*`` key (q, k, v and the
    always-zero softmax of each attention) included."""
    m, args = port_unet(ref)
    got = convert.qparams_to_numpy(calibrate(
        m, [args], pipeline.WQ, pipeline.AQ, softmax_aq=SM,
        splits=ref["splits"]))
    want = ref["qparams"]
    assert set(got) == set(want)
    qact = [n for n in want if ".act_quantizer_" in n]
    n_attn = sum(1 for n, _ in m.named_modules()
                 if n.endswith((".attn1", ".attn2")))
    assert len(qact) == 4 * n_attn > 0
    for name, fields in want.items():
        for f, v in fields.items():
            g = got[name][f]
            assert (g is None) == (v is None), (name, f)
            if v is None:
                continue
            if f.endswith("zp"):
                assert np.abs(g - v).max() <= 1, (name, f)
            elif f.startswith("w"):
                np.testing.assert_allclose(g, v, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(g, v, rtol=1e-4, err_msg=name)
    for name in qact:
        if name.endswith("softmax"):
            assert (want[name]["a_zp"] == 0).all()


def test_adaround_deploy_codes_match_jax(ref):
    """``build_deploy_params`` with AdaRound alphas: every entry's codes
    (a split conv's halves with alpha sliced on HWIO axis 2, fused QKV/KV
    entries rebuilt from each member's alpha) equal JAX's; without alphas
    they differ."""
    m, _ = port_unet(ref)
    qp_np = ref["qparams"]
    layer_bits = {n: (8, 8) for n in ref["names"]}
    alphas = {n: T(a) for n, a in ref["alphas"].items()}
    got = build_deploy_params(m, convert.qparams_from_numpy(qp_np),
                              layer_bits, splits=ref["splits"],
                              alphas=alphas, fuse_qkv=True)
    jqp = {n: jstate.LayerQParams(**{f: None if v is None else jnp.asarray(v)
                                     for f, v in fs.items()})
           for n, fs in qp_np.items()}
    want = jax.jit(lambda p, qp, al: jdeploy.build_deploy_params(
        p, qp, layer_bits, splits=ref["splits"], alphas=al, fuse_qkv=True))(
        ref["params"], jqp,
        {n: jnp.asarray(a) for n, a in ref["alphas"].items()})
    assert set(got) == set(want)
    n_split = 0
    for name, e in want.items():
        g = got[name]
        assert g.kind == e.kind, name
        pairs = ([(g.part0, e.part0), (g.part1, e.part1)]
                 if e.kind == "conv_split" else [(g, e)])
        n_split += e.kind == "conv_split"
        for gg, ee in pairs:
            if ee.w_int is None:
                continue
            np.testing.assert_array_equal(gg.w_int.numpy(),
                                          np.asarray(ee.w_int), err_msg=name)
            np.testing.assert_array_equal(gg.bias0.numpy(),
                                          np.asarray(ee.bias0), err_msg=name)
    assert n_split == len(ref["splits"]) > 0
    plain = build_deploy_params(m, convert.qparams_from_numpy(qp_np),
                                layer_bits, splits=ref["splits"],
                                fuse_qkv=True)
    assert not torch.equal(plain["conv_in"].w_int, got["conv_in"].w_int)
    # the deploy context carries them through
    ctx = deploy_unet_ctx(m, convert.qparams_from_numpy(qp_np),
                          state.uniform_ctrl(ref["names"]), pipeline.WQ,
                          splits=ref["splits"], alphas=alphas)
    assert torch.equal(ctx.deploy["conv_in"].w_int, got["conv_in"].w_int)
