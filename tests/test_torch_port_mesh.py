"""The port's (dp, tp) mesh (``mixdq_tpu_torch/parallel/``) and its users
on the CPU, in one gloo world of two ranks spawned for the module
(``tests/torch_mesh_ranks.py``: each rank imports torch and the port
only, and computes the unsharded side itself):

* ``make_mesh``: (dp, tp) = (1, 2) by default on two ranks, (2, 1) with
  ``tp=1``; asked for more ranks than the world has, it raises (JAX
  silently takes fewer);
* the shard plan (``make_param_shardings``) of tiny-sdxl's parameters and
  of its W8A8 deploy against JAX's ``param_spec``, leaf for leaf (the JAX
  params at ``jax.eval_shape``'s shapes, the JAX deploy built on them
  with the ranks' qparams);
* the dp sweep equals the sequential sweep value for value, in the
  function and in ``mixed_precision_search --dp_mesh 2``;
* tp: the W8A8 step and the bf16 step equal the unsharded steps bit for
  bit (every sharded tensor is gathered where it is read, so the bound
  of one code and 1 % of codes is met with none differing);
* dp: the int8 flash kernels' dynamic scale over the sharded batch is the
  whole batch's; the engine's images equal the unsharded engine's (FP
  within 1e-4: a batch of 1 against 2 moves f32 GEMMs' last bits;
  ``attn_impl='int8_flash'`` within 1e-3, a code at a rounding edge; with
  the scale taken per rank it misses by 2.2e-3); two tp engines built on
  one pipeline equal them bit for bit, and the pipeline is left whole
  (rank 0 then runs it alone, with no collective);
* QAT's sharded step (``__graft_entry__.py``'s dryrun): on the (1, 2)
  mesh at batch 1, a finite loss equal to the unsharded step's, and the
  same gradients and updated parameters; on (2, 1) at batch 2, in f64,
  the loss and gradients of the global batch.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models.configs import get_family as jfamily  # noqa: E402
from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.parallel.mesh import param_spec as jparam_spec  # noqa: E402
from mixdq_tpu.quant import deploy as jdeploy  # noqa: E402
from mixdq_tpu.quant import state as jstate  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402

from mixdq_tpu_torch import convert  # noqa: E402
from mixdq_tpu_torch.models.configs import get_family  # noqa: E402
from mixdq_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mixdq_tpu_torch.parallel.launch import spawn  # noqa: E402
from mixdq_tpu_torch.scripts import gen_calib_data, ptq  # noqa: E402
from mixdq_tpu_torch.utils.config import (load_config, merge,  # noqa: E402
                                          save_config)

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of ``torch_mesh_ranks.run_checks``, after the
    PTQ CLIs on ``configs/tiny.yaml`` for the search."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = merge(load_config(os.path.join(REPO, "configs", "tiny.yaml")),
                {"calib_data": {"path": str(tmp / "calib.npz")}})
    cfg_path = str(tmp / "tiny.yaml")
    save_config(cfg, cfg_path)
    exp = str(tmp / "exp")
    gen_calib_data.main(["--config", cfg_path, "--device", "cpu"])
    ptq.main(["--config", cfg_path, "--outdir", exp, "--device", "cpu"])
    search = ["--base_path", exp, "--quick", "--n_prompts", "1",
              "--device", "cpu"]
    return spawn("tests.torch_mesh_ranks:run_checks", 2, (search,),
                 threads=2, timeout=600)


def test_make_mesh_shapes_and_more_ranks_raise(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["meshes"] == ((2, 1), (1, 2))
    assert "the world has 2 ranks" in ranks[0]["more_ranks"]
    with pytest.raises(ValueError, match="make_mesh\\(2\\)"):
        pmesh.make_mesh(2, device="cpu")


def _jax_params():
    f = jfamily("tiny-sdxl")
    S = f.unet.sample_size
    pooled = get_family("tiny-sdxl").pooled_dim
    args = (jnp.zeros((1, S, S, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 77, f.unet.cross_attention_dim)),
            {"text_embeds": jnp.zeros((1, pooled)),
             "time_ids": jnp.zeros((1, 6))})
    unet = JUNet(f.unet)
    return unet, jax.eval_shape(unet.init, jax.random.PRNGKey(0), *args)


@pytest.mark.parametrize("tp", [2, 4])
def test_param_plan_matches_jax(ranks, tp):
    """``param_spec`` over tiny-sdxl's parameters, by the port's names
    (``convert.params_to_state_dict`` maps JAX's leaves to them), at tp 2
    and 4; at tp 2 also the ranks' ``make_param_shardings``."""
    _, shapes = _jax_params()
    paths, tree = jax.tree_util.tree_flatten_with_path(shapes["params"])
    jspecs = [tuple(jparam_spec(p, leaf, tp)) for p, leaf in paths]
    idx = jax.tree_util.tree_unflatten(
        tree, [np.full(1, i, np.float32) for i in range(len(paths))])
    names = {k: int(v) for k, v in
             convert.params_to_state_dict(idx).items()}
    plan = ranks[0]["plan_params"]
    assert set(names) == {p[0] for p in plan}
    n_sharded = 0
    for name, i in names.items():
        leaf = paths[i][1]
        want = jspecs[i]
        assert pmesh.param_spec((name,), leaf, tp) == want, name
        if tp == 2:
            assert plan[(name,)] == want, name
        n_sharded += "tp" in want
    assert n_sharded > len(names) // 2


def test_deploy_plan_matches_jax(ranks):
    """The ranks' shard plan of the W8A8 deploy (fused QKV / KV) against
    JAX's ``param_spec`` on JAX's deploy of the same qparams, field by
    field; the port's ``scale_inv`` / ``zp_shifted`` are Python floats
    (JAX: 0-d, replicated) and its ``bos_w`` has no JAX twin."""
    unet, shapes = _jax_params()
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), shapes)
    jqp = {n: jstate.LayerQParams(**{k: None if v is None else jnp.asarray(v)
                                     for k, v in d.items()})
           for n, d in ranks[0]["qparams"].items()}
    ctrl = jstate.uniform_ctrl(jstate.quantizable_layers(variables["params"]),
                               w_bits=8, a_bits=8)
    ctx = jdeploy.deploy_unet_ctx(
        unet, variables, jqp, ctrl,
        JSpec(sym=True, channel_wise=True, round_mode="nearest"),
        JSpec(running_stat=True), fuse_qkv=True)
    plan = ranks[0]["plan_deploy"]
    got = {}
    for layer, e in ctx.deploy.items():
        for f in ("w_int", "w_packed", "bos_out", "scale", "bias0",
                  "scale_inv", "zp_shifted"):
            v = getattr(e, f)
            if v is None:
                continue
            want = tuple(jparam_spec((layer, f), v, 2))
            if (layer, f) in plan:
                got[(layer, f)] = plan[(layer, f)]
                assert plan[(layer, f)] == want, (layer, f)
            else:
                assert want == () and f in ("scale_inv", "zp_shifted")
    assert set(plan) - set(got) == {k for k in plan if k[1] == "bos_w"}
    assert sum("tp" in s for s in got.values()) > len(got) // 2


def test_dp_sweep_equals_sequential(ranks):
    for r in ranks:
        seq, par = r["sweep"]
        assert par == seq
    assert ranks[0]["sweep"] == ranks[1]["sweep"]


def test_search_cli_dp_mesh(ranks):
    """``mixed_precision_search --dp_mesh 2`` (rank 0's result) against
    the same command without it: the same sensitivities, point for point,
    the same candidates and winner; rank 1 returns nothing."""
    dp, one = ranks[0]["search"]
    assert ranks[1]["search"] == (None, None)
    assert dp["sens_quality"] == one["sens_quality"]
    assert dp["sens_content"] == one["sens_content"]
    assert dp["points"] == one["points"] > 0
    assert dp["candidates"] == one["candidates"]
    assert dp["winner"] == one["winner"]


def test_tp_w8a8_step_equals_unsharded(ranks):
    for r in ranks:
        ref, got, kind, held = r["w8a8"]
        assert kind == "ShardedTree"
        assert torch.equal(ref, got)
    # each rank holds about half the UNet's parameters (tp = 2)
    full = sum(int(np.prod(leaf.shape)) for leaf in
               jax.tree_util.tree_leaves(_jax_params()[1]["params"]))
    assert 0.45 * full < ranks[0]["w8a8"][3] < 0.6 * full


def test_tp_bf16_step_equals_unsharded(ranks):
    for r in ranks:
        ref, got = r["bf16"]
        assert ref.dtype == torch.bfloat16 and torch.equal(ref, got)


def test_dp_statistic_is_the_whole_batch(ranks):
    for r in ranks:
        (codes, s), (local, s_local), rows = r["dynamic"]
        assert float(s_local) == float(s)
        assert torch.equal(local, codes[rows])


def test_dp_engine_equals_unsharded(ranks):
    (fp, fl), (dfp, dfl) = ranks[0]["engine"]
    assert fp.shape == dfp.shape == (2, 128, 128, 3)
    assert np.abs(dfp - fp).max() <= 1e-4
    assert np.abs(dfl - fl).max() <= 1e-3
    for a, b in zip(ranks[0]["engine"][1], ranks[1]["engine"][1]):
        assert np.array_equal(a, b)
    for r in ranks:
        assert len(r["engine_tp"]) == 2
        for img in r["engine_tp"]:
            assert np.array_equal(img, fp)
        assert r["pipe_whole"]
    assert np.array_equal(ranks[0]["pipe_alone"], fp)


def test_qat_sharded_step(ranks):
    for r in ranks:
        (l0, g0, n0), (l1, g1, n1) = r["qat"]["1x2"]
        assert np.isfinite(l1) and l1 == l0
        assert g0.keys() == g1.keys()
        for k in g0:
            assert torch.equal(g0[k], g1[k]), k
            assert torch.equal(n0[k], n1[k]), k
        (l0, g0, _), (l1, g1, _) = r["qat"]["2x1"]
        assert abs(l1 - l0) <= 1e-12 * l0
        for k in g0:
            scale = float(g0[k].abs().max()) or 1.0
            assert float((g1[k] - g0[k]).abs().max()) <= 1e-6 * scale, k
