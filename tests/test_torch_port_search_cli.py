"""The port's int8 CLI with precomputed BoS outputs, and its search and
analysis CLIs, on the CPU: ``gen_calib_data`` -> ``ptq`` ->
``quant_txt2img --backend int8 --fuse_qkv`` on ``configs/tiny.yaml``
(its calibration data moved into a temporary directory), then
``mixed_precision_search --quick`` and ``quant_error``.

* The int8 CLI computes every cross-attention k/v entry's BoS row on
  the unquantized weights (the JAX script's ``precompute_bos_outputs``,
  rel 1e-6 against JAX's on the same weights), and the deployed model's
  first k/v row is ``emb0 @ W_fp`` (before, it was the dequantized
  weight's product).
* The search writes files that read under ``yaml.safe_load`` and the
  port's readers; its winner is one of JAX's ``metric_decoupled_
  allocation`` candidates for the port's own sensitivities and sizes.
* ``quant_error --target weight`` equals JAX's ``weight_error`` on the
  same weights and qparams file, ``--target arch`` JAX's
  ``dump_structure``.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from mixdq_tpu.analysis import model_arch as jarch  # noqa: E402
from mixdq_tpu.analysis import quant_error as jqe  # noqa: E402
from mixdq_tpu.mixed_precision import ilp as jilp  # noqa: E402
from mixdq_tpu.quant import checkpoint as jckpt  # noqa: E402
from mixdq_tpu.quant import deploy as jdeploy  # noqa: E402
from mixdq_tpu.quant.core import QuantSpec as JSpec  # noqa: E402

from mixdq_tpu_torch.models.layers import bos_row  # noqa: E402
from mixdq_tpu_torch.pipelines.loader import build_pipeline  # noqa: E402
from mixdq_tpu_torch.quant import checkpoint  # noqa: E402
from mixdq_tpu_torch.quant.bitmaps import (load_bit_map,  # noqa: E402
                                           load_layer_list)
from mixdq_tpu_torch.quant.state import quantizable_layers  # noqa: E402
from mixdq_tpu_torch.scripts import (gen_calib_data,  # noqa: E402
                                     mixed_precision_search, ptq,
                                     quant_error, quant_txt2img)
from mixdq_tpu_torch.utils.config import (load_config, loads,  # noqa: E402
                                          merge, save_config)

REPO = os.path.join(os.path.dirname(__file__), "..")
JWQ = JSpec(sym=True, channel_wise=True, round_mode="nearest")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the tier-1 run's
    workers share the cores, and small eager ops contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The PTQ CLIs and the int8 CLI (one image) on the CPU in one
    temporary directory; the root logger restored after."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    tmp = tmp_path_factory.mktemp("search_flow")
    cfg = merge(load_config(os.path.join(REPO, "configs", "tiny.yaml")),
                {"calib_data": {"path": str(tmp / "calib.npz")}})
    cfg_path = str(tmp / "tiny.yaml")
    save_config(cfg, cfg_path)
    exp = str(tmp / "exp")
    gen_calib_data.main(["--config", cfg_path, "--device", "cpu"])
    ptq.main(["--config", cfg_path, "--outdir", exp, "--device", "cpu"])
    out = quant_txt2img.main(["--base_path", exp, "--device", "cpu",
                              "--backend", "int8", "--fuse_qkv",
                              "--n_images", "1", "--batch_size", "1"])
    ref = build_pipeline(cfg, device="cpu")
    yield dict(tmp=tmp, cfg=cfg, exp=exp, out=out, ref=ref)
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def test_int8_cli_bos_rows_are_fp(flow):
    """Every fused attn2 ``to_kv`` entry of the int8 CLI's deploy: the
    first k/v row its attention reads (``bos_row``, for any prompt) is
    ``emb0 @ W_fp`` on the unquantized weights of the same seed (rel
    1e-6), and its ``bos_out`` equals JAX's ``precompute_bos_outputs`` on
    those weights; no ``bos_w`` is kept."""
    ref, ctx = flow["ref"], flow["out"]["ctx"]
    ehs, _ = ref.encode_prompt(ref.tokens(["a photo of a cat", "a dog"]))
    emb0 = ehs[0, 0]
    layers = quantizable_layers(ref.unet)
    kv = sorted(n for n in ctx.deploy if n.endswith(".attn2.to_kv"))
    assert len(kv) == 12
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    checkpoint.module_params(ref.unet))
    want_j = jdeploy.precompute_bos_outputs(
        {n: jdeploy.DeployEntry(kind=e.kind) for n, e in ctx.deploy.items()},
        params, jnp.asarray(emb0.numpy()))
    for n in kv:
        pre = n[:-len(".to_kv")]
        with torch.no_grad():
            w = torch.cat([layers[f"{pre}.{m}"].weight
                           for m in ("to_k", "to_v")], 1)
            want = (emb0[None] @ w).expand(2, 1, -1)
            got = bos_row(ehs, ctx.deploy[n], torch.float32)
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * want.abs().max().item())
        e = ctx.deploy[n]
        assert e.bos_w is None
        np.testing.assert_allclose(e.bos_out.numpy(),
                                   np.asarray(want_j[n].bos_out), rtol=1e-6,
                                   atol=1e-6 * want.abs().max().item())


def test_search_cli_quick(flow):
    """``mixed_precision_search --quick`` (weights): 8 quality layers at
    bits 4 and 8, 8 content layers at 2, 4 and 8; the elected map and the
    sensitivities read back under ``yaml.safe_load`` and the port's
    readers, mirrored under ``--artifacts_dir``; the winner is one of
    JAX's candidates for the same sensitivities and sizes."""
    exp, art = flow["exp"], str(flow["tmp"] / "artifacts")
    r = mixed_precision_search.main(["--base_path", exp, "--quick",
                                     "--device", "cpu", "--target_bits",
                                     "5.0", "--artifacts_dir", art])
    sc, sq = r["sens_content"], r["sens_quality"]
    assert len(sc) == len(sq) == 8 and r["points"] == 40
    assert all(len(v) == 3 for v in sc.values())
    assert all(len(v) == 2 and np.isfinite(v).all() for v in sq.values())
    frac = jilp.tensor_size_fractions(r["sizes"])
    want = jilp.metric_decoupled_allocation(sc, sq, frac, 5.0)
    assert r["candidates"] == want and r["winner"] in want
    assert r["winner"] == want[r["index"]]
    path = r["paths"]["config"]
    with open(path) as f:
        text = f.read()
    assert yaml.safe_load(text) == r["winner"] == load_bit_map(path)
    assert text.startswith("# target_avg_bits: 5.0  achieved_avg_bits: ")
    with open(r["paths"]["sensitivity"]) as f:
        text = f.read()
    sens = yaml.safe_load(text)
    assert sens == loads(text)
    assert sens["content"] == sc and sens["quality"] == sq
    assert sens["meta"]["achieved_avg_bits"] == r["achieved"]
    mirror = os.path.join(art, "final_config", "weight",
                          f"{r['achieved']:.2f}.yaml")
    assert load_bit_map(mirror) == r["winner"]
    assert os.path.isfile(os.path.join(art, "sensitivity_log",
                                       "sensitivity_weight.yaml"))


def test_search_cli_act_protect(flow):
    """``--which act --protect_frac``: the most sensitive act layers of
    each group go to ``act_protect.yaml`` (yaml and the port's list
    reader) and out of both groups; act sizes from a captured forward."""
    r = mixed_precision_search.main([
        "--base_path", flow["exp"], "--quick", "--device", "cpu",
        "--which", "act", "--target_bits", "7.5", "--protect_frac", "0.1"])
    prot = r["protected"]
    assert len(prot) == 2
    path = r["paths"]["act_protect"]
    with open(path) as f:
        assert yaml.safe_load(f) == prot == load_layer_list(path)
    assert not set(prot) & (set(r["sens_content"]) | set(r["sens_quality"]))
    names = sorted(quantizable_layers(flow["ref"].unet))
    assert set(r["sizes"]) == set(names) and min(r["sizes"].values()) > 1
    assert load_bit_map(r["paths"]["config"]) == r["winner"]


def test_quant_error_cli_matches_jax(flow):
    """``--target weight --limit 6`` against JAX's ``weight_error`` on
    the same weights and qparams file (rel 1e-5), ``--target arch``
    against JAX's ``dump_structure``; ``act`` and ``unet_output`` write
    their files."""
    exp = flow["exp"]
    w = quant_error.main(["--base_path", exp, "--target", "weight",
                          "--limit", "6", "--device", "cpu"])
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    checkpoint.module_params(flow["ref"].unet))
    names = sorted(quantizable_layers(flow["ref"].unet))[:6]
    want = jqe.weight_error(params, jckpt.load_qparams(
        os.path.join(exp, "qparams.msgpack")), names, JWQ)
    with open(w["path"]) as f:
        got = yaml.safe_load(f)
    assert sorted(got) == sorted(want) == names
    for n in names:
        for k in ("sqnr", "mse"):
            np.testing.assert_allclose(got[n][k], want[n][k], rtol=1e-5)
    a = quant_error.main(["--base_path", exp, "--target", "arch",
                          "--device", "cpu"])
    with open(a["path"]) as f:
        assert f.read() == jarch.dump_structure(params) == a["result"]
    for t in ("act", "unet_output"):
        r = quant_error.main(["--base_path", exp, "--target", t, "--limit",
                              "3", "--device", "cpu"])
        with open(r["path"]) as f:
            res = yaml.safe_load(f)
        assert len(res) == 3 and all(
            len(v["sqnr"]) == 3 and v["sqnr"][2] > v["sqnr"][0]
            for v in res.values()), t
