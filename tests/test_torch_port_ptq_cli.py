"""The port's PTQ flow through files on the CPU: its three CLIs
(``mixdq_tpu_torch/scripts/gen_calib_data.py``, ``ptq.py``,
``quant_txt2img.py``) run with ``--device cpu`` on ``configs/tiny.yaml``
(its calibration data path moved into a temporary directory) and write
``calib.npz``, ``qparams.msgpack``, ``config.yaml`` and PNGs. The JAX
package's ``calibrate`` on the port's ``calib.npz``, batched by the JAX
``scripts/ptq.py`` in the same order, on the same weights, gives the
port's qparams at the port's calibration parity tolerance (zero points
within 1, weight deltas rel 1e-6, act deltas rel 1e-4). The
reconstruction options run (they are held against JAX in
``tests/test_torch_port_recon.py``)."""

import importlib.util
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.models.unet import UNet2DConditionModel as JUNet  # noqa: E402
from mixdq_tpu.pipelines.loader import (  # noqa: E402
    specs_from_config as jspecs)
from mixdq_tpu.quant import calibrate as jcal  # noqa: E402
from mixdq_tpu.utils.config import load_config as jload_config  # noqa: E402

from mixdq_tpu_torch import convert  # noqa: E402
from mixdq_tpu_torch.pipelines.loader import (build_pipeline,  # noqa: E402
                                              specs_from_config)
from mixdq_tpu_torch.quant import checkpoint  # noqa: E402
from mixdq_tpu_torch.quant.bitmaps import load_layer_list  # noqa: E402
from mixdq_tpu_torch.quant.state import quantizable_layers  # noqa: E402
from mixdq_tpu_torch.scripts import (gen_calib_data, ptq,  # noqa: E402
                                     quant_txt2img)
from mixdq_tpu_torch.utils.config import (load_config, merge,  # noqa: E402
                                          save_config)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _jax_ptq_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_ptq", os.path.join(REPO, "scripts", "ptq.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def restore_logging():
    """The CLIs point the root logger at their run.log and stdout
    (``setup_experiment``); later tests get it back as it was."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def _jax_unet_config(cfg):
    from mixdq_tpu.models.configs import get_family

    return get_family(cfg.model.family).unet


@pytest.fixture(scope="module")
def flow(tmp_path_factory, restore_logging):
    """The three CLIs in turn on the CPU, in one temporary directory."""
    tmp = tmp_path_factory.mktemp("ptq_flow")
    cfg = merge(load_config(os.path.join(REPO, "configs", "tiny.yaml")),
                {"calib_data": {"path": str(tmp / "calib.npz")}})
    cfg_path = str(tmp / "tiny.yaml")
    save_config(cfg, cfg_path)
    exp = str(tmp / "exp")
    gen = gen_calib_data.main(["--config", cfg_path, "--device", "cpu"])
    res = ptq.main(["--config", cfg_path, "--outdir", exp,
                    "--device", "cpu"])
    out = quant_txt2img.main(["--base_path", exp, "--device", "cpu",
                              "--backend", "int8",
                              "--fuse_qkv", "--n_images", "3",
                              "--batch_size", "2"])
    return dict(tmp=tmp, cfg=cfg, cfg_path=cfg_path, exp=exp, gen=gen,
                res=res, out=out)


def test_cli_flow_writes_its_files(flow):
    from PIL import Image

    with np.load(flow["cfg"].calib_data.path) as f:
        shapes = {k: f[k].shape for k in f.files}
        assert all(f[k].dtype == np.float32 for k in f.files)
    assert shapes == {"xs": (1, 4, 16, 16, 4), "ts": (1,),
                      "outputs": (1, 4, 16, 16, 4),
                      "text_embs": (4, 77, 128), "text_embeds": (4, 64),
                      "time_ids": (4, 6)}
    exp = flow["exp"]
    for name in ("qparams.msgpack", "config.yaml", "run.log",
                 "GIT_REVISION"):
        assert os.path.isfile(os.path.join(exp, name)), name
    assert load_config(os.path.join(exp, "config.yaml")) == flow["cfg"]
    qp = checkpoint.load_qparams(flow["res"]["path"])
    assert set(qp) == set(flow["res"]["qparams"])
    assert sum(q.w0_delta is not None for q in qp.values()) == 6
    paths = flow["out"]["paths"]
    assert len(paths) == 3
    for p in paths:
        img = np.asarray(Image.open(p))
        assert img.shape == (128, 128, 3) and img.dtype == np.uint8
    ctx = flow["out"]["ctx"]
    assert sum(e.kind == "conv_split" for e in ctx.deploy.values()) == 6
    # the CLI pruned every deployed fp weight
    assert all(m.weight is None for n, m in
               flow["out"]["pipe"].unet.named_modules() if n in ctx.deploy)


def test_jax_calibration_on_port_calib_data(flow):
    """JAX's calibrate, fed the port's calib.npz by the JAX script's
    ``calib_batches_from_npz`` (``RandomState(0)`` order), on the weights
    the port's CLIs built, equals the port's qparams.msgpack."""
    cfg = flow["cfg"]
    pipe = build_pipeline(cfg, device="cpu")
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), checkpoint.module_params(pipe.unet))
    jcfg = jload_config(flow["cfg_path"])
    wq, aq, _ = jspecs(jcfg)
    data = dict(np.load(cfg.calib_data.path))
    batches = list(_jax_ptq_script().calib_batches_from_npz(
        data, cfg.calib_data.batch_size, np.random.RandomState(0)))
    assert len(batches) == 2
    jqp = jcal.calibrate(JUNet(_jax_unet_config(cfg)), {"params": params},
                         batches, wq, aq, splits=pipe.splits)
    got = convert.qparams_to_numpy(checkpoint.load_qparams(
        flow["res"]["path"]))
    assert set(got) == set(jqp)
    for name, qp in jqp.items():
        for f in ("w_delta", "w_zp", "a_delta", "a_zp", "w0_delta", "w0_zp",
                  "a0_delta", "a0_zp"):
            v, g = getattr(qp, f), got[name][f]
            assert (g is None) == (v is None), (name, f)
            if v is None:
                continue
            v = np.asarray(v)
            if f.endswith("zp"):
                assert np.abs(g - v).max() <= 1, (name, f)
            elif f.startswith("w"):
                np.testing.assert_allclose(g, v, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(g, v, rtol=1e-4, err_msg=name)


def test_act_protect_pt_list(flow, tmp_path):
    """A torch-saved ``.pt`` list (the reference's act-protect format) reads
    with ``weights_only=True`` and protects its layers in the CLI's
    deploy: weight-only entries."""
    names = ["model.up_blocks.0.resnets.0.conv_shortcut", "conv_in"]
    pt = str(tmp_path / "protect.pt")
    torch.save(names, pt)
    assert load_layer_list(pt) == ["up_blocks.0.resnets.0.conv_shortcut",
                                   "conv_in"]
    out = quant_txt2img.main([
        "--base_path", flow["exp"], "--device", "cpu", "--backend", "int8",
        "--n_images", "1", "--batch_size", "1", "--act_protect", pt,
        "--outdir", str(tmp_path / "img")])
    deploy = out["ctx"].deploy
    assert deploy["up_blocks.0.resnets.0.conv_shortcut"].kind == "conv_split"
    assert deploy["up_blocks.0.resnets.0.conv_shortcut"].act_off
    assert deploy["conv_in"].act_off and len(out["paths"]) == 1
    torch.save({"not": "a list"}, pt)
    with pytest.raises(ValueError):
        load_layer_list(pt)


def test_options_not_ported_raise(flow, tmp_path):
    """Every option of the JAX ``ptq`` runs now: ``--recon block
    --adaround --recon_iters 1`` writes ``alphas.msgpack`` (an alpha of
    each layer's weight shape) beside ``qparams.msgpack``, and
    ``--adaround`` without ``--recon`` learns nothing, as in the JAX
    script; the softmax spec and the fake backend run too (the fake flow
    is held in ``tests/test_torch_port_fake_cli.py``, the reconstruction
    in ``tests/test_torch_port_recon.py``)."""
    out = str(tmp_path / "x")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tier-1 run's workers share the cores
    try:
        res = ptq.main(["--config", flow["cfg_path"], "--outdir", out,
                        "--device", "cpu", "--recon", "block", "--adaround",
                        "--recon_iters", "1"])
        unet = build_pipeline(flow["cfg"], device="cpu").unet
        res2 = ptq.main(["--config", flow["cfg_path"], "--outdir",
                         str(tmp_path / "y"), "--device", "cpu",
                         "--adaround"])
    finally:
        torch.set_num_threads(threads)
    shapes = {n: tuple(m.weight.shape)
              for n, m in quantizable_layers(unet).items()}
    assert {n: tuple(a.shape) for n, a in res["alphas"].items()} == shapes
    assert os.path.exists(os.path.join(out, "alphas.msgpack"))
    assert os.path.exists(res["path"]) and res["seconds"]["recon"] > 0
    assert res2["alphas"] is None and "recon" not in res2["seconds"]
    cfg = merge(flow["cfg"], {"quant": {"softmax": {"enabled": True}}})
    sm = specs_from_config(cfg)[2]
    assert sm.always_zero and not sm.sym and sm.n_bits == 8
    if not torch.cuda.is_available():
        # the CLIs run on the card unless --device cpu is given
        with pytest.raises(RuntimeError, match="CUDA"):
            gen_calib_data.main(["--config", flow["cfg_path"]])
