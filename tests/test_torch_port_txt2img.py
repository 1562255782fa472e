"""The port's ``Text2ImgPipeline`` and ``ServingEngine`` against the JAX
package's pipeline at ``tiny-sdxl`` size, on the same weights (the JAX
pipeline's params converted by ``mixdq_tpu_torch.convert``), the same
tokens and the same initial noise, in float32 on the CPU.

Tolerances: prompt embeddings rel 1e-4; sampled latents and images rel
1e-2 (the tiny UNet's random weights amplify float differences over
steps). The JAX side is one tiny pipeline, its denoise programs jitted
once per (steps, guidance) pair.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mixdq_tpu.pipelines import samplers as jsamplers  # noqa: E402
from mixdq_tpu.pipelines.txt2img import (  # noqa: E402
    Text2ImgPipeline as JPipeline)

from mixdq_tpu_torch import convert  # noqa: E402
from mixdq_tpu_torch.pipelines import samplers  # noqa: E402
from mixdq_tpu_torch.pipelines.graphed import GraphedCall  # noqa: E402
from mixdq_tpu_torch.pipelines.serving import ServingEngine  # noqa: E402
from mixdq_tpu_torch.pipelines.txt2img import (  # noqa: E402
    Text2ImgPipeline, make_schedule)
from mixdq_tpu_torch.utils.prompts import BUILTIN_PROMPTS  # noqa: E402

PROMPTS = BUILTIN_PROMPTS[:2]
NEGATIVE = ["blurry", "low quality"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, its params, the port's pipeline on the same
    weights), ``tiny-sdxl`` in float32."""
    jp = JPipeline("tiny-sdxl", dtype=jnp.float32)
    params = jp.init_params(jax.random.PRNGKey(0))
    p = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu")
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        getattr(p, part).load_state_dict(
            convert.params_to_state_dict(np_tree(params[part])), strict=True)
    return jp, params, p


def test_encode_prompt_parity(pipes):
    jp, params, p = pipes
    tokens = jp.tokenizer(PROMPTS)
    want_e, want_p = jp.encode_prompt(params, jnp.asarray(tokens))
    got_e, got_p = p.encode_prompt(p.tokens(PROMPTS))
    np.testing.assert_array_equal(p.tokens(PROMPTS).numpy(), tokens)
    assert got_e.shape == (2, 77, 128) and got_p.shape == (2, 64)
    assert rel(got_e, want_e) < 1e-4
    assert rel(got_p, want_p) < 1e-4


def _conds(jp, params, p, g):
    """JAX and port prompt embeddings and added conditions (negative ones
    too where ``g > 1``)."""
    B = len(PROMPTS)
    out = {}
    for side in ("jax", "port"):
        res = []
        for texts in ([PROMPTS, NEGATIVE] if g > 1 else [PROMPTS]):
            if side == "jax":
                e, pooled = jp.encode_prompt(params,
                                             jnp.asarray(jp.tokenizer(texts)))
                a = {"text_embeds": pooled,
                     "time_ids": jp.default_time_ids(B, 128, 128)}
            else:
                e, pooled = p.encode_prompt(p.tokens(texts))
                a = p.added_conds(pooled, p.default_time_ids(B, 128, 128))
            res += [e, a]
        out[side] = res + [None, None] * (g <= 1)
    return out


@pytest.mark.parametrize("steps,g", [(1, 0.0), (2, 0.0), (1, 5.0),
                                     (2, 5.0)])
def test_sample_latents_parity(pipes, steps, g):
    """The Euler loop on the same latents, with and without CFG: latents
    and the captured trajectory within rel 1e-2 of JAX's."""
    jp, params, p = pipes
    rng = np.random.default_rng(steps)
    js = jsamplers.make_euler_schedule(steps)
    lat = (rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
           * js.init_noise_sigma)
    c = _conds(jp, params, p, g)
    je, ja, jne, jna = c["jax"]
    want, wtraj = jp._sampler_program(steps, g, True)(
        params, je, ja, jnp.asarray(lat), jne, jna, jp_fp_ctx(),
        jax.random.PRNGKey(0))
    e, a, ne, na = c["port"]
    got, traj = p.sample_latents(e, a, T(lat), make_schedule(p.family, steps),
                                 g, ne, na, capture=True)
    assert got.dtype == torch.float32
    assert rel(got, want) <= 1e-2
    assert traj["trajectory"].shape == (steps, 2, 16, 16, 4)
    assert rel(traj["trajectory"], wtraj["trajectory"]) <= 1e-2
    assert rel(traj["unet_outputs"], wtraj["unet_outputs"]) <= 1e-2
    np.testing.assert_array_equal(traj["timesteps"].numpy(),
                                  np.asarray(wtraj["timesteps"]))


def jp_fp_ctx():
    from mixdq_tpu.quant.state import QuantCtx

    return QuantCtx()


def test_lcm_loop_parity(pipes):
    """The LCM loop (``denoised`` at the last step) driven through the
    tiny UNet with JAX's noise draws."""
    jp, params, p = pipes
    rng = np.random.default_rng(7)
    steps = 2
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    c = _conds(jp, params, p, 0.0)
    key = jax.random.PRNGKey(3)
    jsched = jsamplers.make_lcm_schedule(steps)
    want, _ = jp.sample_latents(params, c["jax"][0], c["jax"][1],
                                jnp.asarray(lat), jsched, 0.0,
                                lcm_noise_key=key)
    noise = jax.random.normal(key, (steps,) + lat.shape, jnp.float32)
    got, _ = p.sample_latents(c["port"][0], c["port"][1], T(lat),
                              samplers.make_lcm_schedule(steps), 0.0,
                              lcm_noise=T(noise))
    assert rel(got, want) <= 1e-2


def test_call_decode_parity(pipes):
    """``__call__`` end to end (2 Euler steps, CFG g=5, VAE decode) on the
    JAX pipeline's initial noise: images within rel 1e-2, in [0, 1]."""
    jp, params, p = pipes
    key = jax.random.PRNGKey(11)
    want = jp(params, PROMPTS, key, num_inference_steps=2,
              guidance_scale=5.0, negative_prompts=NEGATIVE)
    k_noise, _ = jax.random.split(key)
    noise = jax.random.normal(k_noise, (2, 16, 16, 4), jnp.float32)
    got = p(PROMPTS, num_inference_steps=2, guidance_scale=5.0,
            negative_prompts=NEGATIVE, noise=T(noise))
    assert got.images.shape == (2, 128, 128, 3)
    assert got.images.dtype == np.float32
    assert got.images.min() >= 0.0 and got.images.max() <= 1.0
    assert rel(got.latents, want.latents) <= 1e-2
    assert rel(got.images, want.images) <= 1e-2


@pytest.mark.parametrize("g", [0.0, 5.0])
def test_serving_engine_equals_pipeline(pipes, g):
    """``ServingEngine`` on the CPU (run eagerly) gives the pipeline's
    images for the same seed (the same noise draw), and other images for
    another seed."""
    _, _, p = pipes
    eng = ServingEngine(p, batch_size=2, steps=2, guidance_scale=g)
    got = eng.generate(PROMPTS, seed=5, negative_prompts=NEGATIVE)
    want = p(PROMPTS, seed=5, num_inference_steps=2, guidance_scale=g,
             negative_prompts=NEGATIVE).images
    assert got.shape == (2, 128, 128, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert eng.launches is None  # nothing captured on the CPU
    assert not np.array_equal(eng.generate(PROMPTS, seed=6), got)
    with pytest.raises(ValueError):
        eng.generate(PROMPTS[:1])


def test_pipeline_seed_and_init_weights():
    """``init_weights`` is deterministic in its seed; the noise of a seed
    is the generator's draw."""
    a = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu").init_weights(3)
    b = Text2ImgPipeline("tiny-sdxl", torch.float32, "cpu").init_weights(3)
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        for (n, x), (_, y) in zip(getattr(a, part).state_dict().items(),
                                  getattr(b, part).state_dict().items()):
            assert torch.equal(x, y), n
    n1 = a.make_noise(1, 128, 128, torch.Generator().manual_seed(9))
    n2 = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(9))
    assert torch.equal(n1, n2)


def test_graphed_call_runs_eagerly_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    g = GraphedCall(fn, (torch.ones(3),))
    assert g.graph is None and g.launches is None and not calls
    torch.testing.assert_close(g(torch.full((3,), 2.0)), torch.full((3,), 4.0))


def test_capture_pauses_the_cycle_collector(monkeypatch):
    """``graphed.capture`` holds Python's cycle collector off through
    ``torch.cuda.graph`` (a dead graph collected inside a capture would
    invalidate it) and restores it after, also when the capture raises;
    a collector that was off stays off."""
    import contextlib
    import gc

    from mixdq_tpu_torch.pipelines import graphed

    seen = []

    @contextlib.contextmanager
    def fake_graph(graph):
        seen.append(("enter", graph, gc.isenabled()))
        yield
        seen.append(("exit", graph, gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    was = gc.isenabled()
    try:
        gc.enable()
        with graphed.capture("g"):
            seen.append(("body", "g", gc.isenabled()))
        assert seen == [("enter", "g", False), ("body", "g", False),
                        ("exit", "g", False)]
        assert gc.isenabled()
        with pytest.raises(RuntimeError):
            with graphed.capture("h"):
                raise RuntimeError("capture failed")
        assert gc.isenabled()
        gc.disable()
        with graphed.capture("k"):
            pass
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


def test_bench_imports_with_main():
    """The graphed bench imports without triton, defines ``main()``, and
    its chained step (run eagerly on the CPU) chains ``inner`` bounded
    steps into its sample buffer."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.scripts import bench

    assert callable(bench.main)
    args = bench.parse_args([])
    assert (args.family, args.backend, args.inner, args.attn) == (
        "sdxl-turbo", "int8_fq_sec", 8, "auto")
    unet = pipeline.build_unet("tiny-sdxl", 0, torch.float32, "cpu")
    inputs = pipeline.example_inputs("tiny-sdxl", 1, 0, torch.float32, "cpu")
    g = bench.chained_graph(unet, inputs, pipeline.FP_CTX, inner=2)
    with torch.inference_mode():
        x = inputs[0]
        for _ in range(2):
            out = unet(x, *inputs[1:])
            x = out / (1 + out.abs())
    got = g(inputs[0].clone())
    torch.testing.assert_close(got, x)
    assert got.abs().max() < 1


@pytest.mark.parametrize("backend,compute", [
    ("int8_fq_sec", "int8_sec"), ("dequant", "dequant"),
    ("pallas_dequant", None)])
def test_bench_backends(backend, compute):
    """``--backend`` takes the two quantized computes of the root bench and
    refuses any other."""
    from mixdq_tpu_torch.scripts import bench

    if compute is None:
        with pytest.raises(SystemExit):
            bench.parse_args(["--backend", backend])
        return
    assert bench.COMPUTE[bench.parse_args(["--backend", backend]).backend] \
        == compute


def test_trajectory_dataclass_fields():
    from mixdq_tpu_torch.pipelines.txt2img import PipelineOutput

    assert [f.name for f in dataclasses.fields(PipelineOutput)] == [
        "images", "latents", "trajectory", "timesteps", "unet_outputs",
        "text_emb", "added_conds"]


def test_profiling_annotations_on_cpu(tmp_path):
    """``utils.profiling``'s trace and its tracer's spans run on the CPU
    (their CUDA timers need the card): a span, with the tracer on, is a
    ``mixdq.`` range in the profile and in the Chrome trace."""
    from mixdq_tpu_torch.utils import profiling

    with profiling.tracing() as tracer:
        with profiling.trace(str(tmp_path)) as prof:
            with profiling.span("block"):
                assert (torch.ones(2) + 1).tolist() == [2.0, 2.0]
    assert "mixdq.block" in {e.key for e in prof.key_averages()}
    assert '"mixdq.block"' in (tmp_path / "trace.json").read_text()
    assert [s.name for (r,) in [tracer.drain()] for s in r.spans] == [
        "block"]


def test_schedule_tensors_hold_the_tables():
    from mixdq_tpu_torch.pipelines.txt2img import ScheduleTensors
    from mixdq_tpu_torch.models.configs import get_family

    e = ScheduleTensors(make_schedule(get_family("tiny-sdxl"), 4), "cpu")
    assert e.timesteps.dtype == torch.float32 and e.sigmas.shape == (5,)
    assert e.sigmas[-1] == 0 and e.timesteps[0] == 999
    sd15 = dataclasses.replace(get_family("tiny-sdxl"), is_sdxl=False)
    lcm = ScheduleTensors(make_schedule(sd15, 4), "cpu")
    assert isinstance(lcm.schedule, samplers.LCMSchedule)
    assert lcm.acp.shape == lcm.acp_prev.shape == (4,)
    assert lcm.acp_prev[-1] == 1.0
