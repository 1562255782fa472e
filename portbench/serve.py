"""The system under test, driven as its users drive it: build a
``ServingEngine`` from a configuration and a seed, then call
``generate`` in a closed loop. Only this module imports the program
(``mixdq_tpu_torch``).

Set-up: the program's CUDA kernels built (``ops._build.build_all``, a
no-op once ``csrc/build/`` holds them), the pipeline constructed with
the weights the benchmark makes from the seed, the model configuration
checked against the configuration file, one calibration trajectory of
the bf16 pipeline on the mix's calibration prompts, the configuration's
deploy recipe (``portbench/recipes/``), and one engine captured at the
mix's batch and the configuration's steps.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import catalog, trace, weights
from .reference.model import Models, per_level, unet_heads


def attention_levels(head_dims, down_types):
    """Head dims at the levels that attend (a cross-attention down block,
    or the last level, which holds the mid block's attention)."""
    n = len(head_dims)
    return [d if t.startswith("CrossAttn") or i == n - 1 else None
            for i, (d, t) in enumerate(zip(head_dims, down_types))]


def family_view(f) -> dict:
    """The program's model family as the configuration file's keys."""
    u = f.unet
    heads = list(u.num_attention_heads)
    ch = list(u.block_out_channels)
    view = {
        "unet": {
            "block_out_channels": ch, "layers_per_block": u.layers_per_block,
            "transformer_layers_per_block":
                list(u.transformer_layers_per_block),
            "heads": heads,
            "head_dim": attention_levels(
                [u.attention_head_dim or c // h for c, h in zip(ch, heads)],
                list(u.down_block_types)),
            "cross_attention_dim": u.cross_attention_dim,
            "use_linear_projection": u.use_linear_projection,
            "addition_embed_type": u.addition_embed_type,
            "norm_num_groups": u.norm_num_groups,
            "sample_size": u.sample_size, "in_channels": u.in_channels,
            "out_channels": u.out_channels,
            "down_block_types": list(u.down_block_types),
            "up_block_types": list(u.up_block_types)},
        "vae": {"block_out_channels": list(f.vae.block_out_channels),
                "layers_per_block": f.vae.layers_per_block,
                "norm_num_groups": f.vae.norm_num_groups,
                "latent_channels": f.vae.latent_channels,
                "scaling_factor": f.vae.scaling_factor},
        "scheduler": "euler" if f.is_sdxl else "lcm",
    }
    if u.addition_embed_type == "text_time":
        view["unet"].update(
            addition_time_embed_dim=u.addition_time_embed_dim,
            projection_class_embeddings_input_dim=(
                u.projection_class_embeddings_input_dim))
    for name in ("text_encoder", "text_encoder_2"):
        t = getattr(f, name)
        if t is not None:
            view[name] = {
                "hidden_size": t.hidden_size,
                "num_hidden_layers": t.num_layers,
                "num_attention_heads": t.num_heads,
                "intermediate_size": t.intermediate_size,
                "vocab_size": t.vocab_size,
                "max_position_embeddings": t.max_position_embeddings,
                "hidden_act": t.hidden_act}
            if name == "text_encoder_2":
                view[name]["projection_dim"] = t.projection_dim
    return view


def file_view(cfg: dict) -> dict:
    """The same keys read from the configuration file."""
    u = cfg["unet"]
    n = len(u["block_out_channels"])
    heads = unet_heads(u)
    view = {"unet": {k: u.get(k) for k in (
        "block_out_channels", "layers_per_block", "cross_attention_dim",
        "addition_embed_type", "norm_num_groups", "sample_size",
        "in_channels", "out_channels", "down_block_types",
        "up_block_types")}}
    view["unet"].update(
        transformer_layers_per_block=per_level(
            u.get("transformer_layers_per_block", 1), n),
        heads=heads,
        head_dim=attention_levels(
            [c // h for c, h in zip(u["block_out_channels"], heads)],
            u["down_block_types"]),
        use_linear_projection=u.get("use_linear_projection", False))
    if u.get("addition_embed_type") == "text_time":
        view["unet"].update({k: u[k] for k in (
            "addition_time_embed_dim",
            "projection_class_embeddings_input_dim")})
    view["vae"] = {k: cfg["vae"][k] for k in (
        "block_out_channels", "layers_per_block", "norm_num_groups",
        "latent_channels", "scaling_factor")}
    view["scheduler"] = cfg["scheduler"]
    for name in ("text_encoder", "text_encoder_2"):
        if name in cfg:
            t = cfg[name]
            view[name] = {k: t[k] for k in (
                "hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "vocab_size", "max_position_embeddings",
                "hidden_act")}
            if name == "text_encoder_2":
                view[name]["projection_dim"] = t["projection_dim"]
    return view


def check_family(cfg: dict, family) -> None:
    """Raise where the program's family differs from the file."""
    want, have = file_view(cfg), family_view(family)
    diff = [(part, k, want[part][k], have.get(part, {}).get(k))
            for part in want if isinstance(want[part], dict)
            for k in want[part] if want[part][k] != have.get(part, {}).get(k)]
    if want["scheduler"] != have["scheduler"] or \
            ("text_encoder_2" in want) != ("text_encoder_2" in have):
        diff.append(("family", "scheduler / towers", want["scheduler"],
                     have["scheduler"]))
    if diff:
        raise ValueError(f"program family {family.name!r} differs from the "
                         f"configuration file: {diff}")


@torch.no_grad()
def load_weights(pipe, cfg: dict, seed: int, lap=lambda what: None
                 ) -> None:
    """The benchmark's weights into the program's modules: every tensor
    of the reference's state dicts, of the same dtype; the program's VAE
    encoder (unused by text-to-image) keeps no weights of ours. ``lap``
    is called after the shapes and after the weights are made."""
    with torch.device("meta"):
        shapes = Models(cfg)
    lap("the reference's shapes")
    made = weights.make(shapes, seed, pipe.device, pipe.dtype)
    lap("weights made")
    for top, sd in made.items():
        mod = getattr(pipe, top)
        have = mod.state_dict()
        for k, v in sd.items():
            if k not in have or have[k].shape != v.shape or \
                    have[k].dtype != v.dtype:
                raise ValueError(f"{top}.{k}: the program holds "
                                 f"{tuple(have[k].shape) if k in have else None}"
                                 f" {have[k].dtype if k in have else ''}, "
                                 f"the benchmark makes {tuple(v.shape)} "
                                 f"{v.dtype}")
        left = [k for k in have if k not in sd]
        if any(not (k.startswith("encoder.") or k.startswith("quant_conv."))
               for k in left):
            raise ValueError(f"{top}: no benchmark weight for {left[:5]}")
        mod.load_state_dict(sd, strict=False)
    del made


@dataclasses.dataclass
class Served:
    pipe: object
    engine: object
    batch: int


def build(cfg: dict, mix: dict, calibration, seed: int, device,
          root: str = catalog.ROOT, log=lambda *a: None) -> Served:
    """Set-up; ``log`` gets the seconds of each phase."""
    t = [time.time()]

    def lap(what):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t.append(time.time())
        log(f"set-up: {what} {t[-1] - t[-2]:.2f} s")

    from mixdq_tpu_torch.pipelines.serving import ServingEngine
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline

    if device.type == "cuda":
        from mixdq_tpu_torch.ops import _build
        _build.build_all()
    lap("import and kernels built")
    dtype = getattr(torch, cfg["dtype"])
    pipe = Text2ImgPipeline(cfg["family"], dtype, device)
    check_family(cfg, pipe.family)
    lap("device context and the pipeline's modules")
    load_weights(pipe, cfg, seed, lap)
    lap("weights loaded")
    S, g = cfg["steps"], cfg["guidance_scale"]
    prompts, cseed = calibration
    rec = pipe(prompts, seed=cseed, num_inference_steps=S, guidance_scale=g,
               capture_trajectory=True, decode=False)
    B = len(prompts)
    added = None
    if rec.added_conds is not None:
        added = {k: v.repeat(S, 1) for k, v in rec.added_conds.items()}
    calib = (rec.trajectory.flatten(0, 1), rec.timesteps.repeat_interleave(B),
             rec.text_emb.repeat(S, 1, 1), added)
    del rec
    lap("calibration trajectory")
    ctx, vae_ctx = catalog.recipe(cfg["quant"]["recipe"], root)(pipe, calib)
    del calib
    lap("deploy")
    engine = ServingEngine(pipe, ctx, batch_size=mix["batch"], steps=S,
                           guidance_scale=g, vae_ctx=vae_ctx).compile()
    lap("engine warm-ups and capture")
    return Served(pipe, engine, mix["batch"])


class Reservoir:
    """A uniform sample of ``k`` finished requests, drawn from the seed as
    they finish: ``items`` of (prompts, noise seed, images). The images
    are copied into ``k`` buffers made and touched at set-up, so the
    program's own output arrays are freed as they would be without the
    check (holding them makes each next output fresh memory, a few ms of
    page faults inside ``generate``)."""

    def __init__(self, k: int, seed: int, like: np.ndarray):
        self.k, self.items = k, []
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 1 << 41])
        self.bufs = [like.copy() for _ in range(k)]

    def offer(self, i: int, item) -> None:
        j = i if i < self.k else int(self.rng.integers(0, i + 1))
        if j < self.k:
            prompts, nseed, images = item
            np.copyto(self.bufs[j], images)
            item = (prompts, nseed, self.bufs[j])
            if j < len(self.items):
                self.items[j] = item
            else:
                self.items.append(item)


class GraphClock:
    """While installed, a pair of CUDA timing events around every
    ``torch.cuda.CUDAGraph.replay``: the device time of each replay, read
    without the profiler. ``take()`` returns the pairs recorded since the
    last call; ``seconds(pairs)`` their device time, once they have run."""

    def __init__(self):
        self.pairs: List = []

    def __enter__(self):
        graph = torch.cuda.CUDAGraph
        self._replay = graph.replay
        orig, pairs = graph.replay, self.pairs

        def replay(g):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            orig(g)
            b.record()
            pairs.append((a, b))

        graph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._replay

    def take(self) -> List:
        out, self.pairs[:] = list(self.pairs), []
        return out

    @staticmethod
    def seconds(pairs) -> float:
        return sum(a.elapsed_time(b) for a, b in pairs) / 1e3


@dataclasses.dataclass
class Window:
    seconds: float
    latencies_s: List[float]
    images: int
    attempted: int
    graph_s: Optional[List[float]] = None


def window(engine, request: Callable, seconds: float,
           keep: Optional[Reservoir], start: int = 0,
           spans: bool = False, clock: Optional[GraphClock] = None
           ) -> Window:
    """One client in a closed loop for ``seconds``: requests are sent while
    the time is left, and the window closes when the last one's images
    are on the host (rate and tail take all its time and requests).
    ``spans``: each request inside a ``portbench.request`` range.
    ``clock`` (installed): ``graph_s``, each request's replay device
    time."""
    lat, images, i, pairs = [], 0, start, []
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        prompts, nseed = request(i)
        t = time.perf_counter()
        if spans:
            with torch.profiler.record_function("portbench.request"):
                out = engine.generate(prompts, nseed)
        else:
            out = engine.generate(prompts, nseed)
        lat.append(time.perf_counter() - t)
        if clock is not None:
            pairs.append(clock.take())
        images += out.shape[0]
        if keep is not None:
            keep.offer(i - start, (prompts, nseed, out))
        i += 1
    win = Window(time.perf_counter() - t0, lat, images, i - start)
    if clock is not None:
        # each request's images are on the host: its events have run
        win.graph_s = [GraphClock.seconds(p) for p in pairs]
    return win


def profile_loop(engine, request, seconds: float, start: int):
    """A profiled stretch of the same loop: (trace, first, last ns)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if engine.pipe.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        window(engine, request, seconds, None, start, spans=True)
    tr = trace.read(prof, engine.pipe.device.type)
    reqs = tr.spans_named("request")
    return tr, reqs[0][0], reqs[-1][1]


SPAN_MODULES = {"towers": ("text_encoder", "text_encoder_2"),
                "unet": ("unet",)}


def profile_spans(served: Served, prompts, nseed):
    """One eager ``run`` on a request's inputs, profiled, with the
    benchmark's spans around the towers, each UNet call and the VAE
    decode (the device synchronized at each span's ends): the trace."""
    from torch.profiler import ProfilerActivity, profile

    pipe, eng = served.pipe, served.engine
    cuda = pipe.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    handles, ranges = [], []

    def enter(name):
        def pre(mod, args):
            sync()
            r = torch.profiler.record_function("portbench." + name)
            r.__enter__()
            ranges.append(r)
        return pre

    def leave(mod, args, out):
        sync()
        ranges.pop().__exit__(None, None, None)

    for name, mods in SPAN_MODULES.items():
        for m in mods:
            mod = getattr(pipe, m, None)
            if mod is not None:
                handles.append(mod.register_forward_pre_hook(enter(name)))
                handles.append(mod.register_forward_hook(leave))
    vae_decode = pipe.vae.decode

    def decode(*a, **k):
        sync()
        with torch.profiler.record_function("portbench.vae"):
            out = vae_decode(*a, **k)
            sync()
        return out

    pipe.vae.decode = decode
    try:
        args = eng.inputs(prompts, nseed)
        with torch.inference_mode():
            eng.run(*args)
            sync()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            with profile(activities=acts) as prof:
                eng.run(*args)
                sync()
    finally:
        del pipe.vae.decode
        for h in handles:
            h.remove()
    return trace.read(prof, pipe.device.type)


def free(served: Served) -> None:
    """Drop the program's state and give its device memory back."""
    served.engine = served.pipe = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
