"""Batch serving: one CUDA graph a batch shape (port of
``mixdq_tpu/pipelines/serving.py``).

``ServingEngine`` runs a whole generation -- tokens -> both CLIP towers ->
the denoise loop (CFG as a doubled batch) -> VAE decode -> images in
[0, 1] -- as one program, as the JAX package's jitted ``run`` does: here
``compile()`` captures ``run`` once into a ``torch.cuda.CUDAGraph`` on
static token and noise buffers (``graphed.GraphedCall``), and
``generate`` tokenizes on the host, copies the tokens and the noise (drawn
outside the graph from a generator seeded by the caller) into the
buffers, replays, and returns numpy. On the CPU ``run`` is called
eagerly.

Every engine's split-K GEMMs share one buffer of arrival counters a
device (``ops.qmatmul.igemm_scratch``); replays on one stream run one
after another, so two engines never touch it at once.

Over a (dp, tp) ``mesh`` (``parallel.mesh.make_mesh``; every rank builds
the same engine): tp shards the pipeline's parameters (on the engine's
copy of its modules, ``sharded_copy``: the caller's pipeline is left as
it is) and both contexts' deploy dicts (``ShardedTree``), each
tensor gathered where it is read; dp shards the batch. Each rank draws the
noise of the whole batch from the caller's seed and keeps its rows, so a
sharded generation sees the unsharded one's noise; it runs its rows
(graphed on CUDA; the tp gathers inside the graph), then the images are
all-gathered over dp outside the graph, and every rank returns the whole
batch. Batch-wide statistics (the int8 flash kernels' dynamic scales)
are all-reduced over dp (``QuantCtx.batch_group``).

Tracing (``utils.profiling.tracing()``): ``generate`` is the request
span ``engine.request``, with the children ``engine.tokenize``,
``engine.noise``, ``engine.copy_in``, ``engine.launch``, ``engine.wait``
(the host waits for the replay's last mark), ``engine.gather`` (with a
mesh) and ``engine.to_host``. ``run`` places the device marks
``run.begin``, ``towers.end``, ``unet.begin`` / ``unet.end`` around each
step's UNet call (``Text2ImgPipeline.sample_latents``), ``vae.begin``
and ``run.end``; the capture records them into the graph, so every
replay times its phases (``phases``), and with the tracer on ``generate``
anchors them on the host clock of its spans.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..quant.state import FP_CTX, QuantCtx
from ..utils import profiling
from . import samplers
from .graphed import GraphedCall
from .txt2img import ScheduleTensors, Text2ImgPipeline, make_schedule


class ServingEngine:
    """Graphed txt2img serving at one batch size and step count.

    Usage:
        eng = ServingEngine(pipe, ctx, batch_size=4, steps=1).compile()
        images = eng.generate(prompts, seed)
    """

    def __init__(
        self,
        pipe: Text2ImgPipeline,
        ctx: QuantCtx = FP_CTX,
        batch_size: int = 1,
        steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        vae_ctx: QuantCtx = FP_CTX,
        mesh=None,
    ):
        f = pipe.family
        self.pipe = pipe
        self.B = batch_size
        self.steps = steps or f.default_steps
        self.g = f.guidance_scale if guidance_scale is None else guidance_scale
        self.height = height or f.unet.sample_size * 8
        self.width = width or f.unet.sample_size * 8
        self.mesh = mesh
        #: this rank's rows of the batch (all of them without a mesh)
        self.rows = slice(0, batch_size)
        if mesh is not None:
            self.rows = pmesh.dp_slice(mesh, batch_size)
            if pmesh.tp_size(mesh) > 1:
                self.pipe = pipe = copy.copy(pipe)
                for name in ("unet", "vae", "text_encoder",
                             "text_encoder_2"):
                    m = getattr(pipe, name)
                    if m is not None:
                        setattr(pipe, name, pmesh.sharded_copy(m, mesh))
            group = (mesh.get_group("dp") if pmesh.dp_size(mesh) > 1
                     else None)
            ctx, vae_ctx = (dataclasses.replace(
                c, deploy=pmesh.shard_tree(mesh, c.deploy),
                batch_group=group) for c in (ctx, vae_ctx))
        self.ctx = ctx
        self.vae_ctx = vae_ctx
        self.schedule = ScheduleTensors(make_schedule(f, self.steps),
                                        pipe.device)
        # built here, outside any capture: a graph copies nothing from
        # the host
        b = self.rows.stop - self.rows.start
        self.time_ids = pipe.default_time_ids(b, self.height, self.width)
        self._graph: Optional[GraphedCall] = None

    @property
    def euler(self) -> bool:
        return isinstance(self.schedule.schedule, samplers.EulerSchedule)

    def denoise(self, tokens: torch.Tensor, ntokens: torch.Tensor,
                noise: torch.Tensor,
                lcm_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tokens -> the sampled latents (``run`` without the decode).
        ``noise``: unit normal initial noise; ``lcm_noise``: the LCM
        loop's."""
        pipe = self.pipe
        embeds, pooled = pipe.encode_prompt(tokens)
        added = pipe.added_conds(pooled, self.time_ids)
        neg_embeds, neg_added = None, None
        if self.g > 1.0:
            neg_embeds, neg_pooled = pipe.encode_prompt(ntokens)
            neg_added = pipe.added_conds(neg_pooled, self.time_ids)
        profiling.mark("towers.end")
        latents = noise
        if self.euler:
            latents = latents * self.schedule.schedule.init_noise_sigma
        latents, _ = pipe.sample_latents(
            embeds, added, latents, self.schedule, self.g, neg_embeds,
            neg_added, self.ctx, False, lcm_noise)
        return latents

    def run(self, tokens: torch.Tensor, ntokens: torch.Tensor,
            noise: torch.Tensor, lcm_noise: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
        """One generation: images ``[b, H, W, 3]`` in [0, 1], model
        dtype, of this rank's ``b`` rows."""
        profiling.mark("run.begin")
        latents = self.denoise(tokens, ntokens, noise, lcm_noise)
        profiling.mark("vae.begin")
        images = self.pipe.decode(latents, self.vae_ctx)
        profiling.mark("run.end")
        return images

    def compile(self) -> "ServingEngine":
        """Warm ``run`` and capture it (CUDA), once per engine."""
        if self._graph is None:
            self._graph = GraphedCall(self.run, self.inputs([""] * self.B))
        return self

    @property
    def launches(self) -> Optional[Dict[str, int]]:
        """Kernel launches one replay makes (counted at capture; None on
        the CPU or before ``compile``)."""
        return None if self._graph is None else self._graph.launches

    def _tokens(self, prompts: Sequence[str],
                negative_prompts: Optional[Sequence[str]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if len(prompts) != self.B:
            raise ValueError(f"engine built for batch {self.B}, got "
                             f"{len(prompts)} prompts")
        r = self.rows
        tokens = self.pipe.tokens(prompts).long()[r]
        ntokens = self.pipe.tokens(negative_prompts
                                   or [""] * self.B).long()[r]
        return tokens, ntokens

    def _noise(self, seed: int) -> Tuple[torch.Tensor, ...]:
        pipe, r = self.pipe, self.rows
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        noise = pipe.make_noise(self.B, self.height, self.width, gen)
        if self.euler:
            return (noise[r],)
        lcm_noise = torch.randn((self.steps,) + tuple(noise.shape),
                                generator=gen, device=pipe.device,
                                dtype=pipe.dtype)
        return noise[r], lcm_noise[:, r]

    def inputs(self, prompts: Sequence[str], seed: int = 0,
               negative_prompts: Optional[Sequence[str]] = None):
        """``run``'s arguments for ``B`` prompts: their tokens and the
        negative prompts' (``""`` each by default) on the device, and the
        noise drawn from ``torch.Generator(device).manual_seed(seed)``
        (``Text2ImgPipeline.make_noise``: the pipeline's noise for the same
        seed; then the LCM loop's); over a mesh, this rank's rows of
        each."""
        return self._tokens(prompts, negative_prompts) + self._noise(seed)

    def generate(self, prompts: Sequence[str], seed: int = 0,
                 negative_prompts: Optional[Sequence[str]] = None
                 ) -> np.ndarray:
        """Images ``[B, H, W, 3]`` float32 in [0, 1]: ``run`` on
        ``inputs(prompts, seed, negative_prompts)``, replayed from the
        captured graph (compiled at the first call); over a mesh, every
        dp rank's rows gathered."""
        graph = self.compile()._graph
        with profiling.span("engine.request"):
            tracer = profiling.active()
            if tracer is not None:
                # the device is idle here: the last request's images were
                # copied to the host
                tracer.anchor(self.pipe.device)
            with profiling.span("engine.tokenize"):
                tokens = self._tokens(prompts, negative_prompts)
            with profiling.span("engine.noise"):
                noise = self._noise(seed)
            out = graph(*tokens, *noise)
            if tracer is not None and graph.marks:
                with profiling.span("engine.wait"):
                    graph.marks[-1][1].synchronize()
                tracer.replayed(graph.marks)
            if self.mesh is not None:
                with profiling.span("engine.gather"):
                    out = pmesh.gather_batch(self.mesh, out)
            with profiling.span("engine.to_host"):
                return out.float().cpu().numpy()


def phases(marks: Sequence[profiling.Mark]) -> Dict[str, int]:
    """The device phases of one ``run`` from its marks, in ns: ``towers``
    (``towers.end - run.begin``), ``unet`` (each step's ``unet.end -
    unet.begin``, summed), ``sampler`` (the rest up to ``vae.begin``: CFG,
    the sampler's arithmetic, noise scaling), ``vae`` (``run.end -
    vae.begin``) and ``run`` (``run.end - run.begin``, their sum)."""
    at, unet, begin = {}, 0, None
    for m in marks:
        if m.name == "unet.begin":
            begin = m.t_ns
        elif m.name == "unet.end":
            unet += m.t_ns - begin
        else:
            at[m.name] = m.t_ns
    return {"towers": at["towers.end"] - at["run.begin"], "unet": unet,
            "sampler": at["vae.begin"] - at["towers.end"] - unet,
            "vae": at["run.end"] - at["vae.begin"],
            "run": at["run.end"] - at["run.begin"]}
