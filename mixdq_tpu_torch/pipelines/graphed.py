"""One callable captured into a CUDA graph on static input buffers: the
port's counterpart of the ``jax.jit`` that the JAX package wraps around a
UNet scan (``bench.py:67-88``) or a whole generation
(``pipelines/serving.py:124-127``).

``GraphedCall(fn, inputs)`` clones ``inputs`` into static buffers, runs
``fn`` on them ``WARMUP`` times on a side stream, then captures one call
into a ``torch.cuda.CUDAGraph``. A call copies its arguments into
the buffers and replays the graph; it returns the captured output
tensors, which the next replay overwrites. A failed capture raises: no
eager fallback.

The kernel wrappers count Python calls (``ops.launch_counts``), so a
replay counts nothing: ``launches`` holds the counts taken during the
capture, the launches one replay makes. In the same way ``marks`` holds
the timing events that ``utils.profiling.mark`` recorded into the graph
during the capture (``profiling.graph_marks``), in the order they run;
every replay sets them again, tracing on or off. With the tracer on, a
call's copies and its replay are the spans ``engine.copy_in`` and
``engine.launch``.

On the CPU (inputs on the CPU: the caller asked for it) nothing is
captured and a call runs ``fn`` eagerly.

Every capture goes through ``capture``, which pauses Python's cycle
collector: torch no longer collects before a capture, so an engine that
died in a reference cycle (an engine and its ``GraphedCall`` hold each
other) keeps its ``CUDAGraph`` until a collection, and a collection
that ran inside another capture would destroy that graph there. The
destroy is a call CUDA refuses while a stream captures; torch only warns
of it, and the capture is invalidated, so the next launch fails with
``cudaErrorStreamCaptureInvalidated``.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import ops
from ..utils import profiling

#: eager calls before the capture. The first builds every kernel, loads
#: every library, fills the per-shape plan caches and allocates the
#: split-K arrival counters, so that this first-use state lies outside the
#: graph's memory pool; the second runs with all of it in place, as the
#: captured call will.
WARMUP = 2


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph"):
    """``torch.cuda.graph(graph)`` with Python's cycle collector paused
    until the capture has ended, so no finalizer (a dead graph's destroy)
    runs inside it."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class GraphedCall:
    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: kernel launches recorded in the graph (``None`` on the CPU)
        self.launches: Optional[Dict[str, int]] = None
        #: ``(name, timing event)`` of each mark recorded in the graph
        self.marks: List[Tuple[str, torch.cuda.Event]] = []
        with torch.inference_mode():
            self.inputs = tuple(t.clone() for t in inputs)
            dev = self.inputs[0].device
            if dev.type != "cuda":
                return
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            before = ops.launch_counts()
            with profiling.graph_marks() as marks, capture(graph):
                self.output = fn(*self.inputs)
            after = ops.launch_counts()
            self.marks = marks
            self.launches = {k: after[k] - before[k] for k in after}
            self.graph = graph

    def __call__(self, *inputs: torch.Tensor):
        with torch.inference_mode():
            if self.graph is None:
                return self.fn(*inputs)
            with profiling.span("engine.copy_in"):
                for buf, x in zip(self.inputs, inputs):
                    buf.copy_(x)
            with profiling.span("engine.launch"):
                self.graph.replay()
            return self.output

    def replay(self):
        """One replay on the buffers as they stand (no copy-in)."""
        self.graph.replay()
        return self.output
