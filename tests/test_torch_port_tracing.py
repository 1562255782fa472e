"""The port's tracer (``mixdq_tpu_torch/utils/profiling.py``) on the serving
path, on the CPU at ``tiny-sdxl`` (one Euler step) and ``tiny-sd15`` (four
LCM steps), batch 2, one torch thread:

* off, ``span`` returns the one shared null context, nothing is recorded
  and a ``generate`` gives the same images as with the tracer on;
* on, one ``generate`` is one request: the root ``engine.request`` with
  its children inside it, sharing its id; its marks (the host clock on
  the CPU) number 2 + 2 S + 2, lie inside the root in the order the
  pipeline runs them, and the phases sum to ``run.end - run.begin``;
* the ring keeps at most its capacity of requests, the newest.

Port only: no JAX. The marks recorded into a CUDA graph are checked on
the card (``tests/test_torch_port_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mixdq_tpu_torch.pipelines.serving import (ServingEngine,  # noqa: E402
                                               phases)
from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline  # noqa: E402
from mixdq_tpu_torch.utils import profiling  # noqa: E402

PROMPTS = ["a red cube", "a blue sphere"]
STEPS = {"tiny-sdxl": 1, "tiny-sd15": 4}
CHILDREN = ["engine.tokenize", "engine.noise", "engine.to_host"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the tier-1 run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(STEPS))
def engine(request):
    fam = request.param
    pipe = Text2ImgPipeline(fam, torch.float32, "cpu").init_weights(0)
    return ServingEngine(pipe, batch_size=2, steps=STEPS[fam]).compile()


def test_off_records_nothing(engine):
    assert profiling.active() is None
    assert profiling.span("a") is profiling.span("b") is profiling._NULL
    with profiling.tracing() as tracer:
        assert profiling.active() is tracer
    assert profiling.active() is None
    engine.generate(PROMPTS, seed=1)
    profiling.mark("run.begin")
    assert tracer.drain() == []


def test_images_equal_on_and_off(engine):
    off = engine.generate(PROMPTS, seed=2)
    with profiling.tracing():
        on = engine.generate(PROMPTS, seed=2)
    assert on.dtype == np.float32 and np.array_equal(on, off)


def test_one_request_with_nested_spans_and_marks(engine):
    with profiling.tracing() as tracer:
        engine.generate(PROMPTS, seed=3)
    (req,) = tracer.drain()
    root, *kids = req.spans
    assert (root.name, root.parent) == ("engine.request", None)
    assert [s.name for s in kids] == CHILDREN
    for s in req.spans:
        assert s.request == req.id and s.start_ns <= s.end_ns
    for s in kids:
        assert s.parent == "engine.request"
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    S = engine.steps
    assert [m.name for m in req.marks] == (
        ["run.begin", "towers.end"] + ["unet.begin", "unet.end"] * S
        + ["vae.begin", "run.end"])
    assert len(req.marks) == 2 + 2 * S + 2
    t = [m.t_ns for m in req.marks]
    assert t == sorted(t) and all(m.request == req.id for m in req.marks)
    assert kids[1].end_ns <= t[0] and t[-1] <= kids[2].start_ns
    ph = phases(req.marks)
    assert min(ph.values()) >= 0 and ph["unet"] > 0
    assert ph["towers"] + ph["unet"] + ph["sampler"] + ph["vae"] \
        == ph["run"] == t[-1] - t[0]


def test_requests_get_their_own_ids(engine):
    with profiling.tracing() as tracer:
        for seed in range(2):
            engine.generate(PROMPTS, seed=seed)
    a, b = tracer.drain()
    assert a.id != b.id and a.spans[0].end_ns <= b.spans[0].start_ns
    assert tracer.drain() == []


def test_ring_keeps_its_capacity(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.tracing() as tracer:
        for i in range(5):
            with profiling.span(f"r{i}"):
                with profiling.span("child"):
                    profiling.mark("m")
        profiling.mark("outside a request")
    got = tracer.drain()
    assert [r.spans[0].name for r in got] == ["r2", "r3", "r4"]
    assert [r.id for r in got] == [2, 3, 4]
    for r in got:
        assert [(s.name, s.parent) for s in r.spans] == [
            (r.spans[0].name, None), ("child", r.spans[0].name)]
        assert [m.name for m in r.marks] == ["m"]


def test_a_raising_request_is_recorded():
    with profiling.tracing() as tracer:
        with pytest.raises(ValueError):
            with profiling.span("engine.request"):
                raise ValueError("no")
    (req,) = tracer.drain()
    assert [s.name for s in req.spans] == ["engine.request"]
    assert profiling.active() is None
