"""Start a world of ranks on one host: one fresh Python process a rank,
meeting at a ``FileStore`` in a temporary directory (no port, no
network). Each process imports ``torch`` and this package only.

    results = spawn("pkg.module:function", world_size, args, device="cpu")

runs ``function(*args)`` on every rank inside the world
(``mesh.init_world``; gloo on the CPU, NCCL on CUDA, rank ``r`` on device
``r``) and returns each rank's return value (``torch.save``-able), in
rank order. A rank that fails makes ``spawn`` raise with its error
output. The ranks share ``PYTHONHASHSEED`` (the caller's, else 0): the
``HashTokenizer``'s ids then agree across them.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import subprocess
import sys
import tempfile
from typing import Any, List, Optional, Sequence

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(target: str, world_size: int, args: Sequence[Any] = (),
          device="cpu", threads: Optional[int] = None,
          timeout: Optional[float] = None) -> List[Any]:
    """``target`` (``'module:function'``) on ``world_size`` ranks;
    ``threads``: torch intra-op threads a rank (default: the host's cores
    shared out)."""
    if torch.device(device).type == "cuda" and \
            world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks asked for, "
                         f"{torch.cuda.device_count()} CUDA devices")
    threads = threads or max(1, (os.cpu_count() or 1) // world_size)
    with tempfile.TemporaryDirectory(prefix="mixdq_world_") as tmp, \
            contextlib.ExitStack() as stack:
        torch.save({"target": target, "args": tuple(args),
                    "world_size": world_size, "device": str(device),
                    "threads": threads}, os.path.join(tmp, "job.pt"))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        env.setdefault("PYTHONHASHSEED", "0")
        procs = []
        for r in range(world_size):
            log = stack.enter_context(
                open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append((stack.enter_context(subprocess.Popen(
                [sys.executable, "-m", __name__, tmp, str(r)], env=env,
                stdout=log, stderr=subprocess.STDOUT)), log))
        failed = []
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q, _ in procs:
                    q.kill()
                rc = "timeout"
            if rc != 0:
                log.seek(0)
                failed.append(f"rank {r} exited {rc}:\n{log.read()[-4000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def spawn_main(module: str, argv: Sequence[str], world_size: int,
               device="cpu") -> Any:
    """A CLI's ``module.main(argv)`` on ``world_size`` ranks (each sees
    the world running and builds its mesh); rank 0's result, without its
    ``engine`` (a live object)."""
    return spawn(f"{__name__}:_main_rank", world_size, (module, list(argv)),
                 device=device)[0]


def _main_rank(module: str, argv: List[str]):
    import torch.distributed as dist

    out = importlib.import_module(module).main(argv)
    if dist.get_rank() != 0 or not isinstance(out, dict):
        return None
    return {k: v for k, v in out.items() if k != "engine"}


def _rank_main(tmp: str, rank: int) -> None:
    from .mesh import init_world

    job = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
    torch.set_num_threads(job["threads"])
    init_world(rank, job["world_size"], os.path.join(tmp, "store"),
               job["device"])
    mod, fn = job["target"].split(":")
    try:
        out = getattr(importlib.import_module(mod), fn)(*job["args"])
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
