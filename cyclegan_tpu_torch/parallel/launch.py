"""Joining a process group, and running a function on several local ranks.

``init_distributed`` is what the CLI calls: one process per device, the
NCCL backend on CUDA devices and gloo on the CPU, initialized from a
launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) or from an explicit
``host:port`` coordinator with a process count and id. Rank r binds
``cuda:(local_rank % device_count)``.

``run_ranks`` starts ``world_size`` fresh processes on this host that join
one group through a file store, runs ``fn(rank, world_size, *args)`` in
each, and returns their results in rank order. Each run has a deadline:
a rank that fails, or a run that outlasts it (a collective that deadlocks),
ends every rank and raises, so a hang costs one call and not its caller.
The tests use it on the CPU; ``chip_smoke.py`` uses it for ranks that
share one card over gloo.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(device: str = "cuda", coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device:
    ``cuda:(local_rank % device_count)`` for ``device="cuda"``, else the
    CPU. The backend is NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one. With ``coordinator`` ("host:port"),
    ``num_processes`` and ``process_id`` say the group; without, the
    launcher's environment does (``env://``)."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        init, world, rank = (f"tcp://{coordinator}", int(num_processes),
                             int(process_id))
    else:
        init = "env://"
        world = int(os.environ.get("WORLD_SIZE", 1))
        rank = int(os.environ.get("RANK", 0))
    bound = torch.device("cpu")
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        bound = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(bound)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return bound


def _rank_main(fn, rank, world_size, store, backend, args, out):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world_size, rank=rank)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        Path(f"{out}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (),
              backend: str = "gloo", timeout: float = 300.0) -> List[Any]:
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned processes
    joined in one ``backend`` group, one torch thread each; their return
    values, in rank order.
    ``fn`` and ``args`` must pickle (a module-level function). Raises
    RuntimeError with the failed ranks' tracebacks, after ending every
    rank, if one fails or the run outlasts ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, store, backend, tuple(args),
            outs[r]), daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = [f"rank {r}:\n{Path(o + '.err').read_text()}"
                  for r, o in enumerate(outs) if os.path.exists(o + ".err")]
        if errors or any(p.exitcode != 0 for p in procs):
            late = time.monotonic() > deadline
            raise RuntimeError(
                f"run_ranks({getattr(fn, '__name__', fn)}, {world_size}): "
                + ("deadline of %g s passed; " % timeout if late else "")
                + f"exit codes {[p.exitcode for p in procs]}\n"
                + "\n".join(errors))
        return [torch.load(o, weights_only=False) for o in outs]
