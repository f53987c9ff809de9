"""Multi-process bring-up, the mesh's process groups and the collectives
of its axes (``biogpt_tpu/parallel/distributed.py``).

Every rank runs the same program (one process per card), and
``initialize`` joins them into one ``torch.distributed`` process group;
``parallel.mesh.make_mesh`` then gives each rank its place on the (data,
model) mesh, with the process groups of its two axes from
:func:`mesh_groups`. The group defaults to NCCL (one card per rank); the CPU tests and
ranks that share one card (NCCL refuses two ranks on one device) ask for
gloo. Failure handling is fail-fast: any rank's error ends the job. A
rank whose script finished waits at a bounded barrier for the others
before it tears its process group down (:func:`exit_barrier`).

Launch, one process per card:

    python -m biogpt_tpu_torch.parallel.distributed --coordinator host0:1234 \\
        --num-processes N --process-id $ID -- your_script.py args...

or call :func:`initialize` at the top of your own entry point.

The collectives run between kernel launches, never inside one, on the
tensors where they lie. Gloo takes CUDA tensors for every collective used
here (all-reduce sum and max, broadcast, all-gather, reduce-scatter; f32,
int32 and bf16, PyTorch 2.11 on an H100), so ranks that share a card run
with gloo unchanged and nothing is staged through host copies by this
module; the kernels run on the card either way.
"""

from __future__ import annotations

import argparse
import runpy
import sys
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> None:
    """Join this process to the job's default process group (a no-op for
    a single process). ``coordinator_address`` is rank 0's ``host:port``;
    without it the ``MASTER_ADDR``/``MASTER_PORT`` environment is read."""
    if num_processes is not None and num_processes <= 1:
        return
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def is_primary() -> bool:
    """True on the process that should do logging and I/O (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _reduced(x: torch.Tensor, group, op) -> torch.Tensor:
    t = x.detach().clone().contiguous()
    dist.all_reduce(t, op, group)
    return t


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return _reduced(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    return _reduced(x, group, dist.ReduceOp.MAX)


def broadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank 0's ``x`` on every rank."""
    t = x.detach().clone().contiguous()
    dist.broadcast(t, 0, group)
    return t


def mesh_groups(data: int, model: int) -> tuple:
    """The process groups of this rank on a (data, model) mesh over every
    rank of the job, laid out as ``jax.make_mesh((data, model))`` lays out
    devices: rank r sits at (r // model, r % model). -> (its model axis'
    group: the ranks of its data replica; its data axis' group: the ranks
    that share its model index); None for an axis of one rank.
    ``torch.distributed.new_group`` must be called by every rank for every
    group, in the same order, even for groups it is not in: this is the
    one place that calls it."""
    rank = dist.get_rank()
    model_group = data_group = None
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
    return model_group, data_group


def all_gather(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """The sum over ranks of ``x``, each rank keeping its own contiguous
    1/size of axis ``dim`` (in rank order)."""
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"axis {dim} of {src.shape[0]} rows does not split "
                         f"over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, dist.ReduceOp.SUM, group)
    return out.movedim(0, dim)


# seconds a rank that finished its script waits at teardown for the others
EXIT_BARRIER_S = 120.0


def exit_barrier(timeout_s: float = EXIT_BARRIER_S) -> None:
    """Hold this rank until every rank has finished its script, so that none
    tears down its connections while a peer is still in its last
    collective; raise if a peer does not arrive within ``timeout_s`` (a
    dead peer then ends the job instead of hanging it). Gloo's monitored
    barrier names the rank that did not arrive."""
    timeout = timedelta(seconds=timeout_s)
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=timeout)
    else:
        dist.barrier(async_op=True).wait(timeout=timeout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--backend", default="nccl",
                        help="nccl (one card per process) or gloo")
    parser.add_argument("script", nargs=argparse.REMAINDER,
                        help="-- script.py [args...] to run after init")
    args = parser.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id,
               backend=args.backend)
    script = [s for s in args.script if s != "--"]
    finished = False
    try:
        if script:
            sys.argv = script
            runpy.run_path(script[0], run_name="__main__")
        elif dist.is_initialized():
            print(f"initialized: process {dist.get_rank()} of "
                  f"{dist.get_world_size()} ({dist.get_backend()})")
        finished = True
    finally:
        if dist.is_initialized():
            try:
                if finished:   # a failing rank ends the job at once
                    exit_barrier()
            finally:
                dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
