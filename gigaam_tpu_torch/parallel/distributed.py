"""Multi-process runtime helpers (port of
``gigaam_tpu/parallel/distributed.py``).

The JAX package runs one program per host and lets ``jax.distributed``
find the cluster.  The port runs one process per device, PyTorch's own
model: ``torchrun`` (or any launcher) starts the processes, and
``initialize`` joins them into one ``torch.distributed`` group with the
backend the caller names: ``nccl`` when each rank owns a CUDA device,
``gloo`` on the CPU (or for ranks that share one device, which NCCL
refuses).  Nothing switches backend on an error.

Typical use::

    from gigaam_tpu_torch.parallel import distributed as dist
    from gigaam_tpu_torch.parallel.mesh import make_mesh
    dist.initialize(backend="nccl")          # no-op for a single process
    mesh = make_mesh(data=dist.world_size())
    model.set_mesh(mesh)                     # DP inference
    # or FineTuner(model, tc, mesh=mesh)     # DP(+TP) training
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence, TypeVar

import torch.distributed as tdist

T = TypeVar("T")

BACKENDS = ("nccl", "gloo")


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 600.0) -> None:
    """Join this process to the default ``torch.distributed`` group.

    With no arguments the group is read from ``torchrun``'s environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); outside
    one, a single process has nothing to join and this is a no-op.  A
    caller who asks for several processes (``world_size > 1`` or a
    ``rank``) with no ``init_method`` and no multi-process environment gets
    a ``ValueError``, never a silent single-process run: every process
    would then train on the whole batch with no error anywhere (the JAX
    function's refusal, ``distributed.py:41-55``).  Safe to call twice."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if tdist.is_initialized():
        return
    if init_method is None and not _env_configured():
        if (world_size or 0) > 1 or rank is not None:
            raise ValueError(
                "initialize(world_size=..., rank=...) needs a rendezvous: "
                "pass init_method (e.g. 'tcp://127.0.0.1:29500') or launch "
                "under torchrun (no multi-process setup is discoverable in "
                "this environment)")
        return
    kw = {}
    if init_method is not None:
        kw = {"init_method": init_method, "world_size": world_size,
              "rank": rank}
    tdist.init_process_group(backend=backend,
                             timeout=timedelta(seconds=timeout_s), **kw)


def _env_configured() -> bool:
    """True when the environment advertises a multi-process run: torch's
    launcher variables (``WORLD_SIZE`` > 1 with ``MASTER_ADDR``) or an
    MPI/SLURM task count above one."""
    env = os.environ
    for k in ("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS",
              "PMI_SIZE"):
        try:
            if int(env.get(k, "1")) > 1:
                return k != "WORLD_SIZE" or bool(env.get("MASTER_ADDR"))
        except ValueError:
            pass
    return False


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK`` under torchrun)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def process_shard(items: Sequence[T], pad: bool = False) -> List[T]:
    """This rank's round-robin slice of a global work list (items i with
    ``i % world == rank``).  ``pad=True`` repeats the final item until every
    rank holds ceil(n / world) items, so that every rank issues the same
    number of collective calls; ``process_shard_indices(n, pad=True)``
    marks the duplicates (they repeat the final index)."""
    p, r = world_size(), rank()
    mine = [x for i, x in enumerate(items) if i % p == r]
    if pad and items:
        target = -(-len(items) // p)
        while len(mine) < target:
            mine.append(mine[-1] if mine else items[-1])
    return mine


def process_shard_indices(n: int, pad: bool = False) -> List[int]:
    """Global indices of this rank's ``process_shard`` items (padded
    duplicates repeat the final index, marking results to drop)."""
    p, r = world_size(), rank()
    mine = [i for i in range(n) if i % p == r]
    if pad and n:
        target = -(-n // p)
        while len(mine) < target:
            mine.append(mine[-1] if mine else n - 1)
    return mine
