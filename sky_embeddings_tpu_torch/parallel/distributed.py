"""Multi-process data parallelism on ``torch.distributed`` (port of
``sky_embeddings_tpu/parallel/distributed.py``).

JAX runs one process per host and lays a global batch over every device of
a mesh; the CUDA idiom is one process per GPU. So a run of N processes is N
ranks, rank r on ``cuda:<r % torch.cuda.device_count()>`` (several hosts of
8 GPUs each: ranks 0-7 on the first host, 8-15 on the second, ...). Each
rank feeds its own ``H5Batcher`` shard (``process_count`` /
``process_index``) with the per-process batch, and the trainers wrap their
model in ``DistributedDataParallel``, whose gradient averaging stands for
the global sum XLA inserts over the data axis.

* :func:`initialize_from_env`: ``init_process_group`` from the same
  contract JAX reads (``SKY_DISTRIBUTED``, ``SKY_COORDINATOR_ADDRESS``,
  ``SKY_NUM_PROCESSES``, ``SKY_PROCESS_ID``), ``nccl`` for a CUDA rank and
  ``gloo`` on the CPU unless the caller names a backend. torchrun's
  variables are not read: JAX has no counterpart.
* :func:`process_count` / :func:`process_index` / :func:`is_main`: 1 / 0 /
  True with no process group.
* :func:`rank_device`: the rank's device.
* :func:`put_global`: each rank's local rows on the rank's device. Under
  DDP there is no global tensor to build: the global batch exists only as
  the rows of every rank together.
* :func:`global_ratio` / :func:`global_mean`: a loss's reduction over the
  global batch. Every rank must call them (they are collectives).
* :func:`data_parallel`, :func:`batch_rows`, :func:`checkpoint_due`,
  :func:`main_only`: the wrap, the rank's rows of a global draw, the loops'
  save clock (rank 0's, so every rank saves together), and logging from
  rank 0 alone.

Under tensor parallelism (``parallel/mesh``: a mesh the trainer made
active) the data axis is the mesh's data group, not every process: the
ranks of one model group take the same rows and the same mask draws
(:func:`batch_rows` by the data index), the loss's sums run over the data
group (:func:`global_ratio`, :func:`global_mean`), and DDP averages over
it, so no sum or replicated gradient is counted once per model rank. With
no mesh active this is the whole process group, as before.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from sky_embeddings_tpu_torch.parallel import mesh as _mesh
from sky_embeddings_tpu_torch.utils.device import resolve_device

ENV_FLAG = "SKY_DISTRIBUTED"
ENV_COORD = "SKY_COORDINATOR_ADDRESS"
ENV_NPROC = "SKY_NUM_PROCESSES"
ENV_PID = "SKY_PROCESS_ID"


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return process_index() == 0


def rank_device(device: str | torch.device = "cuda", rank: Optional[int] = None) -> torch.device:
    """``device`` for a CPU rank; else ``cuda:<rank % device count>``, the
    rank being this process's (0 with no process group)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_from_env(log_fn=print, backend: Optional[str] = None,
                        device: str | torch.device = "cuda") -> bool:
    """``init_process_group`` when the launcher set ``SKY_DISTRIBUTED``.

    Returns True when a process group exists. Safe to call more than once
    and in single-process runs (no-op, False). Unlike ``jax.distributed`` on
    a TPU VM, ``torch.distributed`` discovers no peers, so the coordinator
    (``host:port``), the process count and this process's id must all be
    set. A CUDA rank is bound to :func:`rank_device` before the group is
    made."""
    if dist.is_initialized():
        return True
    if not os.environ.get(ENV_FLAG):
        return False
    missing = [k for k in (ENV_COORD, ENV_NPROC, ENV_PID) if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"{ENV_FLAG} is set but {', '.join(missing)} not: torch.distributed "
                           "needs the coordinator address, the process count and this process's id")
    world, rank = int(os.environ[ENV_NPROC]), int(os.environ[ENV_PID])
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{os.environ[ENV_COORD]}",
                            world_size=world, rank=rank)
    log_fn(f"torch.distributed initialized ({backend}): process {rank}/{world} on {dev}")
    return True


def put_global(batch: Any, sharding) -> Any:
    """A rank's local batch (nested dicts / lists of numpy arrays or
    tensors) on ``sharding.device``: the rank's rows of the global batch,
    which no tensor holds whole. With one process, the batch on the
    device."""
    from sky_embeddings_tpu_torch.data.prefetch import map_leaves

    return map_leaves(lambda x: torch.as_tensor(x).to(sharding.device), batch)


def data_parallel(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` wrapped in ``DistributedDataParallel`` over the data group
    under a process group, else ``module`` itself (also under a mesh with
    one data index: tensor parallelism alone has nothing to average).
    ``find_unused_parameters`` lets a parameter that takes no gradient on
    every rank (SimMIM's ``mask_token``) leave its gradient None, which the
    trainers fill with
    JAX's zero gradient; the cost is a walk of the autograd graph and one
    small all-reduce of the used-parameter map a step. The buffers (the
    fixed sin-cos tables) are the same on every rank, so they are not
    broadcast before each forward (``forward_sync_buffers``, called
    ``broadcast_buffers`` before PyTorch 2.13)."""
    if not dist.is_initialized() or (_mesh.active() is not None and _mesh.data_count() == 1):
        return module
    import inspect

    from torch.nn.parallel import DistributedDataParallel

    sync = ("forward_sync_buffers" if "forward_sync_buffers"
            in inspect.signature(DistributedDataParallel.__init__).parameters else "broadcast_buffers")
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        find_unused_parameters=True, process_group=_mesh.data_group(), **{sync: False})


def batch_rows(local: int) -> Optional[tuple[slice, int]]:
    """``(this rank's rows, global batch size)`` of a global batch of
    ``local`` rows a rank; None with no process group. The trainers draw
    their masks and augmentations for the global batch from a generator
    every rank seeds alike, as JAX draws them from a replicated key, and
    keep these rows: by the data index, so the ranks of one model group
    take the same rows."""
    if not dist.is_initialized():
        return None
    r, n = _mesh.data_index(), _mesh.data_count()
    return slice(r * local, (r + 1) * local), n * local


def checkpoint_due(started: float, minutes: float, validated: bool) -> bool:
    """Whether ``minutes`` have passed since ``started`` (``time.time()``).
    With no process group this is read at every step. Under one, a save is
    a collective (ZeRO's moments are collected), so every rank must decide
    alike: rank 0's clock decides, read at validation steps (``validated``)
    only, since the broadcast waits for the other ranks."""
    due = time.time() - started >= minutes * 60
    if not dist.is_initialized():
        return due
    if not validated:
        return False
    # a host decision: on the CPU unless NCCL, which takes CUDA tensors only, runs the group
    on = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(due)], device=on)
    dist.broadcast(t, 0)
    return bool(t.item())


def main_only(log_fn):
    """``log_fn`` on rank 0, a no-op on the other ranks."""
    return log_fn if is_main() else (lambda *_, **__: None)


class _Reduced(torch.autograd.Function):
    """Forward: ``value``, already reduced over the ranks; backward: the
    gradient of ``num`` as ``g * scale / den``."""

    @staticmethod
    def forward(ctx, num, value, scale, den):
        ctx.scale, ctx.den = scale, den
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale / ctx.den, None, None, None


def global_ratio(num: torch.Tensor, den, eps: float = 0.0) -> torch.Tensor:
    """``num / (den + eps)`` over the global batch: ``num`` a sum over this
    rank's rows, ``den`` the count beside it (taken under no grad).

    With no process group this is ``num / (den + eps)``, bit for bit. Under
    one, both parts are all-reduced over the data group and every rank gets
    the global value; the gradient that flows to ``num`` is that of ``world
    · num / (den_all + eps)``, ``world`` the data group's size, so that
    DDP's average over the ranks is exactly the gradient of the global
    masked mean (averaging the ranks' own ratios would weigh each rank's
    rows by its count). At world 1 the value and gradient equal
    the no-group ones bit for bit."""
    if not dist.is_initialized():
        return num / (den + eps)
    den = torch.as_tensor(den, dtype=torch.float32, device=num.device)
    both = torch.stack([num.detach().float(), den.detach()])
    dist.all_reduce(both, group=_mesh.data_group())
    total = both[1] + eps
    return _Reduced.apply(num, both[0] / total, float(_mesh.data_count()), total)


def global_mean(values: Sequence[torch.Tensor], count: int) -> tuple[torch.Tensor, ...]:
    """Means over this rank's ``count`` rows -> means over the global batch
    (``values`` unchanged with no process group). A rank's gradient is
    scaled by ``world · count / global count``, 1 where the ranks' batches
    are equal, so DDP's average is the gradient of the global mean."""
    if not dist.is_initialized():
        return tuple(values)
    parts = torch.stack([v.detach().float() * count for v in values]
                        + [torch.tensor(float(count), device=values[0].device)])
    dist.all_reduce(parts, group=_mesh.data_group())
    n = parts[-1]
    scale = float(_mesh.data_count() * count / float(n))
    return tuple(_Reduced.apply(v, parts[i] / n, scale, 1.0) for i, v in enumerate(values))
