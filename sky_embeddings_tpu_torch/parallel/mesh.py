"""Device mesh and batch layouts (port of
``sky_embeddings_tpu/parallel/mesh.py``).

:func:`create_mesh` builds the ('data', 'model') :class:`Mesh` over the
ranks of the process group, with JAX's divisibility errors. JAX lays the
devices out as ``reshape(data, model)``, so the model axis is consecutive
ranks: rank ``r`` has data index ``r // model`` and model index ``r %
model``. Under a process group the mesh holds a ``torch.distributed`` group
per row (the model group: the ranks of one data index, which hold one
model's shards and all-reduce its tensor-parallel partials) and per column
(the data group: the ranks of one model index, over which DDP averages
gradients and ZeRO-1 shards the moments); ``new_group`` is called for every
row and column on every rank, in the same order, as it must be. With
``model = 1`` the data group is the whole process group (None) and there is
no model group; with ``model > 1`` every row and column has its group,
one of a single rank included. Every trainer takes any model axis that
divides the rank count (:func:`create_mesh`'s errors otherwise, JAX's); a
block whose heads the axis does not divide runs whole on every rank
(``parallel/sharding.py``).

The trainers :func:`activate` the mesh they build, and
``parallel/distributed`` reads it (:func:`data_group`, :func:`data_index`,
:func:`data_count`) for the batch's rows, the loss's global sums and the
wraps; with none active, the data axis is every process, as before.

:func:`batch_sharding` and :func:`replicated` are plain descriptors
(:class:`Sharding`) that ``data/prefetch.device_prefetch`` and
``parallel/distributed.put_global`` read: the rank's device, and whether
the leading axis is split over 'data' (each rank holds its own rows) or
every rank holds it whole. :func:`local_sharding` gives the same
descriptor for the active mesh (or a data-only one over every process)
without building one, which is what the trainers use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

@dataclass(frozen=True)
class Sharding:
    """Where a batch's leaves go: ``device`` (this rank's), split over
    'data' (``batch``: rank ``index`` of ``count`` holds its own rows) or
    replicated."""

    device: torch.device
    batch: bool = True
    index: int = 0
    count: int = 1


class Mesh:
    """A ('data', 'model') layout of the ranks ``devices`` (a (data, model)
    array, consecutive ranks along 'model') seen from ``rank``, with this
    rank's process groups (None without a process group; the data group
    None too at model = 1, where it is the whole process group)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, devices: np.ndarray, rank: int, device_type: str,
                 data_group=None, model_group=None):
        self.devices = devices
        self.shape = tuple(devices.shape)
        self.device_type = device_type
        self.rank = rank
        self.data_index, self.model_index = (int(i[0]) for i in np.nonzero(devices == rank))
        self.data_group = data_group
        self.model_group = model_group

    def size(self, dim: int | str = 0) -> int:
        return self.shape[self.mesh_dim_names.index(dim) if isinstance(dim, str) else dim]

    def get_local_rank(self, dim: str) -> int:
        return self.data_index if dim == "data" else self.model_index

    @property
    def tp(self) -> int:
        return self.shape[1]

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group in place (nothing at model = 1)."""
        if self.tp > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.model_group)
        return t

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, data_index={self.data_index}, "
                f"model_index={self.model_index})")


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence[int]] = None, device_type: str = "cuda") -> Mesh:
    """A ('data', 'model') :class:`Mesh` over ``devices`` (the ranks, every
    rank of the process group by default). ``data`` defaults to the rank
    count over ``model``; ``data * model`` must equal the rank count.
    Under a process group every rank must call it (it makes the groups);
    without one it describes rank 0's place and makes none."""
    import torch.distributed as dist

    on = dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size() if on else 1))
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data({data}) * model({model}) != device count ({n})")
    arr = np.asarray(devices).reshape(data, model)
    rank = dist.get_rank() if on else int(arr[0, 0])
    data_group = model_group = None
    if on and model > 1:
        for row in arr:  # one model group per data index
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                model_group = g
        for col in arr.T:  # one data group per model index (of one rank at data = 1)
            g = dist.new_group([int(r) for r in col])
            if rank in col:
                data_group = g
    return Mesh(arr, rank, device_type, data_group, model_group)


_ACTIVE: Optional[Mesh] = None


def tensor_parallel_mesh(tp: int, device: str | torch.device) -> Optional[Mesh]:
    """The trainers' mesh for ``[TRAINING] tensor_parallel = tp``: at 1 none
    (and none active: the data axis is every process), else
    ``create_mesh(model=tp)`` over the process group, made active. Every
    rank must call it."""
    if tp <= 1:
        activate(None)
        return None
    mesh = create_mesh(model=tp, device_type=torch.device(device).type)
    activate(mesh)
    return mesh


def activate(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the layout ``parallel/distributed`` reads (None: the
    data axis is every process)."""
    global _ACTIVE
    _ACTIVE = mesh


def active() -> Optional[Mesh]:
    return _ACTIVE


def data_group() -> Any:
    """The data group of the active mesh; None (the whole process group)
    without one."""
    return _ACTIVE.data_group if _ACTIVE is not None else None


def data_index() -> int:
    from sky_embeddings_tpu_torch.parallel.distributed import process_index

    return _ACTIVE.data_index if _ACTIVE is not None else process_index()


def data_count() -> int:
    from sky_embeddings_tpu_torch.parallel.distributed import process_count

    return _ACTIVE.shape[0] if _ACTIVE is not None else process_count()


def _rank_device(mesh) -> torch.device:
    from sky_embeddings_tpu_torch.parallel.distributed import rank_device

    return rank_device(mesh.device_type)


def batch_sharding(mesh) -> Sharding:
    """The leading (batch) axis split over 'data'; the rest replicated."""
    return Sharding(_rank_device(mesh), True, mesh.get_local_rank("data"), mesh.size(0))


def replicated(mesh) -> Sharding:
    return Sharding(_rank_device(mesh), False, 0, 1)


def local_sharding(device: torch.device) -> Sharding:
    """:func:`batch_sharding` of the active mesh (a data-only mesh over
    every process without one), on ``device``, without building a mesh."""
    return Sharding(torch.device(device), True, data_index(), data_count())
