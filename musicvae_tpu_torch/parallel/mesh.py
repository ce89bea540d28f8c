"""The process layout: which rows of the global batch each process trains
on, which processes share a model shard, and on which device.

Counterpart of the JAX package's parallel/mesh.py. There the batch axis
is sharded over a ('data', 'model') device mesh and XLA reduces the
gradients; here each process of the group (parallel/distributed.py)
drives one device and stands at one point of the same grid: the world's
P processes laid out as ``reshape(data, model)``, so process p has data
index p // M and model index p % M. A process takes rows
[d·B/D, (d+1)·B/D) of every global batch of B rows by its data index d
(the JAX mesh's process-contiguous order), the train step averages the
gradients over its data group (the processes of its model index), and
under tensor parallelism (parallel/tp.py) the processes of one model
group (one data index) each hold a shard of the weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from musicvae_tpu_torch.config import MeshSpec
from musicvae_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``data`` × ``model`` processes (``processes``, the group's world
    size), this process's global ``rank`` and the ``device`` it trains
    on. ``group``: whether a process group is joined (the gradients are
    then averaged over the data group, even at data = 1 when there is no
    model axis). ``data_group`` and ``model_group``: this process's
    subgroups when ``model`` > 1 (None means the whole group and no model
    axis)."""

    data: int
    rank: int
    device: torch.device
    group: bool = False
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def processes(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def rows(self, batch: int) -> slice:
        """This process's rows of a global batch of ``batch`` rows, by its
        data index."""
        if batch % self.data:
            raise ValueError(f"batch_size {batch} not divisible by "
                             f"{self.data} processes")
        n = batch // self.data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)


def _subgroups(world: int, model: int, rank: int):
    """(data group, model group) of ``rank``: every process creates every
    subgroup, in the same order (``dist.new_group`` is collective)."""
    data_groups = [dist.new_group(list(range(m, world, model)))
                   for m in range(model)]
    model_groups = [dist.new_group(list(range(d * model, (d + 1) * model)))
                    for d in range(world // model)]
    return data_groups[rank % model], model_groups[rank // model]


def _model_axis(spec: Optional[MeshSpec]) -> int:
    """``spec``'s model axis M, refused in the JAX package's words when it
    is larger than the world, and when it does not divide it."""
    model = max(1, (spec or MeshSpec()).model)
    world = distributed.world_size()
    if model > world:
        raise ValueError(f"model axis {model} > {world} devices")
    if world % model:
        raise ValueError(f"{world} processes are not a multiple of the "
                         f"model axis {model}")
    return model


def data_axis(spec: Optional[MeshSpec] = None) -> Tuple[int, int]:
    """(data, this process's data index) of the layout ``make_mesh(spec)``
    gives, without creating its groups: what a host-local data shard is
    chosen by."""
    model = _model_axis(spec)
    return distributed.world_size() // model, distributed.rank() // model


def make_mesh(spec: Optional[MeshSpec] = None, device=None) -> DataMesh:
    """The layout of this process: model = ``spec.model``, data = the
    group's world size P (1 without a group) over it, this rank, and
    ``device``; a CUDA device without an index (the default) is
    ``cuda:LOCAL_RANK``.

    The JAX package clamps the data axis to the devices there are, so a
    config registered with ``MeshSpec(data=8)`` (c4_cond) runs the global
    batch on one process; here P // model is the data axis whatever the
    spec asks. A model axis larger than P is a ValueError in the JAX
    package's words, and so is one that does not divide P. With
    ``spec.model`` > 1 every process must call this together: it creates
    the data and model subgroups."""
    model = _model_axis(spec)
    world = distributed.world_size()
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", distributed.local_rank())
    group = dist.is_available() and dist.is_initialized()
    rank = distributed.rank()
    data_group = model_group = None
    if model > 1:
        data_group, model_group = _subgroups(world, model, rank)
    return DataMesh(world // model, rank, device, group, model, data_group,
                    model_group)


def shard_batch(x, mesh: DataMesh, axis: int = 0):
    """This process's rows of ``x`` (an array or tensor whose ``axis`` is
    the global batch): a view, contiguous when ``axis`` is the leading
    one."""
    rows = mesh.rows(x.shape[axis])
    return x[(slice(None),) * axis + (rows,)]
