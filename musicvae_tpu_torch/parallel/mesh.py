"""The data-parallel layout: which rows of the global batch each process
trains on, and on which device.

Counterpart of the data-axis part of the JAX package's parallel/mesh.py.
There the batch axis is sharded over a ('data', 'model') device mesh and
XLA reduces the gradients; here each process of the group
(parallel/distributed.py) drives one device, holds the whole (replicated)
model, and takes rows [p·B/P, (p+1)·B/P) of every global batch of B rows:
the JAX mesh's process-contiguous order, so process p trains on the rows
the JAX package's process p would. The train step averages the gradients
over the group (train/trainer.py).

Tensor parallelism over a 'model' axis (the JAX package's parallel/tp.py)
is not in the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from musicvae_tpu_torch.config import MeshSpec
from musicvae_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``data`` processes on the data axis (the group's world size), this
    process's ``rank`` among them, and the ``device`` it trains on.
    ``group``: whether a process group is joined (the gradients are then
    averaged over it, even at data = 1)."""

    data: int
    rank: int
    device: torch.device
    group: bool = False

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` rows."""
        if batch % self.data:
            raise ValueError(f"batch_size {batch} not divisible by "
                             f"{self.data} processes")
        n = batch // self.data
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(spec: Optional[MeshSpec] = None, device=None) -> DataMesh:
    """The data-parallel layout of this process: data = the group's world
    size (1 without a group), this rank, and ``device``; a CUDA device
    without an index (the default) is ``cuda:LOCAL_RANK``.

    The JAX package clamps the data axis to the devices there are, so a
    config registered with ``MeshSpec(data=8)`` (c4_cond) runs the global
    batch on one process; here the world size is the data axis whatever
    the spec asks. ``spec.model`` > 1 (tensor parallelism) is refused."""
    spec = spec or MeshSpec()
    if max(1, spec.model) > 1:
        raise NotImplementedError(
            f"tensor parallelism (MeshSpec.model={spec.model}) is not in "
            "the PyTorch port yet (ROADMAP.md item A16)")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", distributed.local_rank())
    group = torch.distributed.is_available() \
        and torch.distributed.is_initialized()
    return DataMesh(distributed.world_size(), distributed.rank(), device,
                    group)


def shard_batch(x, mesh: DataMesh, axis: int = 0):
    """This rank's rows of ``x`` (an array or tensor whose ``axis`` is the
    global batch): a view, contiguous when ``axis`` is the leading one."""
    rows = mesh.rows(x.shape[axis])
    return x[(slice(None),) * axis + (rows,)]
