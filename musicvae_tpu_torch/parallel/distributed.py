"""The process group of multi-process data-parallel training.

Counterpart of the JAX package's parallel/distributed.py. Every process
drives one device; the group is ``torch.distributed`` over NCCL between
CUDA devices and over gloo on the CPU (or, asked for by name, between
CUDA devices that share one card: NCCL refuses two ranks on one device).
The data path is the JAX package's: every process computes the same
host-side values (the bar cache, the window ids, the initial state, all
deterministic in the corpus and the seed) and trains on its own rows of
the global batch (parallel/mesh.py), and ``assert_hosts_identical``
checks that contract once at start-up.

A launch names the group by one of, in this order:

1. the arguments of ``initialize_from_env``;
2. ``MVAE_COORDINATOR`` (host:port of rank 0), ``MVAE_NUM_PROCS`` and
   ``MVAE_PROC_ID``, all three together;
3. torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
   and ``LOCAL_RANK``, when ``MVAE_AUTO_DISTRIBUTED=1``
   (``torchrun --nproc-per-node N -m musicvae_tpu_torch train ...`` sets
   the first five; the sixth opts in, as in the JAX package).

Nothing configured means one process and no group.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import torch
import torch.distributed as dist

_MVAE_VARS = ("MVAE_COORDINATOR", "MVAE_NUM_PROCS", "MVAE_PROC_ID")


def world_size() -> int:
    """The number of processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """The rank among this host's processes: torchrun's ``LOCAL_RANK``,
    else the global rank modulo the visible cards (one host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not dist.is_initialized():
        return 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank() % n if n else 0


def _backend(device) -> str:
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        device=None, backend: Optional[str] = None) -> bool:
    """Join the process group a multi-process launch configured (the
    module docstring lists the sources); True once joined, False when
    nothing is configured. A second call after joining does nothing and
    returns True.

    ``backend``: "nccl" or "gloo"; by default NCCL when this process
    drives a CUDA device (``device``, else whether CUDA is available) and
    gloo on the CPU. A partial ``MVAE_*`` set is a ValueError naming the
    missing variables: it never trains alone by mistake."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or env.get("MVAE_COORDINATOR")
    if num_processes is None and "MVAE_NUM_PROCS" in env:
        num_processes = int(env["MVAE_NUM_PROCS"])
    if process_id is None and "MVAE_PROC_ID" in env:
        process_id = int(env["MVAE_PROC_ID"])
    fields = dict(zip(_MVAE_VARS, (coordinator, num_processes, process_id)))
    present = {k for k, v in fields.items() if v is not None}
    if present and present != set(fields):
        missing = sorted(set(fields) - present)
        raise ValueError(
            "partial multi-process configuration: missing "
            f"{', '.join(missing)} (all of MVAE_COORDINATOR, "
            "MVAE_NUM_PROCS, MVAE_PROC_ID must be set together)")
    if present:
        init = f"tcp://{coordinator}"
    elif env.get("MVAE_AUTO_DISTRIBUTED") == "1":
        need = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
        missing = [k for k in need if k not in env]
        if missing:
            raise ValueError(
                "MVAE_AUTO_DISTRIBUTED=1 reads torchrun's variables, but "
                f"{', '.join(missing)} is not set (launch with torchrun)")
        init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} not in "
                         f"[0, {num_processes})")
    dist.init_process_group(backend=backend or _backend(device),
                            init_method=init, world_size=num_processes,
                            rank=process_id)
    return True


def collective_device() -> torch.device:
    """Where a collective's tensors live: the CPU for gloo, this rank's
    card for NCCL (which reduces CUDA tensors only)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assert_hosts_identical(what: str, *chunks) -> None:
    """Fail on every rank when any rank's ``chunks`` (bytes or C-contiguous
    buffers, hashed as they are: a corpus is not copied) differ from
    rank 0's. The data path's contract is that every process computes the
    same host-side values; this hashes them with sha256 and all-gathers 16
    bytes a rank, so every rank sees the same table and raises, naming
    the ranks that differ. One collective, at start-up; nothing at world
    size 1."""
    if world_size() == 1:
        return
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    dev = collective_device()
    local = torch.frombuffer(bytearray(h.digest()[:16]),
                             dtype=torch.uint8).to(dev)
    table = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(table, local)
    table = [t.cpu() for t in table]
    bad = [p for p, t in enumerate(table) if not torch.equal(t, table[0])]
    if bad:
        raise RuntimeError(
            f"multi-process data divergence: {what} differs across "
            f"processes (processes {bad} disagree with process 0). Every "
            f"process must compute the identical corpus and batches; see "
            f"parallel/mesh.py's data contract.")
