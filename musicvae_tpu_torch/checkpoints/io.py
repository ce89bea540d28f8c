"""Checkpoint files: save, keep-N retention, restore and resume.

Counterpart of the JAX package's checkpoints/io.py, which keeps its steps
with Orbax. The port writes its own format, readable without jax:

    <directory>/<step>/state.pt      TrainState.state_dict() on the CPU,
                                     torch.save, loads with weights_only
    <directory>/<step>/config.json   the effective Config (config_to_json)

A step is written into a hidden temporary directory beside it and
committed by one ``os.rename``, so a step directory that is listed was
written whole; an interrupted write leaves only the hidden directory,
which is never listed. The behaviours are the JAX module's: ``save``
refuses a step at or below the newest one, keeps the newest N, and writes
on one background thread after the copy to the host; ``restore`` tries the
steps newest first, twice each, falls back past a step that fails, and
quarantines the failed newer steps (``<step>.corrupt``) once an older step
of the same template has restored.

Under multi-process training (parallel/distributed.py) process 0 alone
writes and quarantines, and every process passes a barrier after a save;
``restore`` reads the same files on every process. A tensor-parallel
state is saved unsharded and restores into one process or into a sharded
state alike.

A JAX checkpoint (the Orbax layout) is brought across by the repo-root
script ``import_orbax_checkpoint.py``, on a machine with jax.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import threading
from typing import Any, List, Optional, Tuple

import torch

from musicvae_tpu_torch import config as config_lib
from musicvae_tpu_torch.parallel import distributed

STATE_FILE = "state.pt"
CONFIG_FILE = "config.json"
IMPORTER = "import_orbax_checkpoint.py"


class OrbaxLayoutError(ValueError):
    """The directory holds the JAX package's Orbax checkpoints."""


def config_to_json(cfg: config_lib.Config) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def config_from_json(text: str) -> config_lib.Config:
    d = json.loads(text)
    return config_lib.Config(
        name=d["name"],
        midi=config_lib.MidiSpec(**d["midi"]),
        model=config_lib.ModelSpec(
            **{**d["model"],
               "enc_channels": tuple(d["model"]["enc_channels"]),
               "dec_channels": tuple(d["model"]["dec_channels"]),
               # absent in checkpoints older than the patch stem
               "stem": d["model"].get("stem", "conv"),
               "patch_size": tuple(d["model"].get("patch_size", (8, 16)))}),
        train=config_lib.TrainSpec(**d["train"]),
        gen=config_lib.GenSpec(**d["gen"]),
        mesh=config_lib.MeshSpec(**d["mesh"]),
    )


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """The steps of one checkpoint directory. ``save`` registers a step at
    once and writes it on one background thread; ``wait_until_finished``
    joins that thread and raises what the write raised. The directory is
    made at the first write, so a manager over a directory that never
    receives a step creates nothing."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._steps = self._scan()

    def _scan(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(
                          os.path.join(self.directory, name)))

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        with self._lock:
            return list(self._steps)

    def latest_step(self) -> Optional[int]:
        with self._lock:
            return self._steps[-1] if self._steps else None

    def reload(self) -> None:
        """Read the step list from the directory again."""
        self.wait_until_finished()
        with self._lock:
            self._steps = self._scan()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"writing a checkpoint into {self.directory} "
                               f"failed") from err

    def write(self, step: int, state_dict: dict, config_json: str,
              wait: bool = False) -> bool:
        """Write ``state_dict`` (tensors on the CPU, owned by the caller no
        longer) as ``step``; False, and nothing written, when the directory
        already holds this step or a newer one."""
        self.wait_until_finished()
        with self._lock:
            if self._steps and step <= self._steps[-1]:
                return False
            self._steps.append(step)
        self._thread = threading.Thread(
            target=self._write, args=(step, state_dict, config_json),
            name=f"ckpt-write-{step}")
        self._thread.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step: int, state_dict: dict, config_json: str) -> None:
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(state_dict, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, CONFIG_FILE), "w") as f:
                f.write(config_json)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, self.step_dir(step))
            _fsync_dir(self.directory)
            with self._lock:
                drop = self._steps[:-self.keep]
                self._steps = self._steps[-self.keep:]
            for s in drop:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
        except BaseException as e:          # noqa: BLE001: re-raised at wait
            with self._lock:
                if step in self._steps:
                    self._steps.remove(step)
            self._error = e


def make_manager(directory: str, keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, keep)


def save(manager: CheckpointManager, state, cfg: config_lib.Config,
         wait: bool = False) -> bool:
    """Save ``state`` (a train/trainer.py TrainState) with ``cfg``; returns
    whether this process wrote the step. False means the directory
    already holds this step or a newer one, or that this is not process 0
    of a process group: every process calls ``save``, process 0 writes
    (every process holds the same state) and all of them then pass a
    barrier. The copy to the host happens here, on the caller's thread,
    and is the only wait for the card; the file write runs on the
    manager's thread (``wait`` joins it). A second save waits for the
    first.

    A tensor-parallel state (parallel/tp.py) is written unsharded, the
    file a one-process run writes: every process gathers its model
    group's shards, and process 0 writes them."""
    written = False
    # the gather is collective: every process of a sharded state takes part
    sd = state.state_dict(device="cpu") if state.tp is not None else None
    if distributed.rank() == 0:
        step = int(state.step)
        manager.wait_until_finished()
        latest = manager.latest_step()
        if latest is None or step > latest:
            if sd is None:
                sd = state.state_dict(device="cpu")
            written = manager.write(step, sd, config_to_json(cfg),
                                    wait=wait)
    if distributed.world_size() > 1:
        torch.distributed.barrier()
    return written


def _check_layout(manager: CheckpointManager, step: int) -> None:
    d = manager.step_dir(step)
    if not os.path.exists(os.path.join(d, STATE_FILE)) and (
            os.path.exists(os.path.join(d, "_CHECKPOINT_METADATA"))
            or os.path.isdir(os.path.join(d, "state"))):
        raise OrbaxLayoutError(
            f"{manager.directory} holds checkpoints in the JAX package's "
            f"Orbax layout (step {step}); convert them to the port's format "
            f"with `python {IMPORTER} --ckpt-dir {manager.directory} --out "
            f"<new dir>` on a machine with jax")


def _read_config(manager: CheckpointManager, step: int) -> config_lib.Config:
    with open(os.path.join(manager.step_dir(step), CONFIG_FILE)) as f:
        return config_from_json(f.read())


def _steps_to_try(manager: CheckpointManager,
                  step: Optional[int]) -> List[int]:
    manager.wait_until_finished()
    steps = ([step] if step is not None
             else sorted(manager.all_steps(), reverse=True))
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in "
                                f"{manager.directory}")
    for s in steps:
        _check_layout(manager, s)
    return steps


def restore_config(manager: CheckpointManager,
                   step: Optional[int] = None) -> config_lib.Config:
    """Read only the Config of a checkpoint. Without ``step`` a step whose
    config cannot be read is skipped, newest first; an explicit ``step``
    is strict."""
    steps = _steps_to_try(manager, step)
    last_err: Optional[Exception] = None
    for s in steps:
        try:
            return _read_config(manager, s)
        except Exception as e:
            if step is not None:
                raise
            last_err = e
    raise RuntimeError(f"no checkpoint step has a readable config "
                       f"({steps})") from last_err


def restore(manager: CheckpointManager, template_state,
            step: Optional[int] = None) -> Tuple[Any, config_lib.Config]:
    """Restore (state, config): ``template_state`` (a TrainState, e.g.
    from trainer.create_state of the checkpoint's config) is overwritten
    in place with the step and returned.

    Without ``step`` a step that fails to load (damaged on disk) is tried
    once more and then skipped for the next-newest one; the failed newer
    steps are quarantined only once an older step of the same template has
    restored, which shows that they, and not the template, are at fault.
    An explicit ``step`` is strict: failures propagate."""
    strict = step is not None
    steps = _steps_to_try(manager, step)
    last_err: Optional[Exception] = None
    failed: list = []
    for s in steps:
        restored = None
        # two attempts a step: a transient failure (file system, host
        # memory) is indistinguishable from damage on one try
        for attempt in range(2):
            try:
                sd = torch.load(os.path.join(manager.step_dir(s),
                                             STATE_FILE),
                                map_location="cpu", weights_only=True)
                cfg = _read_config(manager, s)
                template_state.load_state_dict(sd)
                restored = cfg
                break
            except Exception as e:
                if strict:
                    raise
                last_err = e
                print(f"warning: checkpoint step {s} failed to restore "
                      f"({type(e).__name__}); "
                      f"{'retrying once' if attempt == 0 else 'falling back to an earlier step'}",
                      file=sys.stderr)
        if restored is None:
            failed.append(s)
            continue
        for fs in failed:
            if distributed.rank() == 0:
                _quarantine_step(manager, fs)
        if failed:
            manager.reload()
        return template_state, restored
    raise RuntimeError(
        f"all checkpoint steps {steps} failed to restore (nothing was "
        f"deleted or quarantined — if this is a config/template mismatch, "
        f"retry with the checkpoint's own config)") from last_err


def _quarantine_step(manager: CheckpointManager, step: int) -> None:
    """Move a step shown to be damaged aside as '<step>.corrupt[.N]': it is
    no longer listed, and its files stay for recovery by hand."""
    src = manager.step_dir(step)
    dst = f"{src}.corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}.corrupt.{n}"
    try:
        os.rename(src, dst)
    except OSError as e:
        print(f"warning: could not quarantine corrupt step {step} "
              f"({type(e).__name__}); saves at steps <= {step} may be "
              f"skipped", file=sys.stderr)
        return
    print(f"warning: quarantined corrupt checkpoint step {step} as "
          f"{os.path.basename(dst)} (recoverable by hand; delete it to "
          f"reclaim space)", file=sys.stderr)
