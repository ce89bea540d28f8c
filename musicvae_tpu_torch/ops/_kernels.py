"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and links into one
``build/kernels/<hash>/libmusicvae_kernels.so`` under the repo root, loaded
with ``ctypes``. The C entry points take raw pointers, sizes and the CUDA
stream, and return the launch's ``cudaError_t``. The build happens at first
use and again whenever a source, a header or the flags change (the
directory is named by their hash). Nothing here runs at import: the CPU
tests import every module on machines with no ``nvcc``.

Each wrapper adds one to its entry of ``LAUNCHES`` where it launches its
kernel (``launched``), and nowhere else, so a run can show which kernels
its main path went through. A wrapper called on a stream that is being
captured into a CUDA graph (utils/graphs.py) launches nothing: its count
goes to the capture's record (``capture_launches``), and each replay of
the graph, which launches the kernel, adds the record to ``LAUNCHES``
(``count_replay``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmusicvae_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element-kind codes of the C entry points (csrc/common.cuh mvk::Kind)
KINDS = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}

LAUNCHES = {"first_conv_s2": 0, "first_conv_s2_bwd": 0, "masked_bce_sum": 0,
            "masked_bce_sum_dual": 0, "masked_bce_bwd": 0, "kl_sum": 0,
            "kl_bwd": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}      # path, seconds, log of the build this process used
_records: dict = {}     # stream under capture → its launch record


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launched(name: str, stream: int) -> None:
    """Count one launch of kernel ``name`` on ``stream`` (a pointer,
    ``stream_of``): in ``LAUNCHES``, or, while that stream is captured
    into a graph, in the capture's record (from whichever thread
    launches: autograd runs a backward in a thread of its own)."""
    record = _records.get(stream)
    (LAUNCHES if record is None else record)[name] += 1


@contextlib.contextmanager
def capture_launches(stream: int):
    """While the block captures ``stream`` (a pointer) into a graph, the
    wrappers' launches on it count into the dict this yields: the
    launches one replay of the graph makes."""
    record = dict.fromkeys(LAUNCHES, 0)
    _records[stream] = record
    try:
        yield record
    finally:
        del _records[stream]


def count_replay(record: dict) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``record``."""
    for name, n in record.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the port's CUDA kernels build on the machine with "
                       "the card")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return srcs, digest.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library if this source hash has
    not been built yet; returns its path. Concurrent builds each work in
    a private temporary directory and publish with an atomic rename."""
    srcs, digest = _sources()
    out_dir = BUILD_ROOT / digest
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, log="(cached)")
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s.name, log) for s, p, log in zip(srcs, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for o in objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_info.update(path=str(lib_path),
                      seconds=time.perf_counter() - t0,
                      log="\n".join(logs))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            handle.mvk_first_conv_s2.argtypes = [p, i, p, p, p, i, i, i, i, p]
            handle.mvk_first_conv_s2_bwd.argtypes = [p, i, p, p, p, i, p, p,
                                                     i, i, i, p]
            handle.mvk_masked_bce_sum.argtypes = [p, i, p, i, p, p, p, p, ll,
                                                  i, p]
            handle.mvk_masked_bce_sum_dual.argtypes = [p, i, p, i, p, p, p, p,
                                                       p, ll, i, p]
            handle.mvk_masked_bce_bwd.argtypes = [p, i, p, i, p, p, p, ll, i,
                                                  p]
            handle.mvk_kl_sum.argtypes = [p, p, i, p, ll, p]
            handle.mvk_kl_bwd.argtypes = [p, p, i, p, p, p, ll, p]
            for name in LAUNCHES:       # one C entry point per kernel
                getattr(handle, "mvk_" + name).restype = i
            _lib = handle
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc}")


def check_cuda_inputs(name: str, device: torch.device, **tensors) -> None:
    """Every tensor on ``device`` and contiguous; raises otherwise."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
