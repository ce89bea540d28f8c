"""Native (C++) host runtime: SMF parse, quantize and corpus rasterize via
ctypes.

The port's copy of the JAX package's native/__init__.py. ``load()`` builds
the shared library at first use (never at import) with ``g++`` into the
repo's ``build/native/`` and falls back to the pure-Python codec of
midi/smf.py and midi/tensorize.py when no toolchain is available: both
follow musicvae_tpu/midi/SEMANTICS.md and the tests hold them equal.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "smf_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = BUILD_DIR / "libmvae_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_ERRORS = {
    -1: "bad header / not SMF",
    -2: "SMPTE division unsupported",
    -3: "truncated event",
    -4: "unknown status byte",
    -5: "note/event overflow; raise the cap with --max-events "
        "(MidiSpec.max_events)",
    -6: "unsupported SMF format",
    -7: "tick overflow (> INT32_MAX)",
    -8: "time signature mismatch (a declared meter implies a bar length "
        "different from the config's; fix the corpus or pass "
        "--ignore-time-signature to force config-meter chunking)",
}


def build(force: bool = False) -> Path:
    """Compile the native library (idempotent). Returns the .so path.

    Compiles to a process-unique temp path then os.replace()s into place:
    concurrent processes (parallel test workers) may all decide to
    rebuild, and a non-atomic `g++ -o LIB` would let one process dlopen
    another's half-written file.
    """
    if force or not _LIB.exists() or (
            _SRC.stat().st_mtime > _LIB.stat().st_mtime):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{_LIB.name}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True)
            os.replace(tmp, _LIB)
        finally:
            if tmp.exists():
                tmp.unlink()
    return _LIB


# bumped in lockstep with smf_parser.cpp's mvae_abi_version(): signature
# changes make an old .so memory-unsafe to call through the new bindings
_ABI_VERSION = 2


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed); None if the toolchain is unavailable OR
    the library on disk is stale/incompatible. A version-mismatched .so
    triggers ONE forced rebuild before giving up: calling the new argtypes
    into old code would corrupt memory, not just error."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            def _version_ok(cand: ctypes.CDLL) -> bool:
                try:
                    cand.mvae_abi_version.restype = ctypes.c_int32
                    return cand.mvae_abi_version() == _ABI_VERSION
                except AttributeError:
                    return False    # pre-versioning .so

            lib = None
            cand = ctypes.CDLL(str(build()))
            if _version_ok(cand):
                lib = cand
            else:
                # stale library: rebuild, then dlopen the result through
                # a UNIQUE temp copy — dlopen caches by pathname, so
                # re-opening the original path would return the stale
                # handle even after os.replace swaps in the new file
                path = build(force=True)
                tmp = f"{path}.{os.getpid()}.abi"
                shutil.copy2(path, tmp)
                try:
                    cand = ctypes.CDLL(tmp)
                    if _version_ok(cand):
                        lib = cand
                finally:
                    # the mapping outlives the unlink (POSIX)
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            if lib is None:
                raise RuntimeError("native ABI mismatch after rebuild")
            _bind(lib)
        except Exception:
            _build_failed = True
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.mvae_parse_smf.restype = ctypes.c_int32
    lib.mvae_parse_smf.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mvae_quantize_events.restype = ctypes.c_int32
    lib.mvae_quantize_events.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.mvae_corpus_totals.restype = ctypes.c_int32
    lib.mvae_corpus_totals.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mvae_corpus_rasterize.restype = ctypes.c_int32
    lib.mvae_corpus_rasterize.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
    ]


def available() -> bool:
    return load() is not None


def parse_smf(data: bytes, max_notes: int = 65536
              ) -> Tuple[np.ndarray, int, int, tuple]:
    """SMF bytes → (notes[n,4] int32 (start,end,pitch,vel), tpq, tempo_us,
    time_signatures) — time_signatures mirrors midi/smf.py
    MidiFile.time_signatures: distinct (num, den) pairs in order of
    appearance (up to 4 recorded; a ``(0, 0)`` sentinel is appended when
    the file declared more distinct signatures than that, so strict
    checks fail closed). Raises ValueError on malformed input (same
    classes as midi/smf.py).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable; use midi.smf")
    notes = np.empty((max_notes, 4), dtype=np.int32)
    tpq = ctypes.c_int32()
    tempo = ctypes.c_int32()
    ts = np.zeros(9, dtype=np.int32)
    n = lib.mvae_parse_smf(
        data, len(data),
        notes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_notes,
        ctypes.byref(tpq), ctypes.byref(tempo),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise ValueError(f"native SMF parse failed: {_ERRORS.get(n, n)}")
    n_ts = int(ts[0])
    timesigs = tuple((int(ts[1 + 2 * i]), int(ts[2 + 2 * i]))
                     for i in range(min(n_ts, 4)))
    if n_ts > 4:
        timesigs += ((0, 0),)
    return notes[:n].copy(), tpq.value, tempo.value, timesigs


def tensorize_corpus(datas, spq: int, steps_per_bar: int,
                     max_notes: int = 65536,
                     num_threads: int = 0,
                     strict_timesig: bool = True) -> list:
    """Whole corpus → list of binary uint8 rolls [total_steps_i, 128].

    One multithreaded native pass (parse + quantize + rasterize per
    SEMANTICS.md §1–§4). num_threads=0 uses the host CPU count.
    ``strict_timesig`` (SEMANTICS.md §1): error on any file whose
    declared time signature implies a bar length ≠ steps_per_bar.
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable; use midi.tensorize")
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    n = len(datas)
    if n == 0:
        return []
    blob = b"".join(datas)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(d) for d in datas], out=offsets[1:])
    totals = np.zeros(n, dtype=np.int64)
    off_p = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    strict = 1 if strict_timesig else 0
    rc = lib.mvae_corpus_totals(
        blob, off_p, n, spq, steps_per_bar, max_notes, num_threads, strict,
        totals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc < 0:
        raise ValueError(f"native corpus parse failed: {_ERRORS.get(rc, rc)}")
    roll_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(totals, out=roll_offsets[1:])
    rolls = np.zeros((int(roll_offsets[-1]), 128), dtype=np.uint8)
    rc = lib.mvae_corpus_rasterize(
        blob, off_p, n, spq, steps_per_bar, max_notes, num_threads, strict,
        roll_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rolls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError(
            f"native corpus rasterize failed: {_ERRORS.get(rc, rc)}")
    return [rolls[int(roll_offsets[i]):int(roll_offsets[i + 1])]
            for i in range(n)]


def quantize_events(notes: np.ndarray, tpq: int, spq: int,
                    steps_per_bar: int, max_events: int
                    ) -> Tuple[np.ndarray, int]:
    """notes[n,4] → (padded events[max_events,3] (s_on,s_off,pitch),
    bar-padded total_steps) — SEMANTICS.md §2/§3 in native code."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable; use midi.tensorize")
    notes = np.ascontiguousarray(notes, dtype=np.int32)
    events = np.empty((max_events, 3), dtype=np.int32)
    total = lib.mvae_quantize_events(
        notes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        notes.shape[0], tpq, spq, steps_per_bar,
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_events)
    if total < 0:
        raise ValueError(f"native quantize failed: {_ERRORS.get(total, total)}")
    return events, int(total)
