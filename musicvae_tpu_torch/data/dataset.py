"""Piano-roll dataset + batch iterator.

The port's copy of the JAX package's data/dataset.py (numpy only). Bars are
stored once as a contiguous uint8 array plus int32 window-start indices;
windows are never materialized (a window is ``bars[start : start+num_bars]``).
The trainer uploads the bar array to the card and gathers whole batches of
windows there (train/trainer.py ``make_train_step_indexed``); ``batch()``
assembles small host batches for eval and tests.

The ``.npz`` layout of ``save_npy`` / ``load_npy`` is the JAX package's, so
a cache written by either package's ``preprocess`` trains the other.
``from_corpus`` tensorizes a MIDI corpus on the host (midi/tensorize.py);
``host_shard`` deals a process its piece-wise share of the corpus for
multi-process training, and ``HostLocalBatches`` marks an iterator of a
process's own rows of the global batch.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from musicvae_tpu_torch.config import MidiSpec


class HostLocalBatches:
    """Marks a streaming iterator as yielding per-process local batch
    slices: each process feeds ``train()`` an iterator whose batches hold
    only its own [global_batch / D] rows (typically windows of its
    ``PianoRollDataset.host_shard``), so no process materializes the
    global batch. The global batch is the data-index-order concatenation
    of the local slices: the processes at data index d of D own rows
    [d·B/D, (d+1)·B/D) (parallel/mesh.py; D = P without a model axis)."""

    def __init__(self, it: Iterator):
        self._it = iter(it)

    def __iter__(self) -> Iterator:
        return self._it

    def __next__(self):
        return next(self._it)


class PianoRollDataset:
    def __init__(self, bars: np.ndarray, starts: np.ndarray, num_bars: int,
                 chords: np.ndarray, keys: np.ndarray,
                 piece_ids: np.ndarray = None, grid=None):
        """bars: [T,96,128] uint8 (all pieces concatenated); starts: [N]
        int32 window starts into ``bars``; chords/keys: [N] int32 labels;
        piece_ids: [N] int32 source-piece index per window (enables
        leakage-free train/eval splits; zeros for legacy caches);
        grid: (steps_per_quarter, quarters_per_bar[, bar_steps]) the
        corpus was QUANTIZED under (None for legacy caches = the 24/4
        default; bar_steps 0 = derived spq*qpb, nonzero for
        bar-adapting meters like 7/8 → 84) — training validates it
        against the config so a --meter cache can never silently train
        under a differently-gridded model."""
        if bars.ndim != 3 or bars.dtype != np.uint8:
            raise ValueError(f"bars must be uint8 [T,steps,pitches], got "
                             f"{bars.dtype} {bars.shape}")
        self.bars = bars
        self.starts = np.asarray(starts, np.int32)
        self.num_bars = int(num_bars)
        self.chords = np.asarray(chords, np.int32)
        self.keys = np.asarray(keys, np.int32)
        self.piece_ids = (np.zeros(self.starts.shape[0], np.int32)
                          if piece_ids is None
                          else np.asarray(piece_ids, np.int32))
        self.grid = None if grid is None else (
            (int(grid[0]), int(grid[1]))
            + ((int(grid[2]),) if len(grid) > 2 and int(grid[2]) else ()))

    # -- construction --------------------------------------------------------

    @classmethod
    def from_corpus(cls, pieces: Sequence[Tuple[bytes, int, int]],
                    spec: MidiSpec, num_bars: int,
                    infer_labels: bool = False) -> "PianoRollDataset":
        """pieces: (smf_bytes, chord_class, key_class) triples. A None
        chord/key means "unlabeled": inferred from the rolls when
        ``infer_labels`` (key per piece via Krumhansl-Schmuckler, chord per
        window via triad match — midi/labels.py), else 0."""
        from musicvae_tpu_torch.midi import labels as labels_mod
        from musicvae_tpu_torch.midi import tensorize

        all_bars = tensorize.corpus_to_bars([p[0] for p in pieces], spec,
                                            as_uint8=True)
        starts: List[int] = []
        chords: List[int] = []
        keys: List[int] = []
        piece_ids: List[int] = []
        offset = 0
        for pid, (bars, (_, chord, key)) in enumerate(zip(all_bars, pieces)):
            # per-bar histograms once per piece; overlapping windows then
            # score from a [num_bars,12] sum instead of re-histogramming
            # the full [num_bars*T,128] roll per window
            hists = (labels_mod.bar_pc_histograms(bars)
                     if infer_labels and (key is None or chord is None)
                     else None)
            if key is None:
                key = (labels_mod.key_from_hist(hists.sum(0))
                       if infer_labels else 0)
            n = bars.shape[0]
            for s in range(0, n - num_bars + 1):
                if chord is None:
                    c = (labels_mod.chord_from_hist(
                            hists[s:s + num_bars].sum(0), fallback=key)
                         if infer_labels else 0)
                else:
                    c = chord
                starts.append(offset + s)
                chords.append(c)
                keys.append(key)
                piece_ids.append(pid)
            offset += n
        if not starts:
            raise ValueError("corpus produced no windows "
                             f"(need pieces with >= {num_bars} bars)")
        return cls(np.concatenate(all_bars, axis=0), np.asarray(starts),
                   num_bars, np.asarray(chords), np.asarray(keys),
                   np.asarray(piece_ids),
                   grid=(spec.steps_per_quarter, spec.quarters_per_bar,
                         spec.bar_steps))

    @classmethod
    def load_npy(cls, path: str) -> "PianoRollDataset":
        with np.load(path) as z:
            if "bars" not in z.files:
                raise ValueError(
                    f"{path} is not a bar-format cache "
                    f"(found {z.files}); re-run `preprocess` to regenerate")
            return cls(z["bars"], z["starts"], int(z["num_bars"]),
                       z["chords"], z["keys"],
                       z["piece_ids"] if "piece_ids" in z.files else None,
                       grid=z["grid"] if "grid" in z.files else None)

    def save_npy(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra = {}
        if self.grid is not None:
            extra["grid"] = np.asarray(self.grid, np.int32)
        np.savez_compressed(path, bars=self.bars, starts=self.starts,
                            num_bars=self.num_bars, chords=self.chords,
                            keys=self.keys, piece_ids=self.piece_ids,
                            **extra)

    # -- splitting -----------------------------------------------------------

    def split(self, holdout_frac: float, seed: int = 0
              ) -> Tuple["PianoRollDataset", "PianoRollDataset"]:
        """Deterministic (train, eval) split for in-training eval.

        Splits at PIECE granularity: neighboring windows share bars, so a
        window-level split leaks eval content into training. Legacy caches
        without piece ids (all zeros) fall back to a tail split by window
        position, which at least keeps the eval windows contiguous.
        """
        if not 0.0 < holdout_frac < 1.0:
            raise ValueError(f"holdout_frac must be in (0, 1), "
                             f"got {holdout_frac}")
        n = len(self)
        pieces = np.unique(self.piece_ids)
        if pieces.shape[0] > 1:
            perm = np.random.default_rng(seed).permutation(pieces)
            n_eval = int(np.clip(round(holdout_frac * pieces.shape[0]),
                                 1, pieces.shape[0] - 1))
            eval_mask = np.isin(self.piece_ids, perm[:n_eval])
        else:
            n_eval = int(np.clip(round(holdout_frac * n), 1, n - 1))
            eval_mask = np.zeros(n, dtype=bool)
            eval_mask[n - n_eval:] = True
        if eval_mask.all() or not eval_mask.any():
            raise ValueError("degenerate split: adjust holdout_frac")

        def _sub(mask: np.ndarray) -> "PianoRollDataset":
            return PianoRollDataset(self.bars, self.starts[mask],
                                    self.num_bars, self.chords[mask],
                                    self.keys[mask], self.piece_ids[mask],
                                    grid=self.grid)

        return _sub(~eval_mask), _sub(eval_mask)

    def host_shard(self, process_index: int, process_count: int,
                   seed: int = 0) -> "PianoRollDataset":
        """Deterministic per-process corpus shard for multi-process data
        loading: the JAX package's shards, bit for bit.

        Pieces are dealt round-robin over a permutation seeded (seed, 71)
        and the shard keeps only its own pieces' bars, so host memory per
        process is ~corpus/process_count; the returned dataset is
        self-contained (remapped window starts), so ``batch()`` and
        ``iterator()`` work unchanged. A process trains on windows of its
        own shard only (the data-parallel sharded-loader contract, as
        torch's DistributedSampler); the global batch is the
        concatenation of the per-shard batches (``HostLocalBatches``)."""
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in "
                             f"[0, {process_count})")
        pieces = np.unique(self.piece_ids)
        if process_count > pieces.shape[0]:
            raise ValueError(
                f"cannot shard {pieces.shape[0]} pieces over "
                f"{process_count} processes (each process needs >= 1 "
                f"piece; legacy caches without piece ids are one piece)")
        perm = np.random.default_rng((seed, 71)).permutation(pieces)
        mine = perm[process_index::process_count]
        win_mask = np.isin(self.piece_ids, mine)
        if not win_mask.any():
            raise ValueError(
                f"shard {process_index}/{process_count} got no windows "
                "(pieces shorter than num_bars contribute none)")
        # keep whole pieces: the kept windows' spans, marked by a +1/-1
        # difference array, are exactly the kept pieces' bars (windows
        # never cross a piece and tile every in-piece offset)
        kept_starts = self.starts[win_mask]
        diff = np.zeros(self.bars.shape[0] + 1, np.int64)
        np.add.at(diff, kept_starts, 1)
        np.add.at(diff, kept_starts + self.num_bars, -1)
        keep_bars = np.cumsum(diff[:-1]) > 0
        new_index = np.cumsum(keep_bars) - 1
        return PianoRollDataset(
            np.ascontiguousarray(self.bars[keep_bars]),
            new_index[self.starts[win_mask]].astype(np.int32),
            self.num_bars, self.chords[win_mask], self.keys[win_mask],
            self.piece_ids[win_mask], grid=self.grid)

    # -- serving -------------------------------------------------------------

    def __len__(self) -> int:
        return self.starts.shape[0]

    def window_indices(self, idx: np.ndarray) -> np.ndarray:
        """[B] window ids → [B, num_bars] bar indices into ``bars``."""
        return (self.starts[idx][:, None]
                + np.arange(self.num_bars, dtype=np.int32)[None, :])

    def batch(self, idx: np.ndarray,
              x_dtype=np.float32) -> Dict[str, np.ndarray]:
        """Small host-side batch (eval/tests); training gathers on device.
        ``x_dtype=np.uint8`` skips the float expansion — the streaming
        path works on uint8 rolls."""
        x = self.bars[self.window_indices(idx)].astype(x_dtype, copy=False)
        return {"x": x,
                "chord": np.repeat(self.chords[idx][:, None], self.num_bars,
                                   axis=1),
                "key_sig": self.keys[idx]}

    def iterator(self, batch_size: int, seed: int = 0,
                 x_dtype=np.float32) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite shuffled epochs of host batches (streaming fallback).

        The per-epoch remainder (< batch_size windows) is always dropped:
        the train step keeps one batch shape, and a shuffled epoch means
        different windows land in the remainder each epoch, so nothing is
        systematically skipped.
        """
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            if n < batch_size:
                yield self.batch(rng.integers(0, n, size=batch_size),
                                 x_dtype)
                continue
            perm = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                yield self.batch(perm[i:i + batch_size], x_dtype)
