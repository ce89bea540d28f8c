"""The data-axis-sharded resident corpus: for corpora larger than one
device's memory but smaller than the group's.

Counterpart of the JAX package's train/sharded_corpus.py; the numpy half
(``build_sharded_arrays``, ``make_sharded_id_schedule``) is its copy and
gives the same arrays and ids bit for bit. The corpus is dealt piece-wise
into one shard per process of the data axis
(``PianoRollDataset.host_shard``) and packed into equal-sized blocks;
process d uploads only block d (``local_block``), so each device holds
1/D of the bar cache, and every train step gathers this process's rows
of the global batch from its own block (train/trainer.py
``_make_window_gather``). No collective touches roll data; the only
traffic between processes stays the gradient reduction.

Sampling follows the sharded-loader contract: each shard shuffles its own
windows under a seed derived from (seed, 23, shard), and rows
[d·B/D, (d+1)·B/D) of the global batch come from shard d. The draws are
stateless in (seed, shard, step), so resume draws what a continuous run
draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from musicvae_tpu_torch.train.trainer import make_id_schedule

CORPUS_KEYS = ("bars", "starts", "chords", "keys")


def build_sharded_arrays(ds, n_shards: int, seed: int
                         ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Partition ``ds`` into ``n_shards`` piece-wise shards and pack them
    into equal-sized blocks (every block padded to the largest shard's bar
    and window counts; pad rows are never addressed, since per-shard ids
    stay below that shard's true count).

    Returns ({"bars": [D*T_pad,96,128] u8, "starts", "chords", "keys":
    [D*S_pad] i32}, counts[D]) with counts[d] shard d's true window
    count."""
    shards = [ds.host_shard(d, n_shards, seed=seed) for d in range(n_shards)]
    t_pad = max(s.bars.shape[0] for s in shards)
    s_pad = max(len(s) for s in shards)

    def pad(a: np.ndarray, n: int) -> np.ndarray:
        return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    arrays = {
        "bars": np.concatenate([pad(s.bars, t_pad) for s in shards]),
        "starts": np.concatenate([pad(s.starts, s_pad) for s in shards]),
        "chords": np.concatenate([pad(s.chords, s_pad) for s in shards]),
        "keys": np.concatenate([pad(s.keys, s_pad) for s in shards]),
    }
    counts = np.array([len(s) for s in shards], np.int64)
    return arrays, counts


def local_block(arrays: Dict[str, np.ndarray], n_shards: int,
                shard: int) -> Dict[str, np.ndarray]:
    """Shard ``shard``'s block of every array of ``build_sharded_arrays``
    (views): what its process uploads."""
    out = {}
    for k in CORPUS_KEYS:
        n = arrays[k].shape[0] // n_shards
        out[k] = arrays[k][shard * n:(shard + 1) * n]
    return out


def make_sharded_id_schedule(seed: int, counts: np.ndarray, b: int
                             ) -> Callable[[int], np.ndarray]:
    """Stateless step → [b] shard-local window ids (shard d owns rows
    [d*b/D, (d+1)*b/D)). Each shard runs its own ``make_id_schedule``
    stream over its true window count under a derived seed, so what the
    resident schedule guarantees (seekable resume, epoch cover,
    small-corpus replacement sampling) holds per shard."""
    d = len(counts)
    if b % d:
        raise ValueError(f"batch_size {b} not divisible by {d} corpus "
                         "shards (the 'data' mesh axis)")
    bl = b // d
    subs = [make_id_schedule(
        int(np.random.default_rng((seed, 23, i)).integers(2 ** 63)),
        int(counts[i]), bl) for i in range(d)]

    def ids_for_step(step: int) -> np.ndarray:
        return np.concatenate([s(step) for s in subs])

    return ids_for_step
