"""The open-loop schedule of a serve mix: when each request is due and the
seed it asks for, made from the run's seed.

Every seed gets the same work: ``round(rate · seconds)`` requests whose
gaps are the same set of exponential quantiles (a Poisson process's gaps
at the mix's rate, scaled to fill the window exactly), in an order drawn
from the seed; and each request asks for a seed of its own. The order is
stratified: every run of ``BLOCK`` consecutive requests takes one gap from
each of ``BLOCK`` strata of the sorted gaps, so the bursts that set a
latency tail come as often in every run, wherever they fall."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BLOCK = 10


def gaps_in_order(n: int, rng: np.random.Generator) -> np.ndarray:
    """The ``n`` exponential quantiles (mean 1), ordered as set out above."""
    q = (np.arange(n) + 0.5) / n
    strata = [rng.permutation(s) for s in
              np.array_split(-np.log1p(-q), min(BLOCK, n))]
    out = []
    for b in range(len(strata[0])):
        block = [s[b] for s in strata if b < len(s)]
        out.extend(rng.permutation(block))
    return np.asarray(out)


def schedule(rate: float, seconds: float, seed: int
             ) -> List[Tuple[float, int]]:
    """[(due seconds after the window opens, request seed)], in order of
    due time, the first due at 0 and the last before ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(seed)
    gaps = gaps_in_order(n, rng)
    gaps *= seconds / gaps.sum()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    seeds = int(rng.integers(0, 1 << 61)) + rng.permutation(n)
    return [(float(t), int(s)) for t, s in zip(due, seeds)]


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` distinct request indices out of ``n`` (all when k >= n), drawn
    from the seed, in order."""
    rng = np.random.default_rng((seed, 7))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
