"""perfbench/served.py with a fault planted where the served bars are
produced: every coalesced sweep's bars come back with a block of cells
flipped."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from musicvae_tpu_torch import cli  # noqa: E402
from perfbench import served  # noqa: E402

_run = cli._CoalescedRunner.run


def _flipped(self, items):
    out = _run(self, items)
    for bars in out:
        bars[:, 1, 10:14, 40:44] ^= 1
    return out


cli._CoalescedRunner.run = _flipped

if __name__ == "__main__":
    sys.exit(served.main())
