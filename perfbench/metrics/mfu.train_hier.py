"""``mfu.train`` in the hierarchical model's training cell, whose bars a
second carry a bound of their own (``train_bars_per_s.hier``)."""

from perfbench import harness

read = harness.reader("mfu.train")
