"""``mfu.train`` in the data-parallel training cell, on rank 0's card: one
process's train step of the conditional VAE at its rows of the global
batch (perfbench/yardstick_dp.py, the runner's ``flops_per_step``) times
the steps of rank 0's traced window, over the window and the card's dense
bf16 peak."""

from perfbench import harness

read = harness.reader("mfu.train")
