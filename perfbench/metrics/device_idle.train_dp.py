"""``device_idle.train`` in the data-parallel training cell: the share of
rank 0's traced window in which no operation ran on its card (NCCL's
kernels count as operations)."""

from perfbench import harness

read = harness.reader("device_idle.train")
