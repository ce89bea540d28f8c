"""The data-parallel cell's arithmetic: the model FLOPs of one process's
train step of the chord/key-conditional VAE (``cond``), and the bytes of
the step's gradient all-reduce, both functions of the configuration's
shapes, and the bound of that all-reduce.

A cond model is the GRU sequence VAE with the chord and key embeddings
(2·``cond_embed_dim`` a bar) joined to the encoder GRU's input, the
decoder GRU's input and the head's input; the embeddings' lookups are not
FLOPs. The all-reduce is one flat f32 bucket of every trainable
parameter's gradient and three metrics (the step's loss, recon and kl),
reduced in place (the bucket of the other kinds likewise).

NVLink between the cards of an H100 SXM host carries 450 GB/s in each
direction. An all-reduce of S bytes makes each process send at least S
and take in at least S (NVLink SHARP, which reduces inside the switch,
reaches that least; a ring sends 2·S·(P−1)/P), so S over 450 GB/s is a
time no algorithm beats.
"""

from __future__ import annotations

import math
from typing import Dict

from perfbench import yardstick
from perfbench.reference import cond as ref_cond
from perfbench.reference import model as ref

NVLINK_BYTES = 450e9        # one direction of a card's NVLink, H100 SXM
METRICS_IN_BUCKET = 3       # loss, recon, kl


def train_forward_macs(spec: dict, batch: int) -> Dict[str, int]:
    """A teacher-forced forward's multiply-adds by part for ``batch``
    windows of a cond model: the GRU sequence VAE's parts, with the
    conditioning vector's share of each GRU's and of the head's first
    dense layer added."""
    m = spec["model"]
    parts = yardstick.train_forward_macs(ref_cond.gru_seq_spec(spec),
                                           batch)
    c = 2 * m["cond_embed_dim"]
    t, p = yardstick._bar(spec)
    dec = m["dec_channels"]
    t0, p0 = -(-t // 2 ** len(dec)), -(-p // 2 ** len(dec))
    bars = batch * m["num_bars"]
    h = m["gru_hidden"]
    parts["enc_gru"] += bars * 3 * h * c
    parts["dec_gru"] += bars * 3 * h * c
    parts["head"] += bars * c * t0 * p0 * dec[0]
    return parts


def train_step_flops(spec: dict, batch: int) -> float:
    """Model FLOPs of one train step of ``batch`` windows (a process's
    rows): the forward's three times, less the first convs' input
    gradients, which the step never computes (their input is data)."""
    parts = train_forward_macs(spec, batch)
    fwd = sum(parts.values())
    return 2.0 * (3 * fwd - parts["enc_conv1"] - parts["prev_conv1"])


def bucket_bytes(spec: dict) -> int:
    """Bytes of the step's all-reduce: every trainable parameter's f32
    gradient and the three metrics (a cond model's parameters, or the
    GRU sequence or hierarchical VAE's)."""
    shapes = (ref_cond.param_shapes(spec) if spec["model"]["kind"] == "cond"
              else ref.param_shapes(spec))
    elems = sum(math.prod(s) for s in shapes.values())
    return 4 * (elems + METRICS_IN_BUCKET)


def allreduce_bound_s(spec: dict) -> float:
    """The least time of the step's all-reduce: its bytes over one
    direction of the card's NVLink."""
    return bucket_bytes(spec) / NVLINK_BYTES
