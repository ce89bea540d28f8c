#!/usr/bin/env python3
"""Bring a JAX checkpoint (musicvae_tpu's Orbax layout) into the PyTorch
port's checkpoint format (musicvae_tpu_torch/checkpoints/io.py).

    python import_orbax_checkpoint.py --ckpt-dir JAX_DIR --out PORT_DIR [--step N]

Runs where jax is installed: the port itself never imports jax, so its
checkpoints cannot read Orbax. The step (default: the newest restorable
one) is restored with ``musicvae_tpu.checkpoints.restore``; its params,
the optax Adam moments and count, and the EMA weights go through the
port's ``checkpoints/convert.py`` ``flax_train_state_to_state_dict``; and
the result is written with the port's ``checkpoints.io.save``, with the
same config, at the same step. The JAX state's PRNG key has no
counterpart: the imported state keeps a generator seeded from the config.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import jax
import numpy as np
import optax

from musicvae_tpu import checkpoints as jax_ckpt
from musicvae_tpu.train import create_state as jax_create_state
from musicvae_tpu_torch.checkpoints import io as port_io
from musicvae_tpu_torch.checkpoints.convert import \
    flax_train_state_to_state_dict
from musicvae_tpu_torch.train.trainer import create_state


def _f32(tree):
    """Numpy f32 leaves (bf16 moments included: torch takes no numpy
    bf16, and bf16 → f32 → bf16 is exact)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def adam_state(opt_state) -> optax.ScaleByAdamState:
    """The one optax Adam state inside ``opt_state`` (behind an optional
    global-norm clip; adam and adamw keep the same one)."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if len(found) != 1:
        raise ValueError(f"expected one optax Adam state, found "
                         f"{len(found)}")
    return found[0]


def convert_state(jax_state, jax_cfg):
    """(port config, port TrainState on the CPU) holding ``jax_state``."""
    cfg = port_io.config_from_json(jax_ckpt.config_to_json(jax_cfg))
    adam = adam_state(jax_state.opt_state)
    sd = flax_train_state_to_state_dict(
        cfg, _f32(jax_state.params), _f32(adam.mu), _f32(adam.nu),
        int(adam.count), int(jax_state.step),
        None if jax_state.ema_params is None
        else _f32(jax_state.ema_params))
    _, state = create_state(cfg, device="cpu")
    state.load_state_dict(sd)
    return cfg, state


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True,
                    help="the JAX package's checkpoint directory")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to import (default: the newest "
                         "restorable one)")
    args = ap.parse_args(argv)
    manager = jax_ckpt.make_manager(args.ckpt_dir)
    if manager.latest_step() is None:
        print(f"error: no checkpoint in {args.ckpt_dir}", file=sys.stderr)
        return 2
    jax_cfg = jax_ckpt.restore_config(manager, args.step)
    # the state's shapes alone: no weights are initialised
    template = jax.eval_shape(lambda: jax_create_state(jax_cfg)[1])
    jax_state, jax_cfg = jax_ckpt.restore(manager, template, args.step)
    cfg, state = convert_state(jax_state, jax_cfg)
    out = port_io.make_manager(args.out, cfg.train.ckpt_keep)
    if not port_io.save(out, state, cfg, wait=True):
        print(f"error: {args.out} already holds step {out.latest_step()}, "
              f"not older than {int(state.step)}", file=sys.stderr)
        return 2
    print(f"imported {cfg.name} step {int(state.step)} from "
          f"{args.ckpt_dir} into {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
