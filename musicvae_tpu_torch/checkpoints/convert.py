"""JAX (flax) params, and a whole JAX train state → the port's layouts.

The port's own copy of the flax → torch direction of the JAX package's
checkpoints/torch_convert.py, for the kinds the port runs. Its output
equals ``flax_params_to_torch_state_dict`` key for key (the names are the
torch oracle's), and ``PianoRollVAE.load_state_dict(strict=True)`` takes
it as it is. Layouts:

- flax Conv kernel (kh,kw,in,out)            → Conv2d (out,in,kh,kw)
- flax ConvTranspose(transpose_kernel=True)
  kernel (kh,kw,out,in)                      → ConvTranspose2d (in,out,kh,kw)
- Dense kernel (in,out)                      → Linear (out,in)
- GRUCell {ir,iz,in,hr,hz,hn}                → weight_ih=[Wr;Wz;Wn],
  weight_hh=[Ur;Uz;Un], bias_ih=[b_ir;b_iz;b_in], bias_hh=[0;0;b_hn]
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.models.vae import check_supported


def flax_params_to_state_dict(params: Dict[str, Any],
                              cfg: Config) -> Dict[str, torch.Tensor]:
    """``params``: the JAX param pytree as nested dicts of arrays (numpy,
    or anything ``np.asarray`` takes)."""
    check_supported(cfg.model)
    out: Dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x))

    def put_conv(name, p):       # Conv and ConvTranspose alike
        out[f"{name}.weight"] = t(np.transpose(np.asarray(p["kernel"]),
                                               (3, 2, 0, 1)))
        out[f"{name}.bias"] = t(p["bias"])

    def put_dense(name, p):
        out[f"{name}.weight"] = t(np.asarray(p["kernel"]).T)
        out[f"{name}.bias"] = t(p["bias"])

    def put_barfeat(name, p):
        for key, sub in p["ConvTrunk_0"].items():
            put_conv(f"{name}.convs.{key.split('_')[1]}", sub)
        put_dense(f"{name}.fc", p["Dense_0"])

    def put_head(name, p):
        put_dense(f"{name}.fc", p["Dense_0"])
        for key, sub in p.items():
            if key.startswith("ConvTranspose_"):
                put_conv(f"{name}.deconvs.{key.split('_')[1]}", sub)

    def put_gru(name, p):
        h = np.asarray(p["hr"]["kernel"]).shape[0]
        kern = {k: np.asarray(p[k]["kernel"]).T
                for k in ("ir", "iz", "in", "hr", "hz", "hn")}
        out[f"{name}.weight_ih"] = t(np.concatenate(
            [kern["ir"], kern["iz"], kern["in"]]))
        out[f"{name}.weight_hh"] = t(np.concatenate(
            [kern["hr"], kern["hz"], kern["hn"]]))
        out[f"{name}.bias_ih"] = t(np.concatenate(
            [np.asarray(p[k]["bias"]) for k in ("ir", "iz", "in")]))
        out[f"{name}.bias_hh"] = t(np.concatenate(
            [np.zeros(2 * h, np.float32), np.asarray(p["hn"]["bias"])]))

    dec = params["decoder"]
    put_barfeat("enc_feat", params["enc_feat"])
    put_gru("enc_gru", params["enc_gru"]["GRUCell_0"])
    put_dense("h_init", dec["h_init"])
    if cfg.model.use_prev_bar:
        put_barfeat("prev_feat", dec["prev_feat"])
    put_gru("dec_gru", dec["seq_gru"])
    put_head("head", dec["head"])
    put_dense("z_head", params["z_head"]["Dense_0"])
    return out


def flax_train_state_to_state_dict(cfg: Config, params: Dict[str, Any],
                                   mu: Dict[str, Any], nu: Dict[str, Any],
                                   count: int, step: Optional[int] = None,
                                   ema: Optional[Dict[str, Any]] = None
                                   ) -> Dict[str, Any]:
    """A JAX train state → the layout of the port's
    ``TrainState.state_dict()`` (train/trainer.py), for
    ``TrainState.load_state_dict``: the params, an optax Adam state (its
    ``mu`` and ``nu`` trees and its ``count``, as
    ``optax.scale_by_adam`` keeps them) and the EMA tree, each a pytree
    shaped like the params, as nested dicts of arrays. ``step`` defaults
    to ``count``. The generator's state has no JAX counterpart and is
    left out: the loading state keeps its own.

    The moments go through the same layout map as the params, which is
    linear (transposes and concatenations); the GRU's r/z hidden biases,
    which flax does not have, get zero moments and never move."""
    return {
        "params": flax_params_to_state_dict(params, cfg),
        "opt": {"mu": flax_params_to_state_dict(mu, cfg),
                "nu": flax_params_to_state_dict(nu, cfg),
                "count": torch.tensor(int(count), dtype=torch.int32)},
        "step": torch.tensor(int(count if step is None else step),
                             dtype=torch.int32),
        "ema": None if ema is None else flax_params_to_state_dict(ema, cfg),
    }
