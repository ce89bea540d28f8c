"""JAX (flax) params, a whole JAX train state, and torch state dicts →
the port's layouts.

The port's own copy of the flax → torch direction of the JAX package's
checkpoints/torch_convert.py, and ``canonical_state_dict``, which checks a
torch state dict against a config and brings it to the form that round
trip gives. For the parity configs (stem "conv", temporal "gru") the
output equals ``flax_params_to_torch_state_dict`` key for key (the names
are the torch oracle's), and ``PianoRollVAE.load_state_dict(strict=True)``
takes it as it is. Layouts:

- flax Conv kernel (kh,kw,in,out)            → Conv2d (out,in,kh,kw)
- flax ConvTranspose(transpose_kernel=True)
  kernel (kh,kw,out,in)                      → ConvTranspose2d (in,out,kh,kw)
- Dense kernel (in,out)                      → Linear (out,in)
- GRUCell {ir,iz,in,hr,hz,hn}                → weight_ih=[Wr;Wz;Wn],
  weight_hh=[Ur;Uz;Un], bias_ih=[b_ir;b_iz;b_in], bias_hh=[0;0;b_hn]
- Embed {embedding} (classes,features)       → Embedding weight, as it is
- LayerNorm {scale, bias}                    → weight, bias

The patch stem and the attention core have no torch oracle: the port's
names mirror flax's, and only this function carries them (the weight
carry of import_orbax_checkpoint.py and the tests), while
``canonical_state_dict`` refuses them as the JAX package's
``torch_convert`` does. Their names:

- ``<bar feat>/PatchTrunk_0/Conv_i``         → ``<bar feat>.convs.i``
  (``enc_trunk/Conv_i`` → ``enc_trunk.convs.i`` for conv_bar)
- ``decoder/head/{Dense_0, ConvTranspose_i, Conv_0}``
                                             → ``head.{fc, deconvs.i, out}``
- ``enc_attn`` and ``decoder/seq_attn``: ``inp``, ``pos_emb``, ``ln1_l``,
  ``ln2_l``, ``qkv_l``, ``wo_l``, ``mlp_up_l``, ``mlp_dn_l``, ``ln_f``
                                             → ``enc_attn`` / ``seq_attn``
  ``.inp``, ``.pos_emb``, ``.ln1.l``, ``.ln2.l``, ``.qkv.l``, ``.wo.l``,
  ``.mlp_up.l``, ``.mlp_dn.l``, ``.ln_f``
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from musicvae_tpu_torch.config import Config
from musicvae_tpu_torch.models.vae import PianoRollVAE, check_supported


class StateDictMismatch(ValueError):
    """A state dict whose keys or shapes are not those of the config's
    model."""


class UnconvertibleConfig(ValueError):
    """A config whose weights have no torch oracle names to convert to or
    from."""


def require_parity_config(cfg: Config) -> None:
    """The JAX package's ``_require_conv_stem``: torch and safetensors
    files carry the oracle's names, which exist for the parity configs
    only."""
    if cfg.model.stem != "conv":
        raise UnconvertibleConfig(
            f"config {cfg.name!r} uses the MXU patch stem "
            f"(ModelSpec.stem={cfg.model.stem!r}) — a beyond-reference "
            "architecture with no torch twin; checkpoint conversion "
            "applies to the parity configs (stem='conv') only")
    if cfg.model.temporal != "gru":
        raise UnconvertibleConfig(
            f"config {cfg.name!r} uses the attention temporal core "
            f"(ModelSpec.temporal={cfg.model.temporal!r}) — a "
            "beyond-reference architecture with no torch twin; checkpoint "
            "conversion applies to the parity configs (temporal='gru') "
            "only")


def canonical_state_dict(sd: Dict[str, Any],
                         cfg: Config) -> Dict[str, torch.Tensor]:
    """A torch state dict (the oracle's names: a ``--to-torch`` export, or
    a reference-style model) as the port's checkpoints hold it: every key
    and shape checked against the model ``cfg`` builds, before anything
    is written, then f32 CPU tensors in the model's order.

    Each GRU's r/z hidden biases ``bias_hh[:2H]`` (``enc_gru``,
    ``dec_gru`` and hier's ``conductor``) are folded into
    ``bias_ih[:2H]`` (both sit inside the same sigmoid) and zeroed: flax
    keeps one bias there, so this is what the JAX package's
    ``torch_state_dict_to_flax`` → ``flax_params_to_torch_state_dict``
    round trip gives, bit for bit (the sum in the file's dtype, then the
    cast to f32).

    The patch stem and the attention core are refused with the JAX
    package's words (``require_parity_config``)."""
    require_parity_config(cfg)
    with torch.device("meta"):
        want = {n: tuple(t.shape) for n, t in
                PianoRollVAE(cfg.model, cfg.midi).state_dict().items()}
    got = {n: torch.as_tensor(v).detach().cpu() for n, v in sd.items()}
    problems = [f"{n}: missing" for n in want if n not in got]
    problems += [f"{n}: not a parameter of config {cfg.name}"
                 for n in got if n not in want]
    problems += [f"{n}: file has {tuple(got[n].shape)}, config {cfg.name} "
                 f"expects {shape}" for n, shape in want.items()
                 if n in got and tuple(got[n].shape) != shape]
    if problems:
        raise StateDictMismatch(
            f"state dict does not match config {cfg.name!r}:\n  "
            + "\n  ".join(problems[:8]))
    out = {}
    for n in want:
        t = got[n]
        if n.endswith(".bias_ih"):
            hh = got[n[:-len("bias_ih")] + "bias_hh"]
            h2 = 2 * (hh.shape[0] // 3)
            t = torch.cat([t[:h2] + hh[:h2], t[h2:]])
        elif n.endswith(".bias_hh"):
            h2 = 2 * (t.shape[0] // 3)
            t = torch.cat([torch.zeros_like(t[:h2]), t[h2:]])
        out[n] = t.to(torch.float32).contiguous()
    return out


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

    def put_trunk(name, p):
        for key, sub in p.items():
            put_conv(f"{name}.convs.{key.split('_')[1]}", sub)

    def put_barfeat(name, p):
        put_trunk(name, p["PatchTrunk_0" if "PatchTrunk_0" in p
                          else "ConvTrunk_0"])
        put_dense(f"{name}.fc", p["Dense_0"])

    def put_head(name, p):
        put_dense(f"{name}.fc", p["Dense_0"])
        for key, sub in p.items():
            if key.startswith("ConvTranspose_"):
                put_conv(f"{name}.deconvs.{key.split('_')[1]}", sub)
        if "Conv_0" in p:                               # the patch head
            put_conv(f"{name}.out", p["Conv_0"])

    def put_attn(name, p):
        put_dense(f"{name}.inp", p["inp"])
        out[f"{name}.pos_emb"] = t(p["pos_emb"])
        for key, sub in p.items():
            layer, _, l = key.rpartition("_")
            if layer in ("ln1", "ln2"):
                put_ln(f"{name}.{layer}.{l}", sub)
            elif layer in ("qkv", "wo", "mlp_up", "mlp_dn"):
                put_dense(f"{name}.{layer}.{l}", sub)
        put_ln(f"{name}.ln_f", p["ln_f"])

    def put_ln(name, p):
        out[f"{name}.weight"] = t(p["scale"])
        out[f"{name}.bias"] = t(p["bias"])

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

    spec = cfg.model
    attn = spec.temporal == "attn"
    dec = params["decoder"]
    if spec.kind == "conv_bar":
        put_trunk("enc_trunk", params["enc_trunk"])
        put_dense("z_head", params["z_head"]["Dense_0"])
        put_head("head", dec["head"])
        if spec.use_prev_bar:
            put_barfeat("prev_feat", dec["prev_feat"])
        return out
    put_barfeat("enc_feat", params["enc_feat"])
    if attn:
        put_attn("enc_attn", params["enc_attn"])
    else:
        put_gru("enc_gru", params["enc_gru"]["GRUCell_0"])
        put_dense("h_init", dec["h_init"])
    if spec.use_prev_bar:
        put_barfeat("prev_feat", dec["prev_feat"])
    if attn:
        put_attn("seq_attn", dec["seq_attn"])
    else:
        put_gru("dec_gru", dec["seq_gru"])
    put_head("head", dec["head"])
    if spec.kind == "hier":
        put_dense("phrase_head", params["phrase_head"]["Dense_0"])
        put_dense("bar_head", params["bar_head"]["Dense_0"])
        if not attn:
            put_dense("cond_init", dec["cond_init"])
            put_gru("conductor", dec["conductor"])
    else:
        put_dense("z_head", params["z_head"]["Dense_0"])
    if spec.kind == "cond":
        out["chord_emb.weight"] = t(params["chord_emb"]["embedding"])
        out["key_emb.weight"] = t(params["key_emb"]["embedding"])
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
