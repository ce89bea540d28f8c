"""Tensor parallelism over the mesh's 'model' axis: the rule table,
``param_shardings`` and ``shard_params``, and the column-parallel
collectives the layers run on a sharded weight.

Counterpart of the JAX package's parallel/tp.py. There a rule table maps
param-tree paths to PartitionSpecs and GSPMD partitions the jitted step;
the port has no GSPMD, so the same table, written on the port's
state-dict names, drives explicit column parallelism:

- ``shard_params`` keeps, on each process of a model group, only its
  slice of every rule-matched parameter (and of its Adam moments and EMA
  copy), sharded on the **output** dim in torch's layout: Linear weight
  dim 0, Conv2d weight [out,in,kh,kw] dim 0, ConvTranspose2d weight
  [in,out,kh,kw] dim 1, every bias dim 0, and the fused GRU
  ``weight_ih``/``weight_hh``/biases [3H, ·] per gate (rows g·H + shard
  for g in r, z, n: flax's separate ir/iz/in/hr/hz/hn kernels).
- A sharded layer computes its slice of the output from its weight slice
  (``column_in`` then the op), and ``column_out`` all-gathers the slices
  over the model group into the full activation, so everything outside
  the layer runs replicated. In the backward ``column_out`` keeps only
  this rank's slice of the incoming gradient (every model rank computes
  the same loss on the same rows, so the slices agree: a summing
  all-gather would scale the gradients by M), and ``column_in``
  all-reduces the input's gradient, of which each rank holds the part
  its weight slice gives. A GRU cell gathers its new hidden state once a
  step, its gates staying local.

The models are a few M parameters, so this is the JAX package's
demonstration axis: no registered config has ``model`` > 1 and neither
``train()`` nor the CLI shards. A caller shards a state it built on
every process from the same seed (or restored): ``shard_params(state,
make_mesh(MeshSpec(data=D, model=M)))``, then any train step with that
mesh.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

# (name regex, dim, gates): the first rule whose regex a parameter's
# state-dict name matches decides; an unmatched parameter is replicated.
# ``dim`` is the sharded dim in torch's layout, split into ``gates`` equal
# blocks that are each sharded alike
DEFAULT_TP_RULES: List[Tuple[str, int, int]] = [
    # decoder head: dense into the deconv stack (the widest matmul)
    (r"^head\.fc\.(weight|bias)$", 0, 1),
    # deconv kernels [in, out, kh, kw]: the output channels (the final
    # 1-channel parity head falls back to replicated: 1 % M)
    (r"^head\.deconvs\.[0-4]\.weight$", 1, 1),
    (r"^head\.deconvs\.[0-4]\.bias$", 0, 1),
    # the patch head's stride-1 conv to pt·pp logit channels
    (r"^head\.out\.(weight|bias)$", 0, 1),
    # bar feature extractors: the conv trunk's output channels and the
    # trunk-flatten dense
    (r"^(enc_feat|prev_feat)\.convs\.[0-4]\.(weight|bias)$", 0, 1),
    (r"^(enc_feat|prev_feat)\.fc\.(weight|bias)$", 0, 1),
    # GRU cells (sequence, encoder, conductor): the hidden dim of every
    # gate, r, z and n alike
    (r"^(dec_gru|conductor|enc_gru)\.(weight|bias)_(ih|hh)$", 0, 3),
    # attention stacks: every dense on its output dim; LayerNorm and the
    # position table stay replicated
    (r"^(seq_attn|enc_attn)\.(inp|qkv\.\d+|wo\.\d+|mlp_up\.\d+"
     r"|mlp_dn\.\d+)\.(weight|bias)$", 0, 1),
    # GRU/conductor init projections and the latent heads
    (r"^(h_init|cond_init)\.(weight|bias)$", 0, 1),
    (r"^(z_head|phrase_head|bar_head)\.(weight|bias)$", 0, 1),
]


class Layout(NamedTuple):
    """How a parameter is sharded: ``dim`` split into ``gates`` equal
    blocks, and each block's slice [rank·n, (rank+1)·n) kept."""

    dim: int
    gates: int = 1

    def local(self, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """This rank's slice of the unsharded ``t`` (a contiguous copy)."""
        v = t.unflatten(self.dim, (self.gates, -1))
        n = v.shape[self.dim + 1] // size
        return v.narrow(self.dim + 1, rank * n, n).flatten(
            self.dim, self.dim + 1).contiguous()

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The unsharded tensor from every rank's slice, in rank order."""
        return torch.cat([p.unflatten(self.dim, (self.gates, -1))
                          for p in parts], self.dim + 1).flatten(
            self.dim, self.dim + 1)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A process's place on the model axis: its ``group``, its ``rank``
    in it and the group's ``size``."""

    group: Any
    rank: int
    size: int


def _all_gather(t: torch.Tensor, shard: ModelShard) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in rank order,
    moved as bytes: no backend's dtype support is relied on."""
    t = t.contiguous()
    flat = t.view(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(shard.size)]
    dist.all_gather(parts, flat, group=shard.group)
    return [p.view(t.dtype).view(t.shape) for p in parts]


class _ReduceGrad(torch.autograd.Function):
    """Identity; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


class _Gather(torch.autograd.Function):
    """The slices of every model rank concatenated along ``dim``; the
    gradient's own slice back."""

    @staticmethod
    def forward(ctx, y, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return torch.cat(_all_gather(y, shard), dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.shard.size
        return g.narrow(ctx.dim, ctx.shard.rank * n, n), None, None


def shard_of(module: nn.Module) -> Optional[ModelShard]:
    """The model shard a module's weight holds, None when replicated (a
    dict lookup: no attribute miss on the hot path)."""
    return module.__dict__.get("tp")


def column_in(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """``x`` as the input of ``module``'s sharded op: itself, and in the
    backward its gradient all-reduced over the model group."""
    shard = shard_of(module)
    return x if shard is None else _ReduceGrad.apply(x, shard)


def column_out(y: torch.Tensor, dim: int, module: nn.Module) -> torch.Tensor:
    """``module``'s output slice ``y`` gathered along ``dim`` over the
    model group into the full activation (``y`` itself when replicated)."""
    shard = shard_of(module)
    return y if shard is None else _Gather.apply(y, dim, shard)


def param_shardings(model: nn.Module, mesh,
                    rules: Sequence[Tuple[str, int, int]] = DEFAULT_TP_RULES
                    ) -> Dict[str, Optional[Layout]]:
    """{parameter name: its ``Layout`` on ``mesh``'s model axis, or None
    when replicated} for every named parameter of ``model``. First match
    wins; as in the JAX package a matched rule whose dim is past the
    parameter's rank, or whose blocks ``mesh.model`` does not divide,
    falls back to replicated (the final 1-channel deconv)."""
    compiled = [(re.compile(pat), dim, gates) for pat, dim, gates in rules]
    out: Dict[str, Optional[Layout]] = {}
    for name, p in model.named_parameters():
        out[name] = None
        for pat, dim, gates in compiled:
            if pat.search(name):
                # the rank check first: the dim check indexes the shape
                if dim < p.dim() and p.shape[dim] % (gates * mesh.model) == 0:
                    out[name] = Layout(dim, gates)
                break
    return out


class TPState:
    """What ``shard_params`` made of a train state: the model shard and,
    in the state's parameter order, each parameter's layout (None:
    replicated) and unsharded shape."""

    def __init__(self, shard: ModelShard, layouts: List[Optional[Layout]],
                 shapes: List[torch.Size], device: torch.device):
        self.shard, self.layouts, self.shapes = shard, layouts, shapes
        self.sharded = torch.tensor([lay is not None for lay in layouts],
                                    device=device)

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of parameter ``i``'s unsharded tensor ``t``."""
        lay = self.layouts[i]
        return t if lay is None else lay.local(t, self.shard.rank,
                                               self.shard.size)

    def unshard_all(self, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """The unsharded tensors of a state-ordered list (parameters,
        moments or EMA copies), gathered over the model group: a
        collective, one all-gather per sharded entry."""
        return [t if lay is None else lay.join(_all_gather(t, self.shard))
                for t, lay in zip(tensors, self.layouts)]


def global_norm(norms: torch.Tensor, tp: TPState) -> torch.Tensor:
    """sqrt(Σ‖g‖²) of the unsharded tree from each entry's local norm
    (``norms``, state order): the sharded entries' squares summed over
    the model group, the replicated ones counted once."""
    sq = norms * norms
    part = torch.where(tp.sharded, sq, 0.0).sum()
    dist.all_reduce(part, group=tp.shard.group)
    return torch.sqrt(part + torch.where(tp.sharded, 0.0, sq).sum())


def shard_params(state, mesh,
                 rules: Sequence[Tuple[str, int, int]] = DEFAULT_TP_RULES):
    """Shard a train state (train/trainer.py ``TrainState``) over ``mesh``'s
    model axis, in place, and return it: each rule-matched parameter, its
    Adam moments and its EMA copy keep only this process's slice, and the
    modules that own them compute column-parallel over the model group.
    Every process must hold the same full state (the same seed, or a
    restored checkpoint) and call this together with the same ``mesh``.
    ``mesh.model`` 1 leaves the state as it is.

    A rule may shard only what a layer computes column-parallel: the
    weight by the layout its class declares as ``column``
    (models/layers.py: a Dense or Conv2d on dim 0, a ConvTranspose2d on
    dim 1, a GRUCell per gate) and the bias on dim 0 with the weight's
    gates, all of a module's parameters together; anything else is a
    ValueError, never a silent replication."""
    if mesh.model == 1:
        return state
    if state.tp is not None:
        raise ValueError("the state is sharded already")
    shard = ModelShard(mesh.model_group, mesh.model_rank, mesh.model)
    model = state.model
    by_name = param_shardings(model, mesh, rules)
    owners = []
    for mod_name, mod in model.named_modules():
        own = {n: by_name[f"{mod_name}.{n}" if mod_name else n]
               for n, _ in mod.named_parameters(recurse=False)}
        if not any(own.values()):
            continue
        weight = getattr(type(mod), "column", None)
        want = weight and {n: weight if n.startswith("weight")
                           else Layout(0, weight.gates) for n in own}
        if own != want:
            raise ValueError(
                f"tensor-parallel rules shard {mod_name} "
                f"({type(mod).__name__}) as {own}, which its forward does "
                f"not compute column-parallel")
        owners.append(mod_name)
    layouts = [by_name[n] for n, _ in model.named_parameters()]
    tp = TPState(shard, layouts, [p.shape for p in state.params],
                 state.params[0].device)
    with torch.no_grad():
        ema = state.ema_params
        for i, lay in enumerate(layouts):
            if lay is not None:
                p = state.params[i]
                p.data = tp.local(i, p.data)
                state.opt.mu[i] = tp.local(i, state.opt.mu[i])
                state.opt.nu[i] = tp.local(i, state.opt.nu[i])
                if ema is not None:
                    ema[i].data = tp.local(i, ema[i].data)
    for m in filter(None, (model, state.ema_model)):
        for mod_name in owners:
            m.get_submodule(mod_name).tp = shard
    state.tp = tp
    return state


def state_bytes(state) -> Dict[str, int]:
    """The bytes this process holds of a train state: parameters, Adam
    moments (mu and nu) and EMA copies."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    return {"params": nbytes(state.params),
            "adam": nbytes(state.opt.mu) + nbytes(state.opt.nu),
            "ema": nbytes(state.ema_params or [])}
