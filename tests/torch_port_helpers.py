"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py):
tiny f32 configs, one set of random weights in both packages, and jitted
JAX calls (op-by-op dispatch of an unjitted flax apply costs seconds of
compiles on the CPU backend)."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicvae_tpu import config as jcfg
from musicvae_tpu.checkpoints.torch_convert import torch_state_dict_to_flax
from musicvae_tpu.models import build_model as jax_build_model
from musicvae_tpu.models import init_params as jax_init
from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch.checkpoints.convert import flax_params_to_state_dict
from musicvae_tpu_torch.models.vae import build_model as torch_build_model

TINY = dict(enc_channels=(4, 8, 8, 8, 8), dec_channels=(8, 8, 8, 8, 8),
            z_dim=16, gru_hidden=32, bar_feat_dim=32, dtype="float32")


def tiny_pair(name: str = "c2_gru_4bar", **model_kw):
    """(JAX config, port config): the registered config ``name`` at tiny
    f32 widths, with ``model_kw`` on top, identical in both packages."""
    kw = {**TINY, **model_kw}
    j = jcfg.get_config(name)
    j = j.replace(model=dataclasses.replace(j.model, **kw))
    t = tcfg.get_config(name)
    t = t.replace(model=dataclasses.replace(t.model, **kw))
    return j, t


def port_midi_spec(spec) -> tcfg.MidiSpec:
    return tcfg.MidiSpec(**dataclasses.asdict(spec))


def jax_params(jc, tc, seed: int = 0):
    """(flax model, flax params as numpy) for random weights from
    ``seed``, made by the port's init and carried into flax by the JAX
    package's oracle importer."""
    sd = torch_build_model(tc, device="cpu", seed=seed).state_dict()
    params = jax.tree.map(np.asarray, torch_state_dict_to_flax(sd, jc))
    return jax_build_model(jc), params


def port_model(tc, params):
    """The port's model on the CPU with flax ``params`` loaded through the
    port's converter, strictly."""
    model = torch_build_model(tc, device="cpu", seed=12345)
    model.load_state_dict(flax_params_to_state_dict(params, tc),
                          strict=True)
    return model


@functools.lru_cache(maxsize=None)
def jitted(jmodel, method: str):
    """jit of ``jmodel.apply(..., method=method)``; flax modules hash by
    their fields, so one compile per (config, method, shapes)."""
    fn = getattr(jmodel, method)
    return jax.jit(lambda params, *a, **kw: jmodel.apply(
        {"params": params}, *a, method=fn, **kw))


def bars(rng: np.random.Generator, shape, density: float = 0.05):
    return (rng.random(shape) < density).astype(np.float32)


TRAIN_KW = dict(batch_size=2, log_every=2, ckpt_every=0, eval_every=0,
                beta_warmup_steps=4, seed=3)


def train_cfg(**train_kw):
    """The port's tiny c2 config with a short-run TrainSpec
    (``TRAIN_KW``, then ``train_kw``)."""
    _, tc = tiny_pair()
    return tc.replace(train=dataclasses.replace(
        tc.train, **{**TRAIN_KW, **train_kw}))


def bar_dataset(seed=0, pieces=6, bars_per_piece=8, num_bars=4):
    """A port PianoRollDataset of Bernoulli(0.05) bars whose windows never
    cross a piece."""
    from musicvae_tpu_torch.data.dataset import PianoRollDataset

    rng = np.random.default_rng(seed)
    bars = (rng.random((pieces * bars_per_piece, 96, 128)) < 0.05
            ).astype(np.uint8)
    per = bars_per_piece - num_bars + 1
    starts = (np.arange(pieces)[:, None] * bars_per_piece
              + np.arange(per)[None, :]).reshape(-1)
    return PianoRollDataset(
        bars, starts, num_bars, rng.integers(0, 24, starts.shape[0]),
        rng.integers(0, 24, starts.shape[0]),
        np.repeat(np.arange(pieces), per), grid=(24, 4, 0))


def state_tensors(state) -> list:
    """Every tensor of a port TrainState, the generator's state included,
    in a fixed order."""
    sd = state.state_dict()
    return ([sd["step"], sd["opt"]["count"], sd["rng"]]
            + [t for k in ("params", "ema") for t in (sd[k] or {}).values()]
            + [t for k in ("mu", "nu") for t in sd["opt"][k].values()])


def bench_spec(cfg) -> dict:
    """The configuration groups of a port config as the benchmark's
    configuration files hold them (perfbench/configs/*.json)."""
    return {g: {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(getattr(cfg, g)).items()}
            for g in ("midi", "model", "train")}


def same_state(a, b) -> bool:
    ta, tb = state_tensors(a), state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The importing module's torch work on one thread: the suite runs as
    several workers on a few cores, where torch's default of a thread a
    core oversubscribes them many times over; unloaded, one thread costs
    these tiny shapes nothing. The previous count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the other parity kinds at tiny widths: hier at 3 bars, hidden 16 and an
# 8-wide phrase latent
KINDS = ("c1_conv_bar", "c3_hier_16bar", "c4_cond")
KIND_KW = {"c1_conv_bar": {},
           "c3_hier_16bar": dict(num_bars=3, gru_hidden=16, z_phrase_dim=8),
           "c4_cond": {}}


def kind_pair(name: str, **model_kw):
    """``tiny_pair`` of a registered config with its kind's tiny sizes."""
    return tiny_pair(name, **{**KIND_KW.get(name, {}), **model_kw})


def kind_inputs(rng: np.random.Generator, spec, b: int = 2,
                density: float = 0.05):
    """(x [B,N,T,P] f32, eps (one array a latent level), labels {} or
    {"chord" [B,N], "key_sig" [B]} int32) for a model spec, numpy."""
    x = bars(rng, (b, spec.num_bars, 96, 128), density)
    if spec.kind == "hier":
        eps = (rng.standard_normal((b, spec.z_phrase_dim)),
               rng.standard_normal((b, spec.num_bars, spec.z_dim)))
    else:
        eps = (rng.standard_normal((b, spec.z_dim)),)
    eps = tuple(e.astype(np.float32) for e in eps)
    labels = {}
    if spec.kind == "cond":
        labels = {"chord": rng.integers(0, spec.cond_chord_classes,
                                        (b, spec.num_bars)).astype(np.int32),
                  "key_sig": rng.integers(0, spec.cond_key_classes,
                                          (b,)).astype(np.int32)}
    return x, eps, labels


def to_jax(tree):
    return jax.tree.map(jax.numpy.asarray, tree)


def to_torch(tree):
    return jax.tree.map(torch.tensor, tree)


# the patch stem and the attention core at tiny widths (the sizes of
# tests/test_attn.py's _tiny_trf_cfg); hier at 3 bars with an 8-wide
# phrase latent, c2_mxu_wide's two-layer stacks kept two layers deep
PATCH_TINY = dict(enc_channels=(8, 8, 16), dec_channels=(16, 8, 8),
                  z_dim=8, gru_hidden=16, bar_feat_dim=16, attn_heads=4)
PATCH_KW = {"c3_mxu": dict(num_bars=3, z_phrase_dim=8),
            "c3_trf": dict(num_bars=3, z_phrase_dim=8),
            "c2_mxu_wide": dict(enc_channels=(8, 16),
                                dec_channels=(16, 16))}


def patch_pair(name: str, **model_kw):
    """``tiny_pair`` of a registered config with the patch-family tiny
    sizes (``PATCH_TINY``; a conv-stem config keeps ``TINY``'s
    channels)."""
    kw = dict(PATCH_TINY)
    if jcfg.get_config(name).model.stem != "patch" \
            and model_kw.get("stem") != "patch":
        kw = {k: v for k, v in kw.items() if "channels" not in k}
    return tiny_pair(name, **{**kw, **PATCH_KW.get(name, {}), **model_kw})


@functools.lru_cache(maxsize=None)
def _jax_init(jc, seed: int):
    return jax.tree.map(np.asarray, jax_init(jc, jax.random.key(seed))[1])


def jax_init_params(jc, seed: int = 0):
    """(flax model, flax params as numpy) made by the JAX package's own
    ``init_params`` (the oracle importer has no names for the patch stem
    or the attention core), initialised once a (config, seed) in f32: the
    params are f32 whatever the compute dtype. Every bias and LayerNorm
    scale is then moved off its constant initial value by N(0, 0.1²)
    noise from ``seed``, so that a comparison sees them."""
    f32 = jc.replace(model=dataclasses.replace(jc.model, dtype="float32"))
    rng = np.random.default_rng(seed)

    def nudge(path, leaf):
        if path[-1].key in ("bias", "scale"):
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                leaf.dtype)
        return leaf

    return jax_build_model(jc), jax.tree_util.tree_map_with_path(
        nudge, _jax_init(f32, seed))


def jax_zero_params(jc):
    """Zero flax params of the shapes the JAX package's ``init_params``
    gives (from ``jax.eval_shape``: traced, not run)."""
    shapes = jax.eval_shape(lambda k: jax_init(jc, k)[1], jax.random.key(0))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def jax_port_model(tc, params):
    """The port's model, built as it is (no weights drawn), with flax
    ``params`` loaded strictly."""
    from musicvae_tpu_torch.models.vae import PianoRollVAE

    model = PianoRollVAE(tc.model, tc.midi)
    model.load_state_dict(flax_params_to_state_dict(params, tc),
                          strict=True)
    return model.eval()


def forward_pair(name, seed=0, b=2, **model_kw):
    """(JAX config, the JAX forward's (logits, latents), the port's) on
    the same JAX-initialised weights, input and noise."""
    jc, tc = patch_pair(name, **model_kw)
    jmodel, params = jax_init_params(jc, seed)
    model = jax_port_model(tc, params)
    x, eps, labels = kind_inputs(np.random.default_rng(seed), jc.model, b)
    x = x[:, :, :jc.midi.steps_per_bar]
    want = jitted(jmodel, "__call__")(params, jnp.asarray(x),
                                      eps=to_jax(eps), **to_jax(labels))
    with torch.no_grad():
        got = model(torch.tensor(x), to_torch(eps), **to_torch(labels))
    return jc, want, got


def close(got, want, atol, bf16, what, bf16_ulps=4):
    """``got`` (torch) within ``atol`` of ``want`` (JAX), or within
    ``bf16_ulps`` bf16 ulps of ``want``'s largest magnitude when
    ``bf16``."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if bf16:
        atol = bf16_ulps * 2.0 ** -8 * max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def check_forward(name, dtype="float32", bf16_ulps=4, **model_kw):
    """``forward_pair``'s outputs held together: f32 logits within 5e-4
    and every latent level's (mu, logvar) within 3e-5; in bf16 each
    within ``bf16_ulps`` bf16 ulps of its largest magnitude (the two
    packages round the same bf16 operations in other orders)."""
    jc, (logits_j, lat_j), (logits, lat) = forward_pair(
        name, seed=1, dtype=dtype, **model_kw)
    bf16 = dtype == "bfloat16"
    assert logits.dtype == torch.float32 and logits.is_contiguous()
    assert len(lat) == len(lat_j) == (2 if jc.model.kind == "hier" else 1)
    close(logits, logits_j, 5e-4, bf16, "logits", bf16_ulps)
    for i, ((mu, lv), (mu_j, lv_j)) in enumerate(zip(lat, lat_j)):
        close(mu, mu_j, 3e-5, bf16, f"mu level {i}", bf16_ulps)
        close(lv, lv_j, 3e-5, bf16, f"logvar level {i}", bf16_ulps)


class InjectedEps:
    """A flax model whose latent noise is handed in: ``apply`` looks the
    step's "latent" PRNG key up in ``keys`` ([K, 2] key data, from
    ``latent_keys``) and runs the model with the matching row of ``eps``
    ([K, B, z]). The JAX package's multi-step functions draw eps from a
    threefry key inside a scan; this lets them take the port's noise."""

    def __init__(self, jmodel, keys, eps):
        self.jmodel = jmodel
        self.keys = jnp.asarray(keys)
        self.eps = jnp.asarray(eps)

    def apply(self, variables, x, rngs=None, **kw):
        kd = jax.random.key_data(rngs["latent"])
        hit = jnp.all(self.keys == kd[None], axis=-1).astype(jnp.float32)
        e = jnp.einsum("k,kbz->bz", hit, self.eps)
        return self.jmodel.apply(variables, x, eps=(e,), **kw)


def latent_keys(rng, k: int) -> np.ndarray:
    """The "latent" keys of k JAX train steps from a state's ``rng`` (the
    JAX step splits (step_rng, next_rng) off the state's key, no transpose
    augmentation), as [k, 2] key data."""
    out = []
    for _ in range(k):
        step_rng, rng = jax.random.split(rng)
        out.append(np.asarray(jax.random.key_data(step_rng)))
    return np.stack(out)


def jax_train_state(jc, params, seed: int = 0):
    """A JAX TrainState at step 0 around ``params``: optax's initial
    moments and the key ``jax.random.key(seed)``."""
    from musicvae_tpu.train import trainer as jtrainer

    params = jax.tree.map(jnp.asarray, params)
    return jtrainer.TrainState(
        params=params, opt_state=jtrainer.make_optimizer(jc).init(params),
        step=jnp.zeros((), jnp.int32), rng=jax.random.key(seed))


# -- the compiled programs (tests/test_torch_graph_*.py) ----------------------

# one config of each model family at its tiny widths: the conv stem with
# the GRU (c2), the conv bar VAE, hier, cond, attention, the patch stem
FAMILIES = ("c2_gru_4bar", "c1_conv_bar", "c3_hier_16bar", "c4_cond",
            "c2_trf", "c2_mxu")


def family_config(name: str, **train_kw):
    """The port's config ``name`` at the tiny widths its family's tests
    use, with a short-run TrainSpec (``TRAIN_KW``, then ``train_kw``)."""
    _, tc = (patch_pair(name) if name in ("c2_trf", "c2_mxu")
             else kind_pair(name))
    return tc.replace(train=dataclasses.replace(
        tc.train, **{**TRAIN_KW, **train_kw}))


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Inside: reading a tensor back to the host (``item``, ``bool``,
    ``float``, ``int``, ``index``, ``tolist``, ``numpy``, ``cpu``) and
    making a tensor from host data (``torch.tensor``, ``from_numpy``,
    ``as_tensor`` of anything but a tensor) raise HostRead. On the card
    the first waits for the device and the second copies from pageable
    memory: neither can be captured in a CUDA graph."""
    def refuse(name):
        def fn(*a, **kw):
            raise HostRead(name)
        return fn

    real_as_tensor = torch.as_tensor

    def as_tensor(data, *a, **kw):
        if not isinstance(data, torch.Tensor):
            raise HostRead("torch.as_tensor of host data")
        return real_as_tensor(data, *a, **kw)

    patches = [(torch.Tensor, m, refuse(f"Tensor.{m}"))
               for m in ("item", "__bool__", "__float__", "__int__",
                         "__index__", "tolist", "numpy", "cpu")]
    patches += [(torch, "tensor", refuse("torch.tensor")),
                (torch, "from_numpy", refuse("torch.from_numpy")),
                (torch, "as_tensor", as_tensor)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


class HandedEps:
    """A flax model whose latent noise is handed in: ``apply`` ignores its
    PRNG keys and runs the model with ``eps`` (one array a latent level),
    so a JAX function that draws the noise inside (eval, reconstruct)
    takes the port's."""

    def __init__(self, jmodel, eps):
        self.jmodel = jmodel
        self.eps = tuple(jnp.asarray(e) for e in eps)

    def apply(self, variables, x, rngs=None, **kw):
        return self.jmodel.apply(variables, x, eps=self.eps, **kw)
