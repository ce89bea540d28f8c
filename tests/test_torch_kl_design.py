"""The KL sum kernel K5 (musicvae_tpu_torch/csrc/kl.cu ``kl_sum_kernel``),
checked on the CPU where it cannot run: a Python mirror of its order of
additions (a thread's elements in index order, trip by trip, then
``block_sum``'s warp and lane tree in common.cuh) covers every element once
and depends on n alone, and the same order in f32, with e^lv taken as the
kernel takes it (2^(lv·log2 e), exact ``exp2`` standing in for the MUFU's
ex2), gives the plain KL sum within 1e-5 relative. The card holds the
kernel itself against its plain version (chip_smoke.py), and checks there
that unaligned inputs give the aligned inputs' bits.

The KL backward K6 (``kl_bwd_kernel``): a mirror of its launch as
``mvk_kl_bwd`` makes it from n and the pointers covers every element
exactly once, by 16-byte vectors where the kernel takes them and by scalar
loads and stores elsewhere."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from musicvae_tpu_torch.ops import fused_elbo, losses

CU = Path(fused_elbo.__file__).resolve().parent.parent / "csrc" / "kl.cu"

NS = (0, 1, 31, 8191, 8192, 8193, 64 * 128, 37 * 128)


def _cu_constants() -> dict:
    """The namespace-level ``constexpr`` ints and floats of kl.cu,
    evaluated in order (each may use the ones before it)."""
    env: dict = {}
    for kind, name, expr in re.findall(
            r"^constexpr (int|float) (\w+) = ([^;]+);", CU.read_text(),
            re.M):
        expr = re.sub(r"(\d)f\b", r"\1", expr)
        env[name] = (int if kind == "int" else float)(
            eval(expr, {"__builtins__": {}}, dict(env)))
    return env


C = _cu_constants()
WARP = 32


def _thread_order(n: int, vec: bool) -> list:
    """Each thread's elements in the order it adds them: trip c takes the
    chunk from c·SUM_CHUNK, thread t its SUM_GROUP elements from
    c·SUM_CHUNK + t·SUM_GROUP, by vector loads where ``vec`` and the whole
    group lies below n, else by scalar loads of the elements below n; either
    way j = 0, 1, ... in order."""
    threads, group, chunk = C["SUM_THREADS"], C["SUM_GROUP"], C["SUM_CHUNK"]
    order = [[] for _ in range(threads)]
    c = 0
    while c * chunk < n:
        for t in range(threads):
            i = c * chunk + t * group
            if vec and i + group <= n:
                order[t].extend(range(i, i + group))
            else:
                order[t].extend(k for k in range(i, i + group) if k < n)
        c += 1
    return order


def _warp_sum(vals: list, add) -> object:
    """Lane 0 of ``warp_sum``: __shfl_down_sync by 16, 8, 4, 2, 1; a lane
    whose source is past lane 31 adds its own value (shfl_down returns it),
    which never reaches lane 0."""
    v = list(vals)
    for off in (16, 8, 4, 2, 1):
        v = [add(v[ln], v[ln + off] if ln + off < WARP else v[ln])
             for ln in range(WARP)]
    return v[0]


def _block_sum(per_thread: list, add, zero) -> object:
    """``block_sum<SUM_THREADS>``: each warp's lane 0 sum into warp_part,
    then warp 0 sums warp_part (lanes past the warps read zero)."""
    warps = C["SUM_THREADS"] // WARP
    part = [_warp_sum(per_thread[w * WARP:(w + 1) * WARP], add)
            for w in range(warps)]
    return _warp_sum(part + [zero] * (WARP - warps), add)


def _flatten(tree) -> list:
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, tuple):
            stack.extend(reversed(node))
        else:
            out.extend(node)
    return out


def test_constants():
    """One trip covers the [64,128] latents of a batch, by 16-byte loads:
    8 f32 are two of each operand, 8 bf16 one."""
    assert C["SUM_CHUNK"] == C["SUM_THREADS"] * C["SUM_GROUP"]
    assert C["SUM_THREADS"] % WARP == 0 and C["SUM_THREADS"] <= 1024
    assert C["SUM_CHUNK"] >= 64 * 128
    assert C["SUM_GROUP"] * 4 == 2 * 16 and C["SUM_GROUP"] * 2 == 16


@pytest.mark.parametrize("n", NS)
def test_order_covers_each_element_once(n):
    """The tree of additions, a thread's run of elements at each leaf,
    holds every element below n exactly once."""
    tree = _block_sum([list(o) for o in _thread_order(n, True)],
                      lambda a, b: (a, b), [])
    leaves = _flatten(tree)
    assert sorted(leaves) == list(range(n))


@pytest.mark.parametrize("n", NS)
def test_order_depends_on_n_alone(n):
    """Vector and scalar loads (aligned and unaligned pointers) add the
    same elements in the same order, so the sum's bits depend on n and the
    data alone."""
    vec = _thread_order(n, True)
    assert vec == _thread_order(n, False)
    add = lambda a, b: (a, b)      # noqa: E731: the tree, not its value
    assert _block_sum([tuple(o) for o in vec], add, ()) == \
        _block_sum([tuple(o) for o in _thread_order(n, False)], add, ())


def _fast_exp(lv: np.ndarray) -> np.ndarray:
    """``kl_term``'s e^lv: lv·log2 e rounded to f32, then 2^x exact (f64)
    where the kernel's ex2.approx.ftz is within a few ulp, rounded to f32
    and flushed to 0 below the smallest normal."""
    x = (lv.astype(np.float32) * np.float32(C["LOG2E"])).astype(np.float32)
    e = np.exp2(x.astype(np.float64)).astype(np.float32)
    return np.where(e < np.float32(2.0 ** -126), np.float32(0.0), e)


def _mirror_sum(mu: np.ndarray, lv: np.ndarray) -> np.float32:
    """K5's value in f32 in K5's order: each term (1 + lv − mu²) − e^lv
    (the product mu·mu exact inside an fma), each addition rounded to
    f32."""
    mu = mu.astype(np.float32).ravel()
    lv = lv.astype(np.float32).ravel()
    n = mu.size
    one = np.float32(1.0)
    fma = (one + lv).astype(np.float64) - mu.astype(np.float64) ** 2
    term = fma.astype(np.float32) - _fast_exp(lv)
    acc = [np.float32(0.0)] * C["SUM_THREADS"]
    for t, idx in enumerate(_thread_order(n, True)):
        a = np.float32(0.0)
        for k in idx:
            a = np.float32(a + term[k])
        acc[t] = a
    total = _block_sum(acc, lambda a, b: np.float32(a + b), np.float32(0.0))
    return np.float32(np.float32(-0.5) * total)


def test_fast_exp_relative_error():
    """e^lv as the kernel takes it is within 1e-6 relative of e^lv in f64
    over lv ∈ [−8, 8] (the model's logvar clamp, 8·tanh(lv/8)): the f32
    rounding of lv·log2 e, at most 2^-24·11.6·ln 2, and the rounding of the
    result."""
    lv = np.linspace(-8.0, 8.0, 2_000_001).astype(np.float32)
    want = np.exp(lv.astype(np.float64))
    rel = np.abs(_fast_exp(lv).astype(np.float64) - want) / want
    assert rel.max() <= 1e-6


@pytest.mark.parametrize("dist", ["randn", "uniform8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 128), (7, 3, 50)])
def test_mirror_sum_matches_plain(shape, dtype, dist):
    """In f32, K5's order and its e^lv give the plain KL sum
    (ops/losses.py) within 1e-5 relative, for f32 and bf16 latents (bf16
    read as f32), lv from randn (as chip_smoke.py's) and uniform on
    [−8, 8]."""
    rng = np.random.default_rng(5)
    mu = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    lv = (rng.standard_normal(shape) if dist == "randn"
          else rng.uniform(-8.0, 8.0, shape))
    lv = torch.tensor(lv, dtype=torch.float32)
    mu, lv = mu.to(dtype).float(), lv.to(dtype).float()
    want = float(losses.kl_diag_gaussian(mu, lv))
    got = float(_mirror_sum(mu.numpy(), lv.numpy()))
    assert abs(got - want) <= 1e-5 * abs(want)


# -- K6 ----------------------------------------------------------------------

def _bwd_blocks(n: int) -> int:
    """``mvk_kl_bwd``'s grid: a block a chunk of BWD_CHUNK elements, at
    most BWD_MAX_BLOCKS."""
    chunks = -(-n // C["BWD_CHUNK"])
    return min(chunks, C["BWD_MAX_BLOCKS"])


def _bwd_vec(offsets, itemsize: int) -> bool:
    """``mvk_kl_bwd``'s choice of vector loads and stores: mu, lv, dmu and
    dlv all on 16-byte boundaries (``offsets`` in elements from a
    16-byte-aligned allocation, as the card's allocator gives)."""
    return all(off * itemsize % 16 == 0 for off in offsets)


def _bwd_groups(n: int, vec: bool):
    """(first element, vector?) of every group the kernel's threads take:
    block b, thread t starts at b·BWD_CHUNK + t·BWD_GROUP and strides by
    blocks·BWD_CHUNK while below n."""
    group, chunk = C["BWD_GROUP"], C["BWD_CHUNK"]
    blocks = _bwd_blocks(n)
    g = np.arange(blocks * C["BWD_THREADS"], dtype=np.int64)
    base = (g // C["BWD_THREADS"]) * chunk + (g % C["BWD_THREADS"]) * group
    trips = -(-n // (blocks * chunk)) if n else 0
    starts = (base[None, :] + blocks * chunk
              * np.arange(trips, dtype=np.int64)[:, None]).ravel()
    starts = starts[starts < n]
    return starts, vec & (starts + group <= n)


BWD_NS = NS + (C["BWD_MAX_BLOCKS"] * C["BWD_CHUNK"] + 12345,)
BWD_LAYOUTS = [            # (itemsize, element offsets of mu, lv, dmu, dlv)
    (4, (0, 0, 0, 0)), (4, (4, 0, 0, 0)), (4, (1, 1, 0, 0)),
    (2, (8, 8, 0, 0)), (2, (0, 4, 0, 0)),
]


def test_bwd_constants():
    """8 f32 elements are two 16-byte vectors of each operand, 8 bf16 one;
    a block's threads fit one block's limit."""
    assert C["BWD_CHUNK"] == C["BWD_THREADS"] * C["BWD_GROUP"]
    assert C["BWD_THREADS"] % WARP == 0 and C["BWD_THREADS"] <= 1024
    assert C["BWD_GROUP"] * 4 == 2 * 16 and C["BWD_GROUP"] * 2 == 16
    assert _bwd_blocks(64 * 128) == -(-64 * 128 // C["BWD_CHUNK"])


@pytest.mark.parametrize("layout", BWD_LAYOUTS)
@pytest.mark.parametrize("n", BWD_NS)
def test_bwd_covers_each_element_once(n, layout):
    """Every element below n is taken by exactly one thread, once; a
    group goes by vectors exactly when all four pointers are aligned and
    the group lies below n, and only the ragged end is scalar then."""
    itemsize, offsets = layout
    vec = _bwd_vec(offsets, itemsize)
    assert vec == (layout in [(4, (0, 0, 0, 0)), (4, (4, 0, 0, 0)),
                              (2, (8, 8, 0, 0))])
    starts, vector = _bwd_groups(n, vec)
    group = C["BWD_GROUP"]
    assert np.all(starts % group == 0)
    ends = np.minimum(starts + group, n)
    hits = np.zeros(n + 1, dtype=np.int64)
    np.add.at(hits, starts, 1)
    np.add.at(hits, ends, -1)
    assert np.all(np.cumsum(hits)[:n] == 1)
    scalar = starts[~vector]
    if vec:
        assert list(scalar) == ([n - n % group] if n % group else [])
    else:
        assert not vector.any()
