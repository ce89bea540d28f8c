"""What surrounds the first-conv kernels (musicvae_tpu_torch/csrc/conv1.cu,
conv1_bwd.cu), checked on the CPU where the kernels cannot run: the launch
geometry that ops/conv1.py computes for them, the per-thread work map the
kernels share (csrc/conv1.cuh ``WorkMap``, mirrored here), and the fast
tanh-GELU formulation (conv1.cuh ``gelu_tanh2``, ``gelu_r2``,
``gelu_grad_of``) written in plain torch f32 with exact ``exp2``. The card holds the kernels
themselves against their plain versions (chip_smoke.py), and also checks
there that the C side's geometry equals ``conv1.geometry``."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from musicvae_tpu_torch.ops import conv1

MS = (1, 2, 4, 5, 9, 64, 256, 1024)
SM_COUNT = 132                # an H100's SMs
SMEM_DEFAULT = 48 * 1024      # dynamic shared memory without an opt-in
SMEM_BLOCK_MAX = 227 * 1024   # with the opt-in (cudaFuncSetAttribute)
SMEM_PER_SM = 228 * 1024      # an H100 SM's shared memory ...
SMEM_RESERVED = 1024          # ... of which each resident block reserves 1 KB


def _block_work(rows: int, c: int, threads: int) -> np.ndarray:
    """(row, pitch, channel group) of every (thread, slot) of one block, as
    conv1.cuh ``WorkMap`` assigns them: lane l owns group l % NG at pitch
    offset l // NG; the block's rows·64/JW slots go to its warps in turn."""
    ng = c // 4
    jw = 32 // ng
    per_row = conv1.P_OUT // jw
    warps = threads // 32
    slots = rows * per_row
    out = []
    for t in range(threads):
        lane, warp = t % 32, t // 32
        g, jj = lane % ng, lane // ng
        for s in range(warp, slots, warps):
            out.append((s // per_row, (s % per_row) * jw + jj, g))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _block_work_mma(rows: int, c: int, threads: int) -> np.ndarray:
    """(row, pitch, channel) of every output of one tile on the forward's
    tensor-core path (conv1.cu ``conv1_tile_mma``, bf16 output, C >= 8):
    warp w takes the 16-position spans ("mslots") w, w + warps, ...; lane
    (gid, tig) ends with channels 8nt+2tig, +1 of positions gid, gid+8."""
    warps = threads // 32
    out = []
    for t in range(threads):
        lane, warp = t % 32, t // 32
        gid, tig = lane // 4, lane % 4
        for s in range(warp, rows * 4, warps):
            ti, p0 = s // 4, (s % 4) * 16 + gid
            for nt in range(c // 8):
                for p in (p0, p0 + 8):
                    for ch in (8 * nt + 2 * tig, 8 * nt + 2 * tig + 1):
                        out.append((ti, p, ch))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _smem_bytes(rows: int, c: int, threads: int, x_bytes: int,
                dy_bytes: int) -> tuple[int, int]:
    """Dynamic shared memory of the forward and the backward launch
    (conv1.cuh ``smem_bytes``, conv1_bwd.cu ``bwd_smem_bytes``): the
    landing buffer of a tile's input rows, the weights and bias, two sets
    of pitch planes; the backward adds two tiles' dy and its per-warp
    sums."""
    in_rows = 2 * rows + 1
    base = in_rows * 128 * x_bytes + 4 * (10 * c + 2 * in_rows * (64 + 68))
    return base, (base + 2 * dy_bytes * rows * 64 * c
                  + 4 * 10 * c * (threads // 32))


def _tiles_of_blocks(tiles: int, blocks: int) -> np.ndarray:
    """How often each tile is walked: block b takes b, b + blocks, ..."""
    hit = np.zeros(tiles, np.int64)
    for b in range(blocks):
        hit[b::blocks] += 1
    return hit


@pytest.mark.parametrize("c", conv1.CHANNELS)
@pytest.mark.parametrize("m", MS)
def test_geometry_covers_each_output_once(m, c):
    """Both kernels' blocks walk every tile once; the tiles cover every
    (bar, output row) once; within a tile the threads cover every (row,
    pitch, channel group) once. So every output position and channel of
    every bar is computed (forward) or read as dy (backward) exactly
    once."""
    geo = conv1.geometry(m, c)
    assert conv1.T_OUT % geo.rows == 0
    for blocks in (geo.fwd_blocks, geo.bwd_blocks):
        assert 1 <= blocks <= geo.tiles
        assert (_tiles_of_blocks(geo.tiles, blocks) == 1).all()
    per_bar = conv1.T_OUT // geo.rows
    tile = np.arange(geo.tiles)
    bar, i0 = tile // per_bar, (tile % per_bar) * geo.rows
    rows_hit = np.zeros((m, conv1.T_OUT), np.int64)
    np.add.at(rows_hit, (np.repeat(bar, geo.rows),
                         (i0[:, None] + np.arange(geo.rows)).ravel()), 1)
    assert (rows_hit == 1).all()
    work = _block_work(geo.rows, c, geo.threads)
    hit = np.zeros((geo.rows, conv1.P_OUT, c // 4), np.int64)
    np.add.at(hit, (work[:, 0], work[:, 1], work[:, 2]), 1)
    assert (hit == 1).all()


@pytest.mark.parametrize("c", (8, 16, 32))
@pytest.mark.parametrize("m", MS)
def test_tensor_core_map_covers_each_output_once(m, c):
    """The forward's bf16 path at C >= 8 computes every (row, pitch,
    channel) of a tile exactly once, with the same tiles and threads as
    the FMA path."""
    geo = conv1.geometry(m, c)
    work = _block_work_mma(geo.rows, c, geo.threads)
    hit = np.zeros((geo.rows, conv1.P_OUT, c), np.int64)
    np.add.at(hit, (work[:, 0], work[:, 1], work[:, 2]), 1)
    assert (hit == 1).all()


@pytest.mark.parametrize("c", conv1.CHANNELS)
@pytest.mark.parametrize("m", MS)
def test_geometry_depends_on_m_and_c_only(m, c, monkeypatch):
    """No card is asked (so the backward's sum order, which follows the
    blocks, is the same on every card); the launch is legal (whole warps,
    at most 256 threads, shared memory within a block's limit for every x
    and dy type) and fills the card as far as the bars allow: at least 132
    forward blocks from M=4 on (serve), never more blocks than an H100
    holds at once (4 forward and 2 backward blocks an SM)."""
    def no_card(*_a, **_k):
        raise AssertionError("geometry asked the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    geo = conv1.geometry(m, c)
    assert geo == conv1.geometry(m, c)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= conv1.MAX_THREADS
    assert geo.tiles == m * (conv1.T_OUT // geo.rows)
    assert geo.fwd_blocks == min(geo.tiles, 4 * SM_COUNT)
    assert geo.bwd_blocks == min(geo.tiles, 2 * SM_COUNT)
    assert geo.fwd_blocks >= min(SM_COUNT, m * conv1.T_OUT)
    if m >= 4:
        assert geo.fwd_blocks >= SM_COUNT and geo.bwd_blocks >= SM_COUNT
    # no more than 8 positions a thread a tile
    assert geo.rows * conv1.P_OUT * (c // 4) <= 8 * geo.threads
    for x_bytes in (1, 2, 4):
        for dy_bytes in (2, 4):
            fwd, bwd = _smem_bytes(geo.rows, c, geo.threads, x_bytes,
                                   dy_bytes)
            assert 4 * (fwd + SMEM_RESERVED) <= SMEM_PER_SM
            assert fwd <= SMEM_DEFAULT and bwd <= SMEM_BLOCK_MAX
            assert 2 * (bwd + SMEM_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("c", conv1.CHANNELS)
@pytest.mark.parametrize("m", MS)
def test_backward_partials_sized_to_its_writes(m, c):
    """Backward block b writes term e of its sums to partials[e·blocks + b]
    for the 10·C terms (dw [3,3,C], then db [C]); the finish reads row e.
    The scratch the wrapper allocates, [10·C, bwd_blocks], holds exactly
    those writes, each once."""
    geo = conv1.geometry(m, c)
    shape = (10 * c, geo.bwd_blocks)
    e, blk = np.meshgrid(np.arange(10 * c), np.arange(geo.bwd_blocks),
                         indexing="ij")
    idx = (e * geo.bwd_blocks + blk).ravel()
    counts = np.bincount(idx, minlength=int(np.prod(shape)))
    assert counts.size == np.prod(shape) and (counts == 1).all()


# -- the fast tanh-GELU (conv1.cuh) in plain torch f32 -------------------------

K0, K1 = 0.7978845608028654, 0.044715
C0, C1 = 2.302208198144325, 0.1029432395800235    # 2·K0·log2(e), ·K1
VALUE_TOL = 1e-6   # absolute; the card adds ex2/rcp.approx's few ulp, and
#                    chip_smoke.py holds the f32 kernel output to 1e-5
GRAD_TOL = 5e-6


def _gelu_d(z):
    """(2u·log2(e) capped at 60, e^{2u} from it); the cap was hit where the
    first is 60."""
    v = torch.clamp(z * (C1 * z * z + C0), max=60.0)
    return v, torch.exp2(v)


def _fast_gelu2(z0, z1):
    """conv1.cuh ``gelu_tanh2``: z − z·r with r = 1/(1 + e^{2u}) of two
    values through one reciprocal."""
    (_, e0), (_, e1) = _gelu_d(z0), _gelu_d(z1)
    q = 1.0 / ((1.0 + e0) * (1.0 + e1))
    return z0 - z0 * ((1.0 + e1) * q), z1 - z1 * ((1.0 + e0) * q)


def _fast_gelu_grad2(z0, z1):
    """conv1.cuh ``gelu_r2`` and ``gelu_grad_of``: r zeroed at the cap,
    1 − r as e^{2u}·r."""
    (v0, e0), (v1, e1) = _gelu_d(z0), _gelu_d(z1)
    q = 1.0 / ((1.0 + e0) * (1.0 + e1))
    r0, r1 = (1.0 + e1) * q, (1.0 + e0) * q
    omr0, omr1 = e0 * r0, e1 * r1
    r0 = torch.where(v0 == 60.0, 0.0, r0)
    r1 = torch.where(v1 == 60.0, 0.0, r1)

    def grad(z, r, omr):
        return (z * r * omr) * (2.0 * K0) * (3.0 * K1 * z * z + 1.0) + omr
    return grad(z0, r0, omr0), grad(z1, r1, omr1)


def _autograd_gelu_grad(z):
    zz = z.clone().requires_grad_(True)
    F.gelu(zz, approximate="tanh").sum().backward()
    return zz.grad


def _pairs():
    """A dense grid over [-12, 12], each value paired with the grid's
    mirror image, so that pairs mix small and large magnitudes."""
    z = torch.linspace(-12.0, 12.0, 240_001, dtype=torch.float32)
    return z, torch.flip(z, (0,)) * 0.37


def test_fast_gelu_matches_torch_gelu():
    z0, z1 = _pairs()
    for got, z in zip(_fast_gelu2(z0, z1), (z0, z1)):
        err = (got - F.gelu(z, approximate="tanh")).abs().max()
        assert float(err) <= VALUE_TOL


def test_fast_gelu_grad_matches_autograd():
    z0, z1 = _pairs()
    for got, z in zip(_fast_gelu_grad2(z0, z1), (z0, z1)):
        err = (got - _autograd_gelu_grad(z)).abs().max()
        assert float(err) <= GRAD_TOL


@pytest.mark.parametrize("v", [0.0, -0.0, 20.0, -20.0, 1e4, -1e4, 1e13,
                               -1e13])
def test_fast_gelu_special_values(v):
    """±0, and |z| large enough that e^{2u} overflows to inf (capped at
    2^60) or underflows to 0, paired with itself, with a moderate value and
    with an opposite extreme: finite, and the same values as torch's GELU
    and its gradient (relative to |z| for the values)."""
    for other in (v, 1.0, -3.0, -v, 1e13):
        z0 = torch.tensor([v], dtype=torch.float32)
        z1 = torch.tensor([other], dtype=torch.float32)
        for got, g, z in zip(_fast_gelu2(z0, z1), _fast_gelu_grad2(z0, z1),
                             (z0, z1)):
            want = F.gelu(z, approximate="tanh")
            assert torch.isfinite(got).all() and torch.isfinite(g).all()
            assert float((got - want).abs()) <= VALUE_TOL * max(
                1.0, float(z.abs()))
            assert float((g - _autograd_gelu_grad(z)).abs()) <= GRAD_TOL
