"""What surrounds the masked-BCE kernels K2, K4 (musicvae_tpu_torch/
csrc/masked_bce.cu ``bce_sum``) and K3 (``bce_bwd``), checked on the CPU
where the kernels cannot run: the launch geometry that ops/fused_elbo.py
mirrors (``sum_geometry``, the three kernels' one geometry), the order in
which a block takes its chunks and a thread its cells, the fixed-column
mask path, the workspace, and the per-cell formulation (``bce_cell``: one
ex2, one rcp, a degree-4 polynomial for log1p; K3 takes only its σ half)
written in plain torch with exact ``exp2`` and division standing in for the
MUFU's. The card holds the kernels themselves against their plain versions
(chip_smoke.py), and also checks there that the C side's geometry equals
``sum_geometry``."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from musicvae_tpu_torch.ops import _kernels, fused_elbo, losses

CU = Path(fused_elbo.__file__).resolve().parent.parent / "csrc" / "masked_bce.cu"

# n at p = 128: one row, a ragged batch, the train and
# eval batch (64 x 4 bars) and an eval tail batch (37 x 4 bars); at another
# p the same number of rows
ROWS = (1, 12345, 64 * 4 * 96, 37 * 4 * 96)
PS = (128, 100, 84)


def _cu_constants() -> dict:
    """The namespace-level ``constexpr`` ints and floats of masked_bce.cu,
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


def _thread_cells() -> tuple:
    """(thread t, cell j of the thread, offset in the chunk) of every cell
    of a chunk: thread t's cell j is 4t + j."""
    t, j = np.meshgrid(np.arange(C["THREADS"]), np.arange(C["GROUP"]),
                       indexing="ij")
    return t.ravel(), j.ravel(), (t * C["GROUP"] + j).ravel()


def test_mirror_matches_the_source():
    """ops/fused_elbo.py's constants are the kernel's."""
    assert fused_elbo._THREADS == C["THREADS"]
    assert fused_elbo.SUM_GROUP == C["GROUP"]
    assert fused_elbo.SUM_CHUNK == C["CHUNK"] == C["THREADS"] * C["GROUP"]
    assert fused_elbo.SUM_MAX_BLOCKS == C["MAX_BLOCKS"]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("rows", ROWS)
def test_geometry_covers_each_cell_once(rows, p):
    """Block b takes chunks b, b + blocks, ..., the threads every cell of a
    chunk once, so the cells below n are summed (and K4's tile written)
    exactly once, and every block has a chunk."""
    n = rows * p
    geo = fused_elbo.sum_geometry(n, p)
    _, _, off = _thread_cells()
    assert np.array_equal(np.sort(off), np.arange(C["CHUNK"]))
    seen = np.zeros(geo.chunks, np.int64)
    for b in range(geo.blocks):
        seq = np.arange(b, geo.chunks, geo.blocks)
        assert seq.size >= 1
        seen[seq] += 1
    assert (seen == 1).all()
    cells = (np.arange(geo.chunks)[:, None] * C["CHUNK"] + off[None]).ravel()
    cells = cells[cells < n]
    hit = np.bincount(cells, minlength=n)
    assert hit.size == n and (hit == 1).all()


@pytest.mark.parametrize("p", PS + (1, 3, 1024, 2048))
@pytest.mark.parametrize("rows", ROWS + (0, 31, 32, 33))
def test_geometry_depends_on_n_and_p_only(rows, p, monkeypatch):
    """No card is asked; the grid is ceil(n / CHUNK) blocks, at least one
    and at most MAX_BLOCKS (the workspace's partials); the fixed-column path
    is taken exactly where p divides CHUNK."""
    def no_card(*_a, **_k):
        raise AssertionError("the geometry asked the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    n = rows * p
    geo = fused_elbo.sum_geometry(n, p)
    assert geo == fused_elbo.sum_geometry(n, p)
    assert geo.chunks == -(-n // C["CHUNK"])
    assert geo.blocks == max(1, min(geo.chunks, C["MAX_BLOCKS"]))
    assert geo.fixed_col == (C["CHUNK"] % p == 0)
    assert geo.fixed_col == (p in (1, 128, 1024))


@pytest.mark.parametrize("p", (1, 2, 4, 64, 128, 256, 1024))
def test_fixed_column_invariant(p):
    """Where the kernel keeps a thread's mask values in registers (p
    divides CHUNK), every cell that thread t adds as its cell j lies in
    column (4t + j) % p, in every chunk."""
    n = 64 * 4 * 96 * 128 + 1000 * p + 7   # the train shape, a ragged tail
    geo = fused_elbo.sum_geometry(n, p)
    assert geo.fixed_col
    t, j, off = _thread_cells()
    cells = np.arange(geo.chunks)[:, None] * C["CHUNK"] + off[None]
    inside = cells < n
    want = np.broadcast_to((t * C["GROUP"] + j) % p, cells.shape)
    assert (cells[inside] % p == want[inside]).all()


@pytest.mark.parametrize("p", (100, 84, 3, 96))
def test_general_mask_path_where_columns_move(p):
    """Any other p takes mask[cell % p]: there a thread's column changes
    between groups, so registers loaded once would be wrong."""
    geo = fused_elbo.sum_geometry(777 * p, p)
    assert not geo.fixed_col
    assert C["CHUNK"] % p != 0


def test_workspace_made_once_per_device_and_stream():
    """The sum kernels' partials and ticket (ops/_kernels.py ``workspace``,
    whose ticket the conv epilogue's backward shares) are made once for
    each (device, stream) and handed out again after: no allocation and no
    memset a call; the ticket starts at 0."""
    dev = torch.device("cpu")
    a = _kernels.workspace(dev, 12345)
    b = _kernels.workspace(dev, 12345)
    c = _kernels.workspace(dev, 67890)
    assert a[0] is b[0] and a[1] is b[1]
    assert c[0] is not a[0] and c[1] is not a[1]
    assert _kernels.ticket(dev, 12345) is a[1]
    assert a[0].shape == (C["MAX_BLOCKS"],) and a[0].dtype == torch.float32
    assert a[1].shape == (1,) and int(a[1]) == 0
    _kernels._workspaces.pop((dev, 12345))
    _kernels._workspaces.pop((dev, 67890))


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 12345 * 128,
                               64 * 4 * 96 * 128, 10 ** 8])
def test_backward_grid_unchanged(n):
    """K3 launches K2/K4's geometry (the grid that was ceil(n / 4096)
    blocks is gone): ``sum_geometry(n, 128)``, block b taking chunks b,
    b + blocks, ..., each chunk's cells once, so every cell below n gets
    its dl written exactly once and every block has a chunk (n = 0: one
    block and no chunk)."""
    geo = fused_elbo.sum_geometry(n, 128)
    assert geo.chunks == -(-n // C["CHUNK"])
    assert geo.blocks == max(1, min(geo.chunks, C["MAX_BLOCKS"]))
    assert geo.fixed_col
    _, _, off = _thread_cells()
    assert np.array_equal(np.sort(off), np.arange(C["CHUNK"]))
    seen = np.zeros(geo.chunks, np.int64)
    for b in range(geo.blocks):
        seq = np.arange(b, geo.chunks, geo.blocks)
        assert seq.size >= 1 or geo.chunks == 0
        seen[seq] += 1
    assert (seen == 1).all()
    # the chunks tile [0, chunks·CHUNK) and only the last one is ragged
    assert geo.chunks * C["CHUNK"] >= n > (geo.chunks - 1) * C["CHUNK"] \
        or n == geo.chunks == 0


# -- the per-cell formulation (bce_cell) in plain torch -----------------------

def _fma(a, b, c):
    """f32 fused multiply-add: the exact product (in f64) plus c, rounded
    once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _exp_parts(l):
    """``bce_cell``'s shared start: e = exp(−|l|), u = 1 + e, w = 2 + e,
    q = 1/(u·w), with exp2 and 1/v exact where the kernel uses
    ex2.approx.ftz and rcp.approx.ftz; every other operation rounds to f32
    as the kernel's does."""
    e = torch.exp2(l.abs() * C["NEG_LOG2E"])
    e = torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)   # .ftz
    u, w = 1.0 + e, 2.0 + e
    return e, u, w, 1.0 / (u * w)


def _fast_sigmoid(l):
    """``bce_cell``'s σ half, all that K3 computes of a cell."""
    e, _, w, q = _exp_parts(l)
    r = w * q
    return torch.where(l >= 0.0, r, e * r)


def _fast_cell(l, t):
    """``bce_cell``: (BCE, σ(l))."""
    l, t = l.float(), t.float()
    e, u, w, q = _exp_parts(l)
    s = e * (u * q)
    z = s * s
    poly = _fma(torch.full_like(z, C["L1P_C4"]), z, torch.full_like(z, C["L1P_C3"]))
    for name in ("L1P_C2", "L1P_C1", "L1P_C0"):
        poly = _fma(poly, z, torch.full_like(z, C[name]))
    bce = _fma(-l, t, torch.clamp_min(l, 0.0)) + s * poly
    return bce, _fast_sigmoid(l)


def _fast_bwd(l, t, mk, g):
    """K3's cell: ((σ(l) − x)·mask)·g, each operation rounded to f32 in
    that order, as the kernel rounds (and as K4's tile times g does)."""
    l, t = l.float(), t.float()
    return ((_fast_sigmoid(l) - t) * mk) * g


def _exact_bwd(l, t, mk, g):
    """(σ(l) − x)·mask·g in f64 from the f32 inputs."""
    return (torch.sigmoid(l.double()) - t.double()) * mk * g


def _truth(l, t):
    """BCE in f64 from the f32 inputs."""
    l, t = l.double(), t.double()
    return torch.clamp_min(l, 0.0) - l * t + torch.log1p(torch.exp(-l.abs()))


BCE_TOL = 1e-6     # relative to max(1, |BCE|); chip_smoke.py holds the sums
#                    to 1e-5 relative
SIG_TOL = 1e-6     # absolute, the f32 tile's tolerance at g = 1
CONFIDENT_TOL = 2e-6   # relative, |l| in [8, 30]: the f32 rounding of
#                        |l|·log2(e) (half an ulp of 43.3 is 1.9e-6, times
#                        ln 2) and a few ulp of the rest


@pytest.mark.parametrize("t", [0.0, 1.0, 0.3, 0.77])
def test_fast_cell_dense_sweep(t):
    l = torch.linspace(-40.0, 40.0, 800_001, dtype=torch.float32)
    x = torch.full_like(l, t)
    bce, sig = _fast_cell(l, x)
    ref = losses.bce_with_logits(l, x)
    err = (bce - ref).abs() / torch.clamp_min(ref.abs(), 1.0)
    assert float(err.max()) <= BCE_TOL
    assert float((sig - torch.sigmoid(l)).abs().max()) <= SIG_TOL


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fast_cell_relative_error_where_confident(sign):
    """A confident cell (|l| from 8 to 30, x on the side the logit
    predicts) has BCE = log1p(e) ≈ e: its error is held relative to
    itself, against f64 and against the plain version, so that a trained
    model's sum (95 % of it such cells) stays within 1e-5."""
    l = sign * torch.linspace(8.0, 30.0, 400_001, dtype=torch.float32)
    x = (l > 0).float()
    bce, sig = _fast_cell(l, x)
    truth = _truth(l, x)
    rel = ((bce.double() - truth).abs() / truth).max()
    assert float(rel) <= CONFIDENT_TOL
    plain = losses.bce_with_logits(l, x).double()
    assert float(((bce.double() - plain).abs() / plain).max()) <= CONFIDENT_TOL
    want = torch.sigmoid(l.double())
    if sign < 0:                # σ ≈ e there: relative too
        assert float(((sig.double() - want).abs() / want).max()) \
            <= CONFIDENT_TOL
    assert float((sig.double() - want).abs().max()) <= SIG_TOL


def test_log1p_polynomial_relative_error():
    """log1p(e) = s·P(s²), s = e/(2+e), for every e in (0, 1] down to the
    smallest normal f32, within 5e-7 relative of log1p in f64."""
    e = torch.cat([torch.logspace(-37.9, 0.0, 200_001, dtype=torch.float64),
                   torch.linspace(0.0, 1.0, 200_001, dtype=torch.float64)[1:]]
                  ).float()
    u, w = 1.0 + e, 2.0 + e
    s = e * (u * (1.0 / (u * w)))
    z = s * s
    poly = torch.full_like(z, C["L1P_C4"])
    for name in ("L1P_C3", "L1P_C2", "L1P_C1", "L1P_C0"):
        poly = _fma(poly, z, torch.full_like(z, C[name]))
    got = (s * poly).double()
    want = torch.log1p(e.double())
    assert float(((got - want).abs() / want).max()) <= 5e-7


@pytest.mark.parametrize("v", [0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0, 1e30,
                               -1e30])
@pytest.mark.parametrize("t", [0.0, 1.0, 0.25])
def test_fast_cell_special_values(v, t):
    """±0, ±1e-30 (e rounds to 1), ±88 (e = exp(−88) is below the smallest
    normal f32 and flushed to 0: an error under 1.2e-38), ±1e30 (e is 0,
    l·x dominates): finite, and within the sweep's tolerances."""
    l = torch.tensor([v], dtype=torch.float32)
    x = torch.tensor([t], dtype=torch.float32)
    bce, sig = _fast_cell(l, x)
    ref = losses.bce_with_logits(l, x)
    assert torch.isfinite(bce).all() and torch.isfinite(sig).all()
    assert float((bce - ref).abs()) <= BCE_TOL * max(1.0, float(ref.abs())) \
        + 1.2e-38
    assert float((sig - torch.sigmoid(l)).abs()) <= SIG_TOL


# -- K3's cell: the σ half of bce_cell, times mask, times g -------------------

@pytest.mark.parametrize("g", [1.0, 3.5])
@pytest.mark.parametrize("t", [0.0, 1.0, 0.3, 0.77])
def test_bwd_cell_dense_sweep(t, g):
    """Over l ∈ [−40, 40] and masks of 1, 0.5 and 0, K3's cell is within
    1e-6·max(1, g) of the exact gradient (the f32 tolerance that
    chip_smoke.py holds K3 to against the plain version)."""
    l = torch.linspace(-40.0, 40.0, 800_001, dtype=torch.float32)
    x = torch.full_like(l, t)
    for mk in (1.0, 0.5, 0.0):
        got = _fast_bwd(l, x, mk, g)
        assert got.dtype == torch.float32
        err = (got.double() - _exact_bwd(l, x, mk, g)).abs().max()
        assert float(err) <= 1e-6 * max(1.0, g)


@pytest.mark.parametrize("g", [1.0, 3.5])
@pytest.mark.parametrize("v", [0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0, 1e30,
                               -1e30])
def test_bwd_cell_special_values(v, g):
    """The special values of ``test_fast_cell_special_values``: finite,
    and within 1e-6·max(1, g) of the exact gradient at every target and
    mask."""
    l = torch.tensor([v], dtype=torch.float32)
    for t in (0.0, 1.0, 0.25):
        x = torch.tensor([t], dtype=torch.float32)
        for mk in (1.0, 0.5, 0.0):
            got = _fast_bwd(l, x, mk, g)
            assert torch.isfinite(got).all()
            err = (got.double() - _exact_bwd(l, x, mk, g)).abs()
            assert float(err) <= 1e-6 * max(1.0, g)
