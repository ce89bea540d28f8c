"""The decoder head's last layer (musicvae_tpu_torch/ops/head_out.py,
csrc/head_out.cu), checked on the CPU where the kernels cannot run:

- the plain versions are the path the kernels replace (ATen's transposed
  conv without its bias, then the epilogue's chain: bias, crop, cast),
  forward and under autograd, bit for bit;
- ``conv_block``'s CPU branch gives the bits it gave before, and its CUDA
  branch sends the one-channel transposed conv, and only it, to
  ``head_out``;
- the wrapper's checks refuse what the kernels cannot take;
- the kernels' arithmetic, mirrored here in numpy: the forward's taps by
  the parity of the output pixel, the backward's staged window, its units
  and the rows whose gradient each unit adds to db;
- the benchmark reader's bytes are the model's call's.

The card holds the kernels themselves against the plain versions
(chip_smoke.py ``head_out``, and the cuda-marked test below)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from musicvae_tpu_torch import config as tcfg
from musicvae_tpu_torch.models import layers
from musicvae_tpu_torch.models.vae import build_model
from musicvae_tpu_torch.ops import _kernels, conv_epilogue as ce
from musicvae_tpu_torch.ops import head_out as ho

ROOT = Path(__file__).resolve().parents[1]
DTYPES = (torch.float32, torch.bfloat16)
# (name, h, w, Cin, crop): c3's last layer (x [48, 64, 16] a bar, the bar's
# [96, 128] of the [97, 129] grid) and an odd grid, whole and cropped
SHAPES = [("c3", 48, 64, 16, (96, 128)), ("odd", 5, 7, 8, None),
          ("odd_crop", 5, 7, 8, (9, 14))]


def _inputs(n, h, w, cin, crop, dt, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = F.gelu(torch.randn(n, h, w, cin, generator=g)).to(dt)
    wt = (torch.randn(cin, 1, 3, 3, generator=g) / 12).to(dt)
    b = (0.5 * torch.randn(1, generator=g)).to(dt)
    ho_, wo = crop or (2 * h + 1, 2 * w + 1)
    dy = 0.01 * torch.randn(n, ho_, wo, 1, generator=g)
    return x, wt, b, dy


def _chain(x, wt, b, crop, out):
    """The replaced path as autograd runs it: the conv without its bias on
    x's NCHW view, the bias add, the crop, the cast, as an NHWC view."""
    c = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, None, stride=2)
    h = c + b.view(1, -1, 1, 1)
    if crop is not None:
        h = h[:, :, :crop[0], :crop[1]]
    return h.to(out).permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("n", (1, 3))
@pytest.mark.parametrize("dt", DTYPES, ids=("f32", "bf16"))
def test_plain_versions_are_the_replaced_chain(dt, n, shape):
    """Forward values, and dx, dW and db under autograd, equal the chain's
    bit for bit, in x's dtype; the logits f32 and contiguous."""
    _, h, w, cin, crop = shape
    x, wt, b, dy = _inputs(n, h, w, cin, crop, dt)
    leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
    want = _chain(*leaves, crop, torch.float32)
    want_grads = torch.autograd.grad(want, leaves, dy)
    got_leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
    got = ho.head_out(*got_leaves, crop, torch.float32)
    grads = torch.autograd.grad(got, got_leaves, dy)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (n, *(crop or (2 * h + 1, 2 * w + 1)), 1)
    assert torch.equal(got, want)
    for g, wg in zip(grads, want_grads):
        assert g.dtype == dt and torch.equal(g, wg)
    assert grads[0].is_contiguous()


# -- conv_block ------------------------------------------------------------------

def _block_before(x, weight, bias, stride, padding, transposed=False,
                  crop=None, gelu=True, out_dtype=None):
    """``conv_block``'s CPU branch as it was before the head's kernels."""
    op = F.conv_transpose2d if transposed else F.conv2d
    x = x.permute(0, 3, 1, 2)
    return ce._chain(op(x, weight, bias, stride=stride, padding=padding),
                     crop, gelu, out_dtype or x.dtype)


@pytest.mark.parametrize("dt", DTYPES, ids=("f32", "bf16"))
def test_conv_block_cpu_branch_unchanged(dt, monkeypatch):
    """On the CPU the head's last layer (and a GELU'd layer beside it) still
    takes ATen's conv with its bias and the chain, bit for bit and
    differentiably, and never ``head_out``."""
    monkeypatch.setattr(ho, "head_out", None)
    x, wt, _, dy = _inputs(2, 6, 8, 16, (12, 16), dt)
    b = torch.full((1,), 0.25).to(dt)
    for args in (((2, 2), (0, 0), True, (12, 16), False, torch.float32),
                 ((2, 2), (0, 0), True, (12, 16), True, dt)):
        leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
        got = ce.conv_block(*leaves, *args)
        want_leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
        want = _block_before(*want_leaves, *args)
        assert torch.equal(got, want)
        g = dy.to(got.dtype)
        for a, w in zip(torch.autograd.grad(got, leaves, g),
                        torch.autograd.grad(want, want_leaves, g)):
            assert torch.equal(a, w)


TAKES = [((16, 1, 3, 3), (2, 2), (0, 0), True, True),
         ((16, 1, 3, 3), 2, 0, True, True),
         ((4, 1, 3, 3), [2, 2], [0, 0], True, True),
         ((16, 1, 3, 3), (2, 2), (0, 0), False, False),
         ((16, 2, 3, 3), (2, 2), (0, 0), True, False),
         ((16, 1, 3, 3), (1, 1), (0, 0), True, False),
         ((16, 1, 3, 3), (2, 2), (1, 1), True, False),
         ((16, 1, 5, 5), (2, 2), (0, 0), True, False)]


@pytest.mark.parametrize("case", TAKES)
def test_cuda_branch_dispatches_by_shape(case, monkeypatch):
    """``conv_block``'s card branch (``on_cpu`` forced False): the one-channel
    3x3 stride-2 padding-0 transposed conv goes to ``head_out`` with x
    NHWC as given; every other conv to cuDNN's op and ``conv_epilogue``."""
    shape, stride, padding, transposed, want = case
    calls = []
    monkeypatch.setattr(_kernels, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(ho, "head_out", lambda *a: calls.append(
        ("head_out", a)) or "head")
    monkeypatch.setattr(ce, "conv_epilogue", lambda *a: calls.append(
        ("epilogue", a)) or "epilogue")
    cin = shape[0] if transposed else shape[1]
    x = torch.zeros(1, 5, 7, cin)
    weight = torch.zeros(shape)
    got = ce.conv_block(x, weight, torch.zeros(shape[1] if transposed
                                                 else shape[0]),
                        stride, padding, transposed, None, False,
                        torch.float32)
    assert got == ("head" if want else "epilogue")
    assert [c[0] for c in calls] == ["head_out" if want else "epilogue"]
    if want:
        assert calls[0][1][0] is x and calls[0][1][3:] == (None,
                                                            torch.float32)


def test_cuda_branch_refuses_a_gelu_on_the_head_layer(monkeypatch):
    monkeypatch.setattr(_kernels, "on_cpu", lambda name, t: False)
    with pytest.raises(ValueError, match="no GELU"):
        ce.conv_block(torch.zeros(1, 5, 7, 16), torch.zeros(16, 1, 3, 3),
                      torch.zeros(1), (2, 2), (0, 0), True, None, True)


# -- the wrapper's checks --------------------------------------------------------

def _x(n=2, h=6, w=8, cin=16, dt=torch.bfloat16):
    return torch.zeros(n, h, w, cin, dtype=dt)


def _misaligned():
    return torch.zeros(1 + 2 * 6 * 8 * 16, dtype=torch.bfloat16)[1:].view(
        2, 6, 8, 16)


def _w(cin=16, dt=torch.bfloat16):
    return torch.zeros(cin, 1, 3, 3, dtype=dt)


BF = torch.bfloat16
REFUSED = {
    "not_4d": lambda: (torch.zeros(2, 6, 8, dtype=BF), _w(), None, BF, {}),
    "f16": lambda: (_x(dt=torch.float16), _w(dt=torch.float16), None,
                    torch.float16, {}),
    "out_f16": lambda: (_x(), _w(), None, torch.float16, {}),
    "cin_3": lambda: (_x(cin=3), _w(3), None, BF, {}),
    "cin_12": lambda: (_x(cin=12), _w(12), None, BF, {}),
    "cin_256": lambda: (_x(cin=256), _w(256), None, BF, {}),
    "too_wide": lambda: (_x(w=129), _w(), None, BF, {}),
    "weight_shape": lambda: (_x(), torch.zeros(16, 2, 3, 3, dtype=BF), None,
                             BF, {}),
    "weight_dtype": lambda: (_x(), _w(dt=torch.float32), None, BF, {}),
    "bias_shape": lambda: (_x(), _w(), None, BF,
                           {"bias": torch.zeros(2, dtype=BF)}),
    "bias_dtype": lambda: (_x(), _w(), None, BF, {"bias": torch.zeros(1)}),
    "crop_outside": lambda: (_x(), _w(), (14, 16), BF, {}),
    "crop_empty": lambda: (_x(), _w(), (0, 16), BF, {}),
    "dy_shape": lambda: (_x(), _w(), (12, 16), torch.float32,
                         {"dy": torch.zeros(2, 12, 17, 1)}),
    "not_contiguous": lambda: (_x().transpose(1, 2), _w(), None, BF, {}),
    "dy_not_contiguous": lambda: (_x(), _w(), (12, 16), torch.float32,
                                  {"dy": torch.zeros(2, 16, 12, 1)
                                   .transpose(1, 2)}),
    "misaligned": lambda: (_misaligned(), _w(), None, BF, {}),
}


@pytest.mark.parametrize("what", tuple(REFUSED))
def test_check_refuses_what_the_kernels_cannot_take(what):
    """``check``, which the wrappers run before a CUDA launch, on a CPU
    stand-in: each input the kernels cannot take raises ValueError."""
    x, w, crop, out, extra = REFUSED[what]()
    with pytest.raises(ValueError):
        ho.check("head_out_fwd", x, w, crop, out, **extra)


@pytest.mark.parametrize("n, h, w, cin, crop", [
    (2, 48, 64, 16, (96, 128)), (1, 5, 7, 4, None), (3, 4, 128, 128, None),
    (1, 9, 5, 32, (19, 11)), (2, 3, 3, 8, (1, 1))])
def test_check_takes_the_heads_layers(n, h, w, cin, crop):
    """x of every width the kernels take, bf16 and f32, with its bias and
    dy, passes, and the kept grid comes back."""
    for dt in DTYPES:
        kept = crop or (2 * h + 1, 2 * w + 1)
        got = ho.check("head_out_bwd", _x(n, h, w, cin, dt), _w(cin, dt),
                       crop, torch.float32, bias=torch.zeros(1, dtype=dt),
                       dy=torch.zeros(n, *kept, 1))
        assert got == kept


# -- the kernels' arithmetic, mirrored ---------------------------------------------

def _fwd_mirror(x, wt, crop):
    """The forward kernel's sum in float64: per band of ROWS x rows, p over
    the band's rows and the one above, then each 2x2 quad (m, q) of output
    rows 2a0 + 2m, + 1 and columns 2q, 2q + 1 by the kernel's taps: the
    even row p rows m + 1 (kh = 0) and m (kh = 2), the odd one row m + 1
    (kh = 1); the even column p columns q (kw = 0, where q < w) and q - 1
    (kw = 2, where q > 0), the odd one column q (kw = 1)."""
    n, h, w, cin = x.shape
    hk, wk = crop or (2 * h + 1, 2 * w + 1)
    rows = ho.ROWS
    wf = wt.reshape(cin, 9)
    out = np.full((n, hk, wk), np.nan)
    bands = -(-hk // (2 * rows))
    qcols = (wk + 1) // 2
    for bn in range(n * bands):
        nn, a0 = bn // bands, (bn % bands) * rows
        p = np.zeros((rows + 1, w, 9))
        for it in range((rows + 1) * w):
            r, b = divmod(it, w)
            a = a0 - 1 + r
            if 0 <= a < h:
                p[r, b] = x[nn, a, b] @ wf
        for e in range(rows * qcols):
            m, q = divmod(e, qcols)
            i, j = 2 * a0 + 2 * m, 2 * q
            if i >= hk:
                break
            lo = p[m + 1, q] if q < w else np.zeros(9)
            hi = p[m, q] if q < w else np.zeros(9)
            lo_l = p[m + 1, q - 1] if q > 0 else np.zeros(9)
            hi_l = p[m, q - 1] if q > 0 else np.zeros(9)
            quad = {(0, 0): lo[0] + lo_l[2] + hi[6] + hi_l[8],
                    (0, 1): lo[1] + hi[7], (1, 0): lo[3] + lo_l[5],
                    (1, 1): lo[4]}
            for (di, dj), v in quad.items():
                if i + di < hk and j + dj < wk:
                    assert np.isnan(out[nn, i + di, j + dj])
                    out[nn, i + di, j + dj] = v
    return out


def _walk(start, step, width, count):
    """A thread's (row, column) walk by increments: from element ``start``
    of rows ``width`` long, ``step`` elements at a time, the column wrapping
    into the next row, as the backward kernel walks its staged elements
    and its pixels."""
    r, c = divmod(start, width)
    dr, dc = divmod(step, width)
    out = []
    for _ in range(count):
        out.append((r, c))
        r, c = r + dr, c + dc
        if c >= width:
            r, c = r + 1, c - width
    return out


def _bwd_mirror(x, wt, dy, crop, blocks):
    """The backward kernel in float64: blocks take units (bar, band of ROWS
    x rows) by a grid stride; a unit stages g rows 2a0 .. 2a0 + 2 ROWS
    (zero beyond the kept grid), each thread's elements by ``_walk``, sums
    the rows it owns into db (its 2 ROWS, the last band the row below them
    too), and each thread's pixels (a quad of channels each, a pixel's
    quads on consecutive threads) by ``_walk``, their dx and dW terms by
    the staged window. Returns (dx, dW [Cin, 9], db, the count of each
    kept g cell summed into db)."""
    n, h, w, cin = x.shape
    hk, wk = dy.shape[1:3]
    rows, threads = ho.ROWS, ho.THREADS
    bands = -(-h // rows)
    gw, grows = 2 * w + 1, 2 * rows + 1
    quads = cin // 4
    slots = threads // quads
    wf = wt.reshape(cin, 9)
    dx = np.full(x.shape, np.nan)
    dw, db = np.zeros((cin, 9)), 0.0
    seen = np.zeros((n, hk, wk), int)
    for blk in range(blocks):
        for unit in range(blk, n * bands, blocks):
            nn, band = divmod(unit, bands)
            a0 = band * rows
            own = (grows if band == bands - 1 else 2 * rows) * gw
            g = np.full(grows * gw, np.nan)
            for tid in range(threads):
                count = len(range(tid, grows * gw, threads))
                for k, (r, j) in enumerate(_walk(tid, threads, gw, count)):
                    e = tid + k * threads
                    assert (r, j) == divmod(e, gw)
                    i = 2 * a0 + r
                    g[e] = dy[nn, i, j] if i < hk and j < wk else 0.0
                    if e < own and i < hk and j < wk:
                        db += g[e]
                        seen[nn, i, j] += 1
            npix = min(rows, h - a0) * w
            for tid in range(threads):
                q, slot = tid % quads, tid // quads
                count = len(range(slot, npix, slots))
                for k, (ar, b) in enumerate(_walk(slot, slots, w, count)):
                    assert (ar, b) == divmod(slot + k * slots, w)
                    win = np.array([g[(2 * ar + kh) * gw + 2 * b + kw]
                                    for kh in range(3) for kw in range(3)])
                    ch = slice(4 * q, 4 * q + 4)
                    assert np.isnan(dx[nn, a0 + ar, b, ch]).all()
                    dx[nn, a0 + ar, b, ch] = wf[ch] @ win
                    dw[ch] += np.outer(x[nn, a0 + ar, b, ch], win)
    return dx, dw, db, seen


MIRRORED = [(2, 48, 64, 4, (96, 128)), (1, 8, 6, 4, None),
            (3, 5, 7, 8, (9, 14)), (1, 16, 3, 4, (33, 7)),
            (2, 3, 2, 4, (1, 1)), (1, 9, 5, 16, (17, 10))]


@pytest.mark.parametrize("shape", MIRRORED)
def test_kernel_arithmetic_is_the_transposed_conv(shape):
    """The forward's and backward's index arithmetic, run in float64, give
    ATen's transposed conv over the kept grid and its input, weight and
    bias gradients; every output and every dx pixel is written once, and
    each kept gradient cell is summed into db exactly once, with the
    backward's block count at and under the units'."""
    n, h, w, cin, crop = shape
    rng = np.random.default_rng(sum(shape[:4]))
    x = rng.standard_normal((n, h, w, cin))
    wt = rng.standard_normal((cin, 1, 3, 3))
    hk, wk = crop or (2 * h + 1, 2 * w + 1)
    dy = rng.standard_normal((n, hk, wk))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    c = F.conv_transpose2d(xt, wtt, None, stride=2)[:, 0, :hk, :wk]
    want_dx, want_dw = torch.autograd.grad(c, (xt, wtt),
                                           torch.from_numpy(dy))
    np.testing.assert_allclose(_fwd_mirror(x, wt, crop), c.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    units = n * -(-h // ho.ROWS)
    for blocks in {ho.bwd_blocks(n, h), max(1, units - 1), 1}:
        dx, dw, db, seen = _bwd_mirror(x, wt, dy, crop, blocks)
        np.testing.assert_allclose(dx, want_dx.permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dw, want_dw.numpy().reshape(cin, 9),
                                   rtol=1e-12, atol=1e-12)
        assert (seen == 1).all()
        np.testing.assert_allclose(db, dy.sum(), rtol=1e-12)


def test_backward_blocks_are_a_function_of_the_shape():
    """The backward's grid: one block a unit up to its cap, the partials'
    row a multiple of 4 columns holding dW's 9·Cin sums and db's."""
    assert ho.bwd_blocks(2048, 48) == ho.BWD_MAX_BLOCKS
    assert ho.bwd_blocks(1, 48) == 6 and ho.bwd_blocks(1, 1) == 1
    assert ho.bwd_blocks(20, 9) == 40
    for cin in (4, 8, 16, 32, 64, 128):
        cols = ho.partial_cols(cin)
        assert cols % 4 == 0 and 9 * cin + 1 <= cols < 9 * cin + 5


# -- the benchmark's reader ------------------------------------------------------

def _reader():
    path = ROOT / "perfbench" / "metrics" / "head_out_roofline.train_hier.py"
    spec = importlib.util.spec_from_file_location("head_out_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reader_bytes_are_the_models_head_layer(monkeypatch):
    """The benchmark's reader counts the bytes of the very call c3's train
    step makes: a forward of the registered c3 (f32 on the CPU, one
    window) records each ``conv_block`` call that ``head_out.takes``, and
    its bytes at c3's batch and dtypes (forward: x read, the logits
    written; backward: their gradient and x read, x's gradient written;
    the weight and bias read each way, their gradients written) are the
    reader's ``step_bytes``, at 805,307,238 (0.24 ms at 3.35 TB/s)."""
    spec = json.loads((ROOT / "perfbench" / "configs"
                       / "c3_hier_16bar.json").read_text())
    cfg = tcfg.get_config("c3_hier_16bar")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    model = build_model(cfg, device="cpu", seed=0)
    calls = []
    block = layers.conv_block

    def recorded(x, weight, bias, stride, padding, transposed=False,
                 crop=None, gelu=True, out_dtype=None):
        if ho.takes(weight, stride, padding, transposed):
            calls.append((tuple(x.shape), tuple(weight.shape), crop, gelu,
                          out_dtype))
        return block(x, weight, bias, stride, padding, transposed, crop,
                     gelu, out_dtype)

    monkeypatch.setattr(layers, "conv_block", recorded)
    eps = (torch.zeros(1, 256), torch.zeros(1, 16, 64))
    with torch.no_grad():
        model(torch.zeros(1, 16, 96, 128, dtype=torch.uint8), eps)
    assert len(calls) == 1
    (n, h, w, cin), wshape, crop, gelu, out = calls[0]
    assert (h, w, cin, wshape, crop, gelu, out) == (
        48, 64, 16, (16, 1, 3, 3), (96, 128), False, torch.float32)
    bars = spec["train"]["batch_size"] * spec["model"]["num_bars"]
    e, o = 2, 4                   # the cell's bf16 x and f32 logits
    x_bytes = bars * h * w * cin * e
    y_bytes = bars * crop[0] * crop[1] * o
    wb = (9 * cin + 1) * e
    total = (x_bytes + y_bytes + wb) + (y_bytes + 2 * x_bytes + 2 * wb)
    assert _reader().step_bytes(spec) == total == 805_307_238


def test_reader_reads_the_head_kernels_or_nothing():
    """The reader sums the trace's ``head_out_`` kernels (and nothing of the
    epilogue's) over the steps, against the bound; a trace without them,
    the parent's, reads None."""
    from types import SimpleNamespace

    spec = json.loads((ROOT / "perfbench" / "configs"
                       / "c3_hier_16bar.json").read_text())
    epi = {"void mvk::conv_epilogue_fwd<float>(int)": [130, 1.0]}
    kernels = {**epi,
               "void mvk::head_out_fwd<__nv_bfloat16, float, 8>(int)": [10,
                                                                      0.0015],
               "void mvk::head_out_bwd<float, __nv_bfloat16>(int)": [10,
                                                                     0.0025]}
    reader = _reader()
    least = 805_307_238 / 3.35e12
    got = reader.read(SimpleNamespace(trace={"kernels": kernels, "steps": 10},
                                      spec=spec))
    assert got == pytest.approx(100 * least / 0.0004)
    assert reader.read(SimpleNamespace(trace={"kernels": epi, "steps": 10},
                                       spec=spec)) is None
    assert reader.read(SimpleNamespace(trace={"kernels": kernels},
                                       spec=spec)) is None


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernels_match_the_plain_versions_on_the_card(shape):
    """On the card, at a small size: the forward and dx within 1 bf16 ulp of
    the plain versions where the f32 sums' order cannot matter (inputs on
    a coarse grid, so every product and sum is exact in f32), dW and db
    within 2^-7 relative + 1e-5 of their sums of |terms|, two runs bit
    for bit (chip_smoke.py ``head_out`` runs the full check at the
    registered widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    _, h, w, cin, crop = shape
    g = torch.Generator().manual_seed(3)
    x = (torch.randint(-8, 9, (2, h, w, cin), generator=g) / 8).to(
        torch.bfloat16).cuda()
    wt = (torch.randint(-8, 9, (cin, 1, 3, 3), generator=g) / 8).to(
        torch.bfloat16).cuda()
    b = torch.tensor([0.25], dtype=torch.bfloat16).cuda()
    kept = crop or (2 * h + 1, 2 * w + 1)
    dy = (torch.randint(-8, 9, (2, *kept, 1), generator=g) / 64).cuda()
    runs = [(ho._forward(x, wt, b, crop, torch.float32),
             *ho._backward(x, wt, dy, crop)) for _ in range(2)]
    want_y = ho.head_out_ref(x, wt, b, crop, torch.float32)
    want_dx, want_dw, want_db = ho.head_out_bwd_ref(x, wt, dy, crop)
    y, dx, dw, db = runs[0]
    assert all(torch.equal(a, c) for a, c in zip(*runs))

    def ulps(a, w_):
        i = torch.stack([a.bfloat16(), w_.bfloat16()]).view(torch.int16)
        i = i.int()
        i = torch.where(i < 0, -(i & 0x7FFF), i)
        return int((i[0] - i[1]).abs().max())

    assert ulps(y.float(), want_y.float()) <= 1
    assert ulps(dx.float(), want_dx.float()) <= 1
    scale = torch.ops.aten.convolution_backward(
        F.pad(dy.abs().permute(0, 3, 1, 2),
              (0, 2 * w + 1 - kept[1], 0, 2 * h + 1 - kept[0])),
        x.float().abs().permute(0, 3, 1, 2), wt.float(), None, [2, 2],
        [0, 0], [1, 1], True, [0, 0], 1, [False, True, False])[1]
    assert ((dw.float() - want_dw.float()).abs()
            <= want_dw.float().abs() * 2.0 ** -7 + 1e-5 * scale).all()
    assert (db.float() - want_db.float()).abs() <= (
        want_db.float().abs() * 2.0 ** -7 + 1e-5 * dy.abs().sum())
