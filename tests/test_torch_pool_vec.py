"""K4 (affine + LeakyReLU + 2^3 pool) and K7 (its backward) of the
PyTorch/CUDA port, as far as a CPU can hold them: which variant a CUDA
launch takes for which dtype and channel count, how "vec" cuts a pooled row
into blocks, and K7 "vec"'s order of float32 sums, emulated in plain
PyTorch, against the plain version at the tolerances the card's check uses.
The kernels themselves run only on a GPU (`chip_smoke.py` phase 3,
`tests/test_torch_package.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from test_torch_mma_variants import _reduce_rows
from transmf_ad_tpu_torch.nn import blocks
from transmf_ad_tpu_torch.ops import pool3d

BF16, F32 = torch.bfloat16, torch.float32
# chip_smoke's tolerance for K7's sums: of their largest magnitude
SUM_TOL = {F32: 1e-4, BF16: 1e-2}


def _pool_widths(dim=128):
    """C of every stage-end pool of a full-width encoder (lane or channel
    vectors alike: the variant reads C alone)."""
    return sorted({co * dim // 4 for _, _, _, (_, co), _, pool in blocks._PLAN
                   if pool is not None})


def test_model_pool_widths_are_known():
    assert _pool_widths() == [32, 64, 128]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("c", _pool_widths())
def test_model_widths_take_vec(dtype, c):
    assert pool3d.variant(dtype, c) == "vec"


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 8, "vec"), (BF16, 32, "vec"), (BF16, 64, "vec"),
    (BF16, 128, "vec"), (F32, 4, "vec"), (F32, 32, "vec"),
    (BF16, 12, "direct"),  # 24 bytes: not a whole number of 16-byte pieces
    (BF16, 4, "direct"), (F32, 6, "direct"), (F32, 2, "direct"),
    (F32, 12, "vec"),
])
def test_variant_by_dtype_and_channels(dtype, c, want):
    assert pool3d.variant(dtype, c) == want


@pytest.mark.parametrize("dtype,z,c,want", [
    # the models' shapes: one block a row, rounded up to a warp
    (BF16, 182, 32, (384, 1)),   # f1: 91 x 4 lanes
    (BF16, 91, 64, (384, 1)),    # f2 and s1's stage 2: 45 x 8
    (BF16, 45, 128, (352, 1)),   # stage 3: 22 x 16
    (BF16, 11, 128, (96, 1)),    # stage 4: 5 x 16
    (BF16, 2, 8, (32, 1)),       # one lane
    (BF16, 95, 64, (384, 1)),    # 376 lanes
    (BF16, 96, 64, (384, 1)),    # 384: one full block
    (BF16, 98, 64, (224, 2)),    # 392: two slices of 196
    (F32, 91, 64, (384, 2)),     # 720: two slices of 360
    (F32, 98, 64, (288, 3)),     # 784: three slices of 262
])
def test_vec_plan(dtype, z, c, want):
    threads, slices = pool3d.vec_plan(dtype, z, c)
    assert (threads, slices) == want
    lanes = (z // 2) * c * dtype.itemsize // 16
    assert threads % 32 == 0 and threads <= pool3d.VEC_MAX_THREADS
    assert (slices - 1) * threads < lanes <= slices * threads


@pytest.mark.parametrize("shape,dtype,want", [
    ((6, 182, 218, 182, 32), BF16, 264),  # 59,514 rows: 264 blocks
    ((6, 91, 109, 91, 64), F32, 132),     # two slices: 132 blocks of rows
    ((1, 3, 5, 2, 8), BF16, 6),           # fewer rows than blocks
])
def test_bwd_blocks(shape, dtype, want):
    assert pool3d.bwd_blocks("vec", dtype, *shape) == want


def emulate_k7_vec(y, scale, shift, p, g, slope, mode, lanes, round_gi,
                   drop=None):
    """K7 "vec"'s d(scale), d(shift), in its order of float32 sums.

    Block i of `bwd_blocks` walks the extended pooled rows r = i, i +
    blocks, ... of (B, ceil(X/2), ceil(Y/2)); each thread owns the lanes
    (2zp + dz, c) and adds dpre * y and dpre into its registers row by row,
    within a row over (dx, dy); the rows on odd x or y tails add nothing.
    The block writes its sums as one partial row (zero on the odd z tail),
    and reduce_rows adds the partials: per lane (Z*C columns), or per
    channel over (block, z) rows. The kernel's fmaf is a multiply and an
    add here. dpre is the plain version's.

    `drop` leaves out terms a faulty kernel would miss: "window row" the
    (dx, dy) = (1, 1) row of every window, "last wave" the rows of the
    blocks' last pass over the grid."""
    b, X, Y, Z, C = y.shape
    Xp, Yp, Zp = X // 2, Y // 2, Z // 2
    Xq, Yq = (X + 1) // 2, (Y + 1) // 2
    s, sh = scale.reshape(-1, C), shift.reshape(-1, C)
    if s.shape[0] > 1:
        s, sh = s[:2 * Zp], sh[:2 * Zp]
    yf = y[:, :2 * Xp, :2 * Yp, :2 * Zp].float()
    pre = yf * s + sh
    window = (b, Xp, 2, Yp, 2, Zp, 2, C)
    gf = g.float()[:, :, None, :, None, :, None]
    if mode == "max":
        z = torch.where(pre >= 0, pre, slope * pre).to(y.dtype).float()
        eq = z.reshape(window) == p.float()[:, :, None, :, None, :, None]
        cnt = eq.sum(dim=(2, 4, 6), keepdim=True).float()
        gi = gf / cnt.clamp(min=1.0)
        if round_gi:
            gi = gi.to(y.dtype).float()
        dz = torch.where(eq, gi, torch.zeros(()))
    else:
        dz = (gf * 0.125).to(y.dtype).float().expand(window)
    dpre = torch.where(pre >= 0, dz.reshape(yf.shape),
                       dz.reshape(yf.shape) * slope)
    # (B, Xp, Yp, 4 window rows (dx, dy), Zp * 2 * C lanes) per term
    terms = [t.reshape(window).permute(0, 1, 3, 2, 4, 5, 6, 7)
             .reshape(b, Xp, Yp, 4, 2 * Zp * C) for t in (dpre * yf, dpre)]
    blocks = pool3d.bwd_blocks("vec", y.dtype, b, X, Y, Z, C)
    part = torch.zeros(2, blocks, Z * C)
    for k, t in enumerate(terms):
        ext = torch.zeros(b, Xq, Yq, 4, 2 * Zp * C)
        ext[:, :Xp, :Yp] = t
        ext = ext.reshape(b * Xq * Yq, 4, 2 * Zp * C)
        acc = torch.zeros(blocks, 2 * Zp * C)
        starts = range(0, ext.shape[0], blocks)
        if drop == "last wave":
            starts = starts[:-1]
        for r0 in starts:
            rows = ext[r0:r0 + blocks]
            for w in range(3 if drop == "window row" else 4):
                acc[:rows.shape[0]] = acc[:rows.shape[0]] + rows[:, w]
        part[k, :, :2 * Zp * C] = acc
    if lanes:
        return torch.stack([_reduce_rows(q) for q in part])
    return torch.stack([_reduce_rows(q.reshape(blocks * Z, C))
                        for q in part])


def _inputs(seed, shape, dtype, lanes, mode, ties=False, identity=False):
    """y, the affine, the plain forward's p and a pooled gradient, from a
    numpy seed; with `ties` y on a grid of 0.5 (tied window maxima)"""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(shape).astype(np.float32)
    if ties:
        y = np.round(2 * y) / 2
    n = shape[3] * shape[4] if lanes else shape[4]
    s = (1 + 0.5 * rng.standard_normal(n)).astype(np.float32)
    b = (0.3 * rng.standard_normal(n)).astype(np.float32)
    slope = 0.01
    if identity:
        s, b, slope = np.ones_like(s), np.zeros_like(b), 1.0
    y, s, b = torch.from_numpy(y).to(dtype), torch.from_numpy(s), \
        torch.from_numpy(b)
    p = pool3d.affine_act_pool_reference(y, s, b, slope, mode)
    g = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
        np.float32)).to(dtype)
    return y, s, b, p, g, slope


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,lanes,mode,ties,identity", [
    # more extended rows than the 264 blocks: several rows a thread
    ((4, 26, 34, 6, 16), True, "max", False, False),
    ((4, 26, 34, 6, 16), False, "max", False, False),
    ((4, 26, 34, 6, 16), False, "avg", False, False),
    # odd X, Y and Z tails together, and each alone
    ((3, 25, 35, 7, 8), True, "max", False, False),
    ((3, 25, 35, 7, 8), False, "avg", False, False),
    ((2, 27, 20, 4, 32), False, "max", False, False),
    ((2, 20, 27, 5, 32), True, "max", False, False),
    # many tied maxima: fused affine, and plain max pooling
    ((4, 24, 30, 6, 16), True, "max", True, False),
    ((4, 24, 30, 6, 16), False, "max", True, True),
])
def test_k7_vec_order_of_sums_meets_the_tolerance(shape, lanes, mode, ties,
                                                  identity, dtype):
    """Only the order of float32 sums differs from the plain version: the
    emulation lands within 1e-5 of the sums' largest magnitude (about
    4e-7 at these seeded inputs), far inside chip_smoke's 1e-4 / 1e-2. The
    emulation documents the kernel's order; the card's check holds the
    kernel itself."""
    y, s, b, p, g, slope = _inputs(0, shape, dtype, lanes, mode, ties,
                                   identity)
    round_gi = mode == "max" and (lanes or identity)
    _, ref = pool3d.affine_act_pool_bwd_reference(y, s, b, p, g, slope, mode,
                                                  round_gi)
    got = emulate_k7_vec(y, s, b, p, g, slope, mode, lanes, round_gi)
    assert got.shape == ref.shape
    if lanes and shape[3] % 2:  # the odd z tail's lanes are exactly zero
        assert not got.reshape(2, shape[3], -1)[:, -1].any()
    err = (got - ref).abs().max()
    assert err <= 1e-5 * ref.abs().max(), (err, ref.abs().max())
    assert err <= SUM_TOL[dtype] * ref.abs().max()
    if ties:  # the ties are there: some window splits its gradient
        dy, _ = pool3d.affine_act_pool_bwd_reference(y, s, b, p, g, slope,
                                                     mode, round_gi)
        hit = (dy != 0).reshape(shape[0], shape[1] // 2, 2, shape[2] // 2, 2,
                                shape[3] // 2, 2, shape[4])
        assert (hit.sum(dim=(2, 4, 6)) > 1).any()


@pytest.mark.parametrize("drop", ["window row", "last wave"])
@pytest.mark.parametrize("shape,lanes,mode", [
    ((4, 26, 34, 6, 16), False, "avg"),   # 884 rows: four passes
    ((2, 27, 20, 4, 32), False, "max"),   # 280 rows: the last pass of 16
])
def test_k7_vec_dropped_terms_miss_the_tolerance(shape, lanes, mode, drop):
    """The tolerance catches a kernel that misses terms: without one (dx,
    dy) row of every window, or without the rows of the blocks' last pass
    over the grid, the sums move by 0.14-0.6 of their largest magnitude at
    these seeded inputs, more than 5x even the bfloat16 tolerance."""
    y, s, b, p, g, slope = _inputs(0, shape, BF16, lanes, mode)
    _, ref = pool3d.affine_act_pool_bwd_reference(y, s, b, p, g, slope, mode,
                                                  False)
    got = emulate_k7_vec(y, s, b, p, g, slope, mode, lanes, False, drop)
    err = (got - ref).abs().max()
    assert err > 5 * SUM_TOL[BF16] * ref.abs().max(), (err, ref.abs().max())
