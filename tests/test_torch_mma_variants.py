"""The tensor-core variants of K2 (attention forward), K3 / K5 (stem conv,
with its BatchNorm sums), K6 (stem weight gradient), K8 (band conv), K9
(its weight gradient), K10 (flash forward), K11 (flash dq) and K12 (flash
dk, dv) of the PyTorch/CUDA port, as far as a CPU can hold them: which
variant a CUDA launch takes for which dtype and shape, and the arithmetic of
K2, K5, K6, K9, K10, K11 and K12 "mma", emulated in plain PyTorch, against
the float32 plain versions at the tolerances the card's check uses. The
kernels themselves run only on a GPU (`chip_smoke.py` phase 3,
`tests/test_torch_package.py -m cuda`).
"""

import math

import numpy as np
import pytest
import torch

from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn import blocks
from transmf_ad_tpu_torch.ops import band_conv, flash_attention as fa, stem

BF16, F32 = torch.bfloat16, torch.float32
FULL_VOLUME = (182, 218, 182)
CHUNK = 64  # keys per shared-memory chunk of K2 "mma"
RTOL, ATOL = 2.0 ** -7, 1e-4  # chip_smoke's tolerance for K2 in bfloat16


def _band_channels(dim=128):
    """(Cin, Cout) of every 3x3x3 body conv of a full-width encoder that a
    182x218x182 input sends through K8, and of its input gradient (K8 on
    the flipped weights, Cin and Cout swapped)."""
    voxels = math.prod(FULL_VOLUME)
    pairs = set()
    for _, _, _, (cin, cout), kernel, pool in blocks._PLAN:
        if kernel == 3 and cin > 0 and voxels >= blocks.BAND_MIN_VOXELS:
            pairs |= {(cin * dim // 4, cout * dim // 4),
                      (cout * dim // 4, cin * dim // 4)}
        if pool is not None:
            voxels //= 8
    return sorted(pairs)


def test_full_resolution_body_convs_are_known():
    assert _band_channels() == [(32, 32), (32, 64), (64, 32)]


@pytest.mark.parametrize("cin,cout", _band_channels())
def test_band_variant_full_width_bf16_is_mma(cin, cout):
    assert band_conv.variant(BF16, cin, cout) == "mma"
    assert band_conv.variant(F32, cin, cout) == "direct"


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (BF16, 3, 5, "direct"),      # odd channel counts
    (BF16, 40, 70, "direct"),    # Cin off the MMA's depth of 16
    (BF16, 32, 12, "direct"),    # Cout off the 8-channel output tile
    (BF16, 256, 64, "direct"),   # the ring of halos would not fit
    (BF16, 16, 8, "mma"),
    (BF16, 64, 64, "mma"),
    (BF16, 128, 128, "mma"),
    (F32, 128, 128, "direct"),
])
def test_band_variant_by_dtype_and_channels(dtype, cin, cout, want):
    assert band_conv.variant(dtype, cin, cout) == want
    assert want in band_conv.VARIANTS


def test_attention_variant_full_width_bf16_is_mma():
    """Every attention call of the full-width models has the head dim of
    their CrossTransformer blocks."""
    for name in ("ad", "transformer_res"):
        dims = {m.dim_head for m in build_model(name).modules()
                if hasattr(m, "dim_head")}
        assert dims == {32}, name
        for d in dims:
            assert fa.attention_variant(BF16, d) == "mma"
            assert fa.attention_variant(F32, d) == "rows"


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 16, "mma"), (BF16, 32, "mma"), (BF16, 64, "mma"),
    (BF16, 128, "mma"), (BF16, 48, "rows"), (BF16, 24, "rows"),
    (BF16, 8, "rows"), (F32, 16, "rows"), (F32, 32, "rows"),
    (F32, 128, "rows"),
])
def test_attention_variant_by_dtype_and_head_dim(dtype, d, want):
    """The rule of K2 and of K10, which takes K2's variants."""
    assert fa.attention_variant(dtype, d) == want
    assert want in fa.ATTENTION_VARIANTS


def _qkv(seed, bh, n, m, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((1, bh, rows, d), dtype=np.float32)).to(BF16)
        for rows in (n, m, m))


def _bf16(t):
    return t.to(BF16).float()


def emulate_k2_mma(q, k, v, scale, split=True):
    """K2 "mma" in plain PyTorch: bfloat16 q, k, v; float32 scores in chunks
    of 64 keys with an online softmax in base 2 (scale * log2(e) applied
    before the maximum); the row sum from the float32 p; p into the p v
    product as hi = bf16(p) plus, with `split`, lo = bf16(p - hi); float32
    accumulation; one division and one rounding."""
    qf, kf, vf = q.float(), k.float(), v.float()
    c = scale * math.log2(math.e)
    m_run = torch.full(q.shape[:-1], -math.inf)
    l_run = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], CHUNK):
        s = torch.matmul(qf, kf[..., k0:k0 + CHUNK, :].transpose(-1, -2)) * c
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp2(m_run - m_new)
        p = torch.exp2(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        hi = _bf16(p)
        pv = torch.matmul(hi, vf[..., k0:k0 + CHUNK, :])
        if split:
            pv = pv + torch.matmul(_bf16(p - hi), vf[..., k0:k0 + CHUNK, :])
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    return (acc / l_run[..., None]).to(q.dtype)


def _misses(out, ref):
    """Elements outside |out - ref| <= ATOL + RTOL |ref|, and the worst
    error as a multiple of that tolerance."""
    err = (out.float() - ref.float()).abs()
    tol = ATOL + RTOL * ref.float().abs()
    return int((err > tol).sum()), float((err / tol).max())


SHAPES = [(2, 1573, 1573, 32), (4, 150, 150, 32)]


@pytest.mark.parametrize("bh,n,m,d", SHAPES)
def test_k2_mma_arithmetic_meets_the_tolerance(bh, n, m, d):
    """The kernel's arithmetic, P split in two bfloat16 fragments, against
    the float32 plain version at chip_smoke's bfloat16 tolerance."""
    q, k, v = _qkv(11, bh, n, m, d)
    ref = fa.attention_reference(q, k, v, d ** -0.5)
    missed, worst = _misses(emulate_k2_mma(q, k, v, d ** -0.5), ref)
    assert missed == 0, (missed, worst)
    assert worst < 1.0


@pytest.mark.parametrize("bh,n,m,d", SHAPES)
def test_k2_single_bf16_p_misses_the_tolerance(bh, n, m, d):
    """Why P is split: with one bfloat16 P fragment (as a library attention
    rounds it) each of the M terms of p v carries up to 2^-9 relative error,
    and the output misses the one-ulp tolerance. Measured with these seeded
    inputs: 891 of 100,672 elements at (2, 1573, 1573, 32), worst 2.35x the
    tolerance, and 1,026 of 19,200 at (4, 150, 150, 32), worst 5.35x; the
    split version misses none (worst 0.71x and 0.86x)."""
    q, k, v = _qkv(11, bh, n, m, d)
    ref = fa.attention_reference(q, k, v, d ** -0.5)
    missed, worst = _misses(emulate_k2_mma(q, k, v, d ** -0.5, split=False),
                            ref)
    assert missed > 0.005 * ref.numel(), (missed, worst)
    assert worst > 2.0


@pytest.mark.parametrize("cin,cout", _band_channels())
def test_dw_variant_full_width_bf16_is_mma(cin, cout):
    assert band_conv.dw_variant(BF16, cin, cout) == "mma"
    assert band_conv.dw_variant(F32, cin, cout) == "direct"


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (BF16, 3, 5, "direct"),      # odd channel counts
    (BF16, 40, 64, "direct"),    # Cin off the MMA's m16
    (BF16, 32, 12, "direct"),    # Cout off the n8
    (BF16, 16, 8, "mma"),
    (BF16, 64, 64, "mma"),
    (BF16, 128, 128, "mma"),
    (BF16, 256, 64, "mma"),      # input channels split over blocks
    (F32, 64, 64, "direct"),
])
def test_dw_variant_by_dtype_and_channels(dtype, cin, cout, want):
    assert band_conv.dw_variant(dtype, cin, cout) == want
    assert want in band_conv.DW_VARIANTS


def emulate_k10_mma(q, k, v, scale):
    """K10 "mma" in plain PyTorch: K2 "mma"'s arithmetic (scores in the
    log2 domain, chunks of 64 keys, P as hi + lo bfloat16), and the
    logsumexp of each row taken from the log2-domain maximum m and sum l
    as (m + log2(l)) * ln(2), all in float32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    c = torch.tensor(scale * math.log2(math.e), dtype=F32)
    m_run = torch.full(q.shape[:-1], -math.inf)
    l_run = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], CHUNK):
        s = torch.matmul(qf, kf[..., k0:k0 + CHUNK, :].transpose(-1, -2)) * c
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp2(m_run - m_new)
        p = torch.exp2(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        hi = _bf16(p)
        pv = (torch.matmul(hi, vf[..., k0:k0 + CHUNK, :])
              + torch.matmul(_bf16(p - hi), vf[..., k0:k0 + CHUNK, :]))
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    lse = (m_run + torch.log2(l_run)) * torch.tensor(math.log(2.0), dtype=F32)
    return (acc / l_run[..., None]).to(q.dtype), lse


@pytest.mark.parametrize("m", [150, 1573, 3146])
def test_k10_mma_arithmetic_meets_the_tolerance(m):
    """The kernel's arithmetic against `flash_fwd_reference` at chip_smoke's
    bfloat16 tolerances for K10: the output within 1e-4 of its scale plus
    one ulp, the float32 logsumexp (values near 5-9) within 1e-5 absolute,
    which the conversion from the log2 domain has to keep to a few ulps."""
    q, k, v = _qkv(13, 2, 300, m, 32)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, 32 ** -0.5)
    out, lse = emulate_k10_mma(q, k, v, 32 ** -0.5)
    err = (out.float() - ref.float()).abs()
    tol = 1e-4 * float(ref.float().abs().max()) + RTOL * ref.float().abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    assert float((lse - ref_lse).abs().max()) <= 1e-5
    assert float(ref_lse.min()) > 4.0


K9_TILE = (16, 16)  # (Y, Z) voxels of a K9 "mma" tile


def _reduce_rows(part):
    """reduce_rows' order: 32 thread rows each add the rows r, r + 32, ...
    in turn, then the 32 row sums are added in turn; float32."""
    sums = []
    for r0 in range(32):
        s = torch.zeros(part.shape[1:])
        for r in range(r0, part.shape[0], 32):
            s = s + part[r]
        sums.append(s)
    out = torch.zeros(part.shape[1:])
    for s in sums:
        out = out + s
    return out


def emulate_k9_mma(x, gy, y, a, b2, segs):
    """K9 "mma"'s split of the contraction: columns of 16 x 16 voxel tiles,
    each cut into `segs` segments along x, one row of float32 partials a
    column segment; per output plane of the segment and per tap the
    (Cin, 16 voxels) x (16 voxels, Cout) products of bfloat16 values (exact
    in float32) added to the row in float32; then the rows added in
    reduce_rows' fixed order. yhat is assembled with the kernel's rounding
    and is zero outside the volume."""
    B, X, Y, Z, cin = x.shape
    cout = gy.shape[-1]
    ty, tz = K9_TILE
    nyt, nzt = -(-Y // ty), -(-Z // tz)
    seg_len = -(-X // segs)
    yh = band_conv._yhat(y, gy, a, b2).float()
    yh = torch.nn.functional.pad(yh, (0, 0, 0, nzt * tz - Z, 0, nyt * ty - Y))
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, nzt * tz - Z + 1,
                                             1, nyt * ty - Y + 1, 1, 1))
    part = torch.zeros(B * segs * nyt * nzt, 27, cin, cout)
    for row in range(part.shape[0]):
        zt, yt = row % nzt, (row // nzt) % nyt
        seg, b = (row // (nzt * nyt)) % segs, row // (nzt * nyt * segs)
        y0, z0 = yt * ty, zt * tz
        for xx in range(seg * seg_len, min(X, (seg + 1) * seg_len)):
            tile = yh[b, xx, y0:y0 + ty, z0:z0 + tz].reshape(-1, cout)
            for tap in range(27):
                dx, dy, dz = tap // 9, (tap // 3) % 3, tap % 3
                xs = xp[b, xx + dx, y0 + dy:y0 + dy + ty,
                        z0 + dz:z0 + dz + tz]
                part[row, tap] += xs.reshape(-1, cin).T @ tile
    return _reduce_rows(part.reshape(part.shape[0], -1)).reshape(
        3, 3, 3, cin, cout)


@pytest.mark.parametrize("with_ab", [True, False])
def test_k9_mma_split_order_meets_the_tolerance(with_ab):
    """The kernel's order of sums against `band_dw_reference`: within
    chip_smoke's bfloat16 tolerance for dw (1e-2 of the largest magnitude)
    and in fact within 1e-5 of it, since bfloat16 products are exact in
    float32 and only the order of the float32 sums differs."""
    rng = np.random.default_rng(17)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    x, gy, y = (draw(2, 3, 17, 18, 16).to(BF16),
                draw(2, 3, 17, 18, 8).to(BF16), draw(2, 3, 17, 18, 8).to(BF16))
    a, b2 = draw(8), 0.1 * draw(8)
    if not with_ab:
        a, b2, y = torch.zeros(8), torch.zeros(8), torch.zeros_like(y)
    ref = (band_conv.band_dw_reference(x, gy, y, a, b2) if with_ab
           else band_conv.band_dw_reference(x, gy))
    out = emulate_k9_mma(x, gy, y, a, b2, segs=2)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= 1e-2 * scale
    assert err <= 1e-5 * scale, err / scale


K6_TILE = (16, 16)  # (Y, Z) voxels of a K6 (and K3 / K5) "mma" tile
K6_WARPS = 8  # warp w of a block takes tile rows w and w + 8


def _mma_tap(m):
    """stem_conv.cu's mma_tap: row m of the tap axis -> its tap, or -1 (a
    zero row): dx in groups of eight (dy, dz), the three (dx, 2, 2) and
    five zero rows last."""
    group, j = divmod(m, 8)
    if group < 3:
        return 9 * group + j
    return 9 * j + 8 if j < 3 else -1


def _stem_channels(name):
    """Output channels of the single-channel stem convs of a full-width
    model: the C of its K6 launches."""
    return {m.out_channels for m in build_model(name).modules()
            if isinstance(m, torch.nn.Conv3d) and m.in_channels == 1}


@pytest.mark.parametrize("name", ["ad", "transformer_res"])
def test_stem_dw_variant_full_width_bf16_is_mma(name):
    assert _stem_channels(name) == {32}
    assert stem.dw_variant(BF16, 32) == "mma"
    assert stem.dw_variant(F32, 32) == "direct"


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 16, "mma"), (BF16, 32, "mma"), (BF16, 48, "mma"),
    (BF16, 64, "mma"),
    (BF16, 8, "direct"),      # half an n-tile pair
    (BF16, 24, "direct"),     # off the multiple of 16
    (BF16, 128, "direct"),    # more sums than a thread keeps
    (F32, 32, "direct"), (F32, 64, "direct"),
])
def test_stem_dw_variant_by_dtype_and_channels(dtype, c, want):
    assert stem.dw_variant(dtype, c) == want
    assert want in stem.DW_VARIANTS


def emulate_k6_mma(x, y, gy, a, b2, segs, zero_outside=True):
    """K6 "mma"'s split of the contraction: columns of 16 x 16 (y, z) voxel
    tiles, each cut into `segs` segments along x, one row of float32
    partials a column segment. Warp w of the block sums, per plane of the
    segment, the products of tile rows w and w + 8: (27 taps, 16 voxels) x
    (16 voxels, C) of bfloat16 values, exact in float32; the block adds its
    warps in order, then reduce_rows adds the rows in its fixed order. yhat
    is assembled with the kernel's rounding and is zero outside the volume;
    `zero_outside=False` leaves round(a) there, as the tile's padding would
    hold without the kernel's mask."""
    B, X, Y, Z = x.shape
    c = y.shape[-1]
    ty, tz = K6_TILE
    nyt, nzt = -(-Y // ty), -(-Z // tz)
    py, pz = nyt * ty - Y, nzt * tz - Z
    seg_len = -(-X // segs)
    pad = torch.nn.functional.pad
    if zero_outside:
        yh = pad(stem._yhat(y, gy, a, b2).float(), (0, 0, 0, pz, 0, py))
    else:
        yh = stem._yhat(pad(y, (0, 0, 0, pz, 0, py)),
                        pad(gy, (0, 0, 0, pz, 0, py)), a, b2).float()
    xp = pad(x.float(), (1, pz + 1, 1, py + 1, 1, 1))
    part = torch.zeros(B * segs * nyt * nzt, 27, c)
    for row in range(part.shape[0]):
        zt, yt = row % nzt, (row // nzt) % nyt
        seg, b = (row // (nzt * nyt)) % segs, row // (nzt * nyt * segs)
        y0, z0 = yt * ty, zt * tz
        warps = torch.zeros(K6_WARPS, 27, c)
        for xx in range(seg * seg_len, min(X, (seg + 1) * seg_len)):
            taps = torch.stack([
                xp[b, xx + t // 9, y0 + (t // 3) % 3:y0 + (t // 3) % 3 + ty,
                   z0 + t % 3:z0 + t % 3 + tz] for t in range(27)])
            tile = yh[b, xx, y0:y0 + ty, z0:z0 + tz]  # (rows, voxels, C)
            prods = torch.einsum("trk,rkc->rtc", taps, tile)
            for w in range(K6_WARPS):
                for r in range(w, ty, K6_WARPS):
                    warps[w] += prods[r]
        for w in range(K6_WARPS):
            part[row] += warps[w]
    return _reduce_rows(part.reshape(part.shape[0], -1)).reshape(3, 3, 3, c)


def _stem_dw_inputs(seed, shape=(2, 3, 17, 18), c=32):
    """bfloat16 x, y, gy and float32 a, b2 on a volume whose Y and Z are
    not multiples of the 16 x 16 tile."""
    rng = np.random.default_rng(seed)

    def draw(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32))

    return (draw(*shape).to(BF16), draw(*shape, c).to(BF16),
            draw(*shape, c).to(BF16), draw(c), 0.1 * draw(c))


@pytest.mark.parametrize("with_ab", [True, False])
def test_k6_mma_split_order_meets_the_tolerance(with_ab):
    """The kernel's order of sums against `stem_dw_reference`: within
    chip_smoke's bfloat16 tolerance for dw (1e-2 of the largest magnitude)
    and in fact within 1e-5 of it, since bfloat16 products are exact in
    float32 and only the order of the float32 sums differs."""
    x, y, gy, a, b2 = _stem_dw_inputs(23)
    if not with_ab:
        a, b2 = torch.zeros_like(a), torch.zeros_like(b2)
    ref = stem.stem_dw_reference(x, y, gy, a, b2)
    out = emulate_k6_mma(x, y, gy, a, b2, segs=2)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= 1e-2 * scale
    assert err <= 1e-5 * scale, err / scale


def test_k6_round_a_in_the_padding_misses_the_tolerance():
    """yhat must be zero outside the volume: round(a) is not, and left in
    the padding of the tiles it moves dw far past the bfloat16 tolerance
    (1e-2 of the largest magnitude)."""
    x, y, gy, a, b2 = _stem_dw_inputs(23)
    ref = stem.stem_dw_reference(x, y, gy, a, b2)
    out = emulate_k6_mma(x, y, gy, a, b2, segs=2, zero_outside=False)
    assert float((out - ref).abs().max()) > 1e-2 * float(ref.abs().max())


@pytest.mark.parametrize("name", ["ad", "transformer_res"])
def test_stem_conv_variant_full_width_bf16_is_mma(name):
    """Every full-width model's stem (C = 32) takes K3 / K5 "mma" in
    bfloat16 and "direct" in float32."""
    for c in _stem_channels(name):
        assert stem.conv_variant(BF16, c) == "mma"
        assert stem.conv_variant(F32, c) == "direct"


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 16, "mma"), (BF16, 32, "mma"), (BF16, 48, "mma"),
    (BF16, 64, "mma"),
    (BF16, 24, "direct"),     # off the multiple of 16
    (BF16, 72, "direct"),     # more than a thread's registers hold
    (F32, 16, "direct"), (F32, 24, "direct"), (F32, 32, "direct"),
    (F32, 48, "direct"), (F32, 64, "direct"), (F32, 72, "direct"),
])
def test_stem_conv_variant_by_dtype_and_channels(dtype, c, want):
    assert stem.conv_variant(dtype, c) == want
    assert want in stem.CONV_VARIANTS


K5_TAPS = [_mma_tap(m) for m in range(32)]  # the product's K, padded
K5_TILE = (32, 16)  # (Y, Z) voxels of a K3 / K5 "mma" tile


def emulate_k5_mma(x, w, segs, tail_in_sums=False):
    """K3 / K5 "mma" in plain PyTorch: (y, (2, C) sums). Per tile row, 16
    z voxels x 32 taps in mma_tap order (rows 27-31 zero in A and B) times
    32 taps x C, bfloat16 products exact in float32 and float32 sums; y is
    that float32 value rounded once. The sums follow the kernel: columns of
    32 x 16 (y, z) tiles cut into `segs` segments along x; thread (warp w,
    lane group g, channel) adds, plane by plane, tile rows w, w + 8, w + 16
    and w + 24, voxels g and g + 8, of the voxels inside the volume (sum,
    and the square by a fused multiply-add, emulated in float64 and rounded
    once);
    the eight g add in a butterfly, the warps in order, then reduce_rows
    adds the column segments in its fixed order. `tail_in_sums` also adds
    the tiles' voxels past Y and Z, which are not zero: their neighbours in
    the volume are not."""
    B, X, Y, Z = x.shape
    c = w.shape[-1]
    ty, tz = K5_TILE
    nyt, nzt = -(-Y // ty), -(-Z // tz)
    yp, zp = nyt * ty, nzt * tz
    seg_len = -(-X // segs)
    segs = -(-X // seg_len)
    xp = torch.nn.functional.pad(x.float(), (1, zp - Z + 1, 1, yp - Y + 1,
                                             1, 1))
    zero = torch.zeros(B, X, yp, zp)
    a = torch.stack([zero if t < 0 else
                     xp[:, t // 9:t // 9 + X, (t // 3) % 3:(t // 3) % 3 + yp,
                        t % 3:t % 3 + zp] for t in K5_TAPS])
    wt = w.float().reshape(27, c)
    b = torch.stack([torch.zeros(c) if t < 0 else wt[t] for t in K5_TAPS])
    acc = torch.einsum("kbxyz,kc->bxyzc", a, b)
    inside = torch.zeros(yp, zp, dtype=torch.bool)
    inside[:Y, :Z] = True
    if tail_in_sums:
        inside[:] = True
    vals = acc.reshape(B, X, nyt, ty, nzt, tz, c)
    mask = inside.reshape(nyt, ty, nzt, tz)
    s = torch.zeros(B, segs, nyt, nzt, K6_WARPS, 8, c)
    sq = torch.zeros_like(s)
    for xx in range(X):
        seg = xx // seg_len
        for i in range(ty // K6_WARPS):  # tile row r = warp + 8 i
            rows = slice(K6_WARPS * i, K6_WARPS * (i + 1))
            for hv in range(2):  # voxel g + 8 hv
                vox = slice(8 * hv, 8 * hv + 8)
                v = vals[:, xx, :, rows, :, vox].permute(0, 1, 3, 2, 4, 5)
                m = mask[:, rows, :, vox].permute(0, 2, 1, 3)[..., None]
                v = torch.where(m, v, torch.zeros(()))
                s[:, seg] = s[:, seg] + v
                sq[:, seg] = (sq[:, seg].double() + v.double() ** 2).float()
    out = []
    for t in (s, sq):
        for lanes in (1, 2, 4):  # shuffles xor 4, 8, 16: g xor 1, 2, 4
            t = t + t[..., [g ^ lanes for g in range(8)], :]
        warps = torch.zeros(t.shape[:4] + (c,))
        for w_ in range(K6_WARPS):
            warps = warps + t[:, :, :, :, w_, 0]
        out.append(_reduce_rows(warps.reshape(-1, c)))
    return acc[:, :, :Y, :Z].to(x.dtype), torch.stack(out)


def _stem_inputs(seed, shape, c):
    """bfloat16 x and weights as chip_smoke draws them: N(0, 1) and
    0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    w = 0.2 * torch.from_numpy(rng.standard_normal((3, 3, 3, c),
                                                   dtype=np.float32))
    return x.to(BF16), w.to(BF16)


def _stem_misses(y, st, ref_y, ref_st):
    """chip_smoke's bfloat16 tolerances for K3 / K5: y within one ulp
    (2^-7 relative) plus 1e-3, the sums within 1e-2 of their largest
    magnitude. Returns y's elements outside it, and the sums' error as a
    multiple of their tolerance."""
    err = (y.float() - ref_y.float()).abs()
    missed = int((err > 1e-3 + RTOL * ref_y.float().abs()).sum())
    return missed, float((st - ref_st).abs().max()
                         / (1e-2 * ref_st.abs().max()))


@pytest.mark.parametrize("shape,c,segs", [
    ((2, 3, 17, 18), 32, 2),   # a partial tile along y, Z two past a tile
    ((1, 1, 9, 21), 16, 1),    # one plane
    ((1, 5, 33, 31), 48, 3),   # Y one past a tile, Z one below two, 3 segments
    ((1, 2, 32, 16), 64, 1),   # Y and Z at a tile
])
def test_k5_mma_arithmetic_meets_the_tolerance(shape, c, segs):
    """The kernel's arithmetic against `_stem_stats_reference`: y within
    one bfloat16 ulp (only the order of the float32 sum of 27 exact
    products differs before the one rounding) and the sums within 1e-5 of
    their largest magnitude, far inside chip_smoke's 1e-2."""
    x, w = _stem_inputs(29, shape, c)
    ref_y, ref_st = stem._stem_stats_reference(x, w)
    y, st = emulate_k5_mma(x, w, segs)
    missed, sums = _stem_misses(y, st, ref_y, ref_st)
    assert missed == 0 and sums < 1e-3, (missed, sums)


def test_k5_tail_voxels_in_the_sums_miss_the_tolerance():
    """The sums take the voxels inside the volume only: a tile's voxels
    past Y and Z are not zero, since their neighbours inside are not.
    Added, at (2, 3, 17, 18) with 32 channels (the rows y = 17 and the
    columns z = 18, whose taps reach 9 of 27 neighbours inside) they move
    the sums of squares by about (1/17 + 1/18) / 3 of their size: 3.7x the
    1e-2 tolerance with these seeded inputs, while y stays within its own
    (the emulation without them: 1.1e-5x)."""
    x, w = _stem_inputs(29, (2, 3, 17, 18), 32)
    ref_y, ref_st = stem._stem_stats_reference(x, w)
    y, st = emulate_k5_mma(x, w, segs=2, tail_in_sums=True)
    missed, sums = _stem_misses(y, st, ref_y, ref_st)
    assert missed == 0
    assert sums > 2.0, sums


def test_flash_bwd_variant_full_width_bf16_is_mma():
    """The backward of every flash call of the full-width models (head dim
    32) takes the tensor cores in bfloat16 and the CUDA cores in float32."""
    for name in ("ad", "transformer_res"):
        for d in {m.dim_head for m in build_model(name).modules()
                  if hasattr(m, "dim_head")}:
            assert fa.flash_bwd_variant(BF16, d) == "mma"
            assert fa.flash_bwd_variant(F32, d) == "rows"


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 16, "mma"), (BF16, 32, "mma"), (BF16, 64, "mma"),
    (BF16, 128, "rows"), (BF16, 48, "rows"), (BF16, 24, "rows"),
    (F32, 16, "rows"), (F32, 32, "rows"), (F32, 64, "rows"),
])
def test_flash_bwd_variant_by_dtype_and_head_dim(dtype, d, want):
    """The rule of K11 and K12: K2's head dims but 128, whose accumulators
    and score tiles K12 could not keep in registers."""
    assert fa.flash_bwd_variant(dtype, d) == want
    assert want in fa.ATTENTION_VARIANTS


def _bwd_inputs(seed, bh, n, m, d):
    """bfloat16 q, k, v, an output gradient g, and the plain forward's
    logsumexp and delta = rowsum(g * out), as chip_smoke builds them."""
    q, k, v = _qkv(seed, bh, n, m, d)
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)
                         ).to(BF16)
    out, lse = fa.flash_fwd_reference(q, k, v, d ** -0.5)
    return q, k, v, g, lse, fa.flash_delta(out, g), d ** -0.5


def _product(a, b, split):
    """a b with the float32 a as bfloat16 fragments: hi = bf16(a), plus
    lo = bf16(a - hi) with `split`; b is bfloat16 already; float32 sums."""
    hi = _bf16(a)
    out = torch.matmul(hi, b)
    if split:
        out = out + torch.matmul(_bf16(a - hi), b)
    return out


def _log2_domain(scale, lse):
    """scale * log2(e) and lse * log2(e) in float32, as the kernels take
    them (once a row or a column)."""
    log2e = torch.tensor(math.log2(math.e), dtype=F32)
    return torch.tensor(scale, dtype=F32) * log2e, lse * log2e


def emulate_k11_mma(q, k, v, g, lse, delta, scale, split=True):
    """K11 "mma" in plain PyTorch: chunks of 64 keys; s = q k^T and dp =
    g v^T of bfloat16 values (exact in float32); p = exp2(s * scale *
    log2(e) - lse * log2(e)); ds = p (dp - delta) in float32; dq += ds k with
    ds as hi + lo bfloat16 (a single bf16 ds without `split`); dq * scale
    rounded once."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    c, lse2 = _log2_domain(scale, lse)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], CHUNK):
        kc, vc = kf[..., k0:k0 + CHUNK, :], vf[..., k0:k0 + CHUNK, :]
        s = torch.matmul(qf, kc.transpose(-1, -2))
        dp = torch.matmul(gf, vc.transpose(-1, -2))
        p = torch.exp2(s * c - lse2[..., None])
        acc = acc + _product(p * (dp - delta[..., None]), kc, split)
    return (acc * scale).to(q.dtype)


def emulate_k12_mma(q, k, v, g, lse, delta, scale, split_p=True,
                    split_ds=True):
    """K12 "mma" in plain PyTorch: the transposed products over chunks of 64
    queries; s^T = k q^T, dp^T = v g^T; p^T and ds^T in float32 with the
    chunk's lse and delta by column; dv += p^T g and dk += ds^T q with p^T
    and ds^T as hi + lo bfloat16 (single bf16 without `split_p` /
    `split_ds`); dk * scale and dv rounded once."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    c, lse2 = _log2_domain(scale, lse)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, q.shape[-2], CHUNK):
        cols = slice(q0, q0 + CHUNK)
        qc, gc = qf[..., cols, :], gf[..., cols, :]
        st = torch.matmul(kf, qc.transpose(-1, -2))
        dpt = torch.matmul(vf, gc.transpose(-1, -2))
        pt = torch.exp2(st * c - lse2[..., None, cols])
        dst = pt * (dpt - delta[..., None, cols])
        dv = dv + _product(pt, gc, split_p)
        dk = dk + _product(dst, qc, split_ds)
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _flash_misses(out, ref):
    """chip_smoke's bfloat16 tolerance for K10-K12, 1e-4 of the output's
    scale plus one ulp: the elements outside it and the worst error as a
    multiple of it."""
    err = (out.float() - ref.float()).abs()
    tol = 1e-4 * float(ref.float().abs().max()) + RTOL * ref.float().abs()
    return int((err > tol).sum()), float((err / tol).max())


BWD_KEYS = [150, 1573, 3146]  # 300 queries: partial chunks on both axes


@pytest.mark.parametrize("m", BWD_KEYS)
def test_k11_k12_mma_arithmetic_meets_the_tolerance(m):
    """The kernels' arithmetic, P and dS each as hi + lo bfloat16, against
    `flash_dq_reference` / `flash_dkv_reference` at chip_smoke's bfloat16
    tolerance for K11 and K12."""
    args = _bwd_inputs(19, 2, 300, m, 32)
    dk, dv = emulate_k12_mma(*args)
    for name, out, ref in (
            ("dq", emulate_k11_mma(*args), fa.flash_dq_reference(*args)),
            *zip(("dk", "dv"), (dk, dv), fa.flash_dkv_reference(*args))):
        missed, worst = _flash_misses(out, ref)
        assert missed == 0 and worst < 1.0, (name, missed, worst)


@pytest.mark.parametrize("m", BWD_KEYS)
def test_k11_k12_single_bf16_p_or_ds_misses_the_tolerance(m):
    """Why P and dS are split: with one bfloat16 fragment each term of a
    product carries up to 2^-9 relative error. Measured with these seeded
    inputs (2, 300 queries, m keys, 32), elements missed and the worst error
    as a multiple of the tolerance: dq with a single dS 1,339 of 19,200 at
    150 keys (worst 6.3x), 1,760 (9.6x) at 1,573, 1,798 (9.2x) at 3,146; dk
    with a single dS 685 of 9,600 (7.5x), 4,123 of 100,672 (6.7x), 4,990 of
    201,344 (5.6x); dv with a single P 714 of 9,600 (5.7x), 5,170 of 100,672
    (6.2x), 10,121 of 201,344 (7.6x). The split versions miss none (worst
    0.64-0.88x)."""
    args = _bwd_inputs(19, 2, 300, m, 32)
    dk, dv = emulate_k12_mma(*args, split_p=False, split_ds=False)
    for name, out, ref in (
            ("dq", emulate_k11_mma(*args, split=False),
             fa.flash_dq_reference(*args)),
            *zip(("dk", "dv"), (dk, dv), fa.flash_dkv_reference(*args))):
        missed, worst = _flash_misses(out, ref)
        assert missed > 0.005 * ref.numel() and worst > 2.0, \
            (name, missed, worst)
