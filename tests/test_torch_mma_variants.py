"""The tensor-core variants of K2 (attention forward) and K8 (band conv) of
the PyTorch/CUDA port, as far as a CPU can hold them: which variant a CUDA
launch takes for which dtype and shape, and the arithmetic of K2 "mma",
emulated in plain PyTorch, against the float32 plain version at the
tolerance the card's check uses. The kernels themselves run only on a GPU
(`chip_smoke.py` phase 3, `tests/test_torch_package.py -m cuda`).
"""

import math

import numpy as np
import pytest
import torch

from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn import blocks
from transmf_ad_tpu_torch.ops import band_conv, flash_attention as fa

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
    (BF16, 16, "mma"), (BF16, 64, "mma"), (BF16, 128, "mma"),
    (BF16, 48, "rows"), (BF16, 24, "rows"), (BF16, 8, "rows"),
    (F32, 16, "rows"), (F32, 128, "rows"),
])
def test_attention_variant_by_dtype_and_head_dim(dtype, d, want):
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
