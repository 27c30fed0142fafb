"""K1 (the fusion head's token pool) of the PyTorch/CUDA port, as far as a
CPU can hold it: which variant a CUDA launch takes for which dtype and
width, how "cluster" splits the tokens, and its order of float32 sums and
maxima, emulated in plain PyTorch, against the plain version at the
tolerance the card's check uses. The kernel itself runs only on a GPU
(`chip_smoke.py` phase 3 and the `cuda` test below).
"""

import pytest
import torch

from transmf_ad_tpu_torch.ops import pooling

BF16, F32 = torch.bfloat16, torch.float32
# chip_smoke's "sums" tolerance of K1, elementwise: (rtol, atol)
TOL = {F32: (1e-4, 2e-5), BF16: (2.0 ** -7, 1e-4)}
# the fusion head's tokens at 182x218x182 (11 x 13 x 11) and at an odd count
SHAPES = [(6, 1573, 128), (6, 157, 128)]


def emulate_k1_cluster(mri, pet, trap=None):
    """K1 "cluster"'s arithmetic in float32, in its order: block `rank` of
    the CLUSTER_SIZE blocks of a batch row takes the tokens [rank * chunk,
    (rank + 1) * chunk); its row slot r adds the tokens n0 + r, n0 + r + R,
    ... in order (and takes their maxima); the block adds its R slots in
    slot order, the cluster its blocks in rank order; the sums are divided
    by N and everything is rounded once to the storage type.

    trap="padded count": the sums divided by the padded count
    CLUSTER_SIZE * chunk instead of N. trap="tail dropped": the tokens of
    the last chunk past a whole number of R rows are dropped."""
    b, n, d = mri.shape
    r, chunk = pooling.cluster_plan(mri.dtype, n, d)
    outs = []
    for x in (mri, pet):
        x = x.float()
        blocks = []
        for rank in range(pooling.CLUSTER_SIZE):
            n0, n1 = rank * chunk, min(n, (rank + 1) * chunk)
            if trap == "tail dropped" and n1 == n:
                n1 = n0 + (n1 - n0) // r * r
            part = x[:, n0:max(n0, n1)]
            steps = -(-part.shape[1] // r)
            pad = steps * r - part.shape[1]
            # (b, steps, r, d): slot r's tokens run down the `steps` axis;
            # the padding adds 0 to a sum and -inf to a maximum
            s = torch.cat([part, part.new_zeros(b, pad, d)], 1)
            m = torch.cat([part, part.new_full((b, pad, d), -torch.inf)], 1)
            s, m = s.view(b, steps, r, d), m.view(b, steps, r, d)
            acc = torch.zeros(b, r, d)
            best = torch.full((b, r, d), -torch.inf)
            for k in range(steps):
                acc = acc + s[:, k]
                best = torch.maximum(best, m[:, k])
            slot_sum, slot_max = acc[:, 0], best[:, 0]
            for j in range(1, r):
                slot_sum = slot_sum + acc[:, j]
                slot_max = torch.maximum(slot_max, best[:, j])
            blocks.append((slot_sum, slot_max))
        total, top = blocks[0]
        for s, m in blocks[1:]:
            total, top = total + s, torch.maximum(top, m)
        count = pooling.CLUSTER_SIZE * chunk if trap == "padded count" else n
        outs.append((total / count, top))
    (sm, mm), (sp, mp) = outs
    return torch.cat([sm, sp, mm, mp], dim=-1).to(mri.dtype)


def _tokens(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g).to(dtype)
                 for _ in range(2))


def _excess(out, ref, dtype):
    """max of |out - ref| / (atol + rtol |ref|): within the tolerance
    where <= 1"""
    rtol, atol = TOL[dtype]
    return float(((out.float() - ref.float()).abs()
                  / (atol + rtol * ref.float().abs())).max())


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_model_width_takes_cluster(dtype):
    """the fusion dim of every fusion model (128) in both dtypes"""
    assert pooling.variant(dtype, (8, 150, 128)) == "cluster"
    assert pooling.variant(dtype, (6, 1573, 128)) == "cluster"


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 128, "cluster"), (BF16, 32, "cluster"), (BF16, 48, "cluster"),
    (F32, 128, "cluster"), (F32, 32, "cluster"), (F32, 48, "cluster"),
    (F32, 12, "cluster"),
    (F32, 6, "column"),  # 24 bytes: not a whole number of 16-byte pieces
    (BF16, 12, "column"), (BF16, 4, "column"), (F32, 2, "column"),
    (BF16, 2048, "cluster"),  # 256 pieces: one row slot a block
    (BF16, 2056, "column"), (F32, 1024, "cluster"), (F32, 1028, "column"),
])
def test_variant_by_dtype_and_width(dtype, d, want):
    assert pooling.variant(dtype, (2, 5, d)) == want


@pytest.mark.parametrize("dtype,n,d,want", [
    (BF16, 1573, 128, (16, 197)),  # the full-resolution head
    (BF16, 150, 128, (16, 19)),
    (F32, 1573, 128, (8, 197)),
    (BF16, 157, 48, (42, 20)),  # 6 pieces a row: 252 of 256 threads
    (BF16, 5, 128, (16, 1)),  # three blocks with no token
    (BF16, 40, 2048, (1, 5)),
])
def test_cluster_plan(dtype, n, d, want):
    assert pooling.cluster_plan(dtype, n, d) == want


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", SHAPES + [(2, 5, 128), (3, 150, 48)])
def test_k1_cluster_order_meets_the_tolerance(shape, dtype):
    mri, pet = _tokens(shape, dtype)
    assert _excess(emulate_k1_cluster(mri, pet),
                   pooling.pool_reference(mri, pet), dtype) <= 1.0


@pytest.mark.parametrize("trap,shape,dtype", [
    ("padded count", (6, 1573, 128), F32),
    ("padded count", (6, 157, 128), F32),
    ("padded count", (6, 157, 128), BF16),
    ("tail dropped", (6, 1573, 128), F32),
    ("tail dropped", (6, 1573, 128), BF16),
    ("tail dropped", (6, 157, 128), F32),
    ("tail dropped", (6, 157, 128), BF16),
])
def test_k1_cluster_traps_miss(trap, shape, dtype):
    """the mistakes the design must avoid fail the same check: the mean
    over the padded count of the chunks (at 1,573 tokens in bfloat16 that
    is 0.2% and within one ulp: it shows in float32), and the last chunk's
    tokens past its whole groups of R rows dropped"""
    mri, pet = _tokens(shape, dtype)
    assert _excess(emulate_k1_cluster(mri, pet, trap),
                   pooling.pool_reference(mri, pet), dtype) > 1.0


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_k1_variants_on_cuda(cuda):
    """both variants against the plain version, "cluster" also against its
    emulation bit for bit, over the shapes of the models and the edges"""
    from transmf_ad_tpu_torch import _build

    for b, n, d in ((6, 1573, 128), (8, 150, 128), (3, 157, 128),
                    (2, 1, 128), (2, 5, 128), (3, 157, 48), (2, 33, 12),
                    (2, 20, 6), (1, 40, 2048)):
        for dtype in (F32, BF16):
            mri, pet = (torch.randn(b, n, d, generator=cuda,
                                    device="cuda").to(dtype)
                        for _ in range(2))
            ref = pooling.pool_reference(mri, pet)
            which = pooling.variant(dtype, mri.shape)
            pooling.TOKEN_POOL.reset()
            out = pooling.fused_token_pool(mri, pet)
            col = torch.empty_like(out)
            pooling.TOKEN_POOL.launch(
                mri.device, mri.data_ptr(), pet.data_ptr(), col.data_ptr(),
                b, n, d, _build.DTYPE_CODES[dtype], 0, variant="column")
            torch.cuda.synchronize()
            assert pooling.TOKEN_POOL.by_variant == (
                {which: 1, "column": 1} if which == "cluster"
                else {"column": 2})
            for o in (out, col):
                assert _excess(o, ref, dtype) <= 1.0, (b, n, d, dtype)
            if which == "cluster":
                emu = emulate_k1_cluster(mri.cpu(), pet.cpu())
                assert torch.equal(out.cpu(), emu), (b, n, d, dtype)
    misaligned = torch.randn(2 * 150 * 128 + 1, generator=cuda,
                             device="cuda").bfloat16()[1:].view(2, 150, 128)
    with pytest.raises(ValueError, match="aligned"):
        pooling.fused_token_pool(misaligned, misaligned)
