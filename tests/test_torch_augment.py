"""The train step's augmentation of a batch (`data/transforms.py::
augment_batch`) and kernel K13 (`csrc/augment.cu`), which runs it on the
card from the step's uniforms without a host read. No jax: the `cuda`
tests run on the card with

    python -m pytest tests/test_torch_augment.py --noconftest -m cuda -q

On the CPU:
- the batched plain path on given uniforms is `draw_params` followed by
  `augment` a sample at a time, and consumes the generator as it does;
- `decode` takes Python's branch at the thresholds (double precision:
  float32(0.3) is above 0.3);
- `emulate_k13`, K13's arithmetic in plain PyTorch (the 8-tap gather mixed
  in the passes' order, two-tap shears, every operation rounded), meets the
  plain dense-matrix version within 1e-5 of the volume's largest value,
  and two wrong orders of the rotation miss it (the traps);
- a meta tensor raises.
On the card: the variant rule by shape, which the kernel library owns; K13
against the plain version (on the CPU) on the same uniforms and against the
emulation bit for bit, in float32 and bfloat16, in both variants; a train
step launches K13 once, records no `sync` span and no `host_syncs`, and
leaves the generator where the plain path leaves it.
"""

import math

import numpy as np
import pytest
import torch

from transmf_ad_tpu_torch.data import transforms
from transmf_ad_tpu_torch.data.transforms import AugmentConfig

F32, BF16 = torch.float32, torch.bfloat16
CFG = AugmentConfig()
ALWAYS = AugmentConfig(flip_prob=0.5, rotate_prob=0.7, zoom_prob=0.7)
BELOW = float(np.nextafter(np.float32(0.3), np.float32(0)))  # < 0.3
AT = float(np.float32(0.3))  # float32(0.3) = 0.30000001... > 0.3

# (u0 flip, u1 rotate, u2 angle, u3 zoom, u4 factor, unused) under CFG
ROWS = [
    [0.9, 0.9, 0.5, 0.9, 0.5, 0.0],  # identity
    [0.1, 0.9, 0.5, 0.9, 0.5, 0.0],  # flip only
    [0.9, 0.9, 0.5, 0.1, 0.3, 0.0],  # zoom only
    [0.9, 0.1, 0.8, 0.9, 0.5, 0.0],  # rotation only (zoom-free)
    [0.1, 0.1, 0.1, 0.1, 0.9, 0.0],  # all three
    [0.1, 0.2, 0.5, 0.9, 0.5, 0.0],  # flip, angle exactly 0: no shears
    [AT, BELOW, 0.05, AT, 0.5, 0.0],  # thresholds: rotation alone
    [BELOW, AT, 0.5, BELOW, 0.99, 0.0],  # thresholds: flip and zoom
]


def _uniforms(rows=ROWS, device="cpu"):
    return torch.tensor(rows, dtype=F32, device=device)


def emulate_k13(vol, flip, angle, zoom, trap=None):
    """K13's arithmetic on one (X, Y, Z) volume in plain float32 PyTorch:
    the x, y and z passes as two-tap gathers mixed a * (1 - w) + b * w in
    that order (K13's 8-tap gather computes the same roundings), then, for
    angle != 0, the shears y by a, z by b, y by a. `trap` changes the
    rotation: "zyz" shears z, y, z; "two" leaves out the last shear."""
    if not flip and angle == 0.0 and zoom == 1.0:
        return vol
    X, Y, Z = vol.shape
    zoom32 = torch.tensor(zoom, dtype=F32)

    def taps(src, size):
        lo = torch.clamp(torch.floor(src), 0, size - 1)
        w = torch.clamp(src - lo, 0.0, 1.0)
        hi = torch.clamp(lo + 1, 0, size - 1)
        return lo.long(), hi.long(), w

    def zoomed(n):
        c = (n - 1) / 2.0
        return (torch.arange(n, dtype=F32) - c) / zoom32 + c

    def mix(a, b, w):
        return a * (1.0 - w) + b * w

    v = vol.float()
    sx = zoomed(X)
    if flip:
        sx = (X - 1) - sx
    lo, hi, w = taps(sx, X)
    v = mix(v[lo], v[hi], w[:, None, None])
    lo, hi, w = taps(zoomed(Y), Y)
    v = mix(v[:, lo], v[:, hi], w[None, :, None])
    lo, hi, w = taps(zoomed(Z), Z)
    v = mix(v[..., lo], v[..., hi], w)
    if angle != 0.0:
        a = torch.tensor(-math.tan(angle / 2.0), dtype=F32)
        b = torch.tensor(math.sin(angle), dtype=F32)
        dy, dz = (torch.arange(n, dtype=F32) for n in (Y, Z))

        def shear_y(v, c):  # column z moves by c * (z - cz)
            lo, hi, w = taps(dy[:, None] - c * (dz - (Z - 1) / 2.0), Y)
            z = torch.arange(Z)
            return mix(v[:, lo, z], v[:, hi, z], w)

        def shear_z(v, c):  # row y moves by c * (y - cy)
            lo, hi, w = taps(dz[None, :] - (c * (dy - (Y - 1) / 2.0))[:, None],
                             Z)
            y = torch.arange(Y)[:, None]
            return mix(v[:, y, lo], v[:, y, hi], w)

        if trap == "zyz":
            v = shear_z(shear_y(shear_z(v, b), a), b)
        elif trap == "two":
            v = shear_z(shear_y(v, a), b)
        else:
            v = shear_y(shear_z(shear_y(v, a), b), a)
    return v.to(vol.dtype)


def _volumes(shape, dtype, seed, m=2, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(shape, generator=g).to(device=device, dtype=dtype)
            for k in ("MRI", "PET")[:m]}


def _excess(out, ref, dtype):
    """The largest |out - ref| over the tolerance: float32 1e-5 of the
    volume's largest magnitude, bfloat16 one ulp of each element."""
    err = (out.float() - ref.float()).abs()
    if dtype == F32:
        return float(err.max()) / (1e-5 * float(ref.float().abs().max()))
    return float((err / (2.0 ** -7 * ref.float().abs()).clamp_min(1e-30))
                 .max())


# -- CPU ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_plain_path_is_per_sample_augment(seed):
    """`augment_batch` on CPU tensors and the uniforms a generator draws
    gives `draw_params` + `augment` per sample on a generator seeded alike,
    and leaves the generator at the same state."""
    vols = _volumes((5, 9, 11, 7), F32, seed)
    g1, g2 = (torch.Generator().manual_seed(seed) for _ in range(2))
    out = transforms.augment_batch(vols, transforms.draw_uniforms(g1, 5),
                                   ALWAYS)
    want = [transforms.augment({k: v[i] for k, v in vols.items()}, p, ALWAYS)
            for i, p in enumerate(transforms.draw_params(g2, ALWAYS, 5))]
    for k in vols:
        assert torch.equal(out[k], torch.stack([w[k] for w in want]))
    assert torch.equal(g1.get_state(), g2.get_state())
    draws = transforms.draw_params(torch.Generator().manual_seed(seed),
                                   ALWAYS, 5)
    for i, d in enumerate(draws):
        if transforms.is_identity(*d):
            assert all(torch.equal(out[k][i], vols[k][i]) for k in vols)


def test_decode_takes_pythons_branch_at_the_thresholds():
    draws = transforms.decode(_uniforms(), CFG)
    assert draws[0] == (False, 0.0, 1.0)
    assert draws[1] == (True, 0.0, 1.0)
    flip, angle, zoom = draws[6]  # float32(0.3) misses, the one below takes
    assert not flip and zoom == 1.0
    assert angle == -0.05 + (0.05 - -0.05) * float(np.float32(0.05))
    flip, angle, zoom = draws[7]
    assert flip and angle == 0.0
    assert zoom == 0.95 + (1.0 - 0.95) * float(np.float32(0.99))
    assert draws[5][1] == 0.0  # -0.05 + 0.1 * 0.5 is exactly 0


@pytest.mark.parametrize("shape", [(9, 11, 7), (12, 17, 10), (5, 33, 21)])
def test_emulation_meets_the_plain_version(shape):
    vol = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    for draw in transforms.decode(_uniforms(), CFG) + [
            (True, 0.04, 0.96), (False, -0.05, 0.95)]:
        ref = transforms.augment({"v": vol}, draw)["v"]
        emu = emulate_k13(vol, *draw)
        assert _excess(emu, ref, F32) <= 1.0, draw
        if draw[1] == 0.0 and draw[2] == 1.0:  # identity or flip alone
            assert torch.equal(emu, ref), draw


@pytest.mark.parametrize("trap", ["zyz", "two"])
def test_emulation_traps_miss(trap):
    vol = torch.rand(12, 17, 10, generator=torch.Generator().manual_seed(4))
    draw = (False, 0.05, 0.97)
    ref = transforms.augment({"v": vol}, draw)["v"]
    assert _excess(emulate_k13(vol, *draw, trap=trap), ref, F32) > 10.0


def test_meta_tensors_raise():
    """Any device but the CPU launches K13 or raises."""
    vols = {"MRI": torch.ones(2, 3, 4, 5, device="meta")}
    with pytest.raises(ValueError, match="CUDA"):
        transforms.augment_batch(vols, torch.ones(2, 6, device="meta"), CFG)


# -- the card ----------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", [
    ((6, 182, 218, 182), "smem"), ((8, 91, 109, 91), "smem"),
    ((1, 3, 250, 226), "smem"), ((1, 3, 250, 227), "global"),
    ((2, 6, 256, 256), "global"), ((1, 5, 300, 7), "global"),
    ((1, 5, 7, 257), "global")])
def test_variant_by_shape(cuda, shape, want):
    assert transforms.variant(shape) == want


def _check_k13(shape, dtype, u, exact=True, m=2):
    """K13 on volumes of `shape` against the plain version on the CPU
    (within the tolerance; identity and flip-only draws bit for bit) and,
    where `exact`, against `emulate_k13` bit for bit, on `m` modalities.
    Returns the variant K13 took. The plain version runs on the CPU because
    on the card PyTorch divides by a Python scalar through its float32
    reciprocal, which moves the zoom's source coordinates by up to an ulp
    (2.7e-5 of the value at 300 voxels); K13 and the CPU divide."""
    vols = _volumes(shape, dtype, shape[1], m, device="cuda")
    transforms.AUGMENT.reset()
    out = transforms.augment_batch(vols, u, CFG)
    torch.cuda.synchronize()
    (which,) = transforms.AUGMENT.by_variant
    assert transforms.AUGMENT.by_variant == {which: 1}
    assert which == transforms.variant(shape)
    vols = {k: v.cpu() for k, v in vols.items()}
    ref = transforms.augment_reference(vols, u.cpu(), CFG)
    draws = transforms.decode(u, CFG)
    for k, v in vols.items():
        assert out[k].dtype == dtype and out[k].shape == v.shape
        for i, draw in enumerate(draws):
            o, r = out[k][i].cpu(), ref[k][i]
            flip, angle, zoom = draw
            if angle == 0.0 and zoom == 1.0:
                assert torch.equal(o, r), (shape, dtype, draw)
            assert _excess(o, r, dtype) <= 1.0, (shape, dtype, draw)
            if exact:
                assert torch.equal(o, emulate_k13(v[i], *draw)), (
                    shape, dtype, draw)
    return which


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_k13_against_plain_and_emulation(cuda, dtype):
    seen = set()
    u = _uniforms(device="cuda")
    for shape in ((8, 7, 9, 5), (8, 13, 33, 17), (8, 5, 300, 7),
                  (8, 4, 256, 240)):
        seen.add(_check_k13(shape, dtype, u))
    assert seen == {"smem", "global"}
    _check_k13((8, 7, 9, 5), dtype, u, m=1)  # one modality
    # the cells' shape: the listed rows, then 6 drawn by a generator,
    # against the plain version
    for rows in (u[:6], u[6:].repeat(3, 1),
                 transforms.draw_uniforms(cuda, 6)):
        _check_k13((6, 182, 218, 182), dtype, rows.contiguous(), exact=False)
    print(f"K13 {dtype}: variants {sorted(seen)} and \"smem\" at "
          "(6, 182, 218, 182)")


@pytest.mark.cuda
def test_k13_train_step_has_no_host_read(cuda, monkeypatch):
    """One train step on the card: K13 launches once, no `sync` span and
    no `host_syncs`; the generator ends where the plain path's ends."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.utils import tracing

    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"MRI": torch.rand(2, 32, 36, 32, generator=g, device="cuda"),
             "PET": torch.rand(2, 32, 36, 32, generator=g, device="cuda"),
             "label": torch.tensor([0, 1], device="cuda")}
    step = make_train_step(aug_cfg=ALWAYS)

    def run():
        torch.manual_seed(0)
        model = build_model("ad", dim=16, heads=2, dim_head=8, mlp_dim=64)
        state = create_state(model, device="cuda", dtype=F32, seed=5,
                             name="Adam", lr=1e-4)
        step(state, batch)
        torch.cuda.synchronize()
        return state.generator.get_state()

    transforms.AUGMENT.reset()
    tracing.enable()
    try:
        after = run()
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    assert transforms.AUGMENT.launches == 1
    assert counters["augment.kernel"] == 1
    assert "host_syncs" not in counters
    assert "sync" not in {s.name for s in spans}
    assert "augment" in {s.name for s in spans}
    monkeypatch.setattr(transforms, "_augment_launch",
                        transforms.augment_reference)
    assert torch.equal(after, run())
    assert transforms.AUGMENT.launches == 1
