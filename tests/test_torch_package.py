"""Packaging and dispatch rules of the PyTorch/CUDA port.

This file imports no jax, so its CUDA test also runs on a machine with a
GPU and without jax:

    python -m pytest tests/test_torch_package.py --noconftest -m cuda -q
"""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from transmf_ad_tpu_torch import _build
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn.grl import revgrad
from transmf_ad_tpu_torch.ops import (KERNELS, attention_core, band_conv,
                                      flash_attention as flash, pool3d,
                                      pooling, reset_launch_counts, stem)
from transmf_ad_tpu_torch.ops.flash_attention import (FLASH_MIN_KEYS,
                                                      attention_reference,
                                                      fused_attention)
from transmf_ad_tpu_torch.serving import make_inference_fn
from transmf_ad_tpu_torch.train import create_state, make_train_step

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import transmf_ad_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'flax', 'transmf_ad_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("entry", [make_inference_fn, create_state])
def test_entry_points_default_to_the_card(entry):
    """Every public entry point that takes a device runs on the card unless
    the caller asks for the CPU."""
    default = inspect.signature(entry).parameters["device"].default
    assert torch.device(default).type == "cuda"


def _volumes(rng, b=2, shape=(19, 21, 17)):
    return [rng.standard_normal((b, *shape)).astype(np.float32)
            for _ in range(2)]


def test_cpu_calls_leave_launch_counts_at_zero(rng):
    """Serving and a train step on CPU tensors run the plain versions only."""
    for k in KERNELS:
        k.launches = 7
    reset_launch_counts()
    assert all(k.launches == 0 for k in KERNELS)
    for name, kw in (("ad", {}), ("ad", {"band_min_voxels": 0}),
                     ("transformer", {}), ("transformer_res", {})):
        model = build_model(name, **SMALL, **kw)
        probs = make_inference_fn(model, "cpu")(*_volumes(rng))
        assert probs.shape == (2, 2)
        mri, pet = _volumes(rng)
        aux = make_train_step(adversarial=name == "ad")(
            create_state(model, "cpu"),
            {"MRI": mri, "PET": pet, "label": [0, 1]})
        assert torch.isfinite(aux["loss"])
    q, kv = torch.ones(1, 1, 3, 8), torch.ones(1, 1, FLASH_MIN_KEYS + 1, 8)
    attention_core(q.requires_grad_(), kv, kv, 1.0).sum().backward()
    pooling.fused_token_pool(torch.ones(1, 3, 4), torch.ones(1, 3, 4))
    pool3d.max_pool3d_2x2(torch.ones(1, 2, 2, 2, 3))
    assert {k.name: k.launches for k in KERNELS} == {
        k.name: 0 for k in KERNELS}


def test_non_cpu_tensors_never_take_the_plain_path():
    """On any device but the CPU a wrapper launches its kernel or raises;
    meta tensors stand in for a device without the kernels."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pooling.fused_token_pool(torch.ones(2, 3, 4, **meta),
                                 torch.ones(2, 3, 4, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        stem.stem_conv(torch.ones(1, 4, 4, 4, **meta),
                       torch.ones(3, 3, 3, 2, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        stem.stem_conv_stats(torch.ones(1, 4, 4, 4, **meta),
                             torch.ones(3, 3, 3, 2, **meta))
    y = torch.ones(1, 4, 4, 4, 2, **meta)
    c2 = torch.ones(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        stem.stem_dw(torch.ones(1, 4, 4, 4, **meta), y, y, c2, c2)
    with pytest.raises(ValueError, match="CUDA"):
        pool3d.max_pool3d_2x2(y)
    w5 = torch.ones(3, 3, 3, 2, 3, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        band_conv.band_conv3d(y, w5)
    with pytest.raises(ValueError, match="CUDA"):
        band_conv.band_conv3d_stats(y, w5)
    y3 = torch.ones(1, 4, 4, 4, 3, **meta)
    c3 = torch.ones(3, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        band_conv.band_dw(y, y3)
    with pytest.raises(ValueError, match="CUDA"):
        band_conv.band_dw(y, y3, y3, c3, c3)
    p = torch.ones(1, 2, 2, 2, 2, **meta)
    for mode in ("max", "avg"):
        with pytest.raises(ValueError, match="CUDA"):
            pool3d.affine_act_pool_bwd(y, c2, c2, p, p, 0.01, mode, False,
                                       False)
    q = torch.ones(1, 1, 3, 8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention(q, q, q, 1.0)
    # above the gate `attention_core` takes the flash kernels, which raise
    # like every other op; so do their separate entries
    long = torch.ones(1, 1, FLASH_MIN_KEYS + 1, 8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        attention_core(q, long, long, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_fwd(q, q, q, 1.0)
    row = torch.ones(1, 1, 3, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_dq(q, q, q, q, row, row, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_dkv(q, q, q, q, row, row, 1.0)
    # on the CPU the long-key case runs the plain flash version
    qc = torch.randn(1, 1, 3, 8)
    kc = torch.randn(1, 1, FLASH_MIN_KEYS + 1, 8)
    out = attention_core(qc, kc, kc, 0.5)
    torch.testing.assert_close(out, flash.flash_fwd_reference(qc, kc, kc,
                                                              0.5)[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(out, attention_reference(qc, kc, kc, 0.5))


def test_train_mode_raises(rng):
    """A CPU train-mode forward runs and moves the running statistics;
    BatchNorm refuses producer sums together with a mask."""
    model = build_model("ad", **SMALL)
    mri, pet = (torch.from_numpy(v[..., None]) for v in _volumes(rng))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    logits, d_mri, d_pet = model(mri, pet, train=True,
                                 generator=torch.Generator().manual_seed(0))
    assert logits.shape == d_mri.shape == d_pet.shape == (2, 2)
    assert logits.requires_grad
    moved = [k for k, v in model.state_dict().items()
             if "running" in k and not torch.equal(v, before[k])]
    assert len(moved) == len(before)  # every BatchNorm layer
    bn = model.mri_cnn.conv1["1"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        bn(None, None, True, stats=(torch.ones(8), torch.ones(8), 2),
           mask=torch.ones(2))


def test_revgrad():
    x = torch.randn(3, 4, requires_grad=True)
    y = revgrad(x, 2.0)
    torch.testing.assert_close(y, x)
    (y * torch.arange(4.0)).sum().backward()
    torch.testing.assert_close(x.grad, -2.0 * torch.arange(4.0).expand(3, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cases(g):
    """(kernel name, kernel call, plain call, kinds) at small odd shapes. A
    call returns one tensor or a tuple; kinds says, per output, whether it
    is a 'value' (elementwise tolerance) or a float32 'sum' (tolerance
    relative to its largest magnitude: only the order of sums differs)."""
    def r(*s):
        return torch.randn(*s, generator=g, device="cuda")

    y, s, b = r(2, 5, 7, 9, 3), r(9 * 3), r(9 * 3)
    yc, sc, bc = r(2, 5, 7, 9, 3), r(3), r(3)
    x4, w4 = r(2, 5, 7, 37), r(3, 3, 3, 5)
    x5, y5, g5, a5, b5 = r(2, 9, 11, 37), r(2, 9, 11, 37, 5), \
        r(2, 9, 11, 37, 5), r(5), r(5)
    m, p = r(3, 7, 40), r(3, 7, 40)
    q, k, v = r(2, 3, 37, 24), r(2, 3, 70, 24), r(2, 3, 70, 24)
    qd, kd = r(1, 2, 5, 128), r(1, 2, 33, 128)
    gp = r(2, 2, 3, 4, 3)
    # flash: partial tiles of queries and keys, a head dim off the lane
    # grid, and the widest head
    qf, kf, vf, gf = r(2, 3, 37, 24), r(2, 3, 70, 24), r(2, 3, 70, 24), \
        r(2, 3, 37, 24)
    qw, kw, gw_ = r(1, 2, 45, 128), r(1, 2, 33, 128), r(1, 2, 45, 128)

    def flash_bwd_in(t, q_, k_, v_, g_, scale):
        """q, k, v, g, and the plain forward's lse and delta"""
        o, lse = flash.flash_fwd_reference(t(q_), t(k_), t(v_), scale)
        return (t(q_), t(k_), t(v_), t(g_), lse,
                flash.flash_delta(o, t(g_)), scale)

    flash_cases = [
        case for args in ((qf, kf, vf, gf, 0.2), (qw, kw, kw, gw_, 0.1))
        for case in (
            ("flash_fwd", lambda t, a=args: flash.flash_fwd(
                t(a[0]), t(a[1]), t(a[2]), a[4]),
             lambda t, a=args: flash.flash_fwd_reference(
                 t(a[0]), t(a[1]), t(a[2]), a[4]), "vv"),
            ("flash_dq", lambda t, a=args: flash.flash_dq(
                *flash_bwd_in(t, *a)),
             lambda t, a=args: flash.flash_dq_reference(
                 *flash_bwd_in(t, *a)), "v"),
            ("flash_dkv", lambda t, a=args: flash.flash_dkv(
                *flash_bwd_in(t, *a)),
             lambda t, a=args: flash.flash_dkv_reference(
                 *flash_bwd_in(t, *a)), "vv"))]
    # band conv: odd channel counts (3 -> 5), then more input channels than
    # one chunk and more output channels than one block (40 -> 70)
    xb, wb, gb, ab, bb = r(2, 5, 7, 19, 3), 0.2 * r(3, 3, 3, 3, 5), \
        r(2, 5, 7, 19, 5), r(5), 0.1 * r(5)
    xw, ww, gw, aw, bw = r(1, 3, 18, 17, 40), 0.1 * r(3, 3, 3, 40, 70), \
        r(1, 3, 18, 17, 70), r(70), 0.1 * r(70)
    band = band_conv
    ref = pool3d.affine_act_pool_reference
    bwd_ref = pool3d.affine_act_pool_bwd_reference
    one, zero = torch.ones(3, device="cuda"), torch.zeros(3, device="cuda")

    def pool_bwd(t, yy, ss, bb, slope, mode, lanes, round_gi, plain):
        pp = ref(t(yy), ss, bb, slope, mode)
        if plain:
            return bwd_ref(t(yy), ss, bb, pp, t(gp), slope, mode, round_gi)
        return pool3d.affine_act_pool_bwd(t(yy), ss, bb, pp, t(gp), slope,
                                          mode, lanes, round_gi)

    bwd_cases = [(y, s, b, 0.01, "max", True, True),
                 (yc, sc, bc, 0.2, "max", False, False),
                 (yc, sc, bc, 0.01, "avg", False, False),
                 (yc, one, zero, 1.0, "max", False, True),
                 (yc, one, zero, 1.0, "avg", False, False)]
    return [
        ("token_pool", lambda t: pooling.fused_token_pool(t(m), t(p)),
         lambda t: pooling.pool_reference(t(m), t(p)), "v"),
        ("attention_fwd", lambda t: fused_attention(t(q), t(k), t(v), 0.2),
         lambda t: attention_reference(t(q), t(k), t(v), 0.2), "v"),
        ("attention_fwd", lambda t: fused_attention(t(qd), t(kd), t(kd), 0.1),
         lambda t: attention_reference(t(qd), t(kd), t(kd), 0.1), "v"),
        ("stem_conv", lambda t: stem.stem_conv(t(x4), t(w4)),
         lambda t: stem._conv_reference(t(x4), t(w4)), "v"),
        ("affine_act_pool",
         lambda t: pool3d.max_pool3d_2x2_affine_act(t(y), s, b, 0.01),
         lambda t: ref(t(y), s, b, 0.01, "max"), "v"),
        ("affine_act_pool",
         lambda t: pool3d.max_pool3d_2x2_affine_act_bc(t(yc), sc, bc, 0.2),
         lambda t: ref(t(yc), sc, bc, 0.2, "max"), "v"),
        ("affine_act_pool",
         lambda t: pool3d.avg_pool3d_2x2_affine_act(t(yc), sc, bc, 0.01),
         lambda t: ref(t(yc), sc, bc, 0.01, "avg"), "v"),
        ("affine_act_pool", lambda t: pool3d.avg_pool3d_2x2(t(yc)),
         lambda t: ref(t(yc), torch.ones_like(sc), torch.zeros_like(bc), 1.0,
                       "avg"), "v"),
        ("stem_conv_stats", lambda t: stem.stem_conv_stats(t(x5), t(w4)),
         lambda t: stem._stem_stats_reference(t(x5), t(w4)), "vs"),
        ("stem_dw", lambda t: stem.stem_dw(t(x5), t(y5), t(g5), a5, b5),
         lambda t: stem.stem_dw_reference(t(x5), t(y5), t(g5), a5, b5), "s"),
    ] + [
        case for x_, w_, g_, a_, b_ in ((xb, wb, gb, ab, bb),
                                        (xw, ww, gw, aw, bw))
        for case in (
            ("band_conv",
             lambda t, x_=x_, w_=w_: band._band_forward(t(x_), t(w_), False),
             lambda t, x_=x_, w_=w_: band.band_conv_reference(t(x_), t(w_)),
             "v"),
            ("band_conv",
             lambda t, x_=x_, w_=w_: band._band_forward(t(x_), t(w_), True),
             lambda t, x_=x_, w_=w_: band.band_conv_stats_reference(
                 t(x_), t(w_)),
             "vs"),
            ("band_dw",
             lambda t, x_=x_, g_=g_: band.band_dw(t(x_), t(g_)),
             lambda t, x_=x_, g_=g_: band.band_dw_reference(t(x_), t(g_)),
             "s"),
            ("band_dw",
             lambda t, x_=x_, g_=g_, a_=a_, b_=b_: band.band_dw(
                 t(x_), t(g_), t(g_.flip(1)), a_, b_),
             lambda t, x_=x_, g_=g_, a_=a_, b_=b_: band.band_dw_reference(
                 t(x_), t(g_), t(g_.flip(1)), a_, b_), "s"))
    ] + [
        ("affine_act_pool_bwd",
         lambda t, c=c: pool_bwd(t, *c, plain=False),
         lambda t, c=c: pool_bwd(t, *c, plain=True), "vs")
        for c in bwd_cases] + flash_cases


def _match(out, ref, kind, dtype, what):
    if kind == "v":
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=1e-4))
    else:
        tol = dict(rtol=0.0, atol=1e-5 * float(ref.abs().max()) + 1e-6)
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(cuda):
    """Each kernel against its plain version at small odd shapes; values in
    float32 to 1e-5 (summation order), in bfloat16 to one ulp (both sides
    round one float32 value); float32 sums (BN statistics, dw, d(scale),
    d(shift)) to 1e-5 of their largest magnitude; each call launches its
    kernel exactly once."""
    counts = {k.name: k for k in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for name, kern, plain, kinds in _cases(cuda):
            def t(a):
                return a.to(dtype)
            before = counts[name].launches
            out = kern(t)
            assert counts[name].launches == before + 1, name
            torch.cuda.synchronize()
            ref = plain(t)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            for o, rf, kind in zip(outs, refs, kinds, strict=True):
                _match(o, rf, kind, dtype, f"{name} {dtype}")


@pytest.mark.cuda
def test_tensor_core_variants_on_cuda(cuda):
    """K8 "mma" and K2 "mma" at the edges of their tiling, each against its
    plain version: one and two planes (the ring of plane halos), Y and Z one
    below, at and one above a tile, batch 2, 32 and 64 input channels (the
    wgmma kernel), 64 -> 64 and 128 -> 128 (the mma.sync kernel, weights
    staged by taps, two blocks of output channels), 16 -> 8, three segments
    along x, with and without the sums; one query, one key, partial chunks,
    queries and keys around a chunk and a block, every head dim. bfloat16
    takes the tensor-core variant, float32 the CUDA-core one, and the count
    per variant says so."""
    def r(*s):
        return torch.randn(*s, generator=cuda, device="cuda")

    for b, vol, cin, cout in ((1, (1, 9, 17), 32, 32), (1, (2, 8, 16), 32, 32),
                              (1, (3, 7, 15), 16, 8), (2, (3, 9, 17), 32, 64),
                              (1, (3, 9, 17), 64, 32), (1, (4, 10, 20), 64, 64),
                              (1, (3, 9, 18), 128, 128),
                              (1, (20, 9, 17), 16, 8)):
        x, w = r(b, *vol, cin), r(3, 3, 3, cin, cout) * (13.5 * cin) ** -0.5
        for dtype, want in ((torch.bfloat16, "mma"),
                            (torch.float32, "direct")):
            assert band_conv.variant(dtype, cin, cout) == want
            xd, wd = x.to(dtype), w.to(dtype)
            band_conv.BAND_CONV.reset()
            y = band_conv._band_forward(xd, wd, False)
            ys, st = band_conv._band_forward(xd, wd, True)
            torch.cuda.synchronize()
            assert band_conv.BAND_CONV.by_variant == {want: 2}
            ref, ref_st = band_conv.band_conv_stats_reference(xd, wd)
            what = f"band_conv {want} {b} {vol} {cin}->{cout}"
            _match(y, ref, "v", dtype, what)
            _match(ys, ref, "v", dtype, what + " with sums")
            _match(st, ref_st, "s", dtype, what + " sums")
    for bh, n, m, d in ((2, 1, 70, 32), (2, 40, 1, 32), (2, 70, 17, 32),
                        (2, 63, 63, 32), (2, 64, 64, 32), (2, 65, 65, 32),
                        (3, 100, 100, 16), (3, 100, 130, 64),
                        (2, 100, 130, 128), (24, 1573, 1573, 32)):
        q, k, v = r(1, bh, n, d), r(1, bh, m, d), r(1, bh, m, d)
        for dtype, want in ((torch.bfloat16, "mma"), (torch.float32, "rows")):
            assert flash.attention_variant(dtype, d) == want
            flash.ATTENTION.reset()
            args = (q.to(dtype), k.to(dtype), v.to(dtype), d ** -0.5)
            out = fused_attention(*args)
            torch.cuda.synchronize()
            assert flash.ATTENTION.by_variant == {want: 1}
            _match(out, attention_reference(*args), "v", dtype,
                   f"attention_fwd {want} {(bh, n, m, d)}")
    # a head dim the tensor-core variant does not take stays on the CUDA cores
    q = r(1, 2, 37, 48).bfloat16()
    flash.ATTENTION.reset()
    out = fused_attention(q, q, q, 0.2)
    assert flash.ATTENTION.by_variant == {"rows": 1}
    _match(out, attention_reference(q, q, q, 0.2), "v", torch.bfloat16,
           "attention_fwd rows D=48")


@pytest.mark.cuda
def test_backward_launches_kernels_on_cuda(cuda):
    """Autograd through the pool entries, the training stem, the band conv
    and flash attention reaches K7, K6, K8/K9 and K11/K12 and gives the
    plain backward's gradients."""
    x = torch.randn(2, 9, 11, 13, generator=cuda, device="cuda")
    w = torch.randn(3, 3, 3, 4, generator=cuda, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        xx, ww = x.to(dev), w.detach().to(dev).requires_grad_()
        y, st = stem.stem_conv_stats(xx, ww)
        s = (1.0 + st[0] / st[0].abs().max()).repeat(y.shape[3])
        out = pool3d.max_pool3d_2x2_affine_act(y, s, torch.zeros_like(s))
        before = {k.name: k.launches for k in KERNELS}
        out.float().square().sum().backward()
        after = {k.name: k.launches for k in KERNELS}
        if dev == "cuda":
            for name in ("stem_dw", "affine_act_pool_bwd"):
                assert after[name] == before[name] + 1, name
        grads.append(ww.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)
    # the band conv: forward K8 (with and without the sums), backward K8 for
    # dx and K9 for dw
    x = torch.randn(2, 6, 7, 9, 3, generator=cuda, device="cuda")
    w = 0.2 * torch.randn(3, 3, 3, 3, 6, generator=cuda, device="cuda")
    for with_stats in (False, True):
        grads = []
        for dev in ("cuda", "cpu"):
            xx = x.detach().to(dev).clone().requires_grad_()
            ww = w.detach().to(dev).clone().requires_grad_()
            before = {k.name: k.launches for k in KERNELS}
            if with_stats:
                y, st = band_conv.band_conv3d_stats(xx, ww)
                loss = y.square().sum() + (st[0] * st[1]).sum() * 1e-3
            else:
                loss = band_conv.band_conv3d(xx, ww).square().sum()
            loss.backward()
            after = {k.name: k.launches for k in KERNELS}
            if dev == "cuda":
                assert after["band_conv"] == before["band_conv"] + 2
                assert after["band_dw"] == before["band_dw"] + 1
            grads.append((xx.grad.cpu(), ww.grad.cpu()))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))
    # flash attention: forward K10, backward K11 and K12, and never K2
    qkv = [torch.randn(2, 2, n, 16, generator=cuda, device="cuda")
           for n in (37, 70, 70)]
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).clone().requires_grad_() for t in qkv]
        before = {k.name: k.launches for k in KERNELS}
        flash.flash_attention(*leaves, 0.25).square().sum().backward()
        after = {k.name: k.launches for k in KERNELS}
        if dev == "cuda":
            for name in ("flash_fwd", "flash_dq", "flash_dkv"):
                assert after[name] == before[name] + 1, name
            assert after["attention_fwd"] == before["attention_fwd"]
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
    x = torch.randn(2, 4, 4, 4, 3, device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        pool3d.max_pool3d_2x2(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        pool3d.max_pool3d_2x2(x.transpose(1, 2))


@pytest.mark.cuda
def test_k9_k10_tensor_core_variants_on_cuda(cuda):
    """K9 "mma" (with and without a, b2) and K10 "mma" at small odd shapes
    against their plain versions: one and two planes, Y and Z around the
    16 x 16 voxel tile, 16 -> 8, 64 x 64 and 128 x 128 (blocks of channels),
    segments along x;
    one query, one key, partial chunks, every head dim, the logsumexp to
    1e-5. bfloat16 takes the tensor-core variant, float32 the CUDA-core
    one, and the count per variant says so."""
    def r(*s):
        return torch.randn(*s, generator=cuda, device="cuda")

    for b, vol, cin, cout in ((1, (1, 15, 15), 32, 32),
                              (1, (2, 16, 16), 32, 64),
                              (2, (3, 17, 17), 16, 8), (1, (4, 10, 20), 64, 64),
                              (1, (3, 9, 18), 128, 128),
                              (1, (20, 33, 35), 64, 32)):
        x, gy, y = r(b, *vol, cin), r(b, *vol, cout), r(b, *vol, cout)
        a, b2 = r(cout), 0.1 * r(cout)
        for dtype, want in ((torch.bfloat16, "mma"),
                            (torch.float32, "direct")):
            assert band_conv.dw_variant(dtype, cin, cout) == want
            xd, gd, yd = x.to(dtype), gy.to(dtype), y.to(dtype)
            band_conv.BAND_DW.reset()
            dw = band_conv.band_dw(xd, gd)
            dw_ab = band_conv.band_dw(xd, gd, yd, a, b2)
            torch.cuda.synchronize()
            assert band_conv.BAND_DW.by_variant == {want: 2}
            what = f"band_dw {want} {b} {vol} {cin}x{cout}"
            _match(dw, band_conv.band_dw_reference(xd, gd), "s", dtype, what)
            _match(dw_ab, band_conv.band_dw_reference(xd, gd, yd, a, b2), "s",
                   dtype, what + " with a, b2")
    for bh, n, m, d in ((2, 1, 70, 32), (2, 40, 1, 32), (2, 70, 17, 32),
                        (2, 65, 65, 32), (3, 100, 100, 16), (3, 100, 130, 64),
                        (2, 100, 130, 128)):
        q, k, v = r(1, bh, n, d), r(1, bh, m, d), r(1, bh, m, d)
        for dtype, want in ((torch.bfloat16, "mma"), (torch.float32, "rows")):
            args = (q.to(dtype), k.to(dtype), v.to(dtype), d ** -0.5)
            flash.FLASH_FWD.reset()
            out, lse = flash.flash_fwd(*args)
            torch.cuda.synchronize()
            assert flash.FLASH_FWD.by_variant == {want: 1}
            ref, ref_lse = flash.flash_fwd_reference(*args)
            what = f"flash_fwd {want} {(bh, n, m, d)}"
            _match(out, ref, "v", dtype, what)
            torch.testing.assert_close(lse, ref_lse, rtol=0.0, atol=1e-5,
                                       msg=lambda m_: f"{what} lse: {m_}")


@pytest.mark.cuda
def test_k9_k10_mma_autograd_on_cuda(cuda):
    """The tensor-core variants inside their autograd functions, bfloat16:
    flash_attention's backward (K11 and K12 "mma") fed the output and
    logsumexp of K10 "mma" against `flash_bwd_reference` (1e-4 of each
    gradient's scale plus one ulp), and band_conv3d_stats's weight gradient through K9 "mma"
    against the plain dw from the same y, a and b2."""
    q, k, v, g = (torch.randn(1, 2, n, 32, generator=cuda, device="cuda")
                  .bfloat16() for n in (45, 70, 70, 45))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    for kern in (flash.FLASH_FWD, flash.FLASH_DQ, flash.FLASH_DKV):
        kern.reset()
    out = flash.flash_attention(*leaves, 0.2)
    out.backward(g)
    for kern in (flash.FLASH_FWD, flash.FLASH_DQ, flash.FLASH_DKV):
        assert kern.by_variant == {"mma": 1}, kern.name
    ref_out, ref_lse = flash.flash_fwd_reference(q, k, v, 0.2)
    refs = flash.flash_bwd_reference(q, k, v, ref_out, ref_lse, g, 0.2)
    for name, leaf, ref in zip("qkv", leaves, refs):
        tol = 1e-4 * float(ref.float().abs().max())
        torch.testing.assert_close(leaf.grad.float(), ref.float(),
                                   rtol=2 ** -7, atol=tol,
                                   msg=lambda m_, n_=name: f"d{n_}: {m_}")
    x = torch.randn(1, 3, 9, 17, 32, generator=cuda, device="cuda").bfloat16()
    w = (0.05 * torch.randn(3, 3, 3, 32, 64, generator=cuda, device="cuda")
         ).bfloat16().requires_grad_()
    band_conv.BAND_DW.reset()
    y, st = band_conv.band_conv3d_stats(x, w)
    gy = torch.randn(y.shape, generator=cuda, device="cuda").bfloat16()
    gst = torch.randn(st.shape, generator=cuda, device="cuda") * 1e-3
    (dw,) = torch.autograd.grad((y, st), (w,), (gy, gst))
    assert band_conv.BAND_DW.by_variant == {"mma": 1}
    ref = band_conv.band_dw_reference(x, gy, y.detach(), gst[0].contiguous(),
                                      (2.0 * gst[1]).contiguous())
    # dw is rounded once to w's bfloat16: one ulp beside the sums' order
    torch.testing.assert_close(dw.float(), ref, rtol=2 ** -7,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_k11_k12_tensor_core_variants_on_cuda(cuda):
    """K11 and K12 "mma" at the edges of their tiling against their plain
    versions: 5, 37 and 1,573 queries (less than a warp's 16, a partial
    block, the model's 24 x 64 + 37), 100 keys (one partial chunk of K11, a
    partial block of K12), 2,100 and the model's 3,146, every head dim they
    take; bfloat16 takes "mma", float32 "rows", and the count per variant
    says so. Tolerance: chip_smoke's, 1e-4 of each output's scale, plus one
    ulp in bfloat16."""
    def r(*s):
        return torch.randn(*s, generator=cuda, device="cuda")

    for bh, n, m, d in ((2, 5, 100, 32), (3, 37, 2100, 16),
                        (2, 37, 100, 64), (1, 1573, 100, 64),
                        (2, 5, 3146, 16), (24, 1573, 3146, 32)):
        q, k, v, g = r(1, bh, n, d), r(1, bh, m, d), r(1, bh, m, d), \
            r(1, bh, n, d)
        for dtype, want in ((torch.bfloat16, "mma"), (torch.float32, "rows")):
            assert flash.flash_bwd_variant(dtype, d) == want
            qd, kd, vd, gd = (t.to(dtype) for t in (q, k, v, g))
            out, lse = flash.flash_fwd_reference(qd, kd, vd, d ** -0.5)
            args = (qd, kd, vd, gd, lse, flash.flash_delta(out, gd),
                    d ** -0.5)
            flash.FLASH_DQ.reset()
            flash.FLASH_DKV.reset()
            got = (flash.flash_dq(*args), *flash.flash_dkv(*args))
            torch.cuda.synchronize()
            assert flash.FLASH_DQ.by_variant == {want: 1}
            assert flash.FLASH_DKV.by_variant == {want: 1}
            refs = (flash.flash_dq_reference(*args),
                    *flash.flash_dkv_reference(*args))
            for name, o, ref in zip(("dq", "dk", "dv"), got, refs):
                rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
                torch.testing.assert_close(
                    o.float(), ref.float(), rtol=rtol,
                    atol=1e-4 * float(ref.float().abs().max()),
                    msg=lambda m_, w=f"{name} {want} {(bh, n, m, d)}":
                    f"{w}: {m_}")
    # a head dim the tensor-core variants do not take stays on the CUDA cores
    q = r(1, 2, 37, 128).bfloat16()
    out, lse = flash.flash_fwd_reference(q, q, q, 0.1)
    flash.FLASH_DQ.reset()
    flash.flash_dq(q, q, q, q, lse, flash.flash_delta(out, q), 0.1)
    assert flash.FLASH_DQ.by_variant == {"rows": 1}


@pytest.mark.cuda
def test_k6_tensor_core_variant_on_cuda(cuda):
    """K6 "mma" at small shapes against `stem_dw_reference`: Y and Z off
    and on its 16 x 16 voxel tile, one plane, 16, 32 and 64 channels; the
    float32 sums to 1e-5 of their largest magnitude (only their order
    differs: bfloat16 products are exact in float32). bfloat16 takes
    "mma", float32 "direct", and the count per variant says so; a second
    call gives the same bits."""
    def r(*s):
        return torch.randn(*s, generator=cuda, device="cuda")

    for b, vol, c in ((1, (3, 17, 18), 32), (2, (1, 9, 33), 16),
                      (1, (4, 16, 16), 64)):
        x, y, gy = r(b, *vol), r(b, *vol, c), r(b, *vol, c)
        a, b2 = r(c), 0.1 * r(c)
        for dtype, want in ((torch.bfloat16, "mma"),
                            (torch.float32, "direct")):
            assert stem.dw_variant(dtype, c) == want
            args = (x.to(dtype), y.to(dtype), gy.to(dtype), a, b2)
            stem.STEM_DW.reset()
            dw = stem.stem_dw(*args)
            torch.cuda.synchronize()
            assert stem.STEM_DW.by_variant == {want: 1}
            _match(dw, stem.stem_dw_reference(*args), "s", dtype,
                   f"stem_dw {want} {b} {vol} C{c}")
            assert torch.equal(dw, stem.stem_dw(*args))


@pytest.mark.cuda
def test_k3_k5_tensor_core_variants_on_cuda(cuda):
    """K3 and K5 "mma" at small shapes against `_stem_stats_reference`: Y
    and Z off and on the 32 x 16 voxel tile, one plane, odd Z (rows of x
    not 16-byte aligned), segments along x, 16, 32, 48 and 64 channels; y
    to one ulp, the float32 sums to 1e-5 of their largest magnitude.
    bfloat16 takes "mma", float32 "direct", and the count per variant says
    so; a second K5 call gives the same bits."""
    def r(*s):
        return torch.randn(*s, generator=cuda, device="cuda")

    for b, vol, c in ((1, (3, 17, 18), 32), (2, (1, 9, 33), 16),
                      (1, (4, 32, 16), 64), (1, (20, 15, 17), 48),
                      (1, (3, 33, 31), 32)):
        x, w = r(b, *vol), 0.2 * r(3, 3, 3, c)
        for dtype, want in ((torch.bfloat16, "mma"),
                            (torch.float32, "direct")):
            assert stem.conv_variant(dtype, c) == want
            xd, wd = x.to(dtype), w.to(dtype)
            stem.STEM_CONV.reset()
            stem.STEM_CONV_STATS.reset()
            y = stem.stem_conv(xd, wd)
            ys, st = stem.stem_conv_stats(xd, wd)
            torch.cuda.synchronize()
            assert stem.STEM_CONV.by_variant == {want: 1}
            assert stem.STEM_CONV_STATS.by_variant == {want: 1}
            ref, ref_st = stem._stem_stats_reference(xd, wd)
            what = f"stem_conv {want} {b} {vol} C{c}"
            _match(y, ref, "v", dtype, what)
            _match(ys, ref, "v", dtype, what + " with sums")
            _match(st, ref_st, "s", dtype, what + " sums")
            again = stem.stem_conv_stats(xd, wd)
            assert torch.equal(ys, again[0]) and torch.equal(st, again[1])


def _k4_direct(y, s, b, slope, mode, lanes):
    """K4's "direct" variant on `_affine_act_pool`'s arguments, launched as
    chip_smoke does"""
    bb, X, Y, Z, C = y.shape
    out = torch.empty(bb, X // 2, Y // 2, Z // 2, C, dtype=y.dtype,
                      device="cuda")
    pool3d.AFFINE_ACT_POOL.launch(
        y.device, y.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
        bb, X, Y, Z, C, C if lanes else 0, float(slope), pool3d._MODES[mode],
        _build.DTYPE_CODES[y.dtype], 0, 0, variant="direct")
    return out


def _k7_direct(y, s, b, p, g, slope, mode, lanes, round_gi):
    """K7's "direct" variant on `affine_act_pool_bwd`'s arguments"""
    bb, X, Y, Z, C = y.shape
    grid = pool3d.bwd_blocks("direct", y.dtype, bb, X, Y, Z, C)
    dy = torch.empty_like(y)
    part = torch.empty(2, grid, Z * C, device="cuda")
    dsb = torch.empty(2, s.numel(), device="cuda")
    pool3d.AFFINE_ACT_POOL_BWD.launch(
        y.device, y.data_ptr(), s.data_ptr(), b.data_ptr(), p.data_ptr(),
        g.data_ptr(), dy.data_ptr(), part.data_ptr(), dsb.data_ptr(), bb, X,
        Y, Z, C, C if lanes else 0, float(slope), pool3d._MODES[mode],
        int(round_gi), grid, _build.DTYPE_CODES[y.dtype], 0, 0,
        variant="direct")
    return dy, dsb


@pytest.mark.cuda
def test_k4_k7_vec_variants_on_cuda(cuda):
    """K4 and K7 "vec" at small shapes against "direct" and the plain
    version: odd tails, lanes and channels, max and mean, C 8, 16 and 32,
    and a pooled row of two slices (392 bfloat16 lanes). K4's output and
    K7's dy give the same bits in both variants and match the plain
    version (exact in float32, one ulp in bfloat16); K7's float32 sums to
    1e-5 of their largest magnitude; two K7 calls give the same bits; the
    count per variant says which ran."""
    def r(*s):
        return torch.randn(*s, generator=cuda, device="cuda")

    ref = pool3d.affine_act_pool_reference
    for shape, lanes, mode in (((2, 5, 7, 9, 16), True, "max"),
                               ((1, 6, 9, 7, 32), False, "max"),
                               ((2, 5, 6, 5, 8), False, "avg"),
                               ((1, 3, 4, 98, 64), True, "max")):
        n = shape[3] * shape[4] if lanes else shape[4]
        s, b = 1.0 + 0.5 * r(n), 0.3 * r(n)
        round_gi = mode == "max" and lanes
        for dtype in (torch.bfloat16, torch.float32):
            assert pool3d.variant(dtype, shape[4]) == "vec"
            y = r(*shape).to(dtype)
            what = f"{mode} {'lanes' if lanes else 'chan'} {shape} {dtype}"
            pool3d.AFFINE_ACT_POOL.reset()
            out = pool3d._affine_act_pool("t", y, s, b, 0.01, mode, lanes)
            direct = _k4_direct(y, s, b, 0.01, mode, lanes)
            assert pool3d.AFFINE_ACT_POOL.by_variant == {"vec": 1,
                                                         "direct": 1}
            assert torch.equal(out, direct), what
            _match(out, ref(y, s, b, 0.01, mode), "v", dtype, what)
            gp = r(*out.shape).to(dtype)
            args = (y, s, b, out, gp, 0.01, mode, lanes, round_gi)
            pool3d.AFFINE_ACT_POOL_BWD.reset()
            dy, dsb = pool3d.affine_act_pool_bwd(*args)
            dy_d, dsb_d = _k7_direct(*args)
            assert pool3d.AFFINE_ACT_POOL_BWD.by_variant == {"vec": 1,
                                                             "direct": 1}
            assert torch.equal(dy, dy_d), what
            ref_dy, ref_dsb = pool3d.affine_act_pool_bwd_reference(
                *args[:7], round_gi)
            _match(dy, ref_dy, "v", dtype, what + " dy")
            _match(dsb, ref_dsb, "s", dtype, what + " sums")
            _match(dsb_d, ref_dsb, "s", dtype, what + " direct sums")
            again = pool3d.affine_act_pool_bwd(*args)
            assert torch.equal(dy, again[0]) and torch.equal(dsb, again[1])


@pytest.mark.cuda
def test_k4_k7_vec_misaligned_raises_on_cuda(cuda):
    """"vec" needs 16-byte aligned tensors: a contiguous view two bytes
    into its storage raises before anything launches; nothing falls back
    to "direct"."""
    shape = (2, 5, 6, 8, 32)
    buf = torch.zeros(int(np.prod(shape)) + 1, device="cuda",
                      dtype=torch.bfloat16)
    y = buf[1:].view(shape)
    s = torch.ones(32, device="cuda")
    b = torch.zeros(32, device="cuda")
    p = torch.zeros(2, 2, 3, 4, 32, device="cuda", dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        pool3d.max_pool3d_2x2_affine_act_bc(y, s, b)
    with pytest.raises(ValueError, match="16-byte"):
        pool3d.affine_act_pool_bwd(y, s, b, p, p, 0.01, "max", False, False)
    assert pool3d.AFFINE_ACT_POOL.launches == 0
    assert pool3d.AFFINE_ACT_POOL_BWD.launches == 0
