#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (transmf_ad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the final line:

1. device   a CUDA device, or exit 1 (there is no CPU fallback); the card's
            name and power limit as nvidia-smi reports them
2. build    compile csrc/*.cu with nvcc, one process per source (timed), and
            load the library
3. kernels  each hand-written kernel K1-K9 against its plain PyTorch version
            on the card, float32 and bfloat16, at the shapes the serving
            paths and the train steps give it (91x109x91 at batch 8 and
            182x218x182 at batch 6; the plain version of a stem or pool
            kernel at 182x218x182 runs one sample at a time, to bound its
            float32 temporaries): max error against a stated tolerance;
            kernel and plain
            median times from CUDA events; the kernel's bound, the larger of
            its bytes (inputs read once, outputs written once) over 3.35 TB/s
            and its operations over the card's peak for their type; and,
            where one PyTorch call computes the same function, that call's
            time (a yardstick: nothing in the port calls it for that)
4. serving  full-width ModelAd (dim 128, depth 3, 4 heads x 32, mlp 512) in
            bfloat16, random weights and BN statistics from a seeded
            torch.Generator, answers 6 batch-8 requests of 91x109x91
            MRI+PET (the last 3 timed); every serving kernel's launch count
            must rise
5. check    the same weights at batch 2 in float32 (TF32 off) on the card and
            through the plain path on the CPU: logits, d_mri and d_pet agree
6. train    the adversarial train step of full-width ModelAd at batch 8,
            91x109x91, bfloat16 compute with float32 master weights,
            augmentation on, head dropout 0.5 from a CUDA torch.Generator,
            Adam 1e-4: 3 warm-up and 5 timed steps; losses finite,
            parameters and running statistics move, and every train-path
            kernel's launch count rises
7. train check  one SGD (lr 1, no momentum) step with the same weights on the
            card (float32, TF32 off) and on the CPU plain path, at full width,
            batch 4, 35x37x33, no augmentation or dropout: the losses, every
            parameter update and every running statistic agree within 1e-3
            of their largest magnitude plus 3x the spread of 4 CPU steps on
            inputs perturbed by 1e-6 (`compare_steps` says why); then the
            same with every body conv on the band route (band_min_voxels=0)
8. full-resolution serving  the same model answers 3 batch-6 requests of
            182x218x182 MRI+PET (the last 2 timed): the stem, both stage-2
            convs (K8) and the lane-vector pools run at full resolution;
            then card float32 against the CPU at 35x37x33 with every body
            conv on the band route
9. full-resolution train  the train step at batch 6, 182x218x182: 2 warm-up
            and 3 timed steps; losses finite, parameters and running
            statistics move, K5, K6, K8 and K9 launched; peak device memory

The line before the last is a JSON object with one entry per kernel: `ms`,
`plain_ms`, `bound_ms`, `bound_by` and `library_ms` belong to the bfloat16
run at the first shape listed for the kernel, `max_abs_err` is the largest
over all its cases, `launches` its count over the four serving and train
runs together, each counted from zero. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCH, VOLUME = 8, (91, 109, 91)
WARMUP, REQUESTS = 3, 6  # requests served; the first WARMUP are not timed
TRAIN_WARMUP, TRAIN_STEPS = 3, 5  # train steps; the first 3 are not timed
FULL_BATCH, FULL_VOLUME = 6, (182, 218, 182)  # the full-resolution phases
FULL_WARMUP, FULL_REQUESTS = 1, 3
FULL_TRAIN_WARMUP, FULL_TRAIN_STEPS = 2, 3
# H100 SXM data sheet: HBM bytes/s; dense FLOP/s of the tensor cores in
# bfloat16 and of the CUDA cores in float32
HBM_RATE = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}
CHECK_BATCH, CHECK_VOLUME = 4, (35, 37, 33)
# the train check's conditioning probe: CPU steps on inputs perturbed by a
# relative CHECK_EPS (a few float32 ulps), and the weight of their spread
CHECK_DRAWS, CHECK_EPS, CHECK_SLACK = 4, 1e-6, 3.0
BF16_RTOL = 2.0 ** -7  # one bfloat16 ulp, relative
SERVING_KERNELS = ("token_pool", "attention_fwd", "stem_conv",
                   "affine_act_pool")
TRAIN_KERNELS = ("token_pool", "attention_fwd", "affine_act_pool",
                 "stem_conv_stats", "stem_dw", "affine_act_pool_bwd")
FULL_SERVING_KERNELS = SERVING_KERNELS + ("band_conv",)
FULL_TRAIN_KERNELS = TRAIN_KERNELS + ("band_conv", "band_dw")


def _median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of `fn`; fewer repeats of a call that takes
    over 20 ms, fewer still over 100 ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = 1e3 * (time.perf_counter() - t0)
    if once > 100.0:
        iters, warmup = 3, 0
    elif once > 20.0:
        iters, warmup = 7, 0
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device="cuda") * scale


def _elem(rtol, atol):
    """|kernel - plain| <= atol + rtol * |plain|, elementwise."""
    return ("elem", rtol, atol)


def _sums(rtol):
    """float32 sums: |kernel - plain| <= rtol * max |plain| (only the order
    of the float32 additions differs)."""
    return ("sum", rtol, 0.0)


@dataclasses.dataclass
class Case:
    """One kernel at one shape: the kernel's wrapper and its plain version
    on the arguments `make(dtype)` builds, one tolerance per output for
    float32 and for bfloat16, the operations the function needs on those
    arguments, and the one PyTorch call (if any) that computes the same."""
    name: str
    label: str
    kern: object
    plain: object
    make: object
    tol32: list
    tol16: list
    # args -> (operations, "mma" for products the tensor cores take in
    # bfloat16, or "f32" for elementwise float32 arithmetic)
    work: object
    library: object = None


def _by_sample(plain, batched, summed=()):
    """`plain` run on one sample at a time: the arguments at the positions
    `batched` are sliced along the batch, the outputs at the positions
    `summed` (sums over the batch) are added in float64 and rounded once to
    float32, the others concatenated. The same function as `plain` on the
    whole batch, with temporaries of one sample."""
    def run(*args):
        parts = []
        for i in range(args[batched[0]].shape[0]):
            out = plain(*(a[i:i + 1] if j in batched else a
                          for j, a in enumerate(args)))
            parts.append(out if isinstance(out, tuple) else (out,))
        outs = tuple(torch.stack(col).double().sum(0).float() if k in summed
                     else torch.cat(col) for k, col in enumerate(zip(*parts)))
        return outs if len(outs) > 1 else outs[0]
    return run


def _kernel_cases(g):
    from torch.nn.grad import conv3d_weight

    from transmf_ad_tpu_torch.ops import band_conv, pool3d, pooling, stem
    from transmf_ad_tpu_torch.ops.flash_attention import (attention_reference,
                                                          fused_attention)

    def attn(b, h, n, d):
        def make(dt):
            q, k, v = (_randn(g, b, h, n, d).to(dt) for _ in range(3))
            return q, k, v, d ** -0.5
        return make

    def affine(shape, lanes):
        n = shape[3] * shape[4] if lanes else shape[4]
        return 1.0 + 0.5 * _randn(g, n), 0.3 * _randn(g, n)

    def pool(shape, lanes):
        def make(dt):
            return (_randn(g, *shape).to(dt), *affine(shape, lanes), 0.01)
        return make

    def pool_bwd(shape, lanes, mode, identity=False):
        """inputs of K7: y, the affine, the plain forward's output p (so
        both sides see the same p) and a pooled gradient g"""
        def make(dt):
            y = _randn(g, *shape).to(dt)
            s, b = affine(shape, lanes)
            slope = 0.01
            if identity:
                s, b, slope = torch.ones_like(s), torch.zeros_like(b), 1.0
            p = _by_sample(pool3d.affine_act_pool_reference, (0,))(
                y, s, b, slope, mode)
            return y, s, b, p, _randn(g, *p.shape).to(dt), slope
        return make

    def k7(mode, lanes, round_gi):
        def kern(y, s, b, p, gg, slope):
            return pool3d.affine_act_pool_bwd(y, s, b, p, gg, slope, mode,
                                              lanes, round_gi)

        def plain(y, s, b, p, gg, slope):
            return pool3d.affine_act_pool_bwd_reference(y, s, b, p, gg, slope,
                                                        mode, round_gi)
        return kern, plain

    def stem_in(b, volume):
        def make(dt):
            return (_randn(g, b, *volume).to(dt),
                    _randn(g, 3, 3, 3, 32, scale=0.2).to(dt))
        return make

    def dw_in(b, volume):
        def make(dt):
            return (_randn(g, b, *volume).to(dt),
                    _randn(g, b, *volume, 32).to(dt),
                    _randn(g, b, *volume, 32).to(dt), _randn(g, 32),
                    _randn(g, 32, scale=0.1))
        return make

    def band_in(cin, cout):
        def make(dt):
            return (_randn(g, FULL_BATCH, *VOLUME, cin).to(dt),
                    _randn(g, 3, 3, 3, cin, cout,
                           scale=(13.5 * cin) ** -0.5).to(dt))
        return make

    def band_dw_in(cin, cout, with_ab):
        def make(dt):
            x = _randn(g, FULL_BATCH, *VOLUME, cin).to(dt)
            gy = _randn(g, FULL_BATCH, *VOLUME, cout).to(dt)
            if not with_ab:
                return x, gy
            return (x, gy, _randn(g, FULL_BATCH, *VOLUME, cout).to(dt),
                    _randn(g, cout), _randn(g, cout, scale=0.1))
        return make

    # operations: 2 per multiply-add of a product, a handful per element of
    # an elementwise pass
    def conv_ops(x, w, *_):
        return 2 * 27 * x.numel() * w.shape[-1], "mma"

    def band_dw_ops(x, gy, *_):
        return 2 * 27 * x.numel() * gy.shape[-1], "mma"

    def stem_dw_ops(x, y, *_):
        return 2 * 27 * y.numel(), "mma"

    def attn_ops(q, k, *_):
        return 4 * q.numel() * k.shape[2], "mma"

    def pool_ops(y, *_):
        return 4 * y.numel(), "f32"  # multiply, add, select, max or add

    def pool_bwd_ops(y, *_):
        return 10 * y.numel(), "f32"

    def token_ops(mri, pet):
        return 2 * (mri.numel() + pet.numel()), "f32"

    # the one PyTorch call that computes the same function, for its time
    def lib_stem(x, w):
        return F.conv3d(x.unsqueeze(1), stem._oidhw(w), padding=1)

    def lib_stem_dw(x, y, gy, a, b2):
        return conv3d_weight(x.unsqueeze(1), (y.shape[-1], 1, 3, 3, 3),
                             gy.permute(0, 4, 1, 2, 3), padding=1)

    def lib_band(x, w):
        wt = w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        return F.conv3d(x.permute(0, 4, 1, 2, 3), wt, padding=1)

    def lib_band_dw(x, gy, *_):
        return conv3d_weight(x.permute(0, 4, 1, 2, 3),
                             (gy.shape[-1], x.shape[-1], 3, 3, 3),
                             gy.permute(0, 4, 1, 2, 3), padding=1)

    def lib_attn(q, k, v, scale):
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    max_ref = functools.partial(pool3d.affine_act_pool_reference, mode="max")
    avg_ref = functools.partial(pool3d.affine_act_pool_reference, mode="avg")
    exact = [_elem(0.0, 0.0)]
    # float32: the order of f32 sums differs (and cuDNN may pick Winograd or
    # FFT algorithms for the plain conv); bfloat16: one ulp of the output,
    # since both sides round the same f32 value once
    sums = [_elem(1e-4, 2e-5)], [_elem(BF16_RTOL, 1e-4)]
    conv = [_elem(1e-4, 1e-4)], [_elem(BF16_RTOL, 1e-3)]
    # K7: dy is the same float32 arithmetic on both sides (exact; one bf16
    # ulp allowed); d(scale), d(shift), the BN sums and dw are float32 sums
    # over up to 4.3e7 terms in another order (1e-4 of their largest
    # magnitude, 1e-2 from bfloat16 inputs)
    bwd = ([_elem(0.0, 0.0), _sums(1e-4)], [_elem(BF16_RTOL, 0.0),
                                             _sums(1e-2)])
    conv_stats = conv[0] + [_sums(1e-4)], conv[1] + [_sums(1e-2)]
    dw_tol = [_sums(1e-4)], [_sums(1e-2)]
    stage1, stage2 = (BATCH, *VOLUME, 32), (BATCH, 45, 54, 45, 64)
    stage3, stage4 = (BATCH, 22, 27, 22, 128), (BATCH, 11, 13, 11, 128)
    # the full-resolution shapes, at the step's batch: the stem's output
    # (2.77 GB in bfloat16, over 2^31 bytes) and the stage-2 end; the plain
    # versions of the stem's kernels and of its pool go sample by sample
    full1 = (FULL_BATCH, *FULL_VOLUME, 32)
    full2 = (FULL_BATCH, *VOLUME, 64)
    full_in = f"({FULL_BATCH},{','.join(map(str, FULL_VOLUME))})"
    k7_full, k7_full_plain = k7("max", True, True)
    band_fwd = functools.partial(band_conv._band_forward, stats=False)
    band_fwd_stats = functools.partial(band_conv._band_forward, stats=True)
    cases = [
        Case("token_pool", "(8,150,128)x2", pooling.fused_token_pool,
             pooling.pool_reference,
             lambda dt: (_randn(g, 8, 150, 128).to(dt),
                         _randn(g, 8, 150, 128).to(dt)), *sums, token_ops),
        Case("attention_fwd", "(32,150,32)", fused_attention,
             attention_reference, attn(8, 4, 150, 32), *sums, attn_ops,
             lib_attn),
        Case("attention_fwd", "(8,1573,32)", fused_attention,
             attention_reference, attn(2, 4, 1573, 32), *sums, attn_ops,
             lib_attn),
        Case("stem_conv", "(8,91,109,91)->C32", stem.stem_conv,
             stem._conv_reference, stem_in(BATCH, VOLUME), *conv, conv_ops,
             lib_stem),
        Case("affine_act_pool", "max lanes (8,91,109,91,32)",
             pool3d.max_pool3d_2x2_affine_act, max_ref, pool(stage1, True),
             exact, exact, pool_ops),
        Case("affine_act_pool", "max chan (8,45,54,45,64)",
             pool3d.max_pool3d_2x2_affine_act_bc, max_ref,
             pool(stage2, False), exact, exact, pool_ops),
        Case("affine_act_pool", "max chan (8,22,27,22,128)",
             pool3d.max_pool3d_2x2_affine_act_bc, max_ref,
             pool(stage3, False), exact, exact, pool_ops),
        Case("affine_act_pool", "avg chan (8,11,13,11,128)",
             pool3d.avg_pool3d_2x2_affine_act, avg_ref, pool(stage4, False),
             [_elem(1e-6, 1e-6)], [_elem(BF16_RTOL, 0.0)], pool_ops),
        Case("stem_conv_stats", "(8,91,109,91)->C32 + (2,32) sums",
             stem.stem_conv_stats, stem._stem_stats_reference,
             stem_in(BATCH, VOLUME), *conv_stats, conv_ops, lib_stem),
        Case("stem_dw", "(8,91,109,91) x (..,32) -> (3,3,3,32)", stem.stem_dw,
             stem.stem_dw_reference, dw_in(BATCH, VOLUME), *dw_tol,
             stem_dw_ops, lib_stem_dw),
        Case("affine_act_pool_bwd", "max lanes (8,91,109,91,32)",
             *k7("max", True, True), pool_bwd(stage1, True, "max"), *bwd,
             pool_bwd_ops),
        Case("affine_act_pool_bwd", "max chan (8,45,54,45,64)",
             *k7("max", False, False), pool_bwd(stage2, False, "max"), *bwd,
             pool_bwd_ops),
        Case("affine_act_pool_bwd", "max chan (8,22,27,22,128)",
             *k7("max", False, False), pool_bwd(stage3, False, "max"), *bwd,
             pool_bwd_ops),
        Case("affine_act_pool_bwd", "avg chan (8,11,13,11,128)",
             *k7("avg", False, False), pool_bwd(stage4, False, "avg"), *bwd,
             pool_bwd_ops),
        Case("affine_act_pool_bwd", "identity max (8,11,13,11,128)",
             *k7("max", False, True),
             pool_bwd(stage4, False, "max", identity=True), *bwd,
             pool_bwd_ops),
        # --- the full-resolution path -------------------------------------
        Case("stem_conv", f"{full_in}->C32", stem.stem_conv,
             _by_sample(stem._conv_reference, (0,)),
             stem_in(FULL_BATCH, FULL_VOLUME), *conv, conv_ops, lib_stem),
        Case("stem_conv_stats", f"{full_in}->C32 + (2,32) sums",
             stem.stem_conv_stats,
             _by_sample(stem._stem_stats_reference, (0,), summed=(1,)),
             stem_in(FULL_BATCH, FULL_VOLUME), *conv_stats, conv_ops,
             lib_stem),
        Case("stem_dw", f"{full_in} x (..,32) -> (3,3,3,32)", stem.stem_dw,
             _by_sample(stem.stem_dw_reference, (0, 1, 2), summed=(0,)),
             dw_in(FULL_BATCH, FULL_VOLUME), *dw_tol, stem_dw_ops,
             lib_stem_dw),
        Case("affine_act_pool", f"max lanes {full_in[:-1]},32), 5824 lanes",
             pool3d.max_pool3d_2x2_affine_act, _by_sample(max_ref, (0,)),
             pool(full1, True), exact, exact, pool_ops),
        Case("affine_act_pool", "max lanes (6,91,109,91,64), 5824 lanes",
             pool3d.max_pool3d_2x2_affine_act, max_ref, pool(full2, True),
             exact, exact, pool_ops),
        Case("affine_act_pool_bwd",
             f"max lanes {full_in[:-1]},32), 5824 lanes", k7_full,
             _by_sample(k7_full_plain, (0, 3, 4), summed=(1,)),
             pool_bwd(full1, True, "max"), *bwd, pool_bwd_ops),
        Case("affine_act_pool_bwd", "max lanes (6,91,109,91,64), 5824 lanes",
             *k7("max", True, True), pool_bwd(full2, True, "max"), *bwd,
             pool_bwd_ops),
    ]
    # K8 and K9 at the stage-2 volume of a 182x218x182 input: the two convs
    # and their input gradients (Cin and Cout swapped)
    for cin, cout in ((32, 32), (32, 64), (64, 32)):
        shape = f"(6,91,109,91) {cin}->{cout}"
        cases.append(Case("band_conv", shape, band_fwd,
                          band_conv.band_conv_reference, band_in(cin, cout),
                          *conv, conv_ops, lib_band))
        if cin == 32:
            cases.append(Case("band_conv", shape + " + (2,C) sums",
                              band_fwd_stats,
                              band_conv.band_conv_stats_reference,
                              band_in(cin, cout), *conv_stats, conv_ops,
                              lib_band))
    for cin, cout in ((32, 32), (32, 64)):
        for with_ab in (True, False):
            cases.append(Case(
                "band_dw", f"(6,91,109,91) {cin}x{cout} -> (3,3,3,{cin},"
                f"{cout})" + (" with a, b2" if with_ab else ""),
                band_conv.band_dw, band_conv.band_dw_reference,
                band_dw_in(cin, cout, with_ab), *dw_tol, band_dw_ops,
                lib_band_dw))
    return cases


def _agree(out, ref, tol) -> bool:
    kind, rtol, atol = tol
    if not bool(torch.isfinite(out).all()):
        return False
    if kind == "sum":
        return bool((out.float() - ref.float()).abs().max()
                    <= rtol * ref.float().abs().max())
    return torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)


def _bound(case, args, outs, tag):
    """(ms, "bytes" or "operations"): the least time the card could take
    for this call, the larger of its bytes (every input tensor read once,
    every output written once) over the HBM rate and its operations over
    the peak for their type: the tensor cores' for products of bfloat16
    inputs, the CUDA cores' float32 rate otherwise."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args, *outs) if isinstance(t, torch.Tensor))
    ops, kind = case.work(*args)
    peak = PEAK[tag] if kind == "mma" else PEAK["float32"]
    by_bytes, by_ops = 1e3 * nbytes / HBM_RATE, 1e3 * ops / peak
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def check_kernels(results):
    g = torch.Generator(device="cuda").manual_seed(1)
    for case in _kernel_cases(g):
        name, label = case.name, case.label
        for dt, dtols in ((torch.float32, case.tol32),
                          (torch.bfloat16, case.tol16)):
            args = case.make(dt)
            outs, refs = case.kern(*args), case.plain(*args)
            torch.cuda.synchronize()
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = refs if isinstance(refs, tuple) else (refs,)
            for o, r in zip(outs, refs, strict=True):
                if o.shape != r.shape or o.dtype != r.dtype:
                    raise AssertionError(f"{name} {label}: {o.shape} "
                                         f"{o.dtype} vs {r.shape} {r.dtype}")
            errs = [(o.float() - r.float()).abs().max().item()
                    for o, r in zip(outs, refs)]
            ok = all(_agree(o, r, t) for o, r, t in zip(outs, refs, dtols,
                                                        strict=True))
            tag = str(dt).replace("torch.", "")
            bound_ms, bound_by = _bound(case, args, outs, tag)
            del refs
            ms = _median_ms(lambda: case.kern(*args))
            plain_ms = _median_ms(lambda: case.plain(*args))
            library_ms = (None if case.library is None
                          else _median_ms(lambda: case.library(*args)))
            verdict = "ok" if ok else "FAIL"
            tol_s = ", ".join(f"{k} rtol={r:.3g} atol={a:.3g}"
                              for k, r, a in dtols)
            lib_s = "none" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"[kernel] {name} {label} {tag}: max_abs_err="
                  f"{[float(f'{e:.3g}') for e in errs]} ({tol_s}) {verdict}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms by {bound_by}, library call {lib_s}",
                  flush=True)
            if not ok:
                raise AssertionError(f"{name} {label} {tag} disagrees with "
                                     f"its plain version: {errs}")
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if dt == torch.bfloat16 and "ms" not in r:  # main-path shape
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
            del args, outs
            torch.cuda.empty_cache()


@torch.no_grad()
def randomize_bn(model, g):
    """Random BN affine and running statistics, so eval BN is far from the
    identity."""
    from transmf_ad_tpu_torch.nn.batchnorm import BatchNormMasked, ManualBN

    for m in model.modules():
        if isinstance(m, (ManualBN, BatchNormMasked)):
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.running_mean.normal_(0.0, 0.2, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)


def serve(card, tag="serving", batch=BATCH, volume=VOLUME, warmup=WARMUP,
          n_requests=REQUESTS, kernels=SERVING_KERNELS):
    """Serve `n_requests` requests of host arrays through
    `make_inference_fn`; returns the model, a float32 CPU copy of it and
    the launch counts of this run, counted from zero."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.ops import reset_launch_counts
    from transmf_ad_tpu_torch.serving import make_inference_fn
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(0)
    model = build_model("ad")
    init_weights(model, g)
    randomize_bn(model, g)
    reference = copy.deepcopy(model)  # float32 CPU copy for phase 5
    fn = make_inference_fn(model, "cuda", "auto")
    rng = np.random.default_rng(0)
    requests = [tuple(rng.standard_normal((batch, *volume), dtype=np.float32)
                      for _ in range(2)) for _ in range(n_requests)]

    reset_launch_counts()
    times = []
    for mri, pet in requests:
        t0 = time.perf_counter()
        probs = fn(mri, pet)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if probs.shape != (batch, 2) or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"{tag}: bad probabilities {probs}")
        if not torch.allclose(probs.sum(-1), torch.ones_like(probs[:, 0]),
                              atol=1e-5):
            raise AssertionError(f"{tag}: rows do not sum to 1: {probs}")
    launches = _launches()
    missing = [n for n in kernels if launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag} never launched {missing}")
    steady = times[warmup:]
    vols = batch * len(steady) / sum(steady)
    print(f"[{tag}] ModelAd dim=128 depth=3 bf16, batch {batch} x "
          f"{volume} MRI+PET, {len(steady)} requests after {warmup} warm-up: "
          f"{vols:.2f} vols/s ({1e3 * np.median(steady):.2f} ms/request "
          f"median) on {card}; launches {launches}", flush=True)
    print(f"[{tag}] request ms: {[round(1e3 * t, 3) for t in times]}",
          flush=True)
    print(f"[{tag}] probabilities of the last request: "
          f"{probs[:, 1].tolist()}", flush=True)
    return model, reference, launches


def cross_check(model, reference, volume=VOLUME, tag="check"):
    """Same weights, batch 2, float32: the card (kernels, TF32 off) against
    the CPU (plain path). Both sides compute in float32; they differ only in
    the order of float32 sums (and cuDNN's choice of conv algorithm), which
    keeps them within 1e-4 of the outputs' scale (3e-7 was measured on an
    H100), while a wrong layout, tap or rounding step moves them by O(1)."""
    rng = np.random.default_rng(2)
    mri, pet = (torch.from_numpy(rng.standard_normal((2, *volume, 1),
                                                     dtype=np.float32))
                for _ in range(2))
    with torch.inference_mode():
        card = [t.float().cpu() for t in model(mri.cuda(), pet.cuda())]
        cpu = reference.eval()(mri, pet)
    for name, a, b in zip(("logits", "d_mri", "d_pet"), card, cpu):
        err = (a - b).abs().max().item()
        tol = 1e-4 * (1.0 + b.abs().max().item())
        print(f"[{tag}] {name} card f32 vs cpu f32: max_abs_err={err:.3g} "
              f"(tol {tol:.3g}); card {a.flatten().tolist()}", flush=True)
        if not (bool(torch.isfinite(a).all()) and err <= tol):
            raise AssertionError(f"{name}: card and CPU disagree by {err}")


def band_cross_check(reference):
    """`cross_check` at a small volume with every 3x3x3 body conv on the
    band route (band_min_voxels=0) on both sides: K8 on the card against
    its plain version on the CPU, through the whole model."""
    from transmf_ad_tpu_torch.models import build_model

    models = []
    for device in ("cuda", "cpu"):
        m = build_model("ad", band_min_voxels=0)
        m.load_state_dict(reference.state_dict())
        models.append(m.to(device).eval())
    before = _launches()["band_conv"]
    cross_check(*models, volume=CHECK_VOLUME, tag="check, band route")
    if _launches()["band_conv"] != before + 10:  # 2 encoders x 5 convs
        raise AssertionError("the band-route check did not launch K8 for "
                             "every 3x3x3 body conv")


def _launches():
    from transmf_ad_tpu_torch.ops import KERNELS

    return {k.name: k.launches for k in KERNELS}


def _snapshot(model):
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def train(card, tag="train", batch_size=BATCH, volume=VOLUME,
          warmup=TRAIN_WARMUP, steps=TRAIN_STEPS, kernels=TRAIN_KERNELS):
    """The train step at full width: ms/step, volumes/s, every loss, the
    launch counts of this run (counted from zero) and its peak memory."""
    from transmf_ad_tpu_torch.data.transforms import AugmentConfig
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.ops import reset_launch_counts
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(3)
    model = build_model("ad")  # head dropout 0.5
    init_weights(model, g)
    randomize_bn(model, g)
    state = create_state(model, "cuda", "auto", seed=0, name="Adam",
                         lr=1e-4)
    step = make_train_step(aug_cfg=AugmentConfig())
    # [0, 1]-normalised volumes made on the device, as a device feed holds
    # them; labels alternate
    dg = torch.Generator(device="cuda").manual_seed(4)
    batches = [{"MRI": torch.rand(batch_size, *volume, generator=dg,
                                  device="cuda"),
                "PET": torch.rand(batch_size, *volume, generator=dg,
                                  device="cuda"),
                "label": torch.arange(batch_size, device="cuda") % 2}
               for _ in range(warmup + steps)]
    before = _snapshot(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        aux = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
    launches = _launches()
    missing = [n for n in kernels if launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag}: the step never launched {missing}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    after = _snapshot(model)
    still = [k for k in after if (k.endswith("weight") or "running" in k)
             and torch.equal(after[k], before[k])]
    if still:
        raise AssertionError(f"{tag}: unchanged after {len(batches)} steps: "
                             f"{still}")
    steady = times[warmup:]
    print(f"[{tag}] ModelAd dim=128 depth=3 bf16 (f32 master weights), "
          f"batch {batch_size} x {volume} MRI+PET, augmentation on, head "
          f"dropout 0.5, Adam 1e-4: {len(steady)} steps after {warmup} "
          f"warm-up: {batch_size * len(steady) / sum(steady):.2f} vols/s "
          f"({1e3 * np.median(steady):.2f} ms/step median) on {card}; "
          f"launches {launches}", flush=True)
    print(f"[{tag}] step ms: {[round(1e3 * t, 3) for t in times]}",
          flush=True)
    print(f"[{tag}] losses: {losses}", flush=True)
    print(f"[{tag}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


def sgd_step(model, device, batch):
    """One step of the port's train step with SGD (lr 1, no momentum, so
    each parameter update is minus its gradient) in float32: name -> tensor
    on the CPU for the three losses, every parameter update and every
    running statistic."""
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    before = _snapshot(model)
    aux = make_train_step()(create_state(model, device, torch.float32,
                                         name="SGD", lr=1.0, milestones=()),
                            batch)
    out = {k: aux[k].float().cpu() for k in ("loss", "ce_loss", "ad_loss")}
    for k, v in _snapshot(model).items():
        if "running" in k:
            out[k] = v
        else:
            out[k + " update"] = v - before[k]
    return out


def compare_steps(card, cpu, perturbed):
    """Hold each tensor of `card` against `cpu` (dicts from `sgd_step`).

    A one-step update of this network is ill-conditioned in float32: a max
    pool's winner or a LeakyReLU's side flips when its margin is below the
    rounding difference of the two sides, and each flip moves a weight
    gradient by a finite amount; a Linear bias before a training BatchNorm
    has an exact gradient of 0, so its update is rounding alone. The
    conditioning is measured on the spot: `perturbed` holds CPU steps on the
    inputs times (1 + CHECK_EPS * N(0, 1)). Tolerance per tensor: 1e-3 of
    its largest magnitude + 1e-6, plus CHECK_SLACK times the largest
    distance of a perturbed step from the CPU's. A wrong gradient misses by
    O(1) of the tensor's magnitude. Returns rows (err / tol, err / the 1e-3
    part, name) sorted from the worst."""
    rows = []
    for name, ref in cpu.items():
        noise = max(float((p[name] - ref).abs().max()) for p in perturbed)
        base = 1e-3 * float(ref.abs().max()) + 1e-6
        tol = base + CHECK_SLACK * noise
        err = float((card[name] - ref).abs().max())
        if not (bool(torch.isfinite(card[name]).all()) and err <= tol):
            raise AssertionError(
                f"train check: {name} card vs cpu differ by {err} (tol "
                f"{tol}: {base} + {CHECK_SLACK} x {noise} from the "
                f"perturbed steps)")
        rows.append((err / tol, err / base, name))
    return sorted(rows, reverse=True)


def check_batch(seed):
    """The train check's batch: [0, 1) volumes from a numpy seed, labels
    alternating."""
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.random((CHECK_BATCH, *CHECK_VOLUME),
                                            dtype=np.float32))
             for k in ("MRI", "PET")}
    batch["label"] = torch.arange(CHECK_BATCH) % 2
    return batch


def perturb(batch, seed):
    """The batch's volumes times (1 + CHECK_EPS * N(0, 1)), drawn from
    `seed`."""
    g = torch.Generator().manual_seed(seed)
    return {k: v if k == "label" else
            v * (1.0 + CHECK_EPS * torch.randn(v.shape, generator=g))
            for k, v in batch.items()}


def train_check(**model_kw):
    """One SGD step with the same weights on the card (kernels, float32,
    TF32 off) and on the CPU (plain versions), at full width, batch 4 (with
    2 samples every BatchNorm1d gradient is O(eps / var), a difference of
    rounding), no augmentation or dropout: the losses, every parameter
    update and every running statistic agree (`compare_steps`).
    `model_kw` (band_min_voxels=0: every 3x3x3 body conv through K8 and
    K9) goes to `build_model`."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(5)
    model = build_model("ad", head_dropout=0.0, **model_kw)
    init_weights(model, g)
    randomize_bn(model, g)
    batch = check_batch(5)
    cpu = sgd_step(copy.deepcopy(model), "cpu", batch)
    perturbed = [sgd_step(copy.deepcopy(model), "cpu", perturb(batch, d))
                 for d in range(CHECK_DRAWS)]
    before = _launches()
    card = sgd_step(model, "cuda", batch)
    if model_kw.get("band_min_voxels") == 0:
        after = _launches()
        # per encoder 5 convs: forward and dx through K8, dw through K9
        if (after["band_conv"] != before["band_conv"] + 20
                or after["band_dw"] != before["band_dw"] + 10):
            raise AssertionError("train check: the band route did not "
                                 "launch K8 and K9 for every body conv")
    rows = compare_steps(card, cpu, perturbed)
    within = sum(r[1] <= 1.0 for r in rows)
    print(f"[train check{' ' + str(model_kw) if model_kw else ''}] one SGD "
          f"step, full width, batch {CHECK_BATCH} x "
          f"{CHECK_VOLUME}, card f32 vs cpu f32: loss "
          f"{float(card['loss']):.6f} vs {float(cpu['loss']):.6f}; all "
          f"{len(rows)} tensors agree, {within} of them within 1e-3 of "
          f"their largest magnitude; closest to the tolerance: "
          f"{[(n, round(t, 3), round(b, 3)) for t, b, n in rows[:4]]} "
          f"(name, of the tolerance, of the 1e-3 part)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from transmf_ad_tpu_torch import _build
    from transmf_ad_tpu_torch.ops import KERNELS

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line:
            print(f"[build] {line.split(':', 1)[-1].strip()}", flush=True)

    results: dict = {}
    check_kernels(results)
    model, reference, serving = serve(card)
    cross_check(model, reference)
    del model, reference
    torch.cuda.empty_cache()
    trained = train(card)
    train_check()
    train_check(band_min_voxels=0)
    model, reference, full_serving = serve(
        card, "serving, full resolution", FULL_BATCH, FULL_VOLUME,
        FULL_WARMUP, FULL_REQUESTS, FULL_SERVING_KERNELS)
    del model
    torch.cuda.empty_cache()
    band_cross_check(reference)
    del reference
    full_trained = train(card, "train, full resolution", FULL_BATCH,
                         FULL_VOLUME, FULL_TRAIN_WARMUP, FULL_TRAIN_STEPS,
                         FULL_TRAIN_KERNELS)
    runs = {"serving": serving, "train": trained,
            "serving, full resolution": full_serving,
            "train, full resolution": full_trained}
    print(f"[launches] {runs}", flush=True)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces,
                "launches": sum(run[k.name] for run in runs.values()),
                **results[k.name]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
