#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (transmf_ad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the final line:

1. device   a CUDA device, or exit 1 (there is no CPU fallback); the card's
            name and power limit as nvidia-smi reports them
2. build    compile csrc/*.cu with nvcc (timed) and load the library
3. kernels  each hand-written kernel against its plain PyTorch version on the
            card, float32 and bfloat16, at the shapes the serving path gives
            it: max error against a stated tolerance, kernel and plain median
            times from CUDA events
4. serving  full-width ModelAd (dim 128, depth 3, 4 heads x 32, mlp 512) in
            bfloat16, random weights and BN statistics from a seeded
            torch.Generator, answers 8 batch-8 requests of 91x109x91
            MRI+PET (the last 5 timed); every kernel's launch count must rise
5. check    the same weights at batch 2 in float32 (TF32 off) on the card and
            through the plain path on the CPU: logits, d_mri and d_pet agree

The line before the last is a JSON object with one entry per kernel (its
`ms` and `plain_ms` are the bfloat16 times at the first shape listed for
it); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, VOLUME = 8, (91, 109, 91)
WARMUP, REQUESTS = 3, 8  # requests served; the first WARMUP are not timed
BF16_RTOL = 2.0 ** -7  # one bfloat16 ulp, relative


def _median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def _kernel_cases(g):
    """(kernel name, label, kernel fn, plain fn, args builder, f32 tol,
    bf16 tol); tolerances are (rtol, atol)."""
    from transmf_ad_tpu_torch.ops import pool3d, pooling, stem
    from transmf_ad_tpu_torch.ops.flash_attention import (attention_reference,
                                                          fused_attention)

    def attn(b, h, n, d):
        def make(dt):
            q, k, v = (_randn(g, b, h, n, d).to(dt) for _ in range(3))
            return q, k, v, d ** -0.5
        return make

    def pool_lanes(shape):
        def make(dt):
            z, c = shape[3], shape[4]
            return (_randn(g, *shape).to(dt),
                    1.0 + 0.5 * _randn(g, z * c), 0.3 * _randn(g, z * c), 0.01)
        return make

    def pool_chan(shape):
        def make(dt):
            c = shape[4]
            return (_randn(g, *shape).to(dt), 1.0 + 0.5 * _randn(g, c),
                    0.3 * _randn(g, c), 0.01)
        return make

    max_ref = functools.partial(pool3d.affine_act_pool_reference, mode="max")
    avg_ref = functools.partial(pool3d.affine_act_pool_reference, mode="avg")
    exact = ((0.0, 0.0), (0.0, 0.0))
    # float32: the order of f32 sums differs (and cuDNN may pick Winograd or
    # FFT algorithms for the plain conv); bfloat16: one ulp of the output,
    # since both sides round the same f32 value once
    sums = ((1e-4, 2e-5), (BF16_RTOL, 1e-4))
    return [
        ("token_pool", "(8,150,128)x2", pooling.fused_token_pool,
         pooling.pool_reference,
         lambda dt: (_randn(g, 8, 150, 128).to(dt),
                     _randn(g, 8, 150, 128).to(dt)), sums),
        ("attention_fwd", "(32,150,32)", fused_attention,
         attention_reference, attn(8, 4, 150, 32), sums),
        ("attention_fwd", "(8,1573,32)", fused_attention,
         attention_reference, attn(2, 4, 1573, 32), sums),
        ("stem_conv", "(8,91,109,91)->C32", stem.stem_conv,
         stem._conv_reference,
         lambda dt: (_randn(g, BATCH, *VOLUME).to(dt),
                     _randn(g, 3, 3, 3, 32, scale=0.2).to(dt)),
         ((1e-4, 1e-4), (BF16_RTOL, 1e-3))),
        ("affine_act_pool", "max lanes (8,91,109,91,32)",
         pool3d.max_pool3d_2x2_affine_act, max_ref,
         pool_lanes((BATCH, *VOLUME, 32)), exact),
        ("affine_act_pool", "max chan (8,45,54,45,64)",
         pool3d.max_pool3d_2x2_affine_act_bc, max_ref,
         pool_chan((BATCH, 45, 54, 45, 64)), exact),
        ("affine_act_pool", "max chan (8,22,27,22,128)",
         pool3d.max_pool3d_2x2_affine_act_bc, max_ref,
         pool_chan((BATCH, 22, 27, 22, 128)), exact),
        ("affine_act_pool", "avg chan (8,11,13,11,128)",
         pool3d.avg_pool3d_2x2_affine_act, avg_ref,
         pool_chan((BATCH, 11, 13, 11, 128)),
         ((1e-6, 1e-6), (BF16_RTOL, 0.0))),
    ]


def check_kernels(results):
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, label, kern, plain, make, tols in _kernel_cases(g):
        for dt, (rtol, atol) in zip((torch.float32, torch.bfloat16), tols):
            args = make(dt)
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"{name} {label}: {out.shape} {out.dtype}"
                                     f" vs {ref.shape} {ref.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and torch.allclose(
                out.float(), ref.float(), rtol=rtol, atol=atol)
            ms = _median_ms(lambda: kern(*args))
            plain_ms = _median_ms(lambda: plain(*args))
            tag = str(dt).replace("torch.", "")
            verdict = "ok" if ok else "FAIL"
            print(f"[kernel] {name} {label} {tag}: max_abs_err={err:.3g} "
                  f"(rtol={rtol:.3g}, atol={atol:.3g}) {verdict}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            if not ok:
                raise AssertionError(f"{name} {label} {tag} disagrees with "
                                     f"its plain version: {err}")
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dt == torch.bfloat16 and "ms" not in r:  # main-path shape
                r.update(ms=ms, plain_ms=plain_ms)
            del args, out, ref


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


def serve(card):
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.ops import KERNELS, reset_launch_counts
    from transmf_ad_tpu_torch.serving import make_inference_fn
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(0)
    model = build_model("ad")
    init_weights(model, g)
    randomize_bn(model, g)
    reference = copy.deepcopy(model)  # float32 CPU copy for phase 5
    fn = make_inference_fn(model, "cuda", "auto")
    rng = np.random.default_rng(0)
    requests = [tuple(rng.standard_normal((BATCH, *VOLUME), dtype=np.float32)
                      for _ in range(2)) for _ in range(REQUESTS)]

    reset_launch_counts()
    times = []
    for mri, pet in requests:
        t0 = time.perf_counter()
        probs = fn(mri, pet)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if probs.shape != (BATCH, 2) or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"serving: bad probabilities {probs}")
        if not torch.allclose(probs.sum(-1), torch.ones_like(probs[:, 0]),
                              atol=1e-5):
            raise AssertionError(f"serving: rows do not sum to 1: {probs}")
    launches = {k.name: k.launches for k in KERNELS}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"serving never launched {missing}")
    steady = times[WARMUP:]
    vols = BATCH * len(steady) / sum(steady)
    print(f"[serving] ModelAd dim=128 depth=3 bf16, batch {BATCH} x "
          f"{VOLUME} MRI+PET, {len(steady)} requests after {WARMUP} warm-up: "
          f"{vols:.2f} vols/s ({1e3 * np.median(steady):.2f} ms/request "
          f"median) on {card}; launches {launches}", flush=True)
    print(f"[serving] request ms: {[round(1e3 * t, 3) for t in times]}",
          flush=True)
    print(f"[serving] probabilities of the last request: "
          f"{probs[:, 1].tolist()}", flush=True)
    return model, reference, launches


def cross_check(model, reference):
    """Same weights, batch 2, float32: the card (kernels, TF32 off) against
    the CPU (plain path). Both sides compute in float32; they differ only in
    the order of float32 sums (and cuDNN's choice of conv algorithm), which
    keeps them within 1e-4 of the outputs' scale (3e-7 was measured on an
    H100), while a wrong layout, tap or rounding step moves them by O(1)."""
    rng = np.random.default_rng(2)
    mri, pet = (torch.from_numpy(rng.standard_normal((2, *VOLUME, 1),
                                                     dtype=np.float32))
                for _ in range(2))
    with torch.inference_mode():
        card = [t.float().cpu() for t in model(mri.cuda(), pet.cuda())]
        cpu = reference.eval()(mri, pet)
    for name, a, b in zip(("logits", "d_mri", "d_pet"), card, cpu):
        err = (a - b).abs().max().item()
        tol = 1e-4 * (1.0 + b.abs().max().item())
        print(f"[check] {name} card f32 vs cpu f32: max_abs_err={err:.3g} "
              f"(tol {tol:.3g}); card {a.flatten().tolist()}", flush=True)
        if not (bool(torch.isfinite(a).all()) and err <= tol):
            raise AssertionError(f"{name}: card and CPU disagree by {err}")


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
    model, reference, launches = serve(card)
    cross_check(model, reference)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.name],
                "max_abs_err": results[k.name]["max_abs_err"],
                "ms": results[k.name]["ms"],
                "plain_ms": results[k.name]["plain_ms"]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
