#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (transmf_ad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the final line:

1. device   a CUDA device, or exit 1 (there is no CPU fallback); the card's
            name and power limit as nvidia-smi reports them
2. build    compile csrc/*.cu with nvcc, one process per source (timed), and
            load the library
3. kernels  each hand-written kernel against its plain PyTorch version on the
            card, float32 and bfloat16, at the shapes the serving path and
            the train step give it: max error against a stated tolerance,
            kernel and plain median times from CUDA events
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
            inputs perturbed by 1e-6 (`compare_steps` says why)

The line before the last is a JSON object with one entry per kernel (its
`ms` and `plain_ms` are the bfloat16 times at the first shape listed for
it, `launches` its count in the serving and train runs together); the last
line is {"ok": true, "device": {...}}.
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
WARMUP, REQUESTS = 3, 6  # requests served; the first WARMUP are not timed
TRAIN_WARMUP, TRAIN_STEPS = 3, 5  # train steps; the first 3 are not timed
CHECK_BATCH, CHECK_VOLUME = 4, (35, 37, 33)
# the train check's conditioning probe: CPU steps on inputs perturbed by a
# relative CHECK_EPS (a few float32 ulps), and the weight of their spread
CHECK_DRAWS, CHECK_EPS, CHECK_SLACK = 4, 1e-6, 3.0
BF16_RTOL = 2.0 ** -7  # one bfloat16 ulp, relative
SERVING_KERNELS = ("token_pool", "attention_fwd", "stem_conv",
                   "affine_act_pool")
TRAIN_KERNELS = ("token_pool", "attention_fwd", "affine_act_pool",
                 "stem_conv_stats", "stem_dw", "affine_act_pool_bwd")


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


def _elem(rtol, atol):
    """|kernel - plain| <= atol + rtol * |plain|, elementwise."""
    return ("elem", rtol, atol)


def _sums(rtol):
    """float32 sums: |kernel - plain| <= rtol * max |plain| (only the order
    of the float32 additions differs)."""
    return ("sum", rtol, 0.0)


def _kernel_cases(g):
    """(kernel name, label, kernel fn, plain fn, args builder, float32
    tolerances, bfloat16 tolerances), one tolerance per output."""
    from transmf_ad_tpu_torch.ops import pool3d, pooling, stem
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
            p = pool3d.affine_act_pool_reference(y, s, b, slope, mode)
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

    def stem_in(dt):
        return (_randn(g, BATCH, *VOLUME).to(dt),
                _randn(g, 3, 3, 3, 32, scale=0.2).to(dt))

    def dw_in(dt):
        x, _ = stem_in(dt)
        return (x, _randn(g, BATCH, *VOLUME, 32).to(dt),
                _randn(g, BATCH, *VOLUME, 32).to(dt), _randn(g, 32),
                _randn(g, 32, scale=0.1))

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
    # over up to 2.9e7 terms in another order (1e-4 of their largest
    # magnitude, 1e-2 from bfloat16 inputs)
    bwd = ([_elem(0.0, 0.0), _sums(1e-4)], [_elem(BF16_RTOL, 0.0),
                                             _sums(1e-2)])
    stage1, stage2 = (BATCH, *VOLUME, 32), (BATCH, 45, 54, 45, 64)
    stage3, stage4 = (BATCH, 22, 27, 22, 128), (BATCH, 11, 13, 11, 128)
    return [
        ("token_pool", "(8,150,128)x2", pooling.fused_token_pool,
         pooling.pool_reference,
         lambda dt: (_randn(g, 8, 150, 128).to(dt),
                     _randn(g, 8, 150, 128).to(dt)), *sums),
        ("attention_fwd", "(32,150,32)", fused_attention,
         attention_reference, attn(8, 4, 150, 32), *sums),
        ("attention_fwd", "(8,1573,32)", fused_attention,
         attention_reference, attn(2, 4, 1573, 32), *sums),
        ("stem_conv", "(8,91,109,91)->C32", stem.stem_conv,
         stem._conv_reference, stem_in, *conv),
        ("affine_act_pool", "max lanes (8,91,109,91,32)",
         pool3d.max_pool3d_2x2_affine_act, max_ref, pool(stage1, True),
         exact, exact),
        ("affine_act_pool", "max chan (8,45,54,45,64)",
         pool3d.max_pool3d_2x2_affine_act_bc, max_ref, pool(stage2, False),
         exact, exact),
        ("affine_act_pool", "max chan (8,22,27,22,128)",
         pool3d.max_pool3d_2x2_affine_act_bc, max_ref, pool(stage3, False),
         exact, exact),
        ("affine_act_pool", "avg chan (8,11,13,11,128)",
         pool3d.avg_pool3d_2x2_affine_act, avg_ref, pool(stage4, False),
         [_elem(1e-6, 1e-6)], [_elem(BF16_RTOL, 0.0)]),
        ("stem_conv_stats", "(8,91,109,91)->C32 + (2,32) sums",
         stem.stem_conv_stats, stem._stem_stats_reference, stem_in,
         conv[0] + [_sums(1e-4)], conv[1] + [_sums(1e-2)]),
        ("stem_dw", "(8,91,109,91) x (..,32) -> (3,3,3,32)", stem.stem_dw,
         stem.stem_dw_reference, dw_in, [_sums(1e-4)], [_sums(1e-2)]),
        ("affine_act_pool_bwd", "max lanes (8,91,109,91,32)",
         *k7("max", True, True), pool_bwd(stage1, True, "max"), *bwd),
        ("affine_act_pool_bwd", "max chan (8,45,54,45,64)",
         *k7("max", False, False), pool_bwd(stage2, False, "max"),
         *bwd),
        ("affine_act_pool_bwd", "max chan (8,22,27,22,128)",
         *k7("max", False, False), pool_bwd(stage3, False, "max"),
         *bwd),
        ("affine_act_pool_bwd", "avg chan (8,11,13,11,128)",
         *k7("avg", False, False), pool_bwd(stage4, False, "avg"),
         *bwd),
        ("affine_act_pool_bwd", "identity max (8,11,13,11,128)",
         *k7("max", False, True),
         pool_bwd(stage4, False, "max", identity=True), *bwd),
    ]


def _agree(out, ref, tol) -> bool:
    kind, rtol, atol = tol
    if not bool(torch.isfinite(out).all()):
        return False
    if kind == "sum":
        return bool((out.float() - ref.float()).abs().max()
                    <= rtol * ref.float().abs().max())
    return torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)


def check_kernels(results):
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, label, kern, plain, make, *tols in _kernel_cases(g):
        for dt, dtols in zip((torch.float32, torch.bfloat16), tols):
            args = make(dt)
            outs, refs = kern(*args), plain(*args)
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
            ms = _median_ms(lambda: kern(*args))
            plain_ms = _median_ms(lambda: plain(*args))
            tag = str(dt).replace("torch.", "")
            verdict = "ok" if ok else "FAIL"
            tol_s = ", ".join(f"{k} rtol={r:.3g} atol={a:.3g}"
                              for k, r, a in dtols)
            print(f"[kernel] {name} {label} {tag}: max_abs_err="
                  f"{[float(f'{e:.3g}') for e in errs]} ({tol_s}) {verdict}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            if not ok:
                raise AssertionError(f"{name} {label} {tag} disagrees with "
                                     f"its plain version: {errs}")
            r = results.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            if dt == torch.bfloat16 and "ms" not in r:  # main-path shape
                r.update(ms=ms, plain_ms=plain_ms)
            del args, outs, refs


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
    missing = [n for n in SERVING_KERNELS if launches[n] == 0]
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


def _snapshot(model):
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def train(card):
    """The train step at full width: ms/step, volumes/s, every loss."""
    from transmf_ad_tpu_torch.data.transforms import AugmentConfig
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.ops import KERNELS, reset_launch_counts
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
    batches = [{"MRI": torch.rand(BATCH, *VOLUME, generator=dg,
                                  device="cuda"),
                "PET": torch.rand(BATCH, *VOLUME, generator=dg,
                                  device="cuda"),
                "label": torch.arange(BATCH, device="cuda") % 2}
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    before = _snapshot(model)
    torch.cuda.synchronize()
    reset_launch_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        aux = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
    launches = {k.name: k.launches for k in KERNELS}
    missing = [n for n in TRAIN_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"the train step never launched {missing}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite losses {losses}")
    after = _snapshot(model)
    still = [k for k in after if (k.endswith("weight") or "running" in k)
             and torch.equal(after[k], before[k])]
    if still:
        raise AssertionError(f"train: unchanged after {len(batches)} steps: "
                             f"{still}")
    steady = times[TRAIN_WARMUP:]
    print(f"[train] ModelAd dim=128 depth=3 bf16 (f32 master weights), "
          f"batch {BATCH} x {VOLUME} MRI+PET, augmentation on, head dropout "
          f"0.5, Adam 1e-4: {len(steady)} steps after {TRAIN_WARMUP} warm-up:"
          f" {BATCH * len(steady) / sum(steady):.2f} vols/s "
          f"({1e3 * np.median(steady):.2f} ms/step median) on {card}; "
          f"launches {launches}", flush=True)
    print(f"[train] step ms: {[round(1e3 * t, 3) for t in times]}",
          flush=True)
    print(f"[train] losses: {losses}", flush=True)
    print(f"[train] peak device memory "
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


def train_check():
    """One SGD step with the same weights on the card (kernels, float32,
    TF32 off) and on the CPU (plain versions), at full width, batch 4 (with
    2 samples every BatchNorm1d gradient is O(eps / var), a difference of
    rounding), no augmentation or dropout: the losses, every parameter
    update and every running statistic agree (`compare_steps`)."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.utils.weights import init_weights

    g = torch.Generator().manual_seed(5)
    model = build_model("ad", head_dropout=0.0)
    init_weights(model, g)
    randomize_bn(model, g)
    batch = check_batch(5)
    cpu = sgd_step(copy.deepcopy(model), "cpu", batch)
    perturbed = [sgd_step(copy.deepcopy(model), "cpu", perturb(batch, d))
                 for d in range(CHECK_DRAWS)]
    card = sgd_step(model, "cuda", batch)
    rows = compare_steps(card, cpu, perturbed)
    within = sum(r[1] <= 1.0 for r in rows)
    print(f"[train check] one SGD step, full width, batch {CHECK_BATCH} x "
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
    print(f"[launches] serving {serving}; train {trained}", flush=True)

    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces,
                "launches": serving[k.name] + trained[k.name],
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
