"""Where the time of one full-width train step goes on one GPU.

    python3 profile_train.py [--batch 8] [--volume 91 109 91]
    python3 profile_train.py --batch 6 --volume 182 218 182 [--serving]
    python3 profile_train.py --model transformer_res --batch 6 \
        --volume 182 218 182 --serving

The train step of `chip_smoke.py`'s train phases (bf16, augmentation on,
Adam; batch 8 at 91x109x91 by default, batch 6 at 182x218x182 for the
full-resolution step; ModelAd by default, `--model` for another ported
model), and each of its parts run alone. Per part: wall ms
(median of 7 after a warm-up, host clock around a synchronised call) and
device ms (torch.profiler: the union of device-event intervals over 3 calls,
divided by 3). Then the largest device kernels of 3 profiled steps, the
kernel launches per step and the peak device memory of a step. With
--serving, the same for one serving request of that batch and volume.

Last, the device time of 3 more profiled steps (and requests) by call
site, with the program's tracer on (`transmf_ad_tpu_torch/utils/tracing.py`):
its spans (the encoders' blocks and their conv, BatchNorm statistics,
affine + activation and pool; the step's phases; fusion, head and
discriminator) are `record_function` ranges in the profile, and each device
kernel goes to the two innermost spans that launched it; a kernel of the
backward gets the spans whose forward op made its autograd node (the
profiler's sequence numbers), marked "backward". Kernels split into the
hand-written ones, cuDNN / cuBLAS, and PyTorch's own (elementwise,
reductions, copies).
Needs a CUDA device.
"""
import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from transmf_ad_tpu_torch.data.transforms import AugmentConfig
from transmf_ad_tpu_torch.models import ADVERSARIAL, build_model
from transmf_ad_tpu_torch.nn.blocks import global_avg_pool, tokens_from_volume
from transmf_ad_tpu_torch.serving import make_inference_fn
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.train.steps import _prep_inputs
from transmf_ad_tpu_torch.utils import tracing
from transmf_ad_tpu_torch.utils.weights import init_weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--batch", type=int, default=8)
parser.add_argument("--volume", type=int, nargs=3, default=(91, 109, 91))
parser.add_argument("--model", default="ad",
                    help="ad (default), transformer or transformer_res")
parser.add_argument("--serving", action="store_true",
                    help="also profile one serving request")
args = parser.parse_args()
B, V = args.batch, tuple(args.volume)
ADV = args.model in ADVERSARIAL
print(f"model {args.model}, batch {B}, volume {V}")
g = torch.Generator().manual_seed(3)
model = build_model(args.model)
init_weights(model, g)
cs.randomize_bn(model, g)
state = create_state(model, "cuda", "auto", seed=0, name="Adam", lr=1e-4)
aug = AugmentConfig()
step = make_train_step(adversarial=ADV, aug_cfg=aug)
step_noaug = make_train_step(adversarial=ADV)
dg = torch.Generator(device="cuda").manual_seed(4)
batch = {"MRI": torch.rand(B, *V, generator=dg, device="cuda"),
         "PET": torch.rand(B, *V, generator=dg, device="cuda"),
         "label": torch.arange(B, device="cuda") % 2}
for _ in range(3):
    step(state, batch)
torch.cuda.synchronize()


def busy_ms(evs):
    iv = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur = 0.0, None
    for s0, e0 in iv:
        if cur is None or s0 > cur[1]:
            if cur:
                busy += cur[1] - cur[0]
            cur = [s0, e0]
        else:
            cur[1] = max(cur[1], e0)
    if cur:
        busy += cur[1] - cur[0]
    return busy / 1e3


def device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def measure(fn, n=7):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return {"wall_ms": round(float(np.median(walls)), 3),
            "device_ms": round(busy_ms(device_events(prof)) / 3, 3)}


x = batch["MRI"].to(torch.bfloat16)[..., None]
gen = state.generator
feat = model.mri_cnn(x, True)
gf = torch.randn_like(feat)
tok = tokens_from_volume(feat.detach()).requires_grad_()
tok2 = tok.detach().clone().requires_grad_()
pooled = global_avg_pool(feat.detach()).requires_grad_()
fused = torch.randn(B, model.fc_cls[0].in_features, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)


def fuse_backward():
    """Forward and backward of the fusion module, with a random gradient
    for each of its outputs (one pooled vector, or the two token streams)."""
    out = model.fuse_transformer(tok, tok2, True, gen)
    outs = (out,) if isinstance(out, torch.Tensor) else out
    torch.autograd.backward(outs, [torch.randn_like(o) for o in outs])


parts = {
    "step (augmentation on)": lambda: step(state, batch),
    "step (no augmentation)": lambda: step_noaug(state, batch),
    "augmentation (dequantize + augment + cast)": lambda: _prep_inputs(
        batch, ("MRI", "PET"), aug, gen, "cuda", torch.bfloat16),
    "one encoder forward": lambda: model.mri_cnn(x, True),
    "one encoder forward + backward":
        lambda: model.mri_cnn(x, True).backward(gf),
    "transformer forward": lambda: model.fuse_transformer(tok, tok2, True,
                                                          gen),
    "transformer forward + backward": fuse_backward,
    "fusion head forward + backward":
        lambda: model.fc_cls(fused, True, None, gen).float().sum().backward(),
    "Adam step": lambda: state.optimizer.step(),
}
if ADV:
    parts["discriminator forward + backward (one modality)"] = \
        lambda: model.D(pooled, True).float().sum().backward()
if args.serving:
    serving_model = build_model(args.model)
    init_weights(serving_model, g)
    cs.randomize_bn(serving_model, g)
    infer = make_inference_fn(serving_model, "cuda", "auto")
    host = [np.random.default_rng(0).random((B, *V), dtype=np.float32)
            for _ in range(2)]
    parts["serving request (host arrays in, probabilities out)"] = \
        lambda: infer(*host)
    parts["serving: host to device copy and cast"] = lambda: [
        torch.as_tensor(v).to(device="cuda", dtype=torch.bfloat16)
        for v in host]
res = {k: measure(fn) for k, fn in parts.items()}
for k, v in res.items():
    print(f"{k:50s} wall {v['wall_ms']:9.3f} ms  device {v['device_ms']:9.3f}"
          f" ms", flush=True)
print(json.dumps(res))

torch.cuda.reset_peak_memory_stats()
step(state, batch)
torch.cuda.synchronize()
print(f"peak device memory of a step "
      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def dev_time(k):
    return getattr(k, "self_device_time_total",
                   getattr(k, "self_cuda_time_total", 0))


def largest_kernels(fn, what):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    rows = sorted([k for k in ka
                   if k.device_type == torch.autograd.DeviceType.CUDA
                   and dev_time(k) > 0], key=lambda k: -dev_time(k))[:25]
    print(f"device kernels, ms per {what} (3 profiled):")
    for k in rows:
        print(f"{dev_time(k) / 1e3 / 3:9.3f} ms x{k.count // 3:5d}  "
              f"{k.key[:110]}")
    launch = [k for k in ka if k.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                         "cudaLaunchKernelExC")]
    print(f"launch calls per {what}", sum(k.count for k in launch) / 3)


largest_kernels(lambda: step(state, batch), "step")
if args.serving:
    largest_kernels(lambda: infer(*host), "request")


# --- device time by call site ----------------------------------------------
# spans that only hold others: a site is named by the two innermost of the
# rest ("encoder conv2.3 / pool", "augment / sync", "fc_cls")
CONTAINERS = ("iteration", "step", "forward")


def kernel_kind(name):
    low = name.lower()
    if "transmf" in low:
        return "hand-written"
    if any(k in low for k in ("cudnn", "xmma", "cutlass", "gemm", "sm90_",
                              "nhwc", "convolve", "winograd", "fft")):
        return "cuDNN / cuBLAS"
    return "PyTorch"


def _label(e, sites):
    """block / part, from the two innermost site ranges around the profiler
    event e (`sites`: the names of the spans' ranges)"""
    out = []
    while e is not None and len(out) < 2:
        if e.name in sites:
            out.append(e.name)
        e = e.cpu_parent
    return " / ".join(reversed(out)) if out else None


def site_of(owner, made, sites):
    """The call site of a kernel launched inside the CPU event `owner`:
    its own ranges, else (backward) the site of the forward op whose
    autograd node encloses it. `made`: sequence number -> site of the
    forward ops inside site ranges."""
    lab, e = _label(owner, sites), owner
    while lab is None and e is not None:
        if e.sequence_nr in made and "Backward" in e.name:
            lab = made[e.sequence_nr] + " (backward)"
        e = e.cpu_parent
    return lab or "(no site)"


def forward_sites(cpu_events, sites):
    """sequence number -> site of each forward op inside a site range
    (the ops that made autograd nodes)"""
    made = {}
    for e in cpu_events:
        if e.sequence_nr >= 0:
            lab = _label(e, sites)
            if lab is not None:
                made.setdefault(e.sequence_nr, lab)
    return made


def by_call_site(fn, what, n=3):
    """Device ms per `what` by call site and kernel kind (n profiled
    calls)."""
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    tracing.disable()
    sites = {s.name for s in tracing.drain()[0]
             if s.name not in CONTAINERS}
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    made = forward_sites(cpu, sites)
    table = collections.defaultdict(float)
    # the profiler lists each device kernel under the innermost CPU event
    # active at its launch
    for e in cpu:
        if e.kernels:
            lab = site_of(e, made, sites)
            for k in e.kernels:
                table[lab, kernel_kind(k.name)] += k.duration / 1e3 / n
    total = sum(table.values())
    sites_ms = collections.defaultdict(float)
    for (lab, _), ms in table.items():
        sites_ms[lab] += ms
    print(f"device ms per {what} by call site ({n} profiled; total "
          f"{total:.3f}): site, all, PyTorch, cuDNN / cuBLAS, hand-written")
    for lab, ms in sorted(sites_ms.items(), key=lambda kv: -kv[1]):
        parts = [table.get((lab, k), 0.0) for k in
                 ("PyTorch", "cuDNN / cuBLAS", "hand-written")]
        print(f"  {lab:58s} {ms:9.3f} {parts[0]:9.3f} {parts[1]:9.3f} "
              f"{parts[2]:9.3f}")
    kinds = collections.defaultdict(float)
    for (_, k), ms in table.items():
        kinds[k] += ms
    print(f"  by kind: {dict((k, round(v, 3)) for k, v in kinds.items())}")


by_call_site(lambda: step(state, batch), "step")
if args.serving:
    by_call_site(lambda: infer(*host), "request")
