"""Where the time of one full-width ModelAd train step goes on one GPU.

    python3 profile_train.py [--batch 8] [--volume 91 109 91]
    python3 profile_train.py --batch 6 --volume 182 218 182 [--serving]

The train step of `chip_smoke.py`'s train phases (bf16, augmentation on,
Adam; batch 8 at 91x109x91 by default, batch 6 at 182x218x182 for the
full-resolution step), and each of its parts run alone. Per part: wall ms
(median of 7 after a warm-up, host clock around a synchronised call) and
device ms (torch.profiler: the union of device-event intervals over 3 calls,
divided by 3). Then the largest device kernels of 3 profiled steps, the
kernel launches per step and the peak device memory of a step. With
--serving, the same for one serving request of that batch and volume.
Needs a CUDA device.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from transmf_ad_tpu_torch.data.transforms import AugmentConfig
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn.blocks import global_avg_pool, tokens_from_volume
from transmf_ad_tpu_torch.serving import make_inference_fn
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.train.steps import _prep_inputs
from transmf_ad_tpu_torch.utils.weights import init_weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--batch", type=int, default=8)
parser.add_argument("--volume", type=int, nargs=3, default=(91, 109, 91))
parser.add_argument("--serving", action="store_true",
                    help="also profile one serving request")
args = parser.parse_args()
B, V = args.batch, tuple(args.volume)
print(f"batch {B}, volume {V}")
g = torch.Generator().manual_seed(3)
model = build_model("ad")
init_weights(model, g)
cs.randomize_bn(model, g)
state = create_state(model, "cuda", "auto", seed=0, name="Adam", lr=1e-4)
aug = AugmentConfig()
step = make_train_step(aug_cfg=aug)
step_noaug = make_train_step()
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
gt = torch.randn(B, 4 * 128, device="cuda", dtype=torch.bfloat16)
pooled = global_avg_pool(feat.detach()).requires_grad_()
fused = torch.randn(B, 512, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
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
    "transformer forward + backward": lambda: model.fuse_transformer(
        tok, tok2, True, gen).backward(gt),
    "discriminator forward + backward (one modality)":
        lambda: model.D(pooled, True).float().sum().backward(),
    "fusion head forward + backward":
        lambda: model.fc_cls(fused, True, None, gen).float().sum().backward(),
    "Adam step": lambda: state.optimizer.step(),
}
if args.serving:
    serving_model = build_model("ad")
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
