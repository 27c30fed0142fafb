"""The readings the correctness limits are set from, on the card, several
seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--half] [--look] [--witness]

For each seed it builds the cell's program object as a run does and reads
the numbers of `kinds/train_step.gaps` for the program against the plain
float32 reference (the lower reading), and with

--control  the reference computed with fp8 operands in the program's place
           (the control, which has to fail);
--half     the reference with half of each batch left out of the loss, the
           mean taken over the rest, its forward over every row (a planted
           fault: the outputs keep their shape);
--altered  the reference with row 0's logits swapped where its forward
           makes them (a planted fault: one answer altered);
--look     the reference against itself, run again on the same rows and
           on rows perturbed by one float32 rounding (2^-23 relative), with
           the max-pool winners that moved counted, and with the encoders'
           outputs perturbed by 1e-6 and 1e-4 relative: what rounding
           alone, at the input and past the encoders, does to each number;
--witness  the program in float32 (a second program object).

A cell's pool is cut to the rows its first steps use: the readings need no
window. One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

LOOK_EPS = (0.0, 2.0 ** -23)  # the rows
LOOK_FEATURE_EPS = (1e-6, 1e-4)  # the encoders' outputs


def worst_leaves(p_g1, p0, p3, ref, n=5) -> dict:
    """The `n` worst leaves of the first gradient (difference) and of the
    change (gap of norms): [gap, leaf, ||program|| / ||reference||]."""
    from portbench.kinds import train_step as ts

    r_g1, r_p3 = ref[1], ref[2]
    keep = ts.kept_leaves(r_g1)
    d_p = {k: p3[k].double() - p0[k].double() for k in keep}
    d_r = {k: r_p3[k].double() - p0[k].double() for k in keep}
    out = {}
    for name, prog, refd, diff in (("grad", p_g1, r_g1, True),
                                   ("update", d_p, d_r, False)):
        g = ts.leaf_gaps(prog, refd, keep, diff=diff)
        ratio = {k: float(prog[k].double().norm())
                 / max(float(refd[k].double().norm()), 1e-30) for k in keep}
        out[name] = sorted(([round(v, 4), k, round(ratio[k], 4)]
                            for k, v in g.items()), reverse=True)[:n]
    return out


@contextlib.contextmanager
def half_loss():
    """The reference's loss over the first half of each batch's rows."""
    from portbench.reference import step as ref_step

    full = ref_step.loss_of

    def half(model, out, labels, adversarial):
        h = labels.shape[0] // 2
        out = tuple(o[:h] for o in out) if adversarial else out[:h]
        return full(model, out, labels[:h], adversarial)

    ref_step.loss_of = half
    try:
        yield
    finally:
        ref_step.loss_of = full


def swap_first_answer(mod, args, out):
    """A forward hook: row 0's logits swapped, one answer altered where
    the model makes it."""
    import torch

    logits = out[0] if isinstance(out, tuple) else out
    logits = torch.cat([logits[:1].flip(1), logits[1:]])
    return (logits, *out[1:]) if isinstance(out, tuple) else logits


@contextlib.contextmanager
def altered_answer():
    """The reference model's forward with row 0's logits swapped."""
    from portbench.reference import step as ref_step

    build = ref_step.build

    def altered(cfg, device):
        model = build(cfg, device)
        model.register_forward_hook(swap_first_answer)
        return model

    ref_step.build = altered
    try:
        yield
    finally:
        ref_step.build = build


@contextlib.contextmanager
def perturbed_features(cfg, eps, seed):
    """The reference model's `features` outputs times (1 + eps * U(-1, 1))
    on every call."""
    import torch

    from portbench.reference import step as ref_step

    build = ref_step.build

    def perturb(mod, args, out):
        g = torch.Generator(device=out.device).manual_seed(seed)
        u = torch.rand(out.shape, generator=g, device=out.device) * 2 - 1
        return out * (1 + eps * u)

    def perturbing(cfg_, device):
        model = build(cfg_, device)
        for name in cfg["features"]:
            model.get_submodule(name).register_forward_hook(perturb)
        return model

    ref_step.build = perturbing
    try:
        yield
    finally:
        ref_step.build = build


class PoolWinners:
    """Stands in for `torch.nn.functional` in the reference's layers and
    keeps (or compares) the winners of the first `calls` max pools."""

    def __init__(self, calls: int):
        import torch.nn.functional as F

        self.F, self.calls = F, calls
        self.kept, self.mode, self.seen = [], None, 0
        self.moved = self.windows = 0

    def __getattr__(self, name):
        return getattr(self.F, name)

    def max_pool3d(self, x, k):
        if self.mode is None or self.seen >= self.calls:
            return self.F.max_pool3d(x, k)
        out, idx = self.F.max_pool3d(x, k, return_indices=True)
        idx = idx.int()
        if self.mode == "keep":
            self.kept.append(idx)
        else:
            self.moved += int((idx != self.kept[self.seen]).sum())
            self.windows += idx.numel()
        self.seen += 1
        return out

    @contextlib.contextmanager
    def watching(self, mode):
        from portbench.reference import layers

        self.mode, self.seen = mode, 0
        self.moved = self.windows = 0
        layers.F = self
        try:
            yield
        finally:
            layers.F, self.mode = self.F, None


def perturbed(batches, eps, seed):
    """Float32 copies of the batches' volumes times (1 + eps * U(-1, 1))."""
    import torch

    g = torch.Generator(device=batches[0]["MRI"].device).manual_seed(seed)
    out = []
    for b in batches:
        c = dict(b)
        for name in ("MRI", "PET"):
            v = b[name].float()
            u = torch.rand(v.shape, generator=g, device=v.device) * 2 - 1
            c[name] = v * (1 + eps * u)
        out.append(c)
    return out


def readings(cfg, mix, limits, seed, device="cuda", control=False,
             half=False, altered=False, look=False, witness=False) -> dict:
    """One seed's readings (see the module's docstring)."""
    import torch

    from portbench.kinds import train_step as ts
    from portbench.reference.layers import Precision

    cuda = device == "cuda"
    mix = dict(mix, pool_pairs=mix["batch"] * ts.FIRST_STEPS)
    winners = PoolWinners(calls=6)  # the two encoders' three max pools
    t0 = time.perf_counter()
    drv = ts.CellRun(cfg, mix, seed, device, limits)
    drv.setup()

    def against(run, ref):
        losses, g1, p3, out1, feat1 = run
        nums = ts.gaps(losses, out1, feat1, g1, drv.p0, p3, ref,
                       cfg.get("output_layers", ()))
        nums["out_each"] = [ts.output_gap([a], [b])
                            for a, b in zip(out1, ref[3])]
        return nums

    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    if cuda:
        out["card"] = torch.cuda.get_device_name(0)
        torch.cuda.reset_peak_memory_stats()
    drv.release()
    t1 = time.perf_counter()
    with winners.watching("keep" if look else None):
        ref = drv.reference()
    out["reference_s"] = time.perf_counter() - t1
    if cuda:
        out["reference_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["program"] = against((drv.first_losses, drv.g1, drv.p3, drv.out1,
                              drv.feat1), ref)
    out["program_worst"] = worst_leaves(drv.g1, drv.p0, drv.p3, ref)
    out["losses"] = {"program": drv.first_losses, "reference": ref[0]}
    if control:
        c = drv.reference(Precision("fp8"))
        out["control"] = against(c, ref)
        out["control_worst"] = worst_leaves(c[1], drv.p0, c[2], ref)
        del c
    if half:
        with half_loss():
            out["half"] = against(drv.reference(), ref)
    if altered:
        with altered_answer():
            out["altered"] = against(drv.reference(), ref)
    if look:
        for eps in LOOK_EPS:
            with winners.watching("compare"):
                r2 = drv.reference(batches=perturbed(drv.first_batches, eps,
                                                     seed))
            key = f"look_{eps:g}"
            out[key] = against(r2, ref)
            out[key + "_worst"] = worst_leaves(r2[1], drv.p0, r2[2], ref)
            out[key + "_pool_winners_moved"] = [winners.moved,
                                                winners.windows]
            del r2
        for eps in LOOK_FEATURE_EPS:
            with perturbed_features(cfg, eps, seed):
                out[f"look_features_{eps:g}"] = against(drv.reference(), ref)
    if witness:
        w = ts.CellRun(dict(cfg, compute_dtype="float32"), mix, seed,
                       device, limits)
        w.setup()
        w.release()
        out["witness_f32"] = w.numbers(ref)
        out["witness_f32_worst"] = worst_leaves(w.g1, w.p0, w.p3, ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    for flag in ("control", "half", "altered", "look", "witness"):
        p.add_argument(f"--{flag}", action="store_true")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    entry, cfg, mix, limits = harness.cell(args.workload)
    harness.require_cards(entry["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cfg, mix, limits, seed, "cuda",
                                  args.control, args.half, args.altered,
                                  args.look, args.witness)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
