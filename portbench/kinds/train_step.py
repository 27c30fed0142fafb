"""Traffic kind `train_step`: the program's train step on batches gathered
on the card, by shuffled ids, from a pool of seeded pairs.

The pool's volumes are `volumes.fill`'s. The mix file gives the batch, the volume, the pool's size and dtype (the
dtype the program's device-cached feed holds), the augmentation (or
null), the optimizer's learning rate, and how many steps the traced
stretch profiles. One object, the program's `TrainState` with its model
and optimizer and the step `make_train_step` returns, is built in set-up,
driven through its first steps by the window's own call and feed, and then
runs the window. The check replays those first steps in the plain float32
reference, from the same weights, rows and seed (see `check`).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from .. import harness, volumes
from ..reference import step as ref_step
from ..reference.layers import Precision

FIRST_STEPS = 3  # steps the reference follows
ADAM_BETA1 = 0.9


class CellRun:
    unit = "step"

    def __init__(self, cfg, mix, seed, device, limits):
        self.cfg, self.mix, self.seed, self.limits = cfg, mix, seed, limits
        self.device = torch.device(device)
        self.batch = mix["batch"]
        self.pairs_per_unit = self.batch

    # -- set-up --------------------------------------------------------
    def setup(self):
        from transmf_ad_tpu_torch.data.transforms import AugmentConfig
        from transmf_ad_tpu_torch.models import build_model
        from transmf_ad_tpu_torch.train import create_state, make_train_step

        cfg, mix, dev = self.cfg, self.mix, self.device
        ref = ref_step.build(cfg, dev)
        self.adversarial = ref_step.module(cfg["reference"]).ADVERSARIAL
        self.weights = harness.seeded_state(ref, harness.subseed(self.seed, 1),
                                            dev)
        del ref
        model = build_model(cfg["registry_key"], **cfg["model"])
        model.load_state_dict(self.weights)
        pool_n = mix["pool_pairs"]
        self.aug_seed = harness.subseed(self.seed, 3)
        self.state = create_state(
            model, device=dev, dtype=getattr(torch, cfg["compute_dtype"]),
            seed=self.aug_seed, name="Adam", lr=mix["lr"],
            steps_per_epoch=max(pool_n // self.batch, 1))
        self.aug = mix["augment"]
        self.step = make_train_step(
            adversarial=self.adversarial,
            aug_cfg=None if self.aug is None else AugmentConfig(**self.aug))

        g = torch.Generator(device=dev).manual_seed(
            harness.subseed(self.seed, 2))
        shape = (pool_n, *mix["volume"])
        pool_dtype = getattr(torch, mix["pool_dtype"])
        self.pool = {}
        for name in ("MRI", "PET"):
            self.pool[name] = volumes.fill(
                torch.empty(shape, dtype=pool_dtype, device=dev), g)
        self.labels = torch.randint(0, 2, (pool_n,), generator=g, device=dev)
        self.gen = g
        self.order, self.cursor = None, pool_n

        params = dict(self.state.model.named_parameters())
        self.p0 = {k: p.detach().clone() for k, p in params.items()}
        self.first_ids, self.first_losses = [], []
        feats, hooks = first_outputs(self.state.model, cfg["features"])
        for t in range(1, FIRST_STEPS + 1):
            ids = self._next_ids()
            aux = self.step(self.state, self._gather(ids))
            for h in hooks:
                h.remove()
            self.first_ids.append(ids)
            self.first_losses.append(float(aux["loss"]))
            if t == 1:
                self.out1 = [aux[k].detach().float().clone() for k in
                             (("logits", "d_mri", "d_pet") if self.adversarial
                              else ("logits",))]
                # a leaf the optimizer did not step has no moment: zero
                opt = self.state.optimizer
                self.g1 = {k: (opt.state[p]["exp_avg"] / (1 - ADAM_BETA1))
                           .detach().clone() if "exp_avg" in opt.state[p]
                           else torch.zeros_like(p)
                           for k, p in params.items()}
        self.feat1 = [feats[n] for n in cfg["features"]]
        self.p3 = {k: p.detach().clone() for k, p in params.items()}
        self._sync()

    def _next_ids(self):
        n = self.pool["MRI"].shape[0]
        if self.cursor + self.batch > n:
            self.order = torch.randperm(n, generator=self.gen,
                                        device=self.device)
            self.cursor = 0
        ids = self.order[self.cursor:self.cursor + self.batch]
        self.cursor += self.batch
        return ids

    def _gather(self, ids):
        return {"MRI": self.pool["MRI"][ids], "PET": self.pool["PET"][ids],
                "label": self.labels[ids]}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ----------------------------------------------------
    def run_units(self, k):
        losses = []
        for _ in range(k):
            losses.append(self.step(self.state,
                                    self._gather(self._next_ids()))["loss"])
        return losses

    def window(self, seconds):
        self._sync()
        t0 = time.perf_counter()
        losses = []
        while True:
            losses += self.run_units(1)
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        finite = torch.isfinite(torch.stack(losses).float())
        self.window_s, self.units = t1 - t0, len(losses)
        return ({"train_pairs_per_s": len(losses) * self.batch / (t1 - t0)},
                len(losses), int((~finite).sum()))

    # -- the check -----------------------------------------------------
    def release(self):
        """Keep what the check needs (the first steps' rows), free the
        rest."""
        self.first_batches = [
            {k: v.clone() for k, v in self._gather(ids).items()}
            for ids in self.first_ids]
        del self.state, self.step, self.pool, self.labels
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec: Precision = Precision(), batches=None):
        """The reference's (losses, first gradients, parameters after the
        first steps, step-1 outputs, step-1 features) from the initial
        weights, on `batches` (the program's first batches by default) and
        the same generator seed."""
        ref = ref_step.build(self.cfg, self.device)
        ref.load_state_dict(self.weights)
        feats, hooks = first_outputs(ref, self.cfg["features"])
        gen = torch.Generator(device=self.device).manual_seed(self.aug_seed)
        out = ref_step.train(ref, self.adversarial,
                             batches or self.first_batches, gen, self.aug,
                             self.mix["lr"], prec)
        for h in hooks:
            h.remove()
        del ref
        return (*out, [feats[n] for n in self.cfg["features"]])

    def numbers(self, ref_out) -> dict:
        """The numbers of the program's first steps against a reference
        run `ref_out` (see `gaps`)."""
        return gaps(self.first_losses, self.out1, self.feat1, self.g1,
                    self.p0, self.p3, ref_out,
                    self.cfg.get("output_layers", ()))

    def check(self) -> dict:
        self.release()
        return self.numbers(self.reference())


def first_outputs(model, names):
    """({name: output}, hooks): forward hooks that keep, in float32, what
    each named submodule returns on its first call."""
    kept, hooks = {}, []
    for name in names:
        def keep(mod, args, out, name=name):
            if name not in kept:
                kept[name] = out.detach().float().clone()
        hooks.append(model.get_submodule(name).register_forward_hook(keep))
    return kept, hooks


MISMATCH = 1e9  # read where the shapes differ or a number is not finite


def output_gap(prog: list, ref: list) -> float:
    """The worst output's relative error: ||program - reference|| over
    ||reference||, each of (logits, d_mri, d_pet), (logits,) or the
    features alone."""
    worst = 0.0
    for p, r in zip(prog, ref):
        if p.shape != r.shape and r.dim() == 5:
            r = r.movedim(1, -1)  # the reference's features channels first
        if p.shape != r.shape or not bool(torch.isfinite(p).all()):
            return MISMATCH
        worst = max(worst, float((p.double() - r.double()).norm())
                    / max(float(r.double().norm()), 1e-30))
    return worst


def kept_leaves(ref_g1: dict) -> list:
    """The leaves compared: those whose reference first gradient is at
    least a thousandth of the median leaf's (a bias before a training
    BatchNorm has an exact zero gradient and moves under Adam by rounding
    alone)."""
    gn = {k: float(v.double().norm()) for k, v in ref_g1.items()}
    med = statistics.median(gn.values())
    return [k for k, v in gn.items() if v >= 1e-3 * med]


def leaf_gaps(prog: dict, ref: dict, keep, diff: bool = False) -> dict:
    """Per kept leaf: | ||prog|| - ||ref|| | (or, with `diff`,
    ||prog - ref||) over max(||ref||, the median leaf's ||ref||)."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(norms.values())
    out = {}
    for k in keep:
        p, r = prog[k].double(), ref[k].double()
        num = (float((p - r).norm()) if diff
               else abs(float(p.norm()) - norms[k]))
        out[k] = num / max(norms[k], med)
    return out


def finite_of(values, of=statistics.median) -> float:
    """`of` the values (their median), or nan where one is not finite (the
    number then reads MISMATCH)."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.nan
    return of(values)


def gaps(p_losses, p_out1, p_feat1, p_g1, p0, p3, ref_out,
         output_layers=()) -> dict:
    """The numbers of the program's first steps (its losses, step-1
    outputs and features, first gradient (Adam's first moment after one
    step) and parameters after the steps) against the reference's
    (`CellRun.reference`'s five results). A cell compares those its
    limits file names.

    out: the step-1 outputs (`output_gap`);
    feat: the step-1 features, what the configuration's `features` (the
    encoders) return, by the same measure;
    loss1: the step-1 loss's relative gap;
    grad: the first gradient, the median kept leaf's ||program -
    reference|| over max(its reference norm, the median leaf's);
    grad_out (where the configuration names its `output_layers`, the
    linear layers that make the outputs): the same of the worst of their
    weights, whose gradient every row's loss reaches without a max;
    update: the median kept leaf's gap of the change's norms over the
    steps (`leaf_gaps`)."""
    r_losses, r_g1, r_p3, r_out1, r_feat1 = ref_out
    keep = kept_leaves(r_g1)
    d_prog = {k: p3[k].double() - p0[k].double() for k in keep}
    d_ref = {k: r_p3[k].double() - p0[k].double() for k in keep}
    g = leaf_gaps(p_g1, r_g1, keep, diff=True)
    nums = {
        "out": output_gap(p_out1, r_out1),
        "feat": output_gap(p_feat1, r_feat1),
        "loss1": abs(p_losses[0] - r_losses[0]) / abs(r_losses[0]),
        "grad": finite_of(g.values()),
        "update": finite_of(leaf_gaps(d_prog, d_ref, keep).values()),
    }
    if output_layers:
        nums["grad_out"] = finite_of(
            (g[f"{n}.weight"] for n in output_layers), of=max)
    return {k: v if math.isfinite(v) else MISMATCH for k, v in nums.items()}
