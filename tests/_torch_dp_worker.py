"""One rank of a data-parallel run of the port on the CPU (Gloo), and the
launcher the tests start ranks with. Imports no jax.

    python -m tests._torch_dp_worker TASK.json RANK

TASK.json holds the world size, the rendezvous port and how the ranks meet
(the three flags' `host:port` form, or torchrun's environment with
`coordinator_address='auto'`), an output directory and a list of jobs;
each job's results go to `<out>/<job name>_r<rank>.pt`:

- "step": one SGD (lr 1) train step of a model loaded from a state_dict
  file, on this rank's rows of a global batch (an .npz); the step's
  outputs, the state_dict after it, and the flat gradients after their
  all-reduce with (pmean) and without (psum) the division by the world
  size;
- "eval": the eval step on this rank's rows of a global batch: the
  MetricState and the step's outputs;
- "feeds": two epochs of `DeviceCachedFeed` and `DeviceFeed` over a
  synthetic tree, this rank's batches;
- "allreduce": a differentiable all-reduce of (rank + 1) x and the
  gradient of its sum;
- "serve": `make_sharded_inference_fn` of a model loaded from a state_dict
  file, on the CPU in float32, over a global batch (an .npz): the
  probabilities every rank gets back, and the `ValueError` a global batch
  of 3 raises (its message);
- "fit": `Trainer.fit` on a synthetic tree (the validation metrics of each
  epoch, `res_fold`, the generator at the end, every file this rank
  opened for writing), then a resumed `Trainer.fit` one epoch longer (each
  rank's generator as the resumed run starts).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----- the launcher (used by the tests) -----

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` ranks running `jobs`, each a subprocess; `wait` collects
    them. A rank that fails, or a run over `timeout` seconds, kills every
    rank and raises with their output, so a hung collective costs one test
    and never the suite."""

    def __init__(self, jobs, out_dir, world: int = 2,
                 timeout: float = 120.0, rendezvous: str = "flags"):
        os.makedirs(out_dir, exist_ok=True)
        task = os.path.join(out_dir, "task.json")
        with open(task, "w") as f:
            json.dump({"world": world, "port": free_port(), "out": out_dir,
                       "jobs": jobs, "rendezvous": rendezvous}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        self.jobs, self.out_dir, self.world = jobs, out_dir, world
        self.logs = [open(os.path.join(out_dir, f"log_r{r}.txt"), "w+")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dp_worker", task, str(r)],
            cwd=ROOT, env=env, stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self):
        """{(job name, rank): results} once every rank has exited 0."""
        procs, failed = self.procs, None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > self.deadline:
                    failed = (f"rank {bad} exited with "
                              f"{[procs[r].returncode for r in bad]}" if bad
                              else f"timed out after {self.timeout} s")
                    break
                time.sleep(0.05)
            if failed is None and any(p.returncode for p in procs):
                failed = f"exit codes {[p.returncode for p in procs]}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if failed:
            out = []
            for r, log in enumerate(self.logs):
                log.seek(0)
                out.append(f"--- rank {r} ---\n{log.read()[-4000:]}")
            raise AssertionError(f"data-parallel run: {failed}\n"
                                 + "\n".join(out))
        for log in self.logs:
            log.close()
        return {(job["name"], r): torch.load(
            os.path.join(self.out_dir, f"{job['name']}_r{r}.pt"),
            weights_only=False)
            for job in self.jobs for r in range(self.world)}


def launch(jobs, out_dir, world: int = 2, timeout: float = 120.0):
    """Run `jobs` on `world` ranks and wait for them (`Ranks`)."""
    return Ranks(jobs, out_dir, world, timeout).wait()


# ----- the jobs -----

def _global_batch(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _model(job):
    from transmf_ad_tpu_torch.models import build_model

    model = build_model(job["model"], **job.get("model_kw", {}))
    model.load_state_dict(torch.load(job["weights"], weights_only=True))
    return model


def job_step(job, group, world, rank):
    from transmf_ad_tpu_torch.parallel import place_global, shard_state
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.train import steps as steps_mod

    model = _model(job)
    state = shard_state(create_state(model, "cpu", name="SGD", lr=1.0,
                                     milestones=()), group)
    grads = {}
    real = steps_mod._pmean_grads

    def spy(params, grp):
        params = list(params)
        flat = torch.cat([p.grad.reshape(-1) for p in params
                          if p.grad is not None])
        psum = flat.clone()
        torch.distributed.all_reduce(psum, group=grp)
        real(params, grp)
        grads["psum"] = psum
        grads["pmean"] = torch.cat([p.grad.reshape(-1) for p in params
                                    if p.grad is not None])

    steps_mod._pmean_grads = spy
    try:
        batch = place_global(_global_batch(job["batch"]), world, rank)
        step = make_train_step(mask_bn=job.get("mask_bn", False),
                               group=group)
        aux = step(state, batch)
    finally:
        steps_mod._pmean_grads = real
    return {"aux": aux, "after": model.state_dict(), **grads}


def job_eval(job, group, world, rank):
    from transmf_ad_tpu_torch.parallel import place_global, shard_state
    from transmf_ad_tpu_torch.train import (MetricState, create_state,
                                            make_eval_step)

    state = shard_state(create_state(_model(job), "cpu"), group)
    batch = place_global(_global_batch(job["batch"]), world, rank)
    ms, out = make_eval_step(group=group)(state, MetricState.zero(), batch)
    return {"metrics": dataclasses.asdict(ms), "out": out}


def _loader(job, indices, **kw):
    from transmf_ad_tpu_torch.data import ADNI, Loader, VolumeSource

    records = ADNI(job["root"], "ADNI.csv", "ADCN").data_dict
    source = VolumeSource(records, dtype=np.float32)
    return Loader(source, list(indices), job["batch_size"], **kw)


def job_feeds(job, group, world, rank):
    from transmf_ad_tpu_torch.data.device_cache import DeviceCachedFeed
    from transmf_ad_tpu_torch.data.pipeline import DeviceFeed

    out = {}
    for name, cls in (("cached", DeviceCachedFeed), ("stream", DeviceFeed)):
        loader = _loader(job, job["indices"], shuffle=True, seed=job["seed"])
        feed = cls(loader, "cpu", pad_to=job["pad_to"], group=group)
        out[name] = [[{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in b.items()} for b in feed]
                     for _ in range(2)]
    return out


def _written(root):
    """An audit hook (and a wrapper of `torch.save`, which opens its file
    in C++) recording every path under `root` this process opens for
    writing; returns the list it fills."""
    seen = []
    root = os.path.realpath(root)

    def hook(event, args):
        if event != "open" or not isinstance(args[0], (str, bytes,
                                                        os.PathLike)):
            return
        mode, flags = args[1], args[2] or 0
        writing = (any(c in (mode or "") for c in "wax+")
                   or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
        path = os.path.realpath(os.fsdecode(args[0]))
        if writing and path.startswith(root):
            seen.append(os.path.relpath(path, root))

    sys.addaudithook(hook)
    save = torch.save  # writes through its own C++ file writer

    def recorded_save(obj, f, *a, **kw):
        hook("open", (f, "wb", 0))
        return save(obj, f, *a, **kw)

    torch.save = recorded_save
    return seen


def job_fit(job, group, world, rank):
    from transmf_ad_tpu_torch.train import engine as engine_mod
    from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

    written = _written(job["save_dir"])
    loaders = [_loader(job, job["train"], shuffle=True, seed=job["seed"]),
               _loader(job, job["val"]), _loader(job, job["test"])]
    cfg = TrainerConfig(**job["cfg"], save_dir=job["save_dir"],
                        device="cpu")
    trainer = Trainer(cfg)  # rank 0 logs to save_dir, the others nowhere
    val = []
    real_eval = trainer.evaluate

    def evaluate(loader):
        m = real_eval(loader)
        val.append({k: v for k, v in m.items() if k != "confusion"})
        return m

    trainer.evaluate = evaluate
    res = trainer.fit(*loaders)
    out = {"val": val, "res_fold": res, "written": list(written),
           "files": sorted(os.listdir(job["save_dir"])),
           "generator": trainer.state.generator.get_state(),
           "after": trainer.state.model.state_dict()}
    # the resumed run: each rank's generator as its engine starts
    started = {}
    real_run = engine_mod.Engine.run

    def run(self, data, max_epochs=1, start_epoch=0):
        started["generator"] = resumed.state.generator.get_state()
        started["step"] = resumed.state.step
        started["start_epoch"] = start_epoch
        return real_run(self, data, max_epochs, start_epoch)

    engine_mod.Engine.run = run
    try:
        resumed = Trainer(dataclasses.replace(cfg, resume=True,
                                              epochs=cfg.epochs + 1))
        resumed.fit(*loaders[:2])
    finally:
        engine_mod.Engine.run = real_run
    out["resumed"] = started
    return out


def job_allreduce(job, group, world, rank):
    from torch.distributed.nn.functional import all_reduce

    x = torch.ones(3, requires_grad=True)
    y = all_reduce(x * (rank + 1.0), group=group)
    y.sum().backward()
    return {"y": y.detach(), "grad": x.grad}


def job_serve(job, group, world, rank):
    from transmf_ad_tpu_torch.serving import make_sharded_inference_fn

    fn = make_sharded_inference_fn(_model(job), group, "cpu")
    batch = _global_batch(job["batch"])
    vols = [batch[k] for k in ("MRI", "PET")]
    probs = fn(*vols)
    try:
        fn(*(v[:3] for v in vols))
        ragged = None
    except ValueError as e:
        ragged = str(e)
    return {"probs": probs, "ragged": ragged}


JOBS = {"step": job_step, "eval": job_eval, "feeds": job_feeds,
        "fit": job_fit, "allreduce": job_allreduce, "serve": job_serve}


def main(task_path, rank):
    torch.set_num_threads(1)
    with open(task_path) as f:
        task = json.load(f)
    world, out = task["world"], task["out"]
    from transmf_ad_tpu_torch.parallel import (init_distributed, shutdown,
                                               world_group)

    timeout = datetime.timedelta(seconds=60)
    if task["rendezvous"] == "torchrun":  # the environment torchrun sets
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                          MASTER_PORT=str(task["port"]))
        init_distributed("auto", device="cpu", timeout=timeout)
    elif any(job["kind"] != "fit" for job in task["jobs"]):
        init_distributed(f"localhost:{task['port']}", world, rank,
                         device="cpu", timeout=timeout)
    try:
        for job in task["jobs"]:
            if job["kind"] == "fit":  # the Trainer joins the group itself
                job["cfg"].update(coordinator_address=
                                  f"localhost:{task['port']}",
                                  num_processes=world, process_id=rank)
            result = JOBS[job["kind"]](job, world_group(), world, rank)
            torch.save(result, os.path.join(out,
                                            f"{job['name']}_r{rank}.pt"))
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
