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
  rank's generator as the resumed run starts);
- "tp_step": one SGD (lr 1) train step on the ('data', 'model') mesh of
  `mp` ranks a model group, the weights `param_shardings(model, mp,
  min_size)` names cut into their rows: the step's outputs, the whole
  state_dict after it, this rank's rows of the sharded weights, their
  names, the head count of every `attention_core` call and of every
  flash forward (`flash_min_keys` lowers the flash gate);
- "tp_grads": for each model of `models` ((name, keywords, volume)),
  seeded weights cut by `param_shardings(model, mp, min_size)`, a
  train-mode forward (dropout from a seeded generator) on a seeded batch
  of `batch` and the gradients of the sum of each output times a seeded
  w: the logits and every gradient whole (gathered over the model group);
  with `remat_min_mb`, TRANSMF_REMAT_MIN_MB for the job;
- "tp_serve": `make_sharded_inference_fn(..., model_axis=mp)` over a
  global batch (the probabilities every rank gets back, and the names
  sharded);
- "tp_resume": `Trainer.fit` of one epoch with `model_parallel` = mp
  writing `latest.pt` (copied to `<out>/latest_mp<mp>.pt`), then a
  resumed fit one epoch longer; with `resume_from`, only the resumed fit,
  from that file. The whole state_dict after the resumed fit.
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


def _mesh(job, world):
    from transmf_ad_tpu_torch.parallel import make_mesh

    return make_mesh({"data": world // job["mp"], "model": job["mp"]})


def job_tp_step(job, group, world, rank):
    from transmf_ad_tpu_torch import ops
    from transmf_ad_tpu_torch.nn import attention as attn_mod
    from transmf_ad_tpu_torch.ops import flash_attention as t_flash
    from transmf_ad_tpu_torch.parallel import (full_state_dict,
                                               param_shardings, place_global,
                                               shard_model, shard_state)
    from transmf_ad_tpu_torch.train import create_state, make_train_step

    mesh = _mesh(job, world)
    model = _model(job)
    state = create_state(model, "cpu", name="SGD", lr=1.0, milestones=())
    names = param_shardings(model, job["mp"], job["min_size"])
    shard_model(model, names, mesh.axis)  # shard_state keeps these
    shard_state(state, mesh.data_group, mesh)
    heads, flash = [], []
    core, fwd, gate = attn_mod.attention_core, t_flash.flash_fwd, \
        ops.FLASH_MIN_KEYS

    def core_spy(q, k, v, scale):
        heads.append(q.shape[1])
        return core(q, k, v, scale)

    def fwd_spy(q, *a, **kw):
        flash.append(q.shape[1])
        return fwd(q, *a, **kw)

    attn_mod.attention_core, t_flash.flash_fwd = core_spy, fwd_spy
    ops.FLASH_MIN_KEYS = job.get("flash_min_keys", gate)
    try:
        batch = place_global(_global_batch(job["batch"]), mesh.data,
                             mesh.data_index)
        aux = make_train_step(adversarial=job["adversarial"],
                              group=mesh.data_group)(state, batch)
    finally:
        attn_mod.attention_core, t_flash.flash_fwd = core, fwd
        ops.FLASH_MIN_KEYS = gate
    return {"aux": aux, "after": full_state_dict(model),
            "local": {n: model.get_parameter(n).detach().clone()
                      for n in names},
            "names": names, "heads": heads, "flash": flash}


def grads_case(name, kw, volume, batch, mesh=None, mp=1, min_size=2048):
    """(logits, {parameter: whole gradient}) of one train-mode forward of
    `name` (weights, inputs, dropout and each output's cotangent w from
    seeds) and the backward of the sum of output * w; sharded over
    `mesh`'s model axis when given."""
    from transmf_ad_tpu_torch.models import build_model
    from transmf_ad_tpu_torch.parallel import (param_shardings, shard_model,
                                               shard_of)
    from transmf_ad_tpu_torch.parallel.tensor import (all_gather,
                                                      reduce_partial_grads)
    from transmf_ad_tpu_torch.utils.weights import init_weights

    model = build_model(name, **kw)
    init_weights(model, torch.Generator().manual_seed(5))
    if mesh is not None:
        shard_model(model, param_shardings(model, mp, min_size), mesh.axis)
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(rng.standard_normal((batch, *volume, 1))
                           .astype(np.float32))
          for _ in range(1 if name == "single" else 2)]
    out = model(*xs, train=True, generator=torch.Generator().manual_seed(7))
    outs = out if isinstance(out, tuple) else (out,)
    sum(o * torch.from_numpy(rng.standard_normal(tuple(o.shape))
                             .astype(np.float32))
        for o in outs).sum().backward()
    logits = outs[0]
    reduce_partial_grads(model)
    grads = {}
    for n, p in model.named_parameters():
        s = shard_of(p)
        grads[n] = (p.grad if s is None
                    else s.join(all_gather(p.grad, s.axis.group)))
    return logits.detach(), grads


def job_tp_grads(job, group, world, rank):
    mesh = _mesh(job, world)
    saved = os.environ.get("TRANSMF_REMAT_MIN_MB")
    if "remat_min_mb" in job:
        os.environ["TRANSMF_REMAT_MIN_MB"] = str(job["remat_min_mb"])
    try:
        return {name: grads_case(name, kw, volume, job["batch"], mesh,
                                 job["mp"], job["min_size"])
                for name, kw, volume in job["models"]}
    finally:
        if saved is None:
            os.environ.pop("TRANSMF_REMAT_MIN_MB", None)
        else:
            os.environ["TRANSMF_REMAT_MIN_MB"] = saved


def job_tp_serve(job, group, world, rank):
    from transmf_ad_tpu_torch.parallel import param_shardings
    from transmf_ad_tpu_torch.serving import make_sharded_inference_fn

    model = _model(job)
    fn = make_sharded_inference_fn(model, group, "cpu", model_axis=job["mp"])
    batch = _global_batch(job["batch"])
    return {"probs": fn(*(batch[k] for k in ("MRI", "PET"))),
            "names": param_shardings(model, job["mp"])}


def job_tp_resume(job, group, world, rank):
    import shutil

    from transmf_ad_tpu_torch.parallel import full_state_dict
    from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

    def loaders():  # fresh ones for each fit, as a new process has
        return (_loader(job, job["train"], shuffle=True, seed=job["seed"]),
                _loader(job, job["val"]))

    cfg = TrainerConfig(**job["cfg"], save_dir=job["save_dir"],
                        device="cpu", model_parallel=job["mp"],
                        save_latest_every=1)
    if "resume_from" in job:
        if rank == 0:
            os.makedirs(job["save_dir"], exist_ok=True)
            shutil.copy(job["resume_from"],
                        os.path.join(job["save_dir"], "latest.pt"))
    else:
        Trainer(cfg).fit(*loaders())
        if rank == 0:
            shutil.copy(os.path.join(job["save_dir"], "latest.pt"),
                        os.path.join(job["out"], f"latest_mp{job['mp']}.pt"))
    torch.distributed.barrier()
    resumed = Trainer(dataclasses.replace(cfg, resume=True,
                                          epochs=cfg.epochs + 1))
    resumed.fit(*loaders())
    return {"after": full_state_dict(resumed.state.model),
            "step": resumed.state.step}


JOBS = {"step": job_step, "eval": job_eval, "feeds": job_feeds,
        "fit": job_fit, "allreduce": job_allreduce, "serve": job_serve,
        "tp_step": job_tp_step, "tp_grads": job_tp_grads,
        "tp_serve": job_tp_serve,
        "tp_resume": job_tp_resume}


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
    elif any(job["kind"] not in ("fit", "tp_resume")
             for job in task["jobs"]):
        init_distributed(f"localhost:{task['port']}", world, rank,
                         device="cpu", timeout=timeout)
    try:
        for job in task["jobs"]:
            job.setdefault("out", out)
            if job["kind"] in ("fit", "tp_resume"):  # the Trainer joins
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
