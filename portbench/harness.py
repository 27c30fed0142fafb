"""What every cell shares: finding a cell's files by name, the seeds, the
card, the seeded weights, the check for JAX in the process, and the
result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the checkout
HERE = ROOT / "portbench"
CACHE = ROOT / ".portbench_cache"  # every compile cache, at fixed paths
FORBIDDEN = ("jax", "jaxlib", "flax", "transmf_ad_tpu")


def set_cache_dirs() -> None:
    """Point every compile cache the program or torch may use into the
    checkout, before torch is imported. The kernels' own library already
    builds into the program's `_build/`."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None):
    """(workload entry, configuration, traffic mix, limits) of a cell."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = load_json(HERE / "configs" / f"{w['config']}.json")
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return w, cfg, mix, limits


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench._" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    return importlib.import_module(f"portbench.kinds.{name}")


def subseed(seed: int, k: int) -> int:
    """A seed for one use (weights, data, the step's generator) of the
    run's seed: any whole number in, a distinct 63-bit number out."""
    return (int(seed) * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9) % 2**63


def require_cards(n: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"portbench: the cell needs {n} CUDA card(s), "
                         f"found {found}; no result")


def card() -> dict:
    """The card's name, the number of cards seen and the power limit."""
    import torch

    out = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "power_limit_w": None}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def seeded_state(model, seed: int, device) -> dict:
    """A state_dict for `model` (the reference model, whose names the
    program shares) drawn on `device` from `seed` in one call: conv and
    linear weights and biases U(-1, 1) / sqrt(fan_in) (torch's default
    bound), norm weights 1 + U(-0.1, 0.1) and biases U(-0.1, 0.1); running
    statistics 0 and 1."""
    import torch
    from torch import nn

    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device) * 2 - 1
    owner = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = mod
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    at = 0
    for name, p in params:
        piece = u[at:at + p.numel()].view(p.shape)
        at += p.numel()
        mod = owner[name]
        if isinstance(mod, (nn.Conv3d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            state[name] = piece / math.sqrt(fan_in)
        elif name.endswith("weight"):
            state[name] = 1 + 0.1 * piece
        else:
            state[name] = 0.1 * piece
    return state
