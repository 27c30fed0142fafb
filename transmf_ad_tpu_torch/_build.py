"""Build, load and launch the hand-written Hopper kernels, and register
the ops that reach them.

Each source under `csrc/` compiles with its own `nvcc` process, all started
together, and the objects link into one shared library with a plain C
interface, which is loaded with `ctypes` (no PyTorch headers, so the build
takes seconds). The build runs at first use, never at import, and is keyed
by a hash of the sources and flags: an unchanged tree reuses the library in
`_build/`. A missing `nvcc` or a failed build raises; nothing falls back to
the plain PyTorch versions.

Each kernel is described by a `Kernel`: its C entry, its argument types, the
source it lives in, the TPU kernel it replaces, and a plain-integer count of
its launches, which rises by one per launch and nowhere else. A kernel with
more than one variant (K2, K6, K8-K12, K14: tensor cores or CUDA cores, by
dtype and shape) also counts its launches per variant.

A kernel of a model (K1-K12, K14) is reached only through a registered op in
the `transmf` namespace (`define_op`): the dispatcher runs the op's CUDA
implementation (checks, variant, `Kernel.launch`) for CUDA tensors and its
plain PyTorch version for CPU tensors, and FakeTensors (`torch.export`,
`opcheck`, `torch.compile`) see only its fake implementation, which
launches and counts nothing. A traced or exported program therefore keeps the op in its
graph, and its launches count as eager calls do. While tracing is on
(`utils/tracing.py`), each op's CPU and CUDA implementations count their
calls and host time. K13, the train step's augmentation, is no op: its
wrapper (`data/transforms.py::augment_batch`) launches it for CUDA tensors
and runs the plain version for CPU tensors itself; the train step is never
exported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile", "0", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit's default
    install location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the Hopper "
        "kernels of transmf_ad_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/*.cu into `build_dir` unless a library for the same
    sources exists; returns its path. One nvcc per source, in parallel,
    then one link. The compilers' report (registers, shared memory, spills
    per kernel) is kept beside the library as a .log file."""
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"libtransmf_kernels_{source_digest()}.so"
    if lib.exists():
        return lib
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                 str(Path(tmp) / f"{src.stem}.o")]
                for src in sorted(CSRC_DIR.glob("*.cu"))]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [" ".join(c) + "\n" + p.communicate()[0]
                for c, p in zip(cmds, procs)]
        failed = [p.returncode for p in procs if p.returncode != 0]
        so = Path(tmp) / "lib.so"
        if not failed:
            link = [nvcc, "-shared", "-o", str(so),
                    *(c[c.index("-o") + 1] for c in cmds)]
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.returncode)
        log = "\n".join(logs)
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"kernel build failed ({failed[0]}):\n{log}")
        os.replace(so, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, built on first use in this process."""
    lib = ctypes.CDLL(str(build()))
    lib.transmf_error_string.argtypes = [ctypes.c_int]
    lib.transmf_error_string.restype = ctypes.c_char_p
    return lib


# ctypes argument kinds; every pointer and the stream are c_void_p, so that
# ctypes never passes them as 32-bit ints
PTR, INT, FLOAT, DOUBLE = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_double)


@dataclasses.dataclass
class Kernel:
    name: str
    entry: str  # C symbol in the library
    argtypes: tuple  # without the trailing stream argument
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel's pallas_call
    launches: int = 0
    # launches per variant name, for the kernels that have variants
    by_variant: dict = dataclasses.field(default_factory=dict)

    @functools.cached_property
    def _fn(self):
        fn = getattr(library(), self.entry)
        fn.argtypes = [*self.argtypes, PTR]
        fn.restype = ctypes.c_int
        return fn

    def launch(self, device: torch.device, *args, variant=None) -> None:
        """Launch on `device`'s current stream; raise if it was refused.
        `variant` names the variant that `args` asks for, for its count."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = library().transmf_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} ({err})")
        self.launches += 1
        if variant is not None:
            self.by_variant[variant] = self.by_variant.get(variant, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.by_variant.clear()


def check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Validate the kernel inputs: one CUDA device, one float32 or bfloat16
    dtype, contiguous. Returns the dtype code."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {t0.device}")
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t0.dtype} not supported "
                        "(float32 or bfloat16)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: inputs must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty input")
    return DTYPE_CODES[t0.dtype]


# the op namespace every kernel is registered in; `define_op` fills it
LIBRARY = torch.library.Library("transmf", "DEF")
OPS: list = []  # every op's default overload, in the order defined


def save_inputs(ctx, inputs, output):
    """`setup_context` of an op whose backward needs its inputs alone."""
    ctx.save_for_backward(*inputs)


def _counted(name: str, impl):
    """`impl` counting, while tracing is on (`utils/tracing.py`), its calls
    in `op.<name>.calls` and its host ns (checks, variant, launch) in
    `op.<name>.host_ns`."""
    calls, host_ns = f"op.{name}.calls", f"op.{name}.host_ns"

    @functools.wraps(impl)
    def run(*args, **kwargs):
        if not tracing.ON:
            return impl(*args, **kwargs)
        t0 = time.perf_counter_ns()
        out = impl(*args, **kwargs)
        tracing.count(host_ns, time.perf_counter_ns() - t0)
        tracing.count(calls)
        return out

    return run


def define_op(schema: str, plain, cuda, fake, backward=None,
              setup_context=None):
    """Register `transmf::<schema>` and return its default overload: `plain`
    for CPU tensors, `cuda` (the kernel's launch path) for CUDA tensors,
    `fake` for FakeTensors, and, for a differentiable op, `backward` and
    `setup_context` as `torch.library.register_autograd` takes them. No
    other device has an implementation: a meta tensor, which stands for a
    device without the kernels, raises as a launch on it would."""
    name = schema.split("(", 1)[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, _counted(name, plain), "CPU")
    LIBRARY.impl(name, _counted(name, cuda), "CUDA")

    def fake_or_raise(*args, **kwargs):
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta"
               for a in (*args, *kwargs.values())):
            raise ValueError(f"{name}: expected CUDA tensors, got meta")
        return fake(*args, **kwargs)

    torch.library.register_fake(f"transmf::{name}", fake_or_raise,
                                lib=LIBRARY)
    if backward is not None:
        torch.library.register_autograd(f"transmf::{name}", backward,
                                        setup_context=setup_context,
                                        lib=LIBRARY)
    op = getattr(torch.ops.transmf, name).default
    OPS.append(op)
    return op
