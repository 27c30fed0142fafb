"""Packaging and dispatch rules of the PyTorch/CUDA port.

This file imports no jax, so its CUDA test also runs on a machine with a
GPU and without jax:

    python -m pytest tests/test_torch_package.py --noconftest -m cuda -q
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from transmf_ad_tpu_torch import _build
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn.grl import revgrad
from transmf_ad_tpu_torch.ops import (KERNELS, attention_core, pool3d,
                                      pooling, reset_launch_counts, stem)
from transmf_ad_tpu_torch.ops.flash_attention import (FLASH_MIN_KEYS,
                                                      attention_reference,
                                                      fused_attention)
from transmf_ad_tpu_torch.serving import make_inference_fn

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import transmf_ad_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'flax', 'transmf_ad_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_cpu_calls_leave_launch_counts_at_zero(rng):
    reset_launch_counts()
    model = build_model("ad", **SMALL)
    probs = make_inference_fn(model, "cpu")(
        rng.standard_normal((2, 19, 21, 17)).astype(np.float32),
        rng.standard_normal((2, 19, 21, 17)).astype(np.float32))
    assert probs.shape == (2, 2)
    pooling.fused_token_pool(torch.ones(1, 3, 4), torch.ones(1, 3, 4))
    pool3d.max_pool3d_2x2(torch.ones(1, 2, 2, 2, 3))
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0]


def test_non_cpu_tensors_never_take_the_plain_path():
    """On any device but the CPU a wrapper launches its kernel or raises;
    meta tensors stand in for a device without the kernels."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pooling.fused_token_pool(torch.ones(2, 3, 4, **meta),
                                 torch.ones(2, 3, 4, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        stem.stem_conv(torch.ones(1, 4, 4, 4, **meta),
                       torch.ones(3, 3, 3, 2, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        pool3d.max_pool3d_2x2(torch.ones(1, 4, 4, 4, 2, **meta))
    q = torch.ones(1, 1, 3, 8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention(q, q, q, 1.0)
    long = torch.ones(1, 1, FLASH_MIN_KEYS + 1, 8, **meta)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention_core(q, long, long, 1.0)
    # on the CPU the long-key case runs the plain version
    qc = torch.randn(1, 1, 3, 8)
    kc = torch.randn(1, 1, FLASH_MIN_KEYS + 1, 8)
    torch.testing.assert_close(attention_core(qc, kc, kc, 0.5),
                               attention_reference(qc, kc, kc, 0.5))


def test_train_mode_raises():
    model = build_model("ad", **SMALL)
    x = torch.zeros(1, 16, 16, 16, 1)
    with pytest.raises(NotImplementedError, match="eval"):
        model(x, x, train=True)
    with pytest.raises(NotImplementedError):
        model.train()(x, x)


def test_revgrad():
    x = torch.randn(3, 4, requires_grad=True)
    y = revgrad(x, 2.0)
    torch.testing.assert_close(y, x)
    (y * torch.arange(4.0)).sum().backward()
    torch.testing.assert_close(x.grad, -2.0 * torch.arange(4.0).expand(3, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cases(g):
    """(kernel call, plain call) pairs at small odd shapes."""
    def r(*s):
        return torch.randn(*s, generator=g, device="cuda")

    y, s, b = r(2, 5, 7, 9, 3), r(9 * 3), r(9 * 3)
    yc, sc, bc = r(2, 5, 7, 9, 3), r(3), r(3)
    x4, w4 = r(2, 5, 7, 37), r(3, 3, 3, 5)
    m, p = r(3, 7, 40), r(3, 7, 40)
    q, k, v = r(2, 3, 37, 24), r(2, 3, 70, 24), r(2, 3, 70, 24)
    qd, kd = r(1, 2, 5, 128), r(1, 2, 33, 128)
    ref = pool3d.affine_act_pool_reference
    return [
        ("token_pool", lambda t: pooling.fused_token_pool(t(m), t(p)),
         lambda t: pooling.pool_reference(t(m), t(p))),
        ("attention_fwd", lambda t: fused_attention(t(q), t(k), t(v), 0.2),
         lambda t: attention_reference(t(q), t(k), t(v), 0.2)),
        ("attention_fwd", lambda t: fused_attention(t(qd), t(kd), t(kd), 0.1),
         lambda t: attention_reference(t(qd), t(kd), t(kd), 0.1)),
        ("stem_conv", lambda t: stem.stem_conv(t(x4), t(w4)),
         lambda t: stem._conv_reference(t(x4), t(w4))),
        ("affine_act_pool",
         lambda t: pool3d.max_pool3d_2x2_affine_act(t(y), s, b, 0.01),
         lambda t: ref(t(y), s, b, 0.01, "max")),
        ("affine_act_pool",
         lambda t: pool3d.max_pool3d_2x2_affine_act_bc(t(yc), sc, bc, 0.2),
         lambda t: ref(t(yc), sc, bc, 0.2, "max")),
        ("affine_act_pool",
         lambda t: pool3d.avg_pool3d_2x2_affine_act(t(yc), sc, bc, 0.01),
         lambda t: ref(t(yc), sc, bc, 0.01, "avg")),
        ("affine_act_pool", lambda t: pool3d.avg_pool3d_2x2(t(yc)),
         lambda t: ref(t(yc), torch.ones_like(sc), torch.zeros_like(bc), 1.0,
                       "avg")),
    ]


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(cuda):
    """Each kernel against its plain version at small odd shapes; float32
    to 1e-5 (summation order), bfloat16 to one ulp (both sides round one
    float32 value); each call launches its kernel exactly once."""
    counts = {k.name: k for k in KERNELS}
    for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                       (torch.bfloat16, dict(rtol=2 ** -7, atol=1e-4))):
        for name, kern, plain in _cases(cuda):
            def t(a):
                return a.to(dtype)
            before = counts[name].launches
            out = kern(t)
            assert counts[name].launches == before + 1, name
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), plain(t).float(), **tol,
                                       msg=lambda m: f"{name} {dtype}: {m}")
    x = torch.randn(2, 4, 4, 4, 3, device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        pool3d.max_pool3d_2x2(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        pool3d.max_pool3d_2x2(x.transpose(1, 2))
