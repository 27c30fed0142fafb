"""Plain float32 PyTorch layers of the models the benchmark runs.

Written from the models' equations (Zhang et al., ISBI 2023; the
reference `models/mymodel.py`), channels first (B, C, X, Y, Z), with no
kernel, no cache and no batching trick. Parameter names follow the
reference torch models, so one state_dict loads into these modules and
into the program under test.

Every product (conv, linear, attention) goes through `Precision`: exact
float32 (TF32 is switched off by the caller) or, for the control that
must come out as not correct, each operand rounded to fp8 (e4m3 forward,
e5m2 for the gradients flowing back) with a per-tensor scale, the step a
lower-precision path would take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SLOPE = 0.01  # LeakyReLU of the sNet blocks
EPS = 1e-5  # BatchNorm and LayerNorm
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x, dtype):
    """x rounded to `dtype` with a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX[dtype], torch.ones_like(amax))
    return ((x / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Precision:
    """What every product's operands go through: `q(x)`."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    @staticmethod
    def bias(train: bool) -> bool:
        """Whether a layer that a BatchNorm follows adds its bias (a
        training BatchNorm cancels it)."""
        return not train

    def q(self, x):
        return x if self.name == "float32" else _Fp8.apply(x)


class _RevGrad(torch.autograd.Function):
    """Gradient reversal: the identity forward, -alpha * g backward."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def revgrad(x, alpha):
    return _RevGrad.apply(x, alpha)


class BN(nn.Module):
    """BatchNorm over every axis but 1 (`F.batch_norm`): batch moments
    (biased variance) in training, the running statistics otherwise. The
    running statistics are not moved: the comparison reads parameters,
    not buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool):
        if train:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, EPS)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, EPS)


# In training, the batch mean of a BatchNorm cancels the bias of the conv
# or linear before it exactly: such a layer runs with `bias=False` there,
# so the bias's gradient is the exact zero the equations give, and not the
# rounding left by summing a large cancelling gradient.


class Conv(nn.Conv3d):
    def run(self, x, prec: Precision, bias: bool = True):
        return F.conv3d(prec.q(x), prec.q(self.weight),
                        self.bias if bias else None, padding=self.padding)


class Linear(nn.Linear):
    def run(self, x, prec: Precision, bias: bool = True):
        return F.linear(prec.q(x), prec.q(self.weight),
                        self.bias if bias else None)


def dropout(x, p: float, train: bool, generator):
    """Each unit kept when its uniform draw is at least p, scaled by
    1 / (1 - p); the draw is one float32 `torch.rand` of x's shape."""
    if not train or p == 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


# sNet: (stage, conv slot, bn slot, cin, cout as multiples of dim / 4
# (0: one input channel), kernel, pool)
SNET = (("conv1", "0", "1", 0, 1, 3, "max"),
        ("conv2", "0", "1", 1, 1, 3, None),
        ("conv2", "3", "4", 1, 2, 3, "max"),
        ("conv3", "0", "1", 2, 2, 3, None),
        ("conv3", "3", "4", 2, 4, 3, "max"),
        ("conv4", "0", "1", 4, 8, 3, None),
        ("conv4", "3", "4", 8, 4, 1, "avg"))


class SNet(nn.Module):
    """Per-modality encoder: seven conv -> BN -> LeakyReLU blocks, a 2^3
    max pool after blocks 0, 2 and 4 and a 2^3 mean pool after block 6.
    (B, 1, X, Y, Z) -> (B, dim, X/16, Y/16, Z/16), floors at each pool."""

    def __init__(self, dim: int):
        super().__init__()
        q = dim // 4
        for stage, cs, bs, ci, co, k, _ in SNET:
            if not hasattr(self, stage):
                self.add_module(stage, nn.ModuleDict())
            slots = getattr(self, stage)
            slots[cs] = Conv(ci * q if ci else 1, co * q, k, padding=k // 2)
            slots[bs] = BN(co * q)

    def forward(self, x, train: bool, prec: Precision):
        for stage, cs, bs, *_, pool in SNET:
            slots = getattr(self, stage)
            x = F.leaky_relu(slots[bs](slots[cs].run(x, prec, prec.bias(train)),
                                       train), SLOPE)
            if pool == "max":
                x = F.max_pool3d(x, 2)
            elif pool == "avg":
                x = F.avg_pool3d(x, 2)
        return x


def tokens(x):
    """(B, C, X, Y, Z) -> (B, X*Y*Z, C), x slowest, channels last."""
    return x.flatten(2).transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim):
        super().__init__(dim, eps=EPS)


class Attention(nn.Module):
    """Queries from x, keys and values from `context` (the first and second
    halves of to_kv), no q/kv bias, scale dim_head ** -0.5, softmax over
    every key."""

    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim))

    def forward(self, x, context, prec: Precision):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        q = self.to_q.run(x, prec)
        k, v = self.to_kv.run(context, prec).chunk(2, dim=-1)

        def split(t):
            return t.reshape(b, t.shape[1], h, dh).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        s = torch.matmul(prec.q(q), prec.q(k).transpose(-1, -2)) * dh ** -0.5
        out = torch.matmul(prec.q(torch.softmax(s, dim=-1)), prec.q(v))
        return self.to_out[0].run(out.transpose(1, 2).reshape(b, n, h * dh),
                                  prec)


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn


class FeedForward(nn.Module):
    """Linear -> exact GELU -> Linear (net.0, net.3)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.net = nn.ModuleDict({"0": Linear(dim, hidden),
                                  "3": Linear(hidden, dim)})

    def forward(self, x, prec: Precision):
        return self.net["3"].run(F.gelu(self.net["0"].run(x, prec)), prec)


class Transformer(nn.Module):
    """One layer: x + attention(LN(x), context), then x + FF(LN(x)), then a
    final LayerNorm. The context enters un-normalised."""

    def __init__(self, dim, heads, dim_head, mlp_dim):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(dim, Attention(dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim))])])
        self.norm = LayerNorm(dim)

    def forward(self, x, context, prec: Precision):
        for attn, ff in self.layers:
            x = attn.fn(attn.norm(x), context, prec) + x
            x = ff.fn(ff.norm(x), prec) + x
        return self.norm(x)


def encoder_pairs(depth, dim, heads, dim_head, mlp_dim):
    """`depth` (MRI, PET) pairs of one-layer Transformers."""
    return nn.ModuleList(nn.ModuleList(
        [Transformer(dim, heads, dim_head, mlp_dim) for _ in range(2)])
        for _ in range(depth))


class FusionHead(nn.Module):
    """(Linear -> [BN] -> ReLU -> Dropout) for 512 and 64 features, then
    Linear(64, 2); slots 0, 1, 4, 5, 8 with BatchNorm, else 0, 3, 6."""

    def __init__(self, fan_in, drop, batchnorm: bool):
        super().__init__()
        self.drop, self.batchnorm = drop, batchnorm
        self.step = 4 if batchnorm else 3
        for i, width in enumerate((512, 64)):
            self.add_module(str(self.step * i), Linear(fan_in, width))
            if batchnorm:
                self.add_module(str(self.step * i + 1), BN(width))
            fan_in = width
        self.add_module(str(2 * self.step), Linear(fan_in, 2))

    def forward(self, x, train, generator, prec: Precision):
        slot = self._modules
        for i in range(2):
            x = slot[str(self.step * i)].run(
                x, prec, prec.bias(train) or not self.batchnorm)
            if self.batchnorm:
                x = slot[str(self.step * i + 1)](x, train)
            x = dropout(F.relu(x), self.drop, train, generator)
        return slot[str(2 * self.step)].run(x, prec)
