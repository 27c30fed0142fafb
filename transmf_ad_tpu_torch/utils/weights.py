"""Weights for the port: reference initialisation and the JAX weight bridge.

`state_dict_from_jax` turns the JAX package's `{"params", "batch_stats"}`
tree into this package's `state_dict`. It is the exact inverse of
`transmf_ad_tpu.utils.torch_import.map_state_dict`, with the same layout
transforms: DHWIO -> OIDHW conv kernels, Dense (in, out) -> Linear
(out, in), BN scale/bias/mean/var -> weight/bias/running_mean/running_var.
It uses numpy only, so it runs without jax (the arrays may be jax or
numpy arrays).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..nn.batchnorm import BatchNormMasked, ManualBN
from ..nn.blocks import _PLAN


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p):
    return {"weight": np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2),
            "bias": p["bias"]}


def _linear(p):
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _bn(p, s):
    return {"weight": p["scale"], "bias": p["bias"],
            "running_mean": s["mean"], "running_var": s["var"]}


def _layernorm(p):
    return {"weight": p["scale"], "bias": p["bias"]}


def _put(sd, prefix, entries):
    for k, v in entries.items():
        sd[f"{prefix}.{k}"] = _f32(v)


def snet_state_dict(params, stats, prefix: str) -> dict:
    """SNet tree (ConvBNAct_0..6) -> reference sNet names
    {prefix}.conv{1..4}.{slot}."""
    sd: dict = {}
    for i, (stage, cs, bs, *_) in enumerate(_PLAN):
        blk = params[f"ConvBNAct_{i}"]
        _put(sd, f"{prefix}.{stage}.{cs}", _conv(blk))
        _put(sd, f"{prefix}.{stage}.{bs}",
             _bn(blk["BatchNorm_0"], stats[f"ConvBNAct_{i}"]["BatchNorm_0"]))
    return sd


def cross_transformer_state_dict(params, prefix: str = "") -> dict:
    """CrossTransformerModAvg tree (Transformer_{2i}, Transformer_{2i+1},
    each one layer deep) -> layers.{i}.{0,1}.*"""
    sd: dict = {}
    pre = f"{prefix}." if prefix else ""
    n = sum(1 for k in params if k.startswith("Transformer_"))
    for t in range(n):
        tr = params[f"Transformer_{t}"]
        base = f"{pre}layers.{t // 2}.{t % 2}"
        attn = tr["Attention_0"]
        _put(sd, f"{base}.layers.0.0.fn.to_q", _linear(attn["to_q"]))
        _put(sd, f"{base}.layers.0.0.fn.to_kv", _linear(attn["to_kv"]))
        _put(sd, f"{base}.layers.0.0.fn.to_out.0", _linear(attn["to_out"]))
        _put(sd, f"{base}.layers.0.0.norm", _layernorm(tr["LayerNorm_0"]))
        _put(sd, f"{base}.layers.0.1.norm", _layernorm(tr["LayerNorm_1"]))
        ff = tr["FeedForward_0"]
        _put(sd, f"{base}.layers.0.1.fn.net.0", _linear(ff["Dense_0"]))
        _put(sd, f"{base}.layers.0.1.fn.net.3", _linear(ff["Dense_1"]))
        _put(sd, f"{base}.norm", _layernorm(tr["LayerNorm_2"]))
    return sd


def state_dict_from_jax(variables, model: str = "ad") -> dict:
    """JAX `{"params", "batch_stats"}` of `model` -> this package's
    state_dict (float32 CPU tensors), ready for `load_state_dict`."""
    if model != "ad":
        raise ValueError(f"state_dict_from_jax: only 'ad' is ported, "
                         f"got {model!r}")
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for mod in ("mri_cnn", "pet_cnn"):
        sd.update(snet_state_dict(params[mod], stats[mod], mod))
    sd.update(cross_transformer_state_dict(params["fuse_transformer"],
                                           "fuse_transformer"))
    head, head_st = params["fc_cls"], stats["fc_cls"]
    _put(sd, "fc_cls.0", _linear(head["Dense_0"]))
    _put(sd, "fc_cls.1", _bn(head["BatchNorm_0"], head_st["BatchNorm_0"]))
    _put(sd, "fc_cls.4", _linear(head["Dense_1"]))
    _put(sd, "fc_cls.5", _bn(head["BatchNorm_1"], head_st["BatchNorm_1"]))
    _put(sd, "fc_cls.8", _linear(head["Dense_2"]))
    d, d_st = params["D"], stats["D"]
    _put(sd, "D.0", _linear(d["Dense_0"]))
    _put(sd, "D.1", _bn(d["BatchNorm_0"], d_st["BatchNorm_0"]))
    _put(sd, "D.3", _linear(d["Dense_1"]))
    return sd


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initialisation, drawn from `generator`: conv kernels
    He-normal over fan_out, conv biases and Linear layers U(+-1/sqrt(fan_in)),
    norms weight 1 / bias 0, running stats mean 0 / var 1. The model's
    parameters must lie on the generator's device."""
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            k = math.prod(m.kernel_size)
            m.weight.normal_(0.0, math.sqrt(2.0 / (m.out_channels * k)),
                             generator=generator)
            bound = 1.0 / math.sqrt(m.in_channels * k)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (ManualBN, BatchNormMasked, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if not isinstance(m, nn.LayerNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
