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


def _transformer_state_dict(tr, base: str) -> dict:
    """A 1-layer Transformer tree -> {base}.layers.0.{0,1}.*, {base}.norm"""
    sd: dict = {}
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


def cross_transformer_state_dict(params, prefix: str = "",
                                 share: bool = False) -> dict:
    """CrossTransformer or CrossTransformerModAvg tree (Transformer_{2i},
    Transformer_{2i+1}, each one layer deep) -> layers.{i}.{0,1}.*; the
    tree of CrossTransformer(share=True) holds one Transformer_{i} per
    depth, which goes under both names of its pair."""
    sd: dict = {}
    pre = f"{prefix}." if prefix else ""
    n = sum(1 for k in params if k.startswith("Transformer_"))
    for t in range(n):
        slots = ((t, 0), (t, 1)) if share else ((t // 2, t % 2),)
        for i, j in slots:
            sd.update(_transformer_state_dict(params[f"Transformer_{t}"],
                                              f"{pre}layers.{i}.{j}"))
    return sd


PORTED = ("ad", "transformer", "transformer_res", "cnn", "cnn_ad")


def state_dict_from_jax(variables, model: str = "ad") -> dict:
    """JAX `{"params", "batch_stats"}` of `model` (one of `PORTED`) -> this
    package's state_dict (float32 CPU tensors), ready for
    `load_state_dict`."""
    if model not in PORTED:
        raise ValueError("state_dict_from_jax: ported models are 'ad', "
                         "'transformer', 'transformer_res', 'cnn' and "
                         f"'cnn_ad', got {model!r}")
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for mod in ("mri_cnn", "pet_cnn"):
        sd.update(snet_state_dict(params[mod], stats[mod], mod))
    if model in ("cnn", "cnn_ad"):  # Linear -> ReLU -> Linear head
        head = "fc" if model == "cnn" else "fc_cls"
        _put(sd, f"{head}.0", _linear(params[head]["Dense_0"]))
        _put(sd, f"{head}.2", _linear(params[head]["Dense_1"]))
        if model == "cnn_ad":
            _discriminator(sd, params["D"], stats["D"])
        return sd
    sd.update(cross_transformer_state_dict(params["fuse_transformer"],
                                           "fuse_transformer"))
    head = params["fc_cls"]
    if model == "transformer_res":  # no BatchNorm, so no batch_stats either
        for i, slot in enumerate((0, 3, 6)):
            _put(sd, f"fc_cls.{slot}", _linear(head[f"Dense_{i}"]))
        return sd
    head_st = stats["fc_cls"]
    _put(sd, "fc_cls.0", _linear(head["Dense_0"]))
    _put(sd, "fc_cls.1", _bn(head["BatchNorm_0"], head_st["BatchNorm_0"]))
    _put(sd, "fc_cls.4", _linear(head["Dense_1"]))
    _put(sd, "fc_cls.5", _bn(head["BatchNorm_1"], head_st["BatchNorm_1"]))
    _put(sd, "fc_cls.8", _linear(head["Dense_2"]))
    if model == "ad":
        _discriminator(sd, params["D"], stats["D"])
    return sd


def _discriminator(sd, d, d_st):
    _put(sd, "D.0", _linear(d["Dense_0"]))
    _put(sd, "D.1", _bn(d["BatchNorm_0"], d_st["BatchNorm_0"]))
    _put(sd, "D.3", _linear(d["Dense_1"]))


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
