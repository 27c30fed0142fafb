"""Weights for the port: reference initialisation and the JAX weight bridge.

`state_dict_from_jax` turns the JAX package's `{"params", "batch_stats"}`
tree of any of the eight models into this package's `state_dict`. It is
the exact inverse of `transmf_ad_tpu.utils.torch_import.map_state_dict`,
with the same layout transforms: DHWIO -> OIDHW conv kernels, Dense (in,
out) -> Linear (out, in), BN scale/bias/mean/var ->
weight/bias/running_mean/running_var, and ADVIT's to_q / to_kv fused into
vit_pytorch's one to_qkv weight.
It uses numpy only, so it runs without jax (the arrays may be jax or
numpy arrays).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..models.advit import ViTEncoder
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


def _conv_bn_blocks(params, stats, pairs) -> dict:
    """ConvBNAct_0..N-1 -> the (conv prefix, BN prefix) pairs, in order."""
    sd: dict = {}
    for i, (conv, bn) in enumerate(pairs):
        blk = f"ConvBNAct_{i}"
        _put(sd, conv, _conv(params[blk]))
        _put(sd, bn, _bn(params[blk]["BatchNorm_0"],
                         stats[blk]["BatchNorm_0"]))
    return sd


def snet_state_dict(params, stats, prefix: str) -> dict:
    """SNet tree (ConvBNAct_0..6) -> reference sNet names
    {prefix}.conv{1..4}.{slot}."""
    return _conv_bn_blocks(params, stats, [
        (f"{prefix}.{stage}.{cs}", f"{prefix}.{stage}.{bs}")
        for stage, cs, bs, *_ in _PLAN])


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


PORTED = ("single", "cnn", "cnn_ad", "transformer", "transformer_res",
          "ad", "advit", "mnet")


def state_dict_from_jax(variables, model: str = "ad") -> dict:
    """JAX `{"params", "batch_stats"}` of `model` (one of `PORTED`) -> this
    package's state_dict (float32 CPU tensors), ready for
    `load_state_dict`."""
    if model not in PORTED:
        raise ValueError(f"state_dict_from_jax: unknown model {model!r}; "
                         f"known: {PORTED}")
    params, stats = variables["params"], variables["batch_stats"]
    if model == "single":
        sd = snet_state_dict(params["cnn"], stats["cnn"], "cnn")
        _mlp_head(sd, "fc", params["fc"])
        return sd
    if model == "advit":
        return _advit_state_dict(params, stats)
    if model == "mnet":
        return _mnet_state_dict(params, stats)
    sd: dict = {}
    for mod in ("mri_cnn", "pet_cnn"):
        sd.update(snet_state_dict(params[mod], stats[mod], mod))
    if model in ("cnn", "cnn_ad"):  # Linear -> ReLU -> Linear head
        head = "fc" if model == "cnn" else "fc_cls"
        _mlp_head(sd, head, params[head])
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
    _fusion_head(sd, "fc_cls", head, stats["fc_cls"])
    if model == "ad":
        _discriminator(sd, params["D"], stats["D"])
    return sd


def _mlp_head(sd, prefix, p):
    _put(sd, f"{prefix}.0", _linear(p["Dense_0"]))
    _put(sd, f"{prefix}.2", _linear(p["Dense_1"]))


def _fusion_head(sd, prefix, p, st):
    """Dense_0..2 with BatchNorm_0..1 -> {prefix}.{0,1,4,5,8}."""
    _put(sd, f"{prefix}.0", _linear(p["Dense_0"]))
    _put(sd, f"{prefix}.1", _bn(p["BatchNorm_0"], st["BatchNorm_0"]))
    _put(sd, f"{prefix}.4", _linear(p["Dense_1"]))
    _put(sd, f"{prefix}.5", _bn(p["BatchNorm_1"], st["BatchNorm_1"]))
    _put(sd, f"{prefix}.8", _linear(p["Dense_2"]))


def _discriminator(sd, d, d_st):
    _put(sd, "D.0", _linear(d["Dense_0"]))
    _put(sd, "D.1", _bn(d["BatchNorm_0"], d_st["BatchNorm_0"]))
    _put(sd, "D.3", _linear(d["Dense_1"]))


def _vit_state_dict(p, prefix: str) -> dict:
    """ViTEncoder tree -> vit_pytorch 1.7.4 names; to_q and to_kv go into
    one fused to_qkv weight, q rows first."""
    sd: dict = {}
    _put(sd, f"{prefix}.to_patch_embedding.1", _layernorm(p["LayerNorm_0"]))
    _put(sd, f"{prefix}.to_patch_embedding.2", _linear(p["Dense_0"]))
    _put(sd, f"{prefix}.to_patch_embedding.3", _layernorm(p["LayerNorm_1"]))
    _put(sd, prefix, {"cls_token": p["cls_token"],
                      "pos_embedding": p["pos_embedding"]})
    tr = p["Transformer_0"]
    depth = sum(1 for k in tr if k.startswith("Attention_"))
    for i in range(depth):
        a, ff = tr[f"Attention_{i}"], tr[f"FeedForward_{i}"]
        base = f"{prefix}.transformer.layers.{i}"
        qkv = np.concatenate([np.asarray(a["to_q"]["kernel"]),
                              np.asarray(a["to_kv"]["kernel"])], axis=1)
        _put(sd, f"{base}.0", {"to_qkv.weight": qkv.T})
        _put(sd, f"{base}.0.to_out.0", _linear(a["to_out"]))
        _put(sd, f"{base}.0.norm", _layernorm(tr[f"LayerNorm_{2 * i}"]))
        _put(sd, f"{base}.1.net.0", _layernorm(tr[f"LayerNorm_{2 * i + 1}"]))
        _put(sd, f"{base}.1.net.1", _linear(ff["Dense_0"]))
        _put(sd, f"{base}.1.net.4", _linear(ff["Dense_1"]))
    _put(sd, f"{prefix}.transformer.norm",
         _layernorm(tr[f"LayerNorm_{2 * depth}"]))
    return sd


def _advit_state_dict(params, stats) -> dict:
    sd: dict = {}
    for mod in ("mri", "pet"):
        p = f"to_2d_{mod}"
        sd.update(_conv_bn_blocks(params[p], stats[p], [
            (f"{p}.0", f"{p}.1"), (f"{p}.4", f"{p}.5")]))
        sd.update(_vit_state_dict(params[f"vit_{mod}"], f"vit_{mod}"))
    _put(sd, "fc", _linear(params["fc"]))
    return sd


# Mnet's ConvBNAct_0..5 of a slice CNN in the reference's (stack, conv
# slot, BN slot), and the spatial stack's three (conv slot, BN slot)
_SLICE_SLOTS = (("conv1", "0", "1"), ("conv2", "0", "1"), ("conv2", "3", "4"),
                ("conv3", "0", "1"), ("conv3", "3", "4"), ("conv3", "6", "7"))
_SPATIAL_SLOTS = (("0", "1"), ("4", "5"), ("8", "9"))


def _mnet_state_dict(params, stats) -> dict:
    sd: dict = {}
    for mod in ("mri", "pet"):
        for view in ("axial", "col", "sag"):
            p, s = params[mod], stats[mod]
            pre = f"{mod}.slice_cnn_{view}"
            sd.update(_conv_bn_blocks(
                p[f"slice_{view}"], s[f"slice_{view}"],
                [(f"{pre}.{c}.{ci}", f"{pre}.{c}.{bi}")
                 for c, ci, bi in _SLICE_SLOTS]))
            pre = f"{mod}.spatial_cnn_{view}.conv1"
            st = "_StridedStack_0"
            sd.update(_conv_bn_blocks(
                p[f"spatial_{view}"][st], s[f"spatial_{view}"][st],
                [(f"{pre}.{ci}", f"{pre}.{bi}") for ci, bi in _SPATIAL_SLOTS]))
    _fusion_head(sd, "fc", params, stats)
    return sd


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initialisation, drawn from `generator`: conv kernels
    He-normal over fan_out, conv biases and Linear layers U(+-1/sqrt(fan_in)),
    norms weight 1 / bias 0, running stats mean 0 / var 1, a ViT's CLS
    token and positional embedding N(0, 0.02). The model's parameters must
    lie on the generator's device."""
    for m in model.modules():
        if isinstance(m, ViTEncoder):
            m.cls_token.normal_(0.0, 0.02, generator=generator)
            m.pos_embedding.normal_(0.0, 0.02, generator=generator)
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
