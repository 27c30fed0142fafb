"""Read reference PyTorch checkpoints into the port's models.

Port of transmf_ad_tpu/utils/torch_import.py. The port's models carry the
reference's module names, so no layout changes: `map_state_dict` keeps the
keys the JAX package's importer reads for a model and drops every other,
as that importer ignores them:

  - BatchNorm `num_batches_tracked` counters;
  - ADVIT's `vit_*.mlp_head.*`, dead under the CLS-latent reading
    (models/advit.py);
  - Mnet's spatial `conv2.*` / `conv3.*` stacks, dead in the reference
    forward (MiSePyNet.py:89-94): only the driven `conv1` stack is read.

The transformer depth is read from the file (`fuse_transformer.layers.i`,
`transformer.layers.i`), as the JAX importer infers it, so a file of
another depth maps another number of tensors. Accepted containers: a bare
state_dict, or one wrapped under 'net_model' / 'model' / 'state_dict'.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..parallel.tensor import shard_of

__all__ = ["import_torch_checkpoint", "map_state_dict", "SUPPORTED_MODELS"]

SUPPORTED_MODELS = ("single", "cnn", "cnn_ad", "transformer",
                    "transformer_res", "ad", "advit", "mnet")

_BN = ("weight", "bias", "running_mean", "running_var")
_SNET = (("conv1.0", "conv1.1"), ("conv2.0", "conv2.1"),
         ("conv2.3", "conv2.4"), ("conv3.0", "conv3.1"),
         ("conv3.3", "conv3.4"), ("conv4.0", "conv4.1"),
         ("conv4.3", "conv4.4"))


def _conv_bn(pairs) -> List[str]:
    """Conv weight and bias, BatchNorm scale, shift and running statistics
    of each (conv prefix, BN prefix)."""
    return [k for cs, bs in pairs
            for k in (f"{cs}.weight", f"{cs}.bias",
                      *(f"{bs}.{n}" for n in _BN))]


def _linear(prefix, bias=True) -> List[str]:
    return [f"{prefix}.weight"] + ([f"{prefix}.bias"] if bias else [])


def _norm(prefix) -> List[str]:
    return [f"{prefix}.weight", f"{prefix}.bias"]


def _snet(prefix) -> List[str]:
    return _conv_bn((f"{prefix}.{c}", f"{prefix}.{b}") for c, b in _SNET)


def _depth(sd, prefix) -> int:
    depth = 0
    while f"{prefix}.layers.{depth}.0.norm.weight" in sd:
        depth += 1
    return depth


def _transformer(prefix) -> List[str]:
    """A 1-layer networks.Transformer: PreNorm attention and feed-forward,
    then the final norm."""
    attn, ff = f"{prefix}.layers.0.0", f"{prefix}.layers.0.1"
    return (_norm(f"{attn}.norm") + _linear(f"{attn}.fn.to_q", False)
            + _linear(f"{attn}.fn.to_kv", False)
            + _linear(f"{attn}.fn.to_out.0") + _norm(f"{ff}.norm")
            + _linear(f"{ff}.fn.net.0") + _linear(f"{ff}.fn.net.3")
            + _norm(f"{prefix}.norm"))


def _cross(sd, prefix="fuse_transformer") -> List[str]:
    return [k for i in range(_depth(sd, prefix)) for j in (0, 1)
            for k in _transformer(f"{prefix}.layers.{i}.{j}")]


def _bn_head(prefix) -> List[str]:
    """Linear -> BN -> ... twice -> Linear (slots 0/1, 4/5, 8)."""
    return (_linear(f"{prefix}.0") + [f"{prefix}.1.{n}" for n in _BN]
            + _linear(f"{prefix}.4") + [f"{prefix}.5.{n}" for n in _BN]
            + _linear(f"{prefix}.8"))


def _discriminator() -> List[str]:
    return _linear("D.0") + [f"D.1.{n}" for n in _BN] + _linear("D.3")


def _vit(sd, prefix) -> List[str]:
    """vit_pytorch 1.7.4's ViT without its dead `mlp_head`."""
    keys = (_norm(f"{prefix}.to_patch_embedding.1")
            + _linear(f"{prefix}.to_patch_embedding.2")
            + _norm(f"{prefix}.to_patch_embedding.3")
            + [f"{prefix}.cls_token", f"{prefix}.pos_embedding"])
    tr = f"{prefix}.transformer"
    for i in range(_depth(sd, tr)):
        attn, ff = f"{tr}.layers.{i}.0", f"{tr}.layers.{i}.1"
        keys += (_norm(f"{attn}.norm") + _linear(f"{attn}.to_qkv", False)
                 + _linear(f"{attn}.to_out.0") + _norm(f"{ff}.net.0")
                 + _linear(f"{ff}.net.1") + _linear(f"{ff}.net.4"))
    return keys + _norm(f"{tr}.norm")


def _mnet(mod) -> List[str]:
    """One modality's three views: the slice CNN's branches and the driven
    spatial conv1 stack."""
    keys = []
    for view in ("axial", "col", "sag"):
        slc = f"{mod}.slice_cnn_{view}"
        keys += _conv_bn((f"{slc}.{c}.{i}", f"{slc}.{c}.{j}")
                         for c, i, j in (("conv1", 0, 1), ("conv2", 0, 1),
                                         ("conv2", 3, 4), ("conv3", 0, 1),
                                         ("conv3", 3, 4), ("conv3", 6, 7)))
        spa = f"{mod}.spatial_cnn_{view}.conv1"
        keys += _conv_bn((f"{spa}.{i}", f"{spa}.{j}")
                         for i, j in ((0, 1), (4, 5), (8, 9)))
    return keys


def _keys(sd, model_name: str) -> List[str]:
    """The keys of `sd` the JAX importer reads for `model_name`."""
    if model_name == "single":
        return _snet("cnn") + _linear("fc.0") + _linear("fc.2")
    if model_name == "advit":
        keys = []
        for mod in ("mri", "pet"):
            keys += _conv_bn(((f"to_2d_{mod}.0", f"to_2d_{mod}.1"),
                              (f"to_2d_{mod}.4", f"to_2d_{mod}.5")))
            keys += _vit(sd, f"vit_{mod}")
        return keys + _linear("fc")
    if model_name == "mnet":
        return _mnet("mri") + _mnet("pet") + _bn_head("fc")
    keys = _snet("mri_cnn") + _snet("pet_cnn")
    if model_name == "cnn":
        return keys + _linear("fc.0") + _linear("fc.2")
    if model_name == "cnn_ad":
        return keys + _discriminator() + _linear("fc_cls.0") \
            + _linear("fc_cls.2")
    if model_name in ("transformer", "ad"):
        keys += _cross(sd) + _bn_head("fc_cls")
        return keys + (_discriminator() if model_name == "ad" else [])
    # transformer_res: a BatchNorm-less head, Linear slots 0, 3, 6
    return keys + _cross(sd) + [k for s in (0, 3, 6)
                                for k in _linear(f"fc_cls.{s}")]


def map_state_dict(sd: Dict, model_name: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of `model_name` from a reference state_dict:
    the entries the JAX importer reads (a missing one raises `KeyError`, as
    there), as float32 tensors; every other key is dropped."""
    if model_name not in SUPPORTED_MODELS:
        raise ValueError(
            f"torch import supports {SUPPORTED_MODELS}, got '{model_name}'")
    return {k: torch.as_tensor(sd[k]).detach().float()
            for k in _keys(sd, model_name)}


def _unwrap(obj):
    for key in ("net_model", "model", "state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            return obj[key]
    return obj


def _check_shapes(mapped, template, what):
    """The JAX importer's checks, on one group of tensors (parameters, or
    running statistics): the same count, then each entry's shape."""
    if len(mapped) != len(template):
        raise ValueError(
            f"{what}: checkpoint maps {len(mapped)} tensors but the model "
            f"has {len(template)} (dim/depth mismatch?)")
    for key, v in mapped.items():
        if key not in template:
            raise ValueError(f"{what}: unexpected tensor at {key}")
        if tuple(v.shape) != tuple(template[key]):
            raise ValueError(
                f"{what}: shape mismatch at {key}: checkpoint "
                f"{tuple(v.shape)} vs model {tuple(template[key])}")


def _whole_shapes(model):
    """{name: whole shape} of the model's parameters and of its buffers
    (a parameter sharded over the model axis at its whole size)."""
    params = {}
    for k, p in model.named_parameters(remove_duplicate=False):
        shape, s = list(p.shape), shard_of(p)
        if s is not None:
            shape[s.dim] = s.full
        params[k] = tuple(shape)
    buffers = {k: tuple(b.shape) for k, b in model.named_buffers()}
    return params, buffers


def import_torch_checkpoint(path_or_state, model_name: str, model=None):
    """A reference `.pt` checkpoint as the port's state_dict of
    `model_name` (`map_state_dict`), ready for `load_state_dict`.

    path_or_state: a checkpoint path (ignite's 'best_label_net_model_*.pt'
    / 'pretrainAD.pt') or an in-memory state_dict, bare or wrapped.
    model: optional built model; when given, the parameters and the
    running statistics are checked against it as the JAX importer checks
    its variables: a different count raises `ValueError` "maps N tensors
    but the model has M (dim/depth mismatch?)", a different shape "shape
    mismatch at ...".

    reference: kfold_train_adversarial.py:80-83 (pretrain load),
    :222-227 (checkpoint format)."""
    if isinstance(path_or_state, (str, bytes)) or hasattr(
            path_or_state, "__fspath__"):
        obj = torch.load(path_or_state, map_location="cpu",
                         weights_only=True)
    else:
        obj = path_or_state
    sd = map_state_dict(_unwrap(obj), model_name)
    if model is not None:
        params, buffers = _whole_shapes(model)
        _check_shapes({k: v for k, v in sd.items() if k not in buffers},
                      params, "params")
        _check_shapes({k: v for k, v in sd.items() if k in buffers},
                      buffers, "batch_stats")
    return sd
