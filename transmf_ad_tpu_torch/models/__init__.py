"""Task models of the port and their registry.

`build_model(name, **overrides)` mirrors transmf_ad_tpu/models/__init__.py:
fusion models get dim, depth, heads and dropout, and default dim_head to
dim // heads and mlp_dim to dim * 4, as the reference's k-fold training
scripts do; 'cnn', 'cnn_ad' and 'single' get dim; ADVIT (a 192-wide ViT)
and Mnet get none of them. Then every keyword the class's constructor does
not take is dropped, so that callers can pass one config to every model.
ADVIT and Mnet take the padded volume's `input_shape`, which fixes their
token grid and head width (the JAX modules infer both from the first
input). All eight models of the JAX registry are ported; 'swin_unetr'
(`SwinUNETRClassifier`, Swin UNETR's encoder as an MRI + PET classifier)
has no JAX counterpart and gets none of the fusion keywords. `ADVERSARIAL`
lists the models that return (logits, d_mri, d_pet) triples, the others
return logits; `SINGLE_MODALITY` those that take the MRI alone.
"""

from __future__ import annotations

import inspect

from .advit import ADVIT, ViTEncoder  # noqa: F401
from .misepynet import MiSePyNet, Mnet, SliceCNN, SpatialCNN  # noqa: F401
from .swin_unetr import SwinUNETRClassifier  # noqa: F401
from .transmf import (  # noqa: F401
    ModelAd,
    ModelCNN,
    ModelCNNAd,
    ModelSingle,
    ModelTransformer,
    ModelTransformerRes,
)

ADVERSARIAL = {"cnn_ad", "ad"}
SINGLE_MODALITY = {"single"}

_REGISTRY = {"single": ModelSingle, "cnn": ModelCNN,
             "transformer": ModelTransformer,
             "transformer_res": ModelTransformerRes, "cnn_ad": ModelCNNAd,
             "ad": ModelAd, "advit": ADVIT, "mnet": Mnet,
             "swin_unetr": SwinUNETRClassifier}
_FUSION_MODELS = {"transformer", "transformer_res", "ad"}


def model_name(model) -> str:
    """The registry key of a model built by `build_model`."""
    for key, cls in _REGISTRY.items():
        if type(model) is cls:
            return key
    raise ValueError(f"{type(model).__name__} is not a registered model; "
                     f"registered: {sorted(_REGISTRY)}")


def build_model(name: str, dim: int = 128, depth: int = 3, heads: int = 4,
                dropout: float = 0.0, **kw):
    """Build a model by key with reference-default hyperparameters. The
    forward's `train` argument picks eval or training mode, as in the JAX
    package."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    cls = _REGISTRY[key]
    if key in _FUSION_MODELS:
        kw.setdefault("dim_head", dim // heads)
        kw.setdefault("mlp_dim", dim * 4)
        kw.update(dim=dim, depth=depth, heads=heads, dropout=dropout)
    elif key in ("cnn", "cnn_ad", "single"):
        kw.update(dim=dim)
    takes = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kw.items() if k in takes})
