"""Task models of the port and their registry.

`build_model(name, **overrides)` mirrors transmf_ad_tpu/models/__init__.py:
fusion models default dim_head to dim // heads and mlp_dim to dim * 4, as
the reference's k-fold training scripts do. Only 'ad', 'transformer' and
'transformer_res' are ported so far. `ADVERSARIAL` lists the ported models
that return (logits, d_mri, d_pet) triples; the others return logits.
"""

from __future__ import annotations

from .transmf import (  # noqa: F401
    ModelAd,
    ModelTransformer,
    ModelTransformerRes,
)

ADVERSARIAL = {"ad"}

_REGISTRY = {"ad": ModelAd, "transformer": ModelTransformer,
             "transformer_res": ModelTransformerRes}


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
        raise ValueError(f"unknown or unported model {name!r}; ported: "
                         f"{sorted(_REGISTRY)}")
    kw.setdefault("dim_head", dim // heads)
    kw.setdefault("mlp_dim", dim * 4)
    return _REGISTRY[key](dim=dim, depth=depth, heads=heads, dropout=dropout,
                          **kw)
