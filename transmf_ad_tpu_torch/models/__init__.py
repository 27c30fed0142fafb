"""Task models of the port and their registry.

`build_model(name, **overrides)` mirrors transmf_ad_tpu/models/__init__.py:
fusion models default dim_head to dim // heads and mlp_dim to dim * 4, as
the reference k-fold drivers do. Only 'ad' is ported so far.
"""

from __future__ import annotations

from .transmf import ModelAd  # noqa: F401

_REGISTRY = {"ad": ModelAd}


def build_model(name: str, dim: int = 128, depth: int = 3, heads: int = 4,
                dropout: float = 0.0, **kw):
    """Build a model by key with reference-default hyperparameters, in eval
    mode (the only mode ported so far)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown or unported model {name!r}; ported: "
                         f"{sorted(_REGISTRY)}")
    kw.setdefault("dim_head", dim // heads)
    kw.setdefault("mlp_dim", dim * 4)
    return _REGISTRY[key](dim=dim, depth=depth, heads=heads, dropout=dropout,
                          **kw).eval()
