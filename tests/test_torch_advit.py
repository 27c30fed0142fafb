"""The port's ADVIT against the JAX package's, float32 CPU, with the same
weights (`state_dict_from_jax`, randomised BatchNorm statistics), at the
reference's widths (ViT dim 192, depth 6, heads 3 x 64) on a (2, 32, 32, 79)
input: the depth collapses to 1, the plane gives 2 x 2 patches + CLS = 5
tokens. The JAX ViT's attention runs its Pallas kernel in interpret mode.

Held: the eval logits within 1e-4; the train-mode logits (BatchNorm batch
statistics, dropout off on both sides), every parameter gradient of
sum(logits * w) for a seeded w and every updated running statistic, each
within 1e-4 of max(1, its largest magnitude) plus 3 times the spread of
DRAWS JAX runs on inputs perturbed by 1e-6 (`_torch_parity.train_grads`).
The spread is needed: XLA's float32 BatchNorm reductions over the 112,640
voxels a channel of the first to-2d conv sees move that conv's weight
gradient by ~1e-4 of its scale between inputs 1e-6 apart, while the port's
float32 gradient stays within 1e-6 of a float64 run of the port. The fused `to_qkv` weight's row order
is pinned by swapping its q and k rows, which must move the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (close, hold_train_grads, train_grads,
                                 zoo_model)
from transmf_ad_tpu_torch.models import ADVIT, build_model
from transmf_ad_tpu_torch.models.advit import collapsed_depth

SHAPE = (32, 32, 79)
DRAWS = 3


@pytest.fixture(scope="module")
def advit():
    port = ADVIT(input_shape=SHAPE, vit_dropout=0.0, emb_dropout=0.0)
    return zoo_model("advit", SHAPE, port)


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, *SHAPE, 1)).astype(np.float32)
            for _ in range(2)]


def test_build_model_is_192_wide_whatever_dim():
    """build_model passes ADVIT no dim: the ViT stays 192 wide, and the
    padded volume fixes the token count (gh * gw + 1)."""
    m = build_model("advit", dim=128, depth=3, heads=8, dropout=0.3,
                    input_shape=(128, 128, 79))
    assert m.fc.in_features == 384
    assert m.vit_mri.pos_embedding.shape == (1, 65, 192)
    assert m.vit_mri.transformer.layers[0][0].to_qkv.weight.shape == \
        (3 * 192, 192)
    assert len(m.vit_pet.transformer.layers) == 6
    assert [collapsed_depth(z) for z in (79, 80, 85)] == [1, 2, 3]


def test_eval(advit):
    jmodel, v, port = advit
    mri, pet = _inputs(1)
    ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b))(
        v, jnp.asarray(mri), jnp.asarray(pet))
    with torch.inference_mode():
        got = port(torch.from_numpy(mri), torch.from_numpy(pet))
    assert got.shape == (2, 2)
    close(got, ref)


def test_train_forward_and_gradients(advit):
    jmodel, v, port = advit
    ref, got, spread = train_grads(jmodel, v, port, _inputs(2), "advit",
                                   draws=DRAWS)
    hold_train_grads(ref, got, spread)
    assert float(got["vit_mri.cls_token"].abs().max()) > 0


def test_qkv_row_order_matters(advit):
    """The fused weight's first `inner` rows are q, then k, then v: with q
    and k swapped in every layer the eval logits move."""
    _, _, port = advit
    mri, pet = (torch.from_numpy(x) for x in _inputs(3))
    with torch.inference_mode():
        want = port(mri, pet)
        sd = {k: t.clone() for k, t in port.state_dict().items()}
        for k, t in sd.items():
            if k.endswith("to_qkv.weight"):
                q, kk, vv = t.chunk(3)
                sd[k] = torch.cat([kk, q, vv])
        swapped = ADVIT(input_shape=SHAPE)
        swapped.load_state_dict(sd, strict=True)
        got = swapped(mri, pet)
    assert float((got - want).abs().max()) > 1e-3
