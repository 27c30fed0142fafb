"""SwinUNETRClassifier (`build_model("swin_unetr")`) against the benchmark's
plain reference, MONAI's code as written (`portbench/reference/
swin_unetr.py`), and K14 (`transmf::window_attention`) against its plain
version. Imports no jax.

On the CPU the port's ops run their plain versions. A tiny Swin with the
published head width of 16 (feature size 16, heads (1, 2, 4, 8), window 3)
at batch 2 and 18x22x14 reaches every case of the equations: padding on
stages 1 and 2 (a 9x11x7 and a 5x6x4 grid), the shift mask over the padded
grid, odd axes at merging, and windows clamped to the grid with MONAI's
index cut at stages 3 and 4 (3x3x2, 2x2x1). Logits, each stage's output and
every leaf's gradient (the relative position tables and the qkv biases
among them) agree within 1e-4 of their largest magnitude, and four planted
faults miss by far more.

The `cuda` cases hold K14's forward and backward, both variants, to the
plain version run on the CPU:

    python -m pytest tests/test_torch_swin.py --noconftest -m cuda -q
"""

import itertools

import pytest
import torch

from portbench import harness
from portbench.reference import swin_unetr as reference
from portbench.reference.layers import Precision
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn import swin
from transmf_ad_tpu_torch.ops import window_attention as wa

TINY = dict(in_channels=2, feature_size=16, depths=[2, 2, 2, 2],
            num_heads=[1, 2, 4, 8], window_size=3, patch_size=2,
            mlp_ratio=4.0, qkv_bias=True)
VOLUME = (18, 22, 14)
TOL = 1e-4
STAGES = [f"swinViT.layers{i}.0" for i in range(1, 5)]


def _outputs(model, call):
    kept, hooks = {}, []
    for name in STAGES:
        def keep(mod, args, out, name=name):
            kept[name] = out.detach()
        hooks.append(model.get_submodule(name).register_forward_hook(keep))
    logits = call()
    logits.pow(2).sum().backward()
    for h in hooks:
        h.remove()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return logits.detach(), kept, grads


def _gaps(seed=0):
    """{what: max |port - reference| / max |reference|} for the logits,
    every stage's output and every leaf's gradient."""
    ref = reference.Model(**TINY)
    state = harness.seeded_state(ref, seed, "cpu")
    ref.load_state_dict(state)
    port = build_model("swin_unetr", **TINY)
    port.load_state_dict(state)
    g = torch.Generator().manual_seed(seed + 1)
    mri, pet = (torch.rand(2, *VOLUME, generator=g) for _ in range(2))
    r = _outputs(ref, lambda: ref(mri[:, None], pet[:, None], True, None,
                                  Precision()))
    p = _outputs(port, lambda: port(mri[..., None], pet[..., None], True))

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())

    gaps = {"logits": gap(p[0], r[0])}
    for name in STAGES:
        gaps[name] = gap(p[1][name], r[1][name].movedim(1, -1))
    assert set(p[2]) == set(r[2])
    for k in r[2]:
        gaps[k] = gap(p[2][k], r[2][k])
    return gaps


def test_state_dict_is_monais():
    """The names the reference (MONAI's) has, the relative position index
    buffer among them, with the same shapes and the same index."""
    ref, port = reference.Model(**TINY), build_model("swin_unetr", **TINY)
    rs, ps = ref.state_dict(), port.state_dict()
    assert {k: v.shape for k, v in rs.items()} == \
        {k: v.shape for k, v in ps.items()}
    name = "swinViT.layers2.0.blocks.1.attn.relative_position_index"
    assert torch.equal(rs[name], ps[name])
    assert "swinViT.layers4.0.downsample.reduction.weight" in ps
    assert "swinViT.layers1.0.blocks.0.mlp.linear1.weight" in ps


def test_port_matches_reference():
    gaps = _gaps()
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < TOL, (worst, gaps[worst])
    assert any("relative_position_bias_table" in k for k in gaps)
    assert any("attn.qkv.bias" in k for k in gaps)


def _scores_without_bias(qkv, qkv_bias, table, window, shift, full_window,
                         scale):
    return _PLAIN_SCORES(qkv, qkv_bias, torch.zeros_like(table), window,
                         shift, full_window, scale)


def _scores_masking_padded_keys(qkv, qkv_bias, table, window, shift,
                                full_window, scale):
    q, k, v, s = _PLAIN_SCORES(qkv, qkv_bias, table, window, shift,
                               full_window, scale)
    pad = wa._to_windows(torch.zeros(*qkv.shape[:4], 1), torch.ones(1),
                         window, shift)[..., 0]  # (bw, n): 1 where padded
    return q, k, v, s.masked_fill(pad[:, None, None, :] > 0, float("-inf"))


def _mask_over_the_grid(dims, window, shift, device=None):
    """compute_mask's regions cut from the grid's own end, not the padded
    grid's."""
    grid = _GRID[0]
    img_mask = torch.zeros((1, *dims, 1), device=device)
    sub = img_mask[:, :grid[0], :grid[1], :grid[2]]
    cnt = 0
    for sd, sh, sw in itertools.product(*(
            (slice(-w), slice(-w, -s), slice(-s, None))
            for w, s in zip(window, shift))):
        sub[:, sd, sh, sw, :] = cnt
        cnt += 1
    windows = wa.window_partition(img_mask, window).squeeze(-1)
    m = windows.unsqueeze(1) - windows.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def _scores_grid_mask(qkv, *args):
    _GRID[0] = qkv.shape[1:4]
    return _PLAIN_SCORES(qkv, *args)


def _merge_in_another_order(self, x):
    _, d, h, w, _ = x.shape
    if d % 2 or h % 2 or w % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2, :] for k, j, i in
                   itertools.product(range(2), repeat=3)], -1)
    return self.reduction(self.norm(x))


_PLAIN_SCORES = wa._scores
_GRID = [None]
FAULTS = {
    "bias left out": [(wa, "_scores", _scores_without_bias)],
    "padded keys masked": [(wa, "_scores", _scores_masking_padded_keys)],
    "mask over the unpadded grid": [(wa, "_scores", _scores_grid_mask),
                                    (wa, "compute_mask",
                                     _mask_over_the_grid)],
    "merge order": [(swin.PatchMergingV2, "forward",
                     _merge_in_another_order)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(fault, monkeypatch):
    """Each fault, planted in the port's plain path, misses the tolerance
    by at least 10x."""
    for owner, name, value in FAULTS[fault]:
        monkeypatch.setattr(owner, name, value)
    gaps = _gaps()
    assert max(gaps.values()) > 10 * TOL, fault


@pytest.mark.parametrize("grid,shift", [((5, 6, 2), (1, 1, 1)),
                                        ((4, 7, 8), (1, 1, 1))])
def test_block_with_a_clamped_axis(grid, shift):
    """One shifted block where an axis is clamped (no shift along it, the
    others shifted and masked) and one with padding on two axes: output and
    every gradient against the reference's block."""
    dim, heads, window = 32, 2, (3, 3, 3)
    ref = reference.SwinTransformerBlock(dim, heads, window, shift, 4.0,
                                         True)
    state = harness.seeded_state(ref, 7, "cpu")
    ref.load_state_dict(state)
    port = swin.SwinTransformerBlock(dim, heads, window, shift)
    port.load_state_dict(state)
    x = torch.randn(2, *grid, dim, generator=torch.Generator().manual_seed(3))
    ws, ss = reference.get_window_size(grid, window, shift)
    padded = [-(-g // w) * w for g, w in zip(grid, ws)]
    mask = reference.compute_mask(padded, ws, ss, None)
    xr, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    yr = ref(xr, mask, Precision())
    yp = port(xp)
    g = torch.randn(yr.shape, generator=torch.Generator().manual_seed(4))
    (yr * g).sum().backward()
    (yp * g).sum().backward()
    pairs = [(yp, yr), (xp.grad, xr.grad)] + [
        (p.grad, dict(ref.named_parameters())[k].grad)
        for k, p in port.named_parameters()]
    for a, b in pairs:
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max() / b.abs().max()) < TOL


def test_train_step_spans_and_counters():
    """The model through `create_state` and `make_train_step` (no
    adversary), with the tracer on: each stage's span holds the blocks'
    `window attention` and `mlp` spans and its `patch merging`, inside
    `forward`; the counters count each call's windows and computed query
    rows (padded rows included) and the ops' calls."""
    from transmf_ad_tpu_torch.train import create_state, make_train_step
    from transmf_ad_tpu_torch.utils import tracing

    model = build_model("swin_unetr", **TINY)
    state = create_state(model, device="cpu", seed=0, name="Adam", lr=1e-4,
                         steps_per_epoch=4)
    step = make_train_step(adversarial=False)
    g = torch.Generator().manual_seed(5)
    batch = {"MRI": torch.rand(2, *VOLUME, generator=g),
             "PET": torch.rand(2, *VOLUME, generator=g),
             "label": torch.tensor([0, 1])}
    tracing.enable()
    try:
        aux = step(state, batch)
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    assert torch.isfinite(aux["loss"])
    by_id = {sp.id: sp for sp in spans}
    names = [sp.name for sp in spans]
    for k in range(1, 5):
        assert names.count(f"swin stage {k}") == 1
    assert names.count("window attention") == names.count("mlp") == 8
    assert names.count("patch merging") == 4
    for sp in spans:
        if sp.name in ("window attention", "mlp", "patch merging"):
            assert by_id[sp.parent].name.startswith("swin stage ")
        if sp.name.startswith("swin stage "):
            assert by_id[sp.parent].name == "forward"
    grid, windows, rows = [v // 2 for v in VOLUME], 0, 0
    for heads in TINY["num_heads"]:
        window, _ = wa.window_size(grid, (3, 3, 3), (1, 1, 1))
        nw = 2 * wa.window_count(grid, window)
        windows += 2 * nw
        rows += 2 * nw * heads * wa.math.prod(window)
        grid = [-(-v // 2) for v in grid]
    assert counters["window_attention.windows"] == windows
    assert counters["window_attention.query_rows"] == rows
    assert counters["op.window_attention.calls"] == 8
    assert counters["op.window_attention_bwd.calls"] == 8


# -- K14 on the card ---------------------------------------------------------

# (B, X, Y, Z), full window, shift of the unclamped axes, heads
CARD_CASES = [
    ((2, 9, 11, 7), 3, 0, 1), ((2, 9, 11, 7), 3, 1, 1),
    ((2, 5, 6, 4), 3, 1, 2), ((2, 3, 3, 2), 3, 0, 4),
    ((1, 5, 6, 2), 3, 1, 2), ((2, 12, 9, 10), 7, 0, 3),
    ((2, 12, 9, 10), 7, 3, 3), ((1, 7, 7, 7), 7, 3, 2),
    ((2, 30, 30, 29), 3, 1, 1),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _close(out, ref, dtype, what, kind="value"):
    if kind == "sum":
        tol = dict(rtol=0.0, atol=(1e-4 if dtype == torch.float32 else 1e-2)
                   * float(ref.abs().max()) + 1e-6)
    elif dtype == torch.float32:
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        tol = dict(rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(out.float().cpu(), ref.float(), **tol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k14_matches_plain_on_cuda(cuda, dtype):
    """K14's forward (out, lse) and backward (dqkv, d qkv_bias, d table)
    against the plain version on the CPU, from the same inputs: values to
    1e-5 in float32 and one ulp in bfloat16, the float32 sums (the table's
    and the bias's gradients) to 1e-4 / 1e-2 of their largest magnitude;
    each call one launch, of the variant its dtype names."""
    for (b, x, y, z), w, s, heads in CARD_CASES:
        full = (w,) * 3
        window, shift = wa.window_size((x, y, z), full, (s,) * 3)
        c = heads * wa.HEAD_DIM
        qkv = torch.randn(b, x, y, z, 3 * c, generator=cuda).to(dtype)
        bias = (0.5 * torch.randn(3 * c, generator=cuda)).to(dtype)
        table = 0.5 * torch.randn(wa.table_size(full), heads, generator=cuda)
        geo = ([*window], [*shift], [*full], 0.25)
        what = f"{dtype} {(b, x, y, z)} window {window} shift {shift}"
        out_p, lse_p = wa.window_attention_reference(qkv, bias, table, *geo)
        g = torch.randn(out_p.shape, generator=cuda).to(dtype)
        grads_p = wa.window_attention_bwd_reference(qkv, bias, table, out_p,
                                                    lse_p, g, *geo)
        dev = [t.cuda() for t in (qkv, bias, table, out_p, lse_p, g)]
        launches = (wa.WINDOW_FWD.by_variant.get(wa.variant(dtype), 0),
                    wa.WINDOW_BWD.by_variant.get(wa.variant(dtype), 0))
        out_k, lse_k = wa.window_attention_op(*dev[:3], *geo)
        grads_k = wa.window_attention_bwd_op(*dev, *geo)
        torch.cuda.synchronize()
        assert (wa.WINDOW_FWD.by_variant[wa.variant(dtype)],
                wa.WINDOW_BWD.by_variant[wa.variant(dtype)]) == \
            (launches[0] + 1, launches[1] + 1), what
        _close(out_k, out_p, dtype, f"out {what}")
        _close(lse_k, lse_p, torch.float32, f"lse {what}")
        for name, k, p, kind in zip(("dqkv", "dbias", "dtable"), grads_k,
                                    grads_p, ("value", "sum", "sum")):
            _close(k, p, dtype, f"{name} {what}", kind)


@pytest.mark.cuda
def test_swin_step_on_cuda(cuda):
    """The tiny model's forward and gradients on the card in float32
    against the CPU: K14 runs both ways, through autograd."""
    port = build_model("swin_unetr", **TINY)
    port.load_state_dict(harness.seeded_state(reference.Model(**TINY), 0,
                                              "cpu"))
    mri, pet = (torch.rand(2, *VOLUME, 1, generator=cuda) for _ in range(2))
    cpu = _outputs(port, lambda: port(mri, pet, True))
    port.zero_grad(set_to_none=True)
    port.cuda()
    before = wa.WINDOW_BWD.launches
    card = _outputs(port, lambda: port(mri.cuda(), pet.cuda(), True))
    assert wa.WINDOW_BWD.launches == before + 8
    _close(card[0], cpu[0], torch.float32, "logits", "sum")
    for k in cpu[2]:
        _close(card[2][k], cpu[2][k], torch.float32, k, "sum")
