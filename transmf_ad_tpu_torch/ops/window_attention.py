"""Shifted-window attention with a relative position bias (Swin UNETR).

Kernel K14 (csrc/window_attention.cu) runs MONAI's `WindowAttention` as
`SwinTransformerBlock.forward_part1` calls it, straight from the
token-ordered qkv projection of a (B, X, Y, Z) token grid: the zero pad to
a multiple of the window, the cyclic roll by -shift, the partition into
windows, the reverse, the roll back and the crop are in the kernel's
addressing, so none of those copies is made. A token the pad adds reads the
projection of a zero vector, the qkv bias, and is a live key; its query row
is computed and dropped, as MONAI computes and crops it. Each score gets
`table[index[i, j], h]`, MONAI's relative position index (of the whole
`full_window`, cut to the window's n tokens, as MONAI cuts it for a window
clamped to a small grid), and, where any shift is non-zero, -100 between
tokens of different regions of the padded grid (`compute_mask`).

The ops: `transmf::window_attention(qkv, qkv_bias, table, window, shift,
full_window, scale) -> (out, lse)`, `out` (B, X, Y, Z, C) in token order and
`lse` the float32 logsumexp of every window row, (B * windows, heads, n);
differentiable in qkv, qkv_bias and table (lse is not), with
`transmf::window_attention_bwd` as its backward: dqkv in token order, the
padded keys' dk and dv summed into the qkv bias's gradient, and the table's
gradient, d table[index[i, j], h] = the sum over windows and samples of
dS[i, j], both float32. qkv's channels are (3, heads, 16): the head width is
16 at every stage of the configuration.

Two variants by dtype alone (`variant`): "mma" for bfloat16, on mma.sync
with K2's forward helpers (csrc/attention_mma.cuh) and K11 / K12's backward
ones (csrc/flash_bwd_mma.cuh); "rows" for float32, one CUDA thread a row.
On CPU tensors the ops run the plain versions below, which follow MONAI's
code (`F.pad`, `torch.roll`, `window_partition`, the table gather, the
-100 mask, `softmax`) in float32.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import (FLOAT, INT, PTR, Kernel, check_cuda, define_op,
                      library)
from ..utils import tracing

_SOURCE = "transmf_ad_tpu_torch/csrc/window_attention.cu"
_REPLACES = "none: the JAX package has no window attention"
# B, X, Y, Z, window (3), shift (3), full window (3), heads
_GEOMETRY = (INT,) * 14
WINDOW_FWD = Kernel(
    name="window_attention_fwd", entry="transmf_window_attention_fwd",
    argtypes=(PTR,) * 5 + _GEOMETRY + (FLOAT, INT, INT), source=_SOURCE,
    replaces=_REPLACES)
WINDOW_BWD = Kernel(
    name="window_attention_bwd", entry="transmf_window_attention_bwd",
    argtypes=(PTR,) * 10 + _GEOMETRY + (FLOAT, INT, INT), source=_SOURCE,
    replaces=_REPLACES)
VARIANTS = ("rows", "mma")  # by their code in C
HEAD_DIM = 16
MAX_TOKENS = 512  # tokens a window (n_pad, a multiple of 64, at most this)


def variant(dtype: torch.dtype) -> str:
    """The K14 variant a CUDA launch takes: "mma" (tensor cores) for
    bfloat16, "rows" (CUDA cores) for float32."""
    return "mma" if dtype == torch.bfloat16 else "rows"


# -- MONAI's helpers, 3D ---------------------------------------------------

def window_size(grid, window, shift):
    """(window, shift) for a grid, as MONAI's `get_window_size`: an axis
    whose grid is at most the window takes the grid's size and no shift."""
    ws, ss = list(window), list(shift)
    for i, g in enumerate(grid):
        if g <= window[i]:
            ws[i], ss[i] = g, 0
    return tuple(ws), tuple(ss)


@functools.cache
def _index(full_window) -> torch.Tensor:
    w0, w1, w2 = full_window
    coords = torch.stack(torch.meshgrid(torch.arange(w0), torch.arange(w1),
                                        torch.arange(w2), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w0 - 1
    rel[:, :, 1] += w1 - 1
    rel[:, :, 2] += w2 - 1
    rel[:, :, 0] *= (2 * w1 - 1) * (2 * w2 - 1)
    rel[:, :, 1] *= 2 * w2 - 1
    return rel.sum(-1)


def relative_position_index(full_window) -> torch.Tensor:
    """MONAI's `relative_position_index` of a full window, (n, n) int64."""
    return _index(tuple(full_window)).clone()


def table_size(full_window) -> int:
    return math.prod(2 * w - 1 for w in full_window)


def padded_grid(grid, window):
    return tuple(-(-g // w) * w for g, w in zip(grid, window))


def window_count(grid, window) -> int:
    """Windows a sample."""
    return math.prod(p // w for p, w in zip(padded_grid(grid, window),
                                            window))


def window_partition(x, window):
    """(b, d, h, w, c) -> (b * windows, n, c), MONAI's order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // window[0], window[0], h // window[1], window[1],
               w // window[2], window[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(
        -1, window[0] * window[1] * window[2], c)


def window_reverse(windows, window, dims):
    """(b * windows, n, c) -> (b, d, h, w, c), MONAI's order."""
    b, d, h, w = dims
    x = windows.view(b, d // window[0], h // window[1], w // window[2],
                     window[0], window[1], window[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w,
                                                               -1)


def compute_mask(dims, window, shift, device=None):
    """MONAI's `compute_mask` over the padded grid `dims`: (windows, n, n),
    -100 between tokens of different regions, else 0."""
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for sd in (slice(-window[0]), slice(-window[0], -shift[0]),
               slice(-shift[0], None)):
        for sh in (slice(-window[1]), slice(-window[1], -shift[1]),
                   slice(-shift[1], None)):
            for sw in (slice(-window[2]), slice(-window[2], -shift[2]),
                       slice(-shift[2], None)):
                img_mask[:, sd, sh, sw, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(
        attn_mask == 0, 0.0)


# -- the plain versions ----------------------------------------------------

def _to_windows(t, fill, window, shift):
    """A token-ordered (B, X, Y, Z, c) tensor in float32, padded at the
    high end of each axis to a multiple of the window with `fill` (c,) or
    zeros, rolled by -shift and partitioned: (B * windows, n, c)."""
    b, x, y, z, c = t.shape
    dp, hp, wp = padded_grid((x, y, z), window)
    if fill is None:
        full = torch.nn.functional.pad(
            t.float(), (0, 0, 0, wp - z, 0, hp - y, 0, dp - x))
    else:
        full = fill.float().expand(b, dp, hp, wp, c).clone()
        full[:, :x, :y, :z] = t.float()
    if any(shift):
        full = torch.roll(full, shifts=tuple(-s for s in shift),
                          dims=(1, 2, 3))
    return window_partition(full, window)


def _from_windows(windows, grid_shape, window, shift):
    """The inverse of `_to_windows` before the crop: (B, Dp, Hp, Wp, c)."""
    b, x, y, z = grid_shape
    full = window_reverse(windows, window, (b, *padded_grid((x, y, z),
                                                            window)))
    if any(shift):
        full = torch.roll(full, shifts=tuple(shift), dims=(1, 2, 3))
    return full


def _scores(qkv, qkv_bias, table, window, shift, full_window, scale):
    """(q, k, v, s): the windows' float32 (bw, heads, n, d) q, k, v and
    their scores with bias and mask, as MONAI's WindowAttention forms
    them."""
    heads = table.shape[1]
    win = _to_windows(qkv, qkv_bias, window, shift)
    bw, n, c3 = win.shape
    qkv_w = win.reshape(bw, n, 3, heads, c3 // 3 // heads).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv_w[0], qkv_w[1], qkv_w[2]
    attn = (q * scale) @ k.transpose(-2, -1)
    index = relative_position_index(full_window)[:n, :n].to(qkv.device)
    bias = table.float()[index.reshape(-1)].reshape(n, n, -1).permute(
        2, 0, 1).contiguous()
    attn = attn + bias.unsqueeze(0)
    if any(shift):
        mask = compute_mask(padded_grid(qkv.shape[1:4], window), window,
                            shift, qkv.device)
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + \
            mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    return q, k, v, attn


def window_attention_reference(qkv, qkv_bias, table, window, shift,
                               full_window, scale: float):
    """(out, lse) in float32, out rounded once to qkv's dtype. qkv (B, X,
    Y, Z, 3C) token-ordered, qkv_bias (3C,), table (T, heads); `window`
    and `shift` as `window_size` gives them for the grid."""
    b, x, y, z, c3 = qkv.shape
    q, k, v, attn = _scores(qkv, qkv_bias, table, window, shift,
                            full_window, scale)
    bw, heads, n, _ = q.shape
    lse = torch.logsumexp(attn, dim=-1)
    attn = torch.softmax(attn, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(bw, n, c3 // 3)
    full = _from_windows(o, (b, x, y, z), window, shift)
    return full[:, :x, :y, :z].contiguous().to(qkv.dtype), lse


def window_attention_bwd_reference(qkv, qkv_bias, table, out, lse, g,
                                   window, shift, full_window,
                                   scale: float):
    """(dqkv, d qkv_bias, d table) for the output gradient g, from the
    saved output and logsumexp: p = exp(s - lse), ds = p * (g v^T -
    rowsum(g * o)) over the windows (the padded rows' g is zero, as the
    crop leaves it); dqkv rounded once to qkv's dtype, the other two
    float32."""
    b, x, y, z, c3 = qkv.shape
    q, k, v, s = _scores(qkv, qkv_bias, table, window, shift, full_window,
                         scale)
    bw, heads, n, d = q.shape

    def heads_first(t):
        w = _to_windows(t, None, window, shift)
        return w.reshape(bw, n, heads, d).transpose(1, 2)

    gw, ow = heads_first(g), heads_first(out)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = gw @ v.transpose(-2, -1)
    ds = p * (dp - (gw * ow).sum(-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-2, -1) @ q) * scale
    dv = p.transpose(-2, -1) @ gw
    dtable = torch.zeros(table.shape, dtype=torch.float32,
                         device=qkv.device).index_add_(
        0, relative_position_index(full_window)[:n, :n].reshape(-1).to(
            qkv.device),
        ds.sum(0).permute(1, 2, 0).reshape(n * n, heads))
    dwin = torch.stack([dq, dk, dv], dim=2)  # (bw, heads, 3, n, d)
    dwin = dwin.permute(0, 3, 2, 1, 4).reshape(bw, n, c3)
    full = _from_windows(dwin, (b, x, y, z), window, shift)
    inside = torch.zeros(full.shape[1:4], dtype=torch.bool,
                         device=qkv.device)
    inside[:x, :y, :z] = True
    dbias = full[:, ~inside].sum((0, 1))
    return full[:, :x, :y, :z].contiguous().to(qkv.dtype), dbias, dtable


# -- the kernel's launch path ----------------------------------------------

def _geometry(name, qkv, qkv_bias, table, window, shift, full_window):
    """The 14 integers of the C entries, after checking the shapes."""
    b, x, y, z, c3 = qkv.shape
    heads = table.shape[1]
    n = math.prod(window)
    if c3 != 3 * heads * HEAD_DIM or qkv_bias.shape != (c3,) \
            or table.shape[0] != table_size(full_window) \
            or table.dtype != torch.float32 or not table.is_contiguous() \
            or tuple(window_size((x, y, z), full_window, shift)[0]) \
            != tuple(window) \
            or -(-n // 64) * 64 > MAX_TOKENS:
        raise ValueError(
            f"{name}: qkv {tuple(qkv.shape)}, qkv_bias "
            f"{tuple(qkv_bias.shape)}, table {tuple(table.shape)} "
            f"{table.dtype}, window {tuple(window)}, full window "
            f"{tuple(full_window)}: expected (B, X, Y, Z, 3 * heads * "
            f"{HEAD_DIM}), (3C,), a float32 (T, heads) table and the "
            f"window MONAI's get_window_size gives, of at most "
            f"{MAX_TOKENS} tokens")
    return (b, x, y, z, *window, *shift, *full_window, heads)


def _count(qkv, window, heads):
    """The tracer's counters of one call: `window_attention.windows`, the
    batch's windows, and `window_attention.query_rows`, the query rows
    computed over every window and head (padded rows included)."""
    if tracing.ON:
        windows = qkv.shape[0] * window_count(qkv.shape[1:4], window)
        tracing.count("window_attention.windows", windows)
        tracing.count("window_attention.query_rows",
                      windows * heads * math.prod(window))


def _fwd_launch(qkv, qkv_bias, table, window, shift, full_window,
                scale: float):
    """K14's forward on CUDA tensors."""
    dtype = check_cuda("window_attention", qkv, qkv_bias)
    geo = _geometry("window_attention", qkv, qkv_bias, table, window, shift,
                    full_window)
    b, x, y, z, c3 = qkv.shape
    heads = table.shape[1]
    out = qkv.new_empty((b, x, y, z, c3 // 3))
    lse = torch.empty((b * window_count((x, y, z), window), heads,
                       math.prod(window)), dtype=torch.float32,
                      device=qkv.device)
    which = variant(qkv.dtype)
    WINDOW_FWD.launch(qkv.device, qkv.data_ptr(), qkv_bias.data_ptr(),
                      table.data_ptr(), out.data_ptr(), lse.data_ptr(), *geo,
                      float(scale), dtype, VARIANTS.index(which),
                      variant=which)
    return out, lse


def work_floats(geometry, which: str) -> int:
    """The float32 work space K14's backward takes for a geometry (the C
    entries' 14 integers) and variant. The kernel library owns the split of
    the windows into groups (`bwd_groups`, `table_groups` in
    csrc/window_attention.cu), so it owns the size too."""
    fn = library().transmf_window_attention_bwd_work
    fn.argtypes, fn.restype = [INT] * 15, ctypes.c_longlong
    return fn(*geometry, VARIANTS.index(which))


def _bwd_launch(qkv, qkv_bias, table, out, lse, g, window, shift,
                full_window, scale: float):
    """K14's backward on CUDA tensors."""
    dtype = check_cuda("window_attention_bwd", qkv, qkv_bias, out, g)
    geo = _geometry("window_attention_bwd", qkv, qkv_bias, table, window,
                    shift, full_window)
    heads = table.shape[1]
    which = variant(qkv.dtype)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    work = torch.empty(work_floats(geo, which), **f32)
    dtable = torch.empty(table.shape, **f32)
    kv_bias = torch.empty((heads, 2 * HEAD_DIM), **f32)
    WINDOW_BWD.launch(qkv.device, qkv.data_ptr(), qkv_bias.data_ptr(),
                      table.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      g.data_ptr(), dqkv.data_ptr(), work.data_ptr(),
                      dtable.data_ptr(), kv_bias.data_ptr(), *geo,
                      float(scale), dtype, VARIANTS.index(which),
                      variant=which)
    c = heads * HEAD_DIM
    dbias = torch.cat([torch.zeros(c, **f32),
                       kv_bias[:, :HEAD_DIM].reshape(c),
                       kv_bias[:, HEAD_DIM:].reshape(c)])
    return dqkv, dbias, dtable


def _fwd_fake(qkv, qkv_bias, table, window, shift, full_window, scale):
    b, x, y, z, c3 = qkv.shape
    windows = b * window_count((x, y, z), window)
    return (qkv.new_empty((b, x, y, z, c3 // 3)),
            qkv.new_empty((windows, table.shape[1], math.prod(window)),
                          dtype=torch.float32))


def _bwd_fake(qkv, qkv_bias, table, out, lse, g, window, shift, full_window,
              scale):
    return (torch.empty_like(qkv),
            qkv.new_empty(qkv_bias.shape, dtype=torch.float32),
            qkv.new_empty(table.shape, dtype=torch.float32))


_GEO = "int[] window, int[] shift, int[] full_window, float scale"
window_attention_bwd_op = define_op(
    "window_attention_bwd(Tensor qkv, Tensor qkv_bias, Tensor table, "
    f"Tensor out, Tensor lse, Tensor g, {_GEO}) -> (Tensor, Tensor, Tensor)",
    window_attention_bwd_reference, _bwd_launch, _bwd_fake)


def _setup(ctx, inputs, output):
    qkv, qkv_bias, table, *ctx.geometry = inputs
    ctx.save_for_backward(qkv, qkv_bias, table, *output)
    ctx.mark_non_differentiable(output[1])


def _backward(ctx, g, _g_lse):
    qkv, qkv_bias, table, out, lse = ctx.saved_tensors
    dqkv, dbias, dtable = window_attention_bwd_op(
        qkv, qkv_bias, table, out, lse, g.contiguous(), *ctx.geometry)
    return (dqkv, dbias.to(qkv_bias.dtype), dtable.to(table.dtype), None,
            None, None, None)


window_attention_op = define_op(
    "window_attention(Tensor qkv, Tensor qkv_bias, Tensor table, "
    f"{_GEO}) -> (Tensor, Tensor)",
    window_attention_reference, _fwd_launch, _fwd_fake, _backward, _setup)


def window_attention(qkv, qkv_bias, table, window, shift, full_window,
                     scale: float) -> torch.Tensor:
    """MONAI's WindowAttention between its qkv and proj layers, over a
    token grid: qkv (B, X, Y, Z, 3C) -> (B, X, Y, Z, C). Kernel K14 on CUDA
    tensors (the variant `variant` names), the plain version on CPU
    tensors; differentiable in qkv, qkv_bias and table."""
    _count(qkv, window, table.shape[1])
    table = table.float().contiguous()
    return window_attention_op(qkv.contiguous(), qkv_bias.contiguous(),
                               table, list(window), list(shift),
                               list(full_window), float(scale))[0]
