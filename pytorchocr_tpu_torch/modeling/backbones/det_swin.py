"""Swin Transformer detection backbone — port of
pytorchocr_tpu/modeling/backbones/det_swin.py (the standard Swin).

NCHW in and out, NHWC inside: the patch embed (the input padded to a
multiple of the patch size, a patch x patch conv, LayerNorm), stages of
SwinBlocks (windowed attention with the relative position bias; every
second block shifts its windows by half a window, with the -100 mask where
the shifted windows join pixels of different regions), PatchMerging
between stages, and a LayerNorm on each output tap. LayerNorm eps 1e-5,
GELU in flax's default tanh form. Names follow flax
(`patch_embed`, `patch_norm`, `stage%d_block%d/{norm1, attn/{qkv,
relative_position_bias_table, proj}, norm2, fc1, fc2}`, `merge%d/{norm,
reduction}`, `out_norm%d`).

A block's window is `ws = min(window_size, h, w)` of its input, and the
shift is dropped where `ws != window_size` or `min(h, w) <= window_size`
(JAX det_swin.py:117-121). The flax attention's bias table has
(2 ws - 1)^2 rows, so its shape follows the input size flax was
initialised at: a table loaded from a state_dict takes that state_dict's
size (WindowAttention._load_from_state_dict), and a forward whose window
differs from its table's raises, as flax's apply fails on the shape. The
relative index and each (hp, wp, ws, shift) mask are made once on the
device and kept outside the state_dict.

The attention follows the JAX order under autocast: q k^T in the compute
dtype, the bias and the mask cast to it and added, the softmax in float32
and cast back to the compute dtype, then the product with v (torch.matmul,
as JAX's einsums: no fused attention, whose softmax rounds otherwise).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import drop_path

__all__ = ["SwinTransformer"]


def _window_partition(x, ws):
    """(N, H, W, C) -> (N * H/ws * W/ws, ws * ws, C)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(windows, ws, h, w):
    n = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, -1)


def _relative_position_index(ws):
    """(ws*ws, ws*ws) rows of the bias table, JAX det_swin.py:37."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(hp, wp, ws, shift):
    """(windows, ws*ws, ws*ws) float32: -100 between pixels of different
    regions of the shifted image, else 0. JAX det_swin.py:48."""
    img_mask = np.zeros((1, hp, wp, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = img_mask.reshape(1, hp // ws, ws, wp // ws, ws, 1)
    mask_windows = mask_windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size, qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self._index = {}  # (ws, device) -> the table's row of each (n, m) pair

    @property
    def table_window(self):
        return (int(round(self.relative_position_bias_table.shape[0] ** 0.5)) + 1) // 2

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        table = state_dict.get(prefix + "relative_position_bias_table")
        if table is not None and table.shape != self.relative_position_bias_table.shape:
            side = int(round(table.shape[0] ** 0.5))
            if side * side != table.shape[0] or side % 2 == 0 \
                    or table.shape[1:] != self.relative_position_bias_table.shape[1:]:
                raise ValueError("relative_position_bias_table %s is no (2 ws - 1)^2 x %d table"
                                 % (tuple(table.shape), self.num_heads))
            # the flax table's rows follow the window its init saw
            self.relative_position_bias_table.data = torch.empty_like(
                table, device=self.relative_position_bias_table.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        ws = int(round(n ** 0.5))
        if ws != self.table_window:
            raise ValueError(
                "a %dx%d window against a bias table for %dx%d windows: flax's table has "
                "(2 ws - 1)^2 rows for the window its init saw" % (ws, ws, self.table_window,
                                                                   self.table_window))
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (head_dim ** -0.5)
        attn = torch.matmul(q, k.transpose(-2, -1))
        key = (ws, x.device)
        if key not in self._index:
            self._index[key] = torch.from_numpy(
                _relative_position_index(ws).reshape(-1)).to(x.device)
        bias = self.relative_position_bias_table[self._index[key]].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, self.num_heads, n, n)
            attn = attn + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(b_, self.num_heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=7, shift_size=0, mlp_ratio=4.0,
                 qkv_bias=True, drop_rate=0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.drop_rate = drop_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._masks = {}  # (hp, wp, ws, shift, device) -> the shift mask

    def forward(self, x, generator=None):
        n, h, w, c = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift_size if ws == self.window_size else 0
        if min(h, w) <= self.window_size:
            shift = 0

        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            key = (hp, wp, ws, shift, x.device)
            if key not in self._masks:
                self._masks[key] = torch.from_numpy(_shift_attn_mask(hp, wp, ws, shift)).to(
                    x.device)
            mask = self._masks[key]
        x = _window_reverse(self.attn(_window_partition(x, ws), mask), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w, :]

        x = shortcut + drop_path(x, self.drop_rate, self.training, generator)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + drop_path(y, self.drop_rate, self.training, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        n, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    def __init__(self, in_channels=3, patch_size=4, embed_dim=96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0, qkv_bias=True,
                 drop_path_rate=0.2, patch_norm=True, out_indices=(0, 1, 2, 3)):
        super().__init__()
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size, patch_size)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None
        rates = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.stages = []
        cur = 0
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2 ** i)
            names = []
            for j in range(depth):
                name = "stage%d_block%d" % (i, j)
                self.add_module(name, SwinBlock(
                    dim, num_heads[i], window_size, 0 if j % 2 == 0 else window_size // 2,
                    mlp_ratio, qkv_bias, rates[cur + j]))
                names.append(name)
            self.stages.append(names)
            cur += depth
            if i in self.out_indices:
                self.add_module("out_norm%d" % i, nn.LayerNorm(dim, eps=1e-5))
            if i < len(depths) - 1:
                self.add_module("merge%d" % i, PatchMerging(dim))
        self.out_channels = [int(embed_dim * 2 ** i) for i in range(len(depths))]

    def forward(self, x, generator=None):
        ps = self.patch_size
        h, w = x.shape[2:]
        pad_b, pad_r = (ps - h % ps) % ps, (ps - w % ps) % ps
        if pad_b or pad_r:
            x = F.pad(x, (0, pad_r, 0, pad_b))
        x = self.patch_embed(x).permute(0, 2, 3, 1)  # NHWC
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, generator)
            if i in self.out_indices:
                outs.append(getattr(self, "out_norm%d" % i)(x).permute(0, 3, 1, 2))
            if i < len(self.stages) - 1:
                x = getattr(self, "merge%d" % i)(x)
        return outs
