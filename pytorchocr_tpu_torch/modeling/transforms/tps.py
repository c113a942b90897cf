"""TPS rectification for STAR-Net — port of
pytorchocr_tpu/modeling/transforms/tps.py:24-180.

The TPS system matrices (inv_delta_C, (F+3) x (F+3), and P_hat, h*w x
(F+3)) depend only on the fiducial count and the input's size: they are
built once per (F, h, w) in float64 numpy, as the JAX package builds them at
trace time, and cast to float32 as it casts them.

`grid_sample_bilinear` is the JAX sampler (tps.py:62-89), not
`F.grid_sample`: both agree for grid points inside [-1, 1], but outside it
the JAX rule takes the weight from x - floor(x) before clamping the index
and then blends the border column (row) with its neighbour, where
`F.grid_sample(padding_mode="border", align_corners=True)` returns the
border value itself. A learned warp does reach past the edge. The gradient
with respect to the grid flows through the weights wx and wy, as in JAX.

Under bf16 autocast the localization network runs in bf16 (the JAX model's
compute dtype), and the fiducials, the solve and the sampling run in
float32 with autocast off, as the JAX package casts them (:156,177-178); the
sampled image takes the input's dtype.
"""

import functools

import numpy as np
import torch
from torch import nn

from ..common import ConvBNAct, max_pool

__all__ = ["TPS", "grid_sample_bilinear"]


def _build_C(F):
    ctrl_pts_x = np.linspace(-1.0, 1.0, F // 2)
    top = np.stack([ctrl_pts_x, -np.ones(F // 2)], axis=1)
    bottom = np.stack([ctrl_pts_x, np.ones(F // 2)], axis=1)
    return np.concatenate([top, bottom], axis=0)  # (F, 2)


def _build_inv_delta_C(C):
    F = C.shape[0]
    hat_C = np.zeros((F, F))
    for i in range(F):
        for j in range(i, F):
            r = np.linalg.norm(C[i] - C[j])
            hat_C[i, j] = hat_C[j, i] = r
    np.fill_diagonal(hat_C, 1)
    hat_C = (hat_C ** 2) * np.log(hat_C)
    delta_C = np.concatenate(
        [
            np.concatenate([np.ones((F, 1)), C, hat_C], axis=1),
            np.concatenate([np.zeros((2, 3)), C.T], axis=1),
            np.concatenate([np.zeros((1, 3)), np.ones((1, F))], axis=1),
        ],
        axis=0,
    )
    return np.linalg.inv(delta_C)  # (F+3, F+3)


def _build_P_hat(C, h, w, eps=1e-6):
    gx = (np.arange(-w, w, 2) + 1.0) / w
    gy = (np.arange(-h, h, 2) + 1.0) / h
    P = np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)  # (n, 2)
    P_diff = P[:, None, :] - C[None, :, :]
    rbf_norm = np.linalg.norm(P_diff, axis=2)
    rbf = np.square(rbf_norm) * np.log(rbf_norm + eps)
    return np.concatenate([np.ones((P.shape[0], 1)), P, rbf], axis=1)  # (n, F+3)


@functools.lru_cache(maxsize=16)
def tps_matrices(F, h, w, device):
    """(inv_delta_C, P_hat) for F fiducials on an h x w input: float32
    tensors on `device`, built in float64. Built as normal tensors even when
    the first call comes under torch.inference_mode (serving), so that a
    later training step can save them for its backward."""
    C = _build_C(F)
    with torch.inference_mode(False):
        return (torch.from_numpy(_build_inv_delta_C(C).astype(np.float32)).to(device),
                torch.from_numpy(_build_P_hat(C, h, w).astype(np.float32)).to(device))


def grid_sample_bilinear(img, grid):
    """img (N, C, H, W); grid (N, Hg, Wg, 2), xy, [-1, 1] the image's corner
    pixel centres; border clamping by the JAX rule (module docstring).
    Returns (N, C, Hg, Wg)."""
    n, c, h, w = img.shape
    x = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    y = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    x0 = x0.long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y0 = y0.long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    flat = img.reshape(n, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, -1).expand(n, c, -1)
        return flat.gather(2, idx).reshape(n, c, *yy.shape[1:])

    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def _work_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


class LocalizationNetwork(nn.Module):
    """Four conv + BN + relu layers (2x2 max-pools between, a global mean
    after the last), fc1 + relu, fc2 to the F fiducials, RARE's init: fc2's
    weight zero and its bias the fiducial grid (tps.py:92-142)."""

    def __init__(self, in_channels, num_fiducial, model_name="small"):
        super().__init__()
        F = num_fiducial
        if model_name == "large":
            filters, fc_dim = [64, 128, 256, 512], 256
        else:
            filters, fc_dim = [16, 32, 64, 128], 64
        self.F = F
        self.n_convs = len(filters)
        for idx, nf in enumerate(filters):
            self.add_module("conv%d" % idx, ConvBNAct(in_channels, nf, 3, 1, act="relu"))
            in_channels = nf
        self.fc1 = nn.Linear(filters[-1], fc_dim)
        self.fc2 = nn.Linear(fc_dim, F * 2)
        self.init_like_jax_()

    @torch.no_grad()
    def init_like_jax_(self):
        """fc2: zero weight, the fiducial-grid bias (tps.py:117-140)."""
        F = self.F
        ctrl_pts_x = np.linspace(-1.0, 1.0, F // 2)
        bias = np.concatenate([
            np.stack([ctrl_pts_x, np.linspace(0.0, -1.0, F // 2)], axis=1),
            np.stack([ctrl_pts_x, np.linspace(1.0, 0.0, F // 2)], axis=1),
        ], axis=0).reshape(-1)
        self.fc2.weight.zero_()
        self.fc2.bias.copy_(torch.from_numpy(bias.astype(np.float32)))

    def forward(self, x):
        for idx in range(self.n_convs):
            x = getattr(self, "conv%d" % idx)(x)
            x = x.mean(dim=(2, 3)) if idx == self.n_convs - 1 else max_pool(x, 2, 2)
        x = self.fc2(self.fc1(x).relu())
        return x.reshape(-1, self.F, 2)


class TPS(nn.Module):
    def __init__(self, in_channels, num_fiducial=20, model_name="small"):
        super().__init__()
        self.in_channels = self.out_channels = in_channels
        self.F = num_fiducial
        self.loc_net = LocalizationNetwork(in_channels, num_fiducial, model_name)
        # the learned 3x2 tail of C' (tps.py:160-175), zero-initialised
        self.fc = nn.Linear(num_fiducial * 2, 6)
        self.init_like_jax_()

    @torch.no_grad()
    def init_like_jax_(self):
        """fc: zero weight and bias (tps.py:170-175)."""
        self.fc.weight.zero_()
        self.fc.bias.zero_()

    def grid(self, x):
        """The sampling grid (N, h, w, 2) for the input x: float32, or float64
        for a float64 input (a float64 reference step)."""
        n, _, h, w = x.shape
        work = _work_dtype(x)
        c_prime = self.loc_net(x).to(work)
        with torch.autocast(x.device.type, enabled=False):
            inv_delta_C, P_hat = (m.to(work) for m in tps_matrices(self.F, h, w, x.device))
            ex = self.fc(c_prime.reshape(n, self.F * 2)).reshape(n, 3, 2)
            T = torch.einsum("ij,njk->nik", inv_delta_C, torch.cat([c_prime, ex], dim=1))
            return torch.einsum("pj,njk->npk", P_hat, T).reshape(n, h, w, 2)

    def forward(self, x):
        grid = self.grid(x)
        with torch.autocast(x.device.type, enabled=False):
            return grid_sample_bilinear(x.to(grid.dtype), grid).to(x.dtype)
