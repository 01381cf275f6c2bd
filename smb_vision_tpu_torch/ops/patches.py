"""Patch embedding as a reshape plus one matrix product.

Counterpart of `smb_vision_tpu/ops/patches.py`. With stride equal to the
kernel size a Conv3d (or SigLIP's Conv2d) is an exact
reshape/transpose/matmul; the weight keeps the Conv3d layout (out, in, kt,
kh, kw), or Conv2d's, so HF checkpoints drop in.
"""

from __future__ import annotations

import numpy as np
import torch


def extract_patches(pixel_values: torch.Tensor, tubelet_size: int,
                    patch_size: int, channel_major: bool) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, N, patch_dim), sequence order t, then h,
    then w. channel_major=True orders each patch vector (c, dt, dh, dw),
    the Conv3d contraction order; False orders it (dt, dh, dw, c), the
    pixel-label order."""
    b, t, c, h, w = pixel_values.shape
    ts, ps = tubelet_size, patch_size
    x = pixel_values.reshape(b, t // ts, ts, c, h // ps, ps, w // ps, ps)
    if channel_major:
        x = x.permute(0, 1, 4, 6, 3, 2, 5, 7)
    else:
        x = x.permute(0, 1, 4, 6, 2, 5, 7, 3)
    n = (t // ts) * (h // ps) * (w // ps)
    return x.reshape(b, n, ts * ps * ps * c)


def patch_embed(pixel_values: torch.Tensor, kernel: torch.Tensor,
                bias, *, dtype=torch.bfloat16) -> torch.Tensor:
    """Tubelet projection (B, T, C, H, W) x (hidden, C, ts, ps, ps) ->
    (B, N, hidden): operands in `dtype`, the bias added in f32."""
    hidden, c, ts, ps, _ = kernel.shape
    patches = extract_patches(pixel_values, ts, ps, channel_major=True)
    wmat = kernel.reshape(hidden, c * ts * ps * ps).t()
    out = torch.matmul(patches.to(dtype), wmat.to(dtype)).float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def patch_embed_2d(pixel_values: torch.Tensor, kernel: torch.Tensor,
                   bias, *, dtype=torch.bfloat16) -> torch.Tensor:
    """The SigLIP patch projection (B, C, H, W) x (hidden, C, ps, ps) ->
    (B, N, hidden), the weight in the HF Conv2d layout, the sequence
    row-major. A size that ps does not divide (so400m-patch14-384: 384 %
    14 == 6) drops the trailing rows and columns, as a stride-ps Conv2d
    with valid padding never reads them. `patch_embed` with a unit time
    axis."""
    hidden, c, ps, _ = kernel.shape
    b, c_in, h, w = pixel_values.shape
    if c_in != c:
        raise ValueError(f"input has {c_in} channels, kernel expects {c}")
    gh, gw = h // ps, w // ps
    if (gh * ps, gw * ps) != (h, w):
        pixel_values = pixel_values[:, :, :gh * ps, :gw * ps]
    return patch_embed(pixel_values[:, None], kernel[:, :, None], bias,
                       dtype=dtype)


def sincos_position_table(n_position: int, d_hid: int) -> torch.Tensor:
    """Fixed sinusoid table (1, n_position, d_hid) float32: angle(pos, j) =
    pos / 10000^(2*(j//2)/d), sin on even dims, cos on odd. Computed in
    float64 numpy, then rounded to f32 (f32 range reduction would lose
    ~2e-3 rad at 20k positions)."""
    j = np.arange(d_hid)
    inv = np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.arange(n_position)[:, None] / inv[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return torch.from_numpy(table[None].astype(np.float32))


def normalize_pixel_targets(patches: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """Per-patch normalisation for norm_pix_loss: subtract the patch mean
    and divide by the unbiased (n - 1) std + eps, statistics in f32 over
    the last axis (for one channel this is the reference's per-channel
    normalisation)."""
    patches = patches.float()
    mean = patches.mean(dim=-1, keepdim=True)
    n = patches.shape[-1]
    var = ((patches - mean) ** 2).sum(dim=-1, keepdim=True) / (n - 1)
    return (patches - mean) / (var.sqrt() + eps)
