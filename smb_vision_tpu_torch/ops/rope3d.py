"""3D rotary position embeddings (V-JEPA2 style).

Counterpart of `smb_vision_tpu/ops/rope3d.py`: the head dim splits into
three equal even chunks (depth, height, width; chunk = 2*((head_dim//3)//2))
and an unrotated remainder (2 lanes at head_dim 128). Within a chunk the
sin/cos tables are *concatenated* ([sin, sin]) while the rotation pairs
*interleaved* lanes (2i, 2i+1): the reference's quirk, kept so that
converted checkpoints give the same outputs. The tables depend only on the
token positions, so a model computes them once per forward. Plain torch, as
the JAX package computes them in XLA outside any kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_axis_dims(head_dim: int) -> Tuple[int, int, int, int]:
    """(depth, height, width, remainder) split of the head dim."""
    c = int(2 * ((head_dim // 3) // 2))
    return c, c, c, head_dim - 3 * c


def position_ids_3d(ids: torch.Tensor, grid_hw: int):
    """Flat token ids -> (frame, height, width) coordinates."""
    per_frame = grid_hw * grid_hw
    frame = torch.div(ids, per_frame, rounding_mode="floor")
    rem = ids - frame * per_frame
    height = torch.div(rem, grid_hw, rounding_mode="floor")
    return frame, height, rem - height * grid_hw


def _axis_cos_sin(pos: torch.Tensor, dim: int, dtype):
    """cos/sin table of one axis: pos (..., N) -> (..., N, dim), the
    half-width table concatenated with itself."""
    half = dim // 2
    omega = torch.arange(half, dtype=torch.float32, device=pos.device) / half
    omega = 1.0 / (10000.0 ** omega)
    freq = pos[..., None].to(torch.float32) * omega
    sin, cos = torch.sin(freq), torch.cos(freq)
    return (torch.cat([cos, cos], dim=-1).to(dtype),
            torch.cat([sin, sin], dim=-1).to(dtype))


def rope3d_cos_sin(ids: torch.Tensor, grid_hw: int, head_dim: int,
                   dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-head cos/sin tables: ids (..., N) -> each (..., N, head_dim);
    the unrotated remainder has cos 1 and sin 0."""
    d_dim, h_dim, w_dim, rem = rope_axis_dims(head_dim)
    coss, sins = [], []
    for pos, dim in zip(position_ids_3d(ids, grid_hw), (d_dim, h_dim, w_dim)):
        c, s = _axis_cos_sin(pos, dim, dtype)
        coss.append(c)
        sins.append(s)
    if rem:
        shape = tuple(ids.shape) + (rem,)
        coss.append(torch.ones(shape, dtype=dtype, device=ids.device))
        sins.append(torch.zeros(shape, dtype=dtype, device=ids.device))
    return torch.cat(coss, dim=-1), torch.cat(sins, dim=-1)


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """y[2i] = -x[2i+1], y[2i+1] = x[2i] inside each axis chunk; zero on
    the remainder."""
    d_dim, h_dim, w_dim, rem = rope_axis_dims(x.shape[-1])
    rot = 3 * d_dim
    pairs = x[..., :rot].unflatten(-1, (rot // 2, 2))
    y = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    if rem:
        y = torch.cat([y, torch.zeros_like(x[..., rot:])], dim=-1)
    return y


def apply_rope3d(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, N, H, D); cos/sin (N, D) or (B, N, D), broadcast over heads."""
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (x * cos + _rotate_pairs(x) * sin).to(x.dtype)
