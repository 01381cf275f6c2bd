"""MIM block masks and V-JEPA multi-block target masks.

Counterpart of `smb_vision_tpu/ops/masking.py`: `mim_mask_counts`,
`mim_mask` and `num_masked_tokens` (a random mask on a coarse grid of
mask_patch_size cells with exactly ceil(cells * ratio) masked cells per
sample, upsampled to the model-patch grid), and `vjepa_target_mask` with
`mask_to_indices`. The random numbers come from a `torch.Generator`, so
they differ from `jax.random`'s; tests that compare the two models hand
both the same mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def mim_mask_counts(input_size: int, depth: int, mask_patch_size: int,
                    model_patch_size: int, mask_ratio: float
                    ) -> Tuple[int, int, int]:
    """(token_count, mask_count, scale) on the coarse mask grid."""
    if input_size % mask_patch_size or depth % mask_patch_size:
        raise ValueError(
            f"input_size ({input_size}) and depth ({depth}) must be "
            f"divisible by mask_patch_size ({mask_patch_size})")
    if mask_patch_size % model_patch_size:
        raise ValueError(
            f"mask_patch_size ({mask_patch_size}) must be divisible by "
            f"model_patch_size ({model_patch_size})")
    if not 0.0 < mask_ratio <= 1.0:
        raise ValueError(f"mask_ratio must be in (0, 1], got {mask_ratio}")
    rs = input_size // mask_patch_size
    rd = depth // mask_patch_size
    scale = mask_patch_size // model_patch_size
    token_count = rd * rs * rs
    mask_count = int(math.ceil(token_count * mask_ratio))
    return token_count, mask_count, scale


def mim_mask(generator: torch.Generator, batch: int, *, input_size: int,
             depth: int, mask_patch_size: int, model_patch_size: int,
             mask_ratio: float) -> torch.Tensor:
    """Per-sample random block mask, (batch, N) bool on the generator's
    device, N = (depth/mp)*(input_size/mp)^2 on the model-patch grid; True
    = masked. Exactly ceil(coarse_count*ratio)*scale^3 tokens are masked
    per sample."""
    rs = input_size // mask_patch_size
    rd = depth // mask_patch_size
    token_count, mask_count, scale = mim_mask_counts(
        input_size, depth, mask_patch_size, model_patch_size, mask_ratio)
    u = torch.rand((batch, token_count), generator=generator,
                   device=generator.device)
    masked_idx = torch.argsort(u, dim=-1)[:, :mask_count]
    coarse = torch.zeros((batch, token_count), dtype=torch.bool,
                         device=u.device)
    coarse.scatter_(1, masked_idx, True)
    coarse = coarse.reshape(batch, rd, rs, rs)
    if scale > 1:
        for axis in (1, 2, 3):
            coarse = coarse.repeat_interleave(scale, dim=axis)
    return coarse.reshape(batch, -1)


def num_masked_tokens(input_size: int, depth: int, mask_patch_size: int,
                      model_patch_size: int, mask_ratio: float) -> int:
    """Masked model-patch tokens per sample (fixed by the geometry)."""
    _, mask_count, scale = mim_mask_counts(
        input_size, depth, mask_patch_size, model_patch_size, mask_ratio)
    return mask_count * scale ** 3


def _block_dims(generator: torch.Generator, batch: int,
                grid: Tuple[int, int, int],
                pred_mask_scale: Tuple[float, float],
                aspect_ratio: Tuple[float, float]) -> torch.Tensor:
    """(batch, 3) block (d, h, w) in patch units, one per sample, by the
    rule of the JAX `_sample_block_dims`: scale ~ U(pred_mask_scale), ar ~
    U(aspect_ratio), d = round(cbrt(floor(n*scale))), h = round(d*ar),
    w = round(d/ar), each clamped to [1, its grid size]."""
    gd, gh, gw = grid
    u = torch.rand((batch, 2), generator=generator,
                   device=generator.device, dtype=torch.float64)
    scale = pred_mask_scale[0] + u[:, 0] * (pred_mask_scale[1]
                                            - pred_mask_scale[0])
    ar = aspect_ratio[0] + u[:, 1] * (aspect_ratio[1] - aspect_ratio[0])
    d = torch.round(torch.floor(gd * gh * gw * scale) ** (1.0 / 3.0))
    h = torch.round(d * ar)
    w = torch.round(d / ar)
    lo = torch.ones(3, dtype=torch.float64, device=u.device)
    hi = torch.tensor([gd, gh, gw], dtype=torch.float64, device=u.device)
    dims = torch.stack([d, h, w], dim=-1)
    return torch.minimum(torch.maximum(dims, lo), hi).to(torch.int64)


def vjepa_target_mask(generator: torch.Generator, batch: int, *,
                      grid: Tuple[int, int, int],
                      pred_mask_scale: Tuple[float, float] = (0.2, 0.8),
                      aspect_ratio: Tuple[float, float] = (0.3, 3.0),
                      num_blocks: int = 3, inv_block: bool = False,
                      full_complement: bool = False,
                      pred_full_complement: bool = False,
                      max_keep: Optional[int] = None) -> torch.Tensor:
    """Multi-block 3D target mask, (batch, N) bool on the generator's
    device, True = target (predicted); the context is its complement. One
    block size per sample (`_block_dims`) and the union of num_blocks
    placements of it, each corner uniform over the positions where the
    block fits; inv_block swaps target and context. As in the JAX package,
    the complement flags hold by construction and are accepted as no-ops,
    and max_keep, which leaves tokens in neither list, raises: use
    `mask_to_indices` and the predictor's index-list path for it."""
    if max_keep is not None:
        raise ValueError(
            "max_keep drops tokens from both the context and target index "
            "lists, which the dense boolean mask cannot represent (context "
            "is defined as ~target). Use mask_to_indices(mask_row, "
            "max_keep=...) and the model's context_mask/target_mask "
            "index-list path instead.")
    del full_complement, pred_full_complement  # no-ops: see docstring
    gd, gh, gw = grid
    dev = generator.device
    dims = _block_dims(generator, batch, grid, pred_mask_scale,
                       aspect_ratio)                       # (B, 3)
    room = torch.tensor([gd, gh, gw], device=dev) - dims + 1
    u = torch.rand((batch, num_blocks, 3), generator=generator, device=dev,
                   dtype=torch.float64)
    start = torch.floor(u * room[:, None, :]).to(torch.int64)  # (B, nb, 3)
    stop = start + dims[:, None, :]
    covered = torch.zeros((batch, gd, gh, gw), dtype=torch.bool, device=dev)
    axes = [torch.arange(g, device=dev) for g in grid]
    for i in range(num_blocks):
        inside = [(a[None] >= start[:, i, j, None])
                  & (a[None] < stop[:, i, j, None])
                  for j, a in enumerate(axes)]            # (B, g_j) each
        covered |= (inside[0][:, :, None, None] & inside[1][:, None, :, None]
                    & inside[2][:, None, None, :])
    out = covered.reshape(batch, -1)
    return ~out if inv_block else out


def mask_to_indices(mask_bool, max_keep: Optional[int] = None, *,
                    full_complement: bool = False,
                    pred_full_complement: bool = False,
                    max_len: Optional[int] = None):
    """One boolean mask row -> (context, target) index arrays in ascending
    token order, the reference's index-list form; max_keep (alias
    max_len) cuts both lists to their first max_keep entries. The
    complement flags are accepted as no-ops, as in the JAX package."""
    del full_complement, pred_full_complement  # no-ops: see docstring
    if max_keep is None:
        max_keep = max_len
    if isinstance(mask_bool, torch.Tensor):
        mask_bool = mask_bool.detach().cpu().numpy()
    mask_bool = np.asarray(mask_bool, dtype=bool)
    target = np.nonzero(mask_bool)[0]
    context = np.nonzero(~mask_bool)[0]
    if max_keep is not None:
        target = target[:max_keep]
        context = context[:max_keep]
    return context, target
