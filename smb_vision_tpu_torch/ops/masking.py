"""MIM block masks.

Counterpart of `smb_vision_tpu/ops/masking.py` (`mim_mask_counts`,
`mim_mask`, `num_masked_tokens`): a random mask on a coarse grid of
mask_patch_size cells with exactly ceil(cells * ratio) masked cells per
sample, upsampled to the model-patch grid. The random numbers come from a
`torch.Generator`, so they differ from `jax.random`'s; tests that compare
the two models hand both the same mask.
"""

from __future__ import annotations

import math
from typing import Tuple

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
