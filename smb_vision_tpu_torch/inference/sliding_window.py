"""Sliding-window embedding over volumes of any size.

Counterpart of `smb_vision_tpu/inference/sliding_window.py`'s
`sliding_window_embed`: dense overlapping 3D windows with the same
scan-interval arithmetic (interval = roi * (1 - overlap); the last window
of each axis moved inside the volume), constant or gaussian importance
weights, and windows run through the model in chunks of `sw_batch_size`,
here in a plain loop on the volume's device. It returns the per-window
token embeddings (B, n_win, L, D), or their weighted means (B, n_win, D)
with pool=True, and the window starts. `sliding_window_inference` is the
voxel-space blend of a predictor's dense outputs: each window's output
weighted by the importance map, summed where windows overlap, divided by
the summed weights and cropped back to the input. The JAX package's
`state=` argument and its cache of jitted runners have no counterpart: a
PyTorch predictor holds its parameters and runs eagerly.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def scan_interval(image_size: Sequence[int], roi_size: Sequence[int],
                  overlap: Sequence[float] | float) -> Tuple[int, ...]:
    """interval = roi * (1 - overlap) per axis, at least 1; the whole axis
    where the roi covers it."""
    if not isinstance(overlap, (tuple, list)):
        overlap = [overlap] * len(roi_size)
    out = []
    for im, roi, ov in zip(image_size, roi_size, overlap):
        if roi == im:
            out.append(im)
        else:
            out.append(max(int(roi * (1 - ov)), 1))
    return tuple(out)


def dense_window_starts(image_size: Sequence[int], roi_size: Sequence[int],
                        interval: Sequence[int]) -> np.ndarray:
    """Start coordinates of every window, (n_win, ndim) int32, the last
    axis fastest; each axis' last window is clamped inside the volume and
    starts that clamping repeats are dropped."""
    per_dim = []
    for im, roi, iv in zip(image_size, roi_size, interval):
        n = max(int(math.ceil((im - roi) / iv)) + 1, 1) if iv else 1
        starts = [min(i * iv, im - roi) for i in range(n)]
        per_dim.append(list(dict.fromkeys(starts)))
    return np.array(list(itertools.product(*per_dim)), dtype=np.int32)


def importance_map(roi_size: Sequence[int], mode: str = "constant",
                   sigma_scale: float = 0.125) -> torch.Tensor:
    """Blending weight of each voxel of a window, float32: ones, or a
    centred gaussian (sigma = sigma_scale * axis length) floored at 1e-3
    of its peak."""
    if mode == "constant":
        return torch.ones(tuple(roi_size), dtype=torch.float32)
    if mode != "gaussian":
        raise ValueError(f"unknown blend mode {mode}")
    grids = []
    for d in roi_size:
        center = (d - 1) / 2.0
        sigma = max(d * sigma_scale, 1e-3)
        x = (np.arange(d) - center) / sigma
        grids.append(np.exp(-0.5 * x * x))
    out = np.einsum("i,j,k->ijk", *grids).astype(np.float32)
    out = np.maximum(out, out.max() * 1e-3)
    return torch.from_numpy(out)


def _pad_to_min(volume: torch.Tensor, roi_size, cval: float) -> torch.Tensor:
    """Pad (B, C, *spatial) symmetrically (the odd voxel at the end) so that
    every spatial axis is at least the roi."""
    pads = []
    for cur, roi in zip(volume.shape[2:], roi_size):
        extra = max(roi - cur, 0)
        pads.append((extra // 2, extra - extra // 2))
    if any(p != (0, 0) for p in pads):
        volume = F.pad(volume, [p for pair in reversed(pads) for p in pair],
                       value=cval)
    return volume


def token_weights(roi_size: Sequence[int], num_tokens: int,
                  mode: str = "constant", sigma_scale: float = 0.125,
                  token_grid: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Blending weight of each token (L,), float32: the voxel importance map
    averaged over the token's patch.

    The weights follow the model's token order, index t*H'*W' + h*W' + w
    (depth-major), while roi_size is spatial (H, W, D). token_grid is
    (T', H', W') as the config's `grid` gives it; without it a cubic patch
    is inferred from num_tokens."""
    if mode == "constant":
        return torch.ones((num_tokens,), dtype=torch.float32)
    if token_grid is None:
        vox_per_token = int(np.prod(roi_size)) / num_tokens
        p = round(vox_per_token ** (1 / 3))
        if p <= 0 or any(r % p for r in roi_size):
            raise ValueError(
                f"cannot infer a regular token grid for roi {tuple(roi_size)}"
                f" with {num_tokens} tokens; pass token_grid=(T', H', W')")
        token_grid = (roi_size[2] // p, roi_size[0] // p, roi_size[1] // p)
    tt, th, tw = token_grid
    if tt * th * tw != num_tokens:
        raise ValueError(f"token grid {tuple(token_grid)} covers "
                         f"{tt * th * tw} tokens, not {num_tokens}")
    imap = importance_map(roi_size, mode, sigma_scale).numpy()
    ph, pw, pt = (roi_size[0] // th, roi_size[1] // tw, roi_size[2] // tt)
    # pool each token's (H, W, D) voxels, then order depth-major (t, h, w)
    w = imap.reshape(th, ph, tw, pw, tt, pt).mean(axis=(1, 3, 5))
    w = w.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(w.reshape(-1),
                                                 dtype=np.float32))


def _windows(vol: torch.Tensor, starts: np.ndarray, roi_size
             ) -> torch.Tensor:
    """(B, C, *spatial) at each start -> (n * B, C, *roi), window-major."""
    r0, r1, r2 = roi_size
    wins = [vol[:, :, s0:s0 + r0, s1:s1 + r1, s2:s2 + r2]
            for s0, s1, s2 in starts.tolist()]
    return torch.cat(wins)


def sliding_window_embed(volume: torch.Tensor, roi_size: Sequence[int],
                         embedder: Callable[..., torch.Tensor],
                         *, overlap: float = 0.25, sw_batch_size: int = 1,
                         mode: str = "constant", sigma_scale: float = 0.125,
                         cval: float = 0.0, pool: bool = False,
                         token_grid: Optional[Sequence[int]] = None):
    """volume: (B, C, H, W, D). embedder: (N, C, *roi) -> (N, L, D).

    Returns (embeddings, starts): embeddings (B, n_win, L, D), or
    (B, n_win, D) with pool=True, on the volume's device; starts
    (n_win, 3), the windows' start coordinates in the padded volume.

    mode="gaussian" weights each token by the mean gaussian weight of its
    voxels (token_weights): with pool=True the window's embedding is the
    weighted mean of its tokens; without, the tokens are scaled by their
    weights normalised to mean 1. mode="constant" passes the tokens through
    (pool=True: their plain mean)."""
    b = volume.shape[0]
    padded = tuple(max(s, r) for s, r in zip(volume.shape[2:], roi_size))
    starts = dense_window_starts(padded, roi_size,
                                 scan_interval(padded, roi_size, overlap))
    vol = _pad_to_min(volume, roi_size, cval)
    chunks = []
    # sw_batch_size windows a call; the last chunk may hold fewer (it is
    # not padded, so no window runs twice)
    for i in range(0, len(starts), sw_batch_size):
        wins = _windows(vol, starts[i:i + sw_batch_size], roi_size)
        emb = embedder(wins)
        chunks.append(emb.reshape(-1, b, *emb.shape[1:]))
    emb = torch.cat(chunks).transpose(0, 1)          # (B, n_win, L, D)
    if mode == "constant":
        return (emb.mean(dim=2) if pool else emb), starts
    num_tokens = (int(np.prod(token_grid)) if token_grid is not None
                  else emb.shape[2])
    w = token_weights(roi_size, num_tokens, mode, sigma_scale,
                      token_grid).to(emb.device)
    if pool:
        return torch.einsum("bwld,l->bwd", emb, w / w.sum()), starts
    return emb * (w / w.mean())[None, None, :, None], starts


def sliding_window_inference(volume: torch.Tensor, roi_size: Sequence[int],
                             predictor: Callable[[torch.Tensor],
                                                 torch.Tensor],
                             *, overlap: float = 0.25,
                             sw_batch_size: int = 1,
                             mode: str = "constant",
                             sigma_scale: float = 0.125,
                             cval: float = 0.0) -> torch.Tensor:
    """Dense voxel-space sliding window: predictor maps (N, C, *roi) ->
    (N, C', *roi); the windows' outputs, weighted by the importance map,
    are summed where they overlap and divided by the summed weights (+1e-8),
    in float32, then cropped back to the input's spatial size. volume:
    (B, C, H, W, D); returns (B, C', H, W, D) on the volume's device."""
    b = volume.shape[0]
    orig = volume.shape[2:]
    padded = tuple(max(s, r) for s, r in zip(orig, roi_size))
    starts = dense_window_starts(padded, roi_size,
                                 scan_interval(padded, roi_size, overlap))
    vol = _pad_to_min(volume, roi_size, cval)
    imap = importance_map(roi_size, mode, sigma_scale).to(vol.device)
    out = cnt = None
    r0, r1, r2 = roi_size
    for i in range(0, len(starts), sw_batch_size):
        chunk = starts[i:i + sw_batch_size]
        pred = predictor(_windows(vol, chunk, roi_size)).float()
        pred = pred.reshape(len(chunk), b, *pred.shape[1:]) * imap
        if out is None:
            out = pred.new_zeros((b, pred.shape[2], *vol.shape[2:]))
            cnt = pred.new_zeros((1, 1, *vol.shape[2:]))
        # windows of one chunk may overlap: one addition each, in order
        for (s0, s1, s2), p in zip(chunk.tolist(), pred):
            out[:, :, s0:s0 + r0, s1:s1 + r1, s2:s2 + r2] += p
            cnt[:, :, s0:s0 + r0, s1:s1 + r1, s2:s2 + r2] += imap
    out = out / (cnt + 1e-8)
    crops = [slice((cur - o) // 2, (cur - o) // 2 + o)
             for cur, o in zip(vol.shape[2:], orig)]
    return out[(slice(None), slice(None), *crops)]
