"""CT preprocessing: RAS reorientation, trilinear resample, HU window,
pad and centre crop.

Counterpart of `smb_vision_tpu/data/preprocess.py`. Orientation is a numpy
transpose/flip on the host; resample, window, pad and crop are torch ops on
an explicit device with the same index and weight arithmetic as the JAX
package's `_trilinear_resize` and `_device_resample_window_fit`: origin-
aligned point sampling (src = dst * out_spacing / in_spacing), edges
clamped, no anti-aliasing. This is not `F.interpolate`, which aligns
voxel centres differently and so differs at the edges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# Tag of this package's preprocessing numerics, part of the volume cache's
# key (data/dataset.py). It differs from the JAX package's
# PREPROCESS_VERSION: the two preprocessors agree to 1e-5, not bit for bit,
# so a cache written by one package is never read by the other. Bump it
# when these numerics change.
PREPROCESS_VERSION = "torch-1"


def io_orientation(affine: np.ndarray) -> list:
    """For each world axis (R, A, S) the dominant voxel axis and its sign:
    [(axis, flip), ...] such that transposing to `axis` order and flipping
    where flip < 0 gives RAS."""
    R = affine[:3, :3].copy()
    norms = np.linalg.norm(R, axis=0)
    norms[norms == 0] = 1.0
    Q = R / norms
    out = []
    used = set()
    for world in range(3):
        best, best_ax = 0.0, None
        for ax in range(3):
            if ax in used:
                continue
            if abs(Q[world, ax]) >= best:
                best, best_ax = abs(Q[world, ax]), ax
        used.add(best_ax)
        out.append((best_ax, 1.0 if Q[world, best_ax] >= 0 else -1.0))
    return out


def to_ras(data: np.ndarray, affine: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient an (x, y, z) volume and its affine to RAS order/direction."""
    ornt = io_orientation(affine)
    axes = [a for a, _ in ornt]
    data = np.transpose(data, axes)
    new_aff = np.eye(4)
    new_aff[:3, :3] = affine[:3, axes]
    new_aff[:3, 3] = affine[:3, 3]
    for i, (_, sign) in enumerate(ornt):
        if sign < 0:
            data = np.flip(data, axis=i)
            new_aff[:3, 3] = (new_aff[:3, 3]
                              + new_aff[:3, i] * (data.shape[i] - 1))
            new_aff[:3, i] = -new_aff[:3, i]
    return np.ascontiguousarray(data), new_aff


@dataclass(frozen=True)
class PreprocessConfig:
    """One named transform pipeline."""

    target_spacing: Tuple[float, float, float]
    target_size: Tuple[int, int, int]      # (H, W, D) after pad+crop
    hu_window: Tuple[float, float] = (-1000.0, 1000.0)
    out_range: Tuple[float, float] = (0.0, 1.0)
    clip: bool = True
    layout: str = "DCHW"   # "DCHW" (depth as frames) | "CHWD"


CT_PIPELINES = {
    "mim": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160)),
    "vjepa": PreprocessConfig((1.0, 1.0, 1.5), (384, 384, 256)),
    "smb-vision": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160)),
    "dinov2": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160),
                               layout="CHWD"),
    "merlin": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160),
                               layout="CHWD"),
}


def resampled_shape(in_shape, in_spacing, out_spacing) -> Tuple[int, ...]:
    """Voxel grid that keeps the physical extent: ceil(size * in / out)."""
    return tuple(
        max(int(np.ceil(s * si / so - 1e-4)), 1)
        for s, si, so in zip(in_shape, in_spacing, out_spacing))


def _trilinear_resize(vol: torch.Tensor, out_shape, scales) -> torch.Tensor:
    """Separable point-sampled trilinear resample: output voxel d reads
    source coordinate d * scale, clamped to the volume."""
    for axis, (out_n, scale) in enumerate(zip(out_shape, scales)):
        in_n = vol.shape[axis]
        if in_n == out_n and abs(scale - 1.0) < 1e-12:
            continue
        f = torch.arange(out_n, dtype=torch.float32, device=vol.device) * scale
        f = torch.clamp(f, 0.0, in_n - 1)
        i0 = torch.clamp(torch.floor(f).long(), 0, in_n - 1)
        i1 = torch.clamp(i0 + 1, 0, in_n - 1)
        w = torch.clamp(f - torch.floor(f), 0.0, 1.0)
        a = torch.index_select(vol, axis, i0)
        b = torch.index_select(vol, axis, i1)
        shape = [1, 1, 1]
        shape[axis] = out_n
        w = w.reshape(shape)
        vol = a * (1.0 - w) + b * w
    return vol


def _resample_window(vol: torch.Tensor, out_shape, scales, hu, rng,
                     clip) -> torch.Tensor:
    """(H, W, D) float -> resample to out_shape -> HU window, keeping the
    resampled extent."""
    vol = _trilinear_resize(vol.float(), out_shape, scales)
    a_min, a_max = hu
    b_min, b_max = rng
    vol = (vol - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        vol = torch.clamp(vol, min(b_min, b_max), max(b_min, b_max))
    return vol


def _resample_window_fit(vol: torch.Tensor, out_shape, scales, hu, rng,
                         clip, target) -> torch.Tensor:
    """(H, W, D) float -> resample -> window -> symmetric pad (extra voxel
    at the end) and centre crop to `target`."""
    vol = _resample_window(vol, out_shape, scales, hu, rng, clip)
    b_min = rng[0]
    pads = []
    for cur, tgt in zip(vol.shape, target):
        extra = max(tgt - cur, 0)
        pads.append((extra // 2, extra - extra // 2))
    if any(p for pair in pads for p in pair):
        vol = torch.nn.functional.pad(vol, _pad_spec(pads), value=b_min)
    slices = []
    for cur, tgt in zip(vol.shape, target):
        start = max(cur // 2 - tgt // 2, 0)
        slices.append(slice(start, start + tgt))
    return vol[tuple(slices)]


def _pad_spec(pads) -> list:
    """[(before, after)] per axis -> F.pad's list, last axis first."""
    return [p for pair in reversed(pads) for p in pair]


def _ras_geometry(data: np.ndarray, affine: np.ndarray, cfg):
    """RAS-reoriented volume, its resampled shape and the per-axis scales
    (out spacing / in spacing)."""
    if data.ndim == 4:  # drop a trailing singleton (time) dim
        data = data[..., 0]
    data, affine = to_ras(data, affine)
    spacing = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
    out_shape = resampled_shape(data.shape, spacing, cfg.target_spacing)
    scales = tuple(so / si for si, so in zip(spacing, cfg.target_spacing))
    return data, out_shape, scales


def preprocess_volume_full(data: np.ndarray, affine: np.ndarray, pipeline,
                           pad_multiple: int = 32,
                           device: Optional[torch.device] = None
                           ) -> np.ndarray:
    """RAS + resample + window on `device` (default cpu), keeping the
    volume's whole extent, then each axis padded at its end up to a
    multiple of `pad_multiple` with the window's low value (after the
    resample: padding before it would change the spacing). Returns the
    (H, W, D) float32 volume, the input of sliding-window embedding."""
    cfg = CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline
    data, out_shape, scales = _ras_geometry(data, affine, cfg)
    vol = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    vol = _resample_window(vol.to(device or torch.device("cpu")), out_shape,
                           scales, cfg.hu_window, cfg.out_range, cfg.clip)
    pads = [(0, (-s) % pad_multiple) for s in vol.shape]
    if any(p[1] for p in pads):
        vol = torch.nn.functional.pad(vol, _pad_spec(pads),
                                      value=cfg.out_range[0])
    return vol.cpu().numpy()


def preprocess_volume(data: np.ndarray, affine: np.ndarray,
                      pipeline, device: Optional[torch.device] = None,
                      bucket: Optional[int] = None) -> np.ndarray:
    """Full chain for one volume: RAS reorientation on the host, then
    resample/window/pad/crop on `device` (default cpu). Returns the
    model-input array, float32:

      layout "DCHW": (D, 1, H, W)  (depth as frames)
      layout "CHWD": (1, H, W, D)

    bucket: accepted for the JAX package's signature and ignored. There
    it pads the input to bound jit compiles, with the exact path's result;
    eager PyTorch compiles nothing, so the exact path runs."""
    del bucket
    cfg = CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline
    data, out_shape, scales = _ras_geometry(data, affine, cfg)
    vol = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    vol = vol.to(device or torch.device("cpu"))
    out = _resample_window_fit(vol, out_shape, scales, cfg.hu_window,
                               cfg.out_range, cfg.clip, cfg.target_size)
    if cfg.layout == "DCHW":
        out = out.permute(2, 0, 1)[:, None]
    else:
        out = out[None]
    return out.contiguous().cpu().numpy()
