"""uint8 pixel shipping: per-volume affine quantisation.

Counterpart of `smb_vision_tpu/data/quantization.py`. A float volume is
shipped as uint8 codes with one (scale, offset) pair per volume,
x ~= q * scale + offset, so the host-to-device copy carries one byte a
voxel (a quarter of float32) at an absolute error of at most scale / 2 =
(max - min) / 510 per voxel. The host side (`quantize_volume`,
`dequantize_volume`) is numpy and gives the JAX package's codes bit for
bit; the decode (`dequantize_pixels`) runs on torch tensors on the device
that holds them. On the training side, `quantize_batch` is the host
fallback for a loader that yields float pixels, and `dequantize_batch`
decodes a batch on the device inside the Trainer's step.

In bfloat16 the decode rounds twice, after the product and after the sum,
as eager PyTorch computes `q * s + o` in that dtype; the JAX package's
decode compiled by XLA on the CPU rounds the same way
(tests/test_torch_quantization.py holds the two bit for bit).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# keys a quantised batch carries beside "pixel_values" (uint8)
SCALE_KEY = "pixel_scale"
OFFSET_KEY = "pixel_offset"

# rows of a volume quantised at a time: the float temporaries stay small
_CHUNK_ROWS = 16


def quantize_volume(vol: np.ndarray) -> Tuple[np.ndarray, np.float32,
                                              np.float32]:
    """(float volume) -> (uint8 codes, scale, offset) with
    vol ~= codes * scale + offset and |err| <= scale / 2 per voxel. A
    constant (or non-finite) volume gives all-zero codes, scale 1 and its
    value as the offset. A transposed view (the native loader's volumes)
    is quantised in its memory order, and its codes are the same view of
    a contiguous array."""
    if not vol.flags.c_contiguous:
        order = np.argsort(vol.strides, kind="stable")[::-1]
        if vol.transpose(order).flags.c_contiguous:
            q, scale, lo = quantize_volume(vol.transpose(order))
            return q.transpose(np.argsort(order)), scale, lo
    lo = float(vol.min())
    hi = float(vol.max())
    scale = (hi - lo) / 255.0
    if scale <= 0.0 or not np.isfinite(scale):
        return (np.zeros(vol.shape, np.uint8), np.float32(1.0),
                np.float32(lo))
    q = np.empty(vol.shape, np.uint8)
    inv = 1.0 / scale
    flat_in = vol.reshape(vol.shape[0], -1)
    flat_out = q.reshape(vol.shape[0], -1)
    for i in range(0, vol.shape[0], _CHUNK_ROWS):
        blk = flat_in[i:i + _CHUNK_ROWS].astype(np.float32)
        np.rint((blk - lo) * inv, out=blk)
        np.clip(blk, 0.0, 255.0, out=blk)
        flat_out[i:i + _CHUNK_ROWS] = blk.astype(np.uint8)
    return q, np.float32(scale), np.float32(lo)


def dequantize_volume(q: np.ndarray, scale, offset,
                      dtype=np.float32) -> np.ndarray:
    """Host inverse of `quantize_volume`: q * scale + offset in float32,
    stored in `dtype`."""
    out = np.empty(q.shape, dtype)
    s = float(scale)
    o = float(offset)
    flat_in = q.reshape(q.shape[0], -1)
    flat_out = out.reshape(q.shape[0], -1)
    for i in range(0, q.shape[0], _CHUNK_ROWS):
        flat_out[i:i + _CHUNK_ROWS] = (
            flat_in[i:i + _CHUNK_ROWS].astype(np.float32) * s + o)
    return out


def dequantize_pixels(q: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Affine decode with per-sample coefficients, on q's device.

    q: (..., B, spatial...) uint8; scale / offset: any prefix shape of q
    ((B,) for a plain batch), broadcast over the trailing pixel dims. The
    coefficients are cast to `dtype` before the product, as in the JAX
    package."""
    shape = tuple(scale.shape) + (1,) * (q.ndim - scale.ndim)
    s = scale.reshape(shape).to(q.device, dtype)
    o = offset.reshape(shape).to(q.device, dtype)
    return q.to(dtype) * s + o


def quantize_batch(batch: Dict) -> Dict:
    """Host fallback when a loader yields float pixels and the run ships
    uint8 (the free path is CTDataset(out_dtype="uint8"), which quantises
    once, when the cache is written): each volume quantised on its own,
    its affine under SCALE_KEY / OFFSET_KEY. A uint8 batch passes."""
    px = batch["pixel_values"]
    if isinstance(px, torch.Tensor):
        px = px.float().numpy() if px.is_floating_point() else px.numpy()
    px = np.asarray(px)
    if px.dtype == np.uint8:
        return batch
    qs, ss, os_ = zip(*(quantize_volume(v) for v in px))
    out = dict(batch)
    out["pixel_values"] = np.stack(qs)
    out[SCALE_KEY] = np.asarray(ss, np.float32)
    out[OFFSET_KEY] = np.asarray(os_, np.float32)
    return out


def dequantize_batch(batch: Dict,
                     dtype: torch.dtype = torch.float32) -> Dict:
    """Decode a uint8 batch on the device that holds it, dropping the
    affine keys; a float batch passes unchanged."""
    px = batch.get("pixel_values")
    if px is None or px.dtype != torch.uint8:
        return batch
    if SCALE_KEY not in batch:
        raise ValueError(
            "uint8 pixel_values without pixel_scale/pixel_offset: "
            "quantised batches must come from CTDataset(out_dtype='uint8') "
            "or quantize_batch()")
    out = {k: v for k, v in batch.items() if k not in (SCALE_KEY,
                                                       OFFSET_KEY)}
    out["pixel_values"] = dequantize_pixels(px, batch[SCALE_KEY],
                                            batch[OFFSET_KEY], dtype)
    return out
