"""ctypes binding of the native C++ CT loader (`csrc/ctloader.cpp`).

Counterpart of `smb_vision_tpu/data/native.py`. `native_load_batch`
decodes, reorients to RAS, resamples, windows and pads/crops N NIfTI
volumes on a C++ thread pool, outside the GIL, into one (N, H, W, D)
float32 array. It runs on the host's CPU. The library is built from the
repo's source at first use (`data/build_native.py`); a failed build raises
its compiler output, and `native_available` logs it and says False.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_lib = None
_error: Optional[Exception] = None
_lock = threading.Lock()


def _load_lib():
    """The bound library, built first if needed; raises if it cannot be
    built or loaded (again on every call, without building anew)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            from smb_vision_tpu_torch.data.build_native import build

            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as err:
                _error = err
                raise
            lib.ctloader_load_batch.restype = ctypes.c_int
            lib.ctloader_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ]
            lib.ctloader_version.restype = ctypes.c_int
            _lib = lib
        if _error is not None:
            raise _error
        return _lib


def native_available() -> bool:
    """True when the library builds and loads; a failure is logged."""
    try:
        return _load_lib().ctloader_version() >= 1
    except (RuntimeError, OSError) as err:
        logger.warning("native CT loader unavailable: %s", err)
        return False


def native_load_batch(paths: Sequence[str], *,
                      target_size: Tuple[int, int, int],
                      target_spacing: Tuple[float, float, float],
                      hu_window: Tuple[float, float] = (-1000.0, 1000.0),
                      out_range: Tuple[float, float] = (0.0, 1.0),
                      num_threads: int = 8
                      ) -> Tuple[np.ndarray, List[int]]:
    """-> (volumes (N, H, W, D) float32 in RAS order, per-item status; 0 is
    success). target_size and target_spacing in RAS (H, W, D) order, as in
    data/preprocess.py."""
    lib = _load_lib()
    n = len(paths)
    t0, t1, t2 = target_size
    out = np.empty((n, t0, t1, t2), dtype=np.float32)
    status = np.empty(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    ret = lib.ctloader_load_batch(
        arr, n, t0, t1, t2,
        float(target_spacing[0]), float(target_spacing[1]),
        float(target_spacing[2]),
        float(hu_window[0]), float(hu_window[1]),
        float(out_range[0]), float(out_range[1]),
        int(num_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if ret != 0:
        raise RuntimeError(f"ctloader_load_batch failed: {ret}")
    return out, status.tolist()


def native_preprocess_volume(path: str, pipeline) -> np.ndarray:
    """One volume through the native loader, in the pipeline's model
    layout ((D, 1, H, W) or (1, H, W, D)) like
    data.preprocess.preprocess_volume. The "DCHW" layout is a transposed
    view of the loader's (H, W, D) array, not a copy: the host's strided
    copy of a 512^2 x 320 volume costs seconds (PERF.md, section 6), so
    the layout is made where the volume is copied anyway, on the device
    or in a host collate."""
    from smb_vision_tpu_torch.data.preprocess import CT_PIPELINES

    cfg = CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline
    vols, status = native_load_batch(
        [path], target_size=cfg.target_size,
        target_spacing=cfg.target_spacing, hu_window=cfg.hu_window,
        out_range=cfg.out_range, num_threads=1)
    if status[0] != 0:
        raise ValueError(f"native decode failed ({status[0]}) for {path}")
    out = vols[0]
    if cfg.layout != "DCHW":
        return out[None]
    return out.transpose(2, 0, 1)[:, None]
