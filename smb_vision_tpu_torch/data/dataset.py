"""Map-style dataset of preprocessed CT volumes.

Counterpart of `smb_vision_tpu/data/dataset.py::CTDataset`, the python
backend: NIfTI decode and RAS reorientation on the host, resample and
window on `device`. The native C++ loader and the on-disk volume cache are
not ported yet (ROADMAP.md queue 1, native loader and dataset cache).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from smb_vision_tpu_torch.data.load import load_data
from smb_vision_tpu_torch.data.nifti import load_nifti
from smb_vision_tpu_torch.data.preprocess import (
    CT_PIPELINES,
    PreprocessConfig,
    preprocess_volume,
)


class CTDataset:
    """Preprocessed CT volumes plus the items' other keys, passed through.

    Items come from `items` or from a dataset spec (`data_path`, `split`).
    Each example is {"image": float32 (D, 1, H, W) array, ...item keys...,
    "_item": item}."""

    def __init__(self, data_path=None, split: Optional[str] = "train",
                 pipeline="smb-vision", cache_dir: Optional[str] = None,
                 items: Optional[List[Dict]] = None,
                 image_key: str = "image", max_samples: Optional[int] = None,
                 backend: str = "python",
                 device: Optional[torch.device] = None):
        if backend != "python":
            raise NotImplementedError(
                f"backend={backend!r}: the native CT loader is not ported "
                "yet (ROADMAP.md queue 1, native loader and dataset cache); "
                "use 'python'")
        if cache_dir:
            raise NotImplementedError(
                "the preprocessed-volume cache (cache_dir) is not ported yet "
                "(ROADMAP.md queue 1, native loader and dataset cache)")
        if items is None:
            items = load_data(data_path, split=split)
        if max_samples:
            items = items[:max_samples]
        self.items = items
        self.image_key = image_key
        self.pipeline: PreprocessConfig = (
            CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline)
        self.device = device or torch.device("cpu")

    def __len__(self) -> int:
        return len(self.items)

    def load_volume(self, item: Dict) -> np.ndarray:
        img = load_nifti(item[self.image_key])
        return preprocess_volume(img.data, img.affine, self.pipeline,
                                 device=self.device)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(self.items[idx])
        out = {"image": self.load_volume(item)}
        for k, v in item.items():
            if k != self.image_key:
                out[k] = v
        out["_item"] = item
        return out
