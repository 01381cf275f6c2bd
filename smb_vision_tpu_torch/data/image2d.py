"""2D medical images (X-rays) for the encoder zoo.

Counterpart of `smb_vision_tpu/data/image2d.py`: a threaded openability
sweep of the manifest, PIL loading, a resize to image_size (bilinear) and a
per-channel normalisation ((x - mean) / std on [0, 1] RGB; or an external
`preprocess_fn`). An unreadable item is not dropped: `__getitem__` raises
for it, so its index keeps pairing with the caller's manifest and
`BaseEncoderRunner` quarantines it under its own uid.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class Image2DDataset:
    def __init__(self, items: List[Dict], *, image_size: int = 384,
                 mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
                 std: Tuple[float, ...] = (0.5, 0.5, 0.5),
                 image_key: str = "image_path",
                 preprocess_fn: Optional[Callable] = None,
                 validate: bool = True, num_workers: int = 32):
        self.image_size = image_size
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)
        self.image_key = image_key
        self.preprocess_fn = preprocess_fn
        self.items = list(items)
        # index -> the error of an unreadable item, raised at access
        self.invalid: Dict[int, str] = (
            self._validate(self.items, num_workers) if validate else {})

    def _validate(self, items: List[Dict],
                  num_workers: int) -> Dict[int, str]:
        """Open and verify every image in threads."""
        from PIL import Image

        def check(it):
            try:
                with Image.open(it[self.image_key]) as im:
                    im.verify()
                return None
            except Exception as e:  # noqa: BLE001 -- recorded per item
                return str(e)

        invalid = {}
        with ThreadPoolExecutor(num_workers) as pool:
            for i, err in enumerate(pool.map(check, items)):
                if err is not None:
                    invalid[i] = err
        if invalid:
            logger.warning("%d unreadable images (quarantined at access)",
                           len(invalid))
        return invalid

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        if idx in self.invalid:
            raise ValueError(
                f"unreadable image {self.items[idx].get(self.image_key)}: "
                f"{self.invalid[idx]}")
        item = dict(self.items[idx])
        with Image.open(item[self.image_key]) as im:
            im = im.convert("RGB").resize(
                (self.image_size, self.image_size), Image.BILINEAR)
            arr = np.asarray(im, np.float32) / 255.0
        arr = arr.transpose(2, 0, 1)               # (C, H, W)
        if self.preprocess_fn is not None:
            arr = self.preprocess_fn(arr)
        else:
            arr = (arr - self.mean) / self.std
        item["image"] = arr.astype(np.float32)
        return item

    @staticmethod
    def collate_fn(examples: List[Dict]) -> Dict[str, np.ndarray]:
        return {"pixel_values": np.stack([e["image"] for e in examples]),
                "uid": [e.get("uid") for e in examples]}
