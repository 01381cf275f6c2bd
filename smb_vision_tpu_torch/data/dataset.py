"""Map-style dataset of preprocessed CT volumes, and the training batch
loader.

Counterpart of `smb_vision_tpu/data/dataset.py` (`CTDataset`, the python
backend: NIfTI decode and RAS reorientation on the host, resample and
window on `device`; `BatchLoader` and `default_collate`). The native C++
loader and the on-disk volume cache are not ported yet (ROADMAP.md queue
1, native loader and dataset cache).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

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


class BatchLoader:
    """Threaded prefetching batch iterator over a dataset. The order is
    shuffled from seed + epoch when `shuffle` (`set_epoch` picks the
    epoch); `drop_last` drops the final partial batch (training wants
    full batches). collate: list of examples -> dict of numpy arrays."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True,
                 collate=None, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate = collate or default_collate
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.ds)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def put(obj) -> bool:
            # gives up once the consumer stopped reading (a mid-epoch
            # break), so the producer never blocks on a full queue
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        examples = list(pool.map(self.ds.__getitem__, idxs))
                        if not put(self.collate(examples)):
                            return
            except Exception as e:  # noqa: BLE001 -- re-raised below
                failure.append(e)
            finally:
                put(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()


def default_collate(examples: List[Dict]) -> Dict[str, np.ndarray]:
    return {"pixel_values": np.stack([e["image"] for e in examples])}
