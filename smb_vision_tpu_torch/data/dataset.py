"""Map-style dataset of preprocessed CT volumes, and the training batch
loader.

Counterpart of `smb_vision_tpu/data/dataset.py`: `CTDataset` with its
two backends (native: the C++ loader of `data/native.py` on the host's
CPU; python: NIfTI decode and RAS reorientation on the host, resample and
window on `device`), the versioned on-disk volume cache and the RAM cache;
`partition_items`; `BatchLoader` and `default_collate`;
`DeviceCachedBatchLoader`, which keeps every volume on the device after
its first load; and `prefetch_to_device`, pinned host buffers copied on a
side stream.
"""

from __future__ import annotations

import collections
import hashlib
import os
import queue
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from smb_vision_tpu_torch.data import native
from smb_vision_tpu_torch.data.load import load_data
from smb_vision_tpu_torch.data.nifti import load_nifti
from smb_vision_tpu_torch.data.preprocess import (
    CT_PIPELINES,
    PREPROCESS_VERSION,
    PreprocessConfig,
    preprocess_volume,
)
from smb_vision_tpu_torch.data.quantization import (
    OFFSET_KEY,
    SCALE_KEY,
    dequantize_volume,
    quantize_volume,
)
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

BACKENDS = ("auto", "native", "python")
CACHE_DTYPES = ("float32", "float16", "uint8")
# numpy has no bfloat16: a bfloat16 volume is returned as a CPU tensor
OUT_DTYPES = ("float32", "float16", "bfloat16", "uint8")


class CTDataset:
    """Preprocessed CT volumes plus the items' other keys, passed through.

    Items come from `items` or from a dataset spec (`data_path`, `split`).
    backend: "native" (the C++ loader, on the host's CPU, outside the
    GIL), "python" (decode on the host, resample on `device`) or "auto"
    (python on a CUDA device; else native when its library builds, else
    python; the choice is logged). A native "DCHW" volume is a transposed
    view of the loader's (H, W, D) array: the copy to a device lays it
    out (DeviceCachedBatchLoader on the device, a host collate on the
    host).
    ram_cache: also keep each example's pixels in host memory after its
    first load (for a dataset that fits there).
    Each example is {"image": (D, 1, H, W) volume, ...item keys...,
    "_item": item}; with out_dtype "uint8" also "image_scale" and
    "image_offset", the volume's affine (data/quantization.py).

    cache_dir: preprocessed volumes are kept there, one file per image
    path, keyed by the md5 of the path and of the pipeline, this package's
    PREPROCESS_VERSION and the cache dtype; written atomically (a temp file
    in the same directory, then a rename), recomputed when unreadable.
    cache_dtype: "float32", "float16" (half the bytes, ~1e-4 rounding of
    the [0, 1] values) or "uint8" (an npz of codes q, scale and offset; at
    most (max - min) / 510 off). out_dtype: the dtype of the returned
    volume, "float32", "float16", "bfloat16" or "uint8" (codes and their
    affine; a float cache is quantised at each load). Values returned when
    an entry is computed equal those read back from the cache later."""

    def __init__(self, data_path=None, split: Optional[str] = "train",
                 pipeline="smb-vision", cache_dir: Optional[str] = None,
                 items: Optional[List[Dict]] = None,
                 image_key: str = "image", max_samples: Optional[int] = None,
                 backend: str = "auto", ram_cache: bool = False,
                 cache_dtype: str = "float32", out_dtype: str = "float32",
                 device: Optional[torch.device] = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: expected one of "
                             f"{BACKENDS}")
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {cache_dtype!r}: expected one of "
                             f"{CACHE_DTYPES}")
        if out_dtype not in OUT_DTYPES:
            raise ValueError(f"out_dtype {out_dtype!r}: expected one of "
                             f"{OUT_DTYPES}")
        if items is None:
            items = load_data(data_path, split=split)
        if max_samples:
            items = items[:max_samples]
        self.items = items
        self.image_key = image_key
        self.pipeline: PreprocessConfig = (
            CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline)
        self.device = device or torch.device("cpu")
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.cache_dtype = np.dtype(cache_dtype)
        self.out_dtype = out_dtype
        dt_tag = "" if cache_dtype == "float32" else cache_dtype
        self._pipe_hash = hashlib.md5(
            (repr(self.pipeline) + PREPROCESS_VERSION + dt_tag).encode()
        ).hexdigest()[:12]
        if backend == "native":
            native._load_lib()             # raises with the build's output
        elif backend == "auto":
            # on a CUDA device the card resamples a volume in about half
            # the time the native loader takes on one host core (PERF.md,
            # section 6)
            backend = ("python" if self.device.type == "cuda"
                       or not native.native_available() else "native")
            logger.info("CTDataset backend: %s", backend)
        self.backend = backend
        self.ram_cache = ram_cache
        self._ram: Dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self.items)

    def _cache_path(self, item: Dict) -> Optional[Path]:
        if self.cache_dir is None:
            return None
        # keyed on the image path alone (plus the pipeline hash): the
        # pixels do not depend on the item's other keys
        key = hashlib.md5(
            (str(item[self.image_key]) + self._pipe_hash).encode()
        ).hexdigest()
        return self.cache_dir / f"{key}.npy"

    def _compute(self, item: Dict) -> np.ndarray:
        if self.backend == "native":
            path = str(item[self.image_key])
            if not os.path.isfile(path):
                # the python backend's error (the loader says status 1)
                raise FileNotFoundError(f"no such volume: {path}")
            return native.native_preprocess_volume(path, self.pipeline)
        img = load_nifti(item[self.image_key])
        return preprocess_volume(img.data, img.affine, self.pipeline,
                                 device=self.device)

    def _load_entry(self, item: Dict):
        """-> (codes, scale, offset) from a uint8 cache, else (float volume
        in cache_dtype, None, None); computed and written on a miss."""
        cache = self._cache_path(item)
        if cache is not None and cache.is_file():
            try:
                loaded = np.load(cache)
                if isinstance(loaded, np.lib.npyio.NpzFile):
                    with loaded:
                        return (loaded["q"], np.float32(loaded["scale"]),
                                np.float32(loaded["offset"]))
                return loaded, None, None
            except (ValueError, EOFError, OSError, KeyError):
                # unreadable entry: drop it and compute the volume again
                try:
                    cache.unlink()
                except OSError:
                    pass
        vol = self._compute(item)
        q = s = o = None
        if self.cache_dtype == np.uint8:
            q, s, o = quantize_volume(vol)
        if cache is not None:
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    if q is not None:
                        np.savez(f, q=q, scale=s, offset=o)
                    else:
                        np.save(f, vol.astype(self.cache_dtype, copy=False))
                os.replace(tmp, cache)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        if q is not None:
            return q, s, o
        # the values a later read of the cache gives
        return vol.astype(self.cache_dtype, copy=False), None, None

    def _example_pixels(self, item: Dict):
        """-> (image, scale, offset): codes and their affine when out_dtype
        is "uint8", else the float volume and None, None."""
        if self.out_dtype == "uint8":
            arr, s, o = self._load_entry(item)
            if s is None:
                arr, s, o = quantize_volume(arr)
            return arr, s, o
        return self.load_volume(item), None, None

    def load_volume(self, item: Dict):
        """The float volume: out_dtype (float32 when out_dtype is
        "uint8"), a bfloat16 CPU tensor for "bfloat16"."""
        arr, s, o = self._load_entry(item)
        if s is not None:
            arr = dequantize_volume(arr, s, o)
        if self.out_dtype == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32, copy=False)).to(
                torch.bfloat16)
        dt = np.float32 if self.out_dtype == "uint8" else self.out_dtype
        return arr.astype(dt, copy=False)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(self.items[idx])
        if self.ram_cache and idx in self._ram:
            vol, s, o = self._ram[idx]
        else:
            vol, s, o = self._example_pixels(item)
            if self.ram_cache:
                self._ram[idx] = (vol, s, o)
        out = {"image": vol}
        if s is not None:
            out["image_scale"] = s
            out["image_offset"] = o
        for k, v in item.items():
            if k != self.image_key:
                out[k] = v
        out["_item"] = item
        return out


def stack_pixels(volumes: List):
    """Stack numpy volumes, or bfloat16 CPU tensors, along a new axis 0."""
    if isinstance(volumes[0], torch.Tensor):
        return torch.stack(volumes)
    return np.stack(volumes)


def pad_to_batch(pixels, batch_size: int):
    """Repeat the last volume of a stacked batch (numpy or tensor) until it
    holds batch_size volumes."""
    rep = [pixels[-1:]] * (batch_size - pixels.shape[0])
    if not rep:
        return pixels
    if isinstance(pixels, torch.Tensor):
        return torch.cat([pixels, *rep])
    return np.concatenate([pixels, *rep])


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
    """{"pixel_values": the stacked volumes}, with the per-sample affine
    of uint8 volumes as SCALE_KEY / OFFSET_KEY float32 arrays."""
    out = {"pixel_values": stack_pixels([e["image"] for e in examples])}
    if "image_scale" in examples[0]:
        out[SCALE_KEY] = np.asarray([e["image_scale"] for e in examples],
                                    np.float32)
        out[OFFSET_KEY] = np.asarray([e["image_offset"] for e in examples],
                                     np.float32)
    return out


def partition_items(items: Sequence, num_shards: int, shard: int,
                    even: bool = True) -> List:
    """Shard `shard` of `num_shards` (every num_shards-th item from shard
    on); with `even`, padded by wrapping round the items so every shard
    holds ceil(len / num_shards)."""
    picked = list(items[shard::num_shards])
    if even and items:
        target = -(-len(items) // num_shards)
        i = 0
        while len(picked) < target:
            picked.append(items[(shard + i) % len(items)])
            i += 1
    return picked


class DeviceCachedBatchLoader(BatchLoader):
    """BatchLoader that keeps each volume on the device after its first
    (host) load: from the second epoch on, batches are put together on
    the device and the host moves no pixel bytes a step. uint8 volumes
    stay there as codes (one byte a voxel) with their scale and offset,
    decoded in the step. `host_loads[epoch]` counts the dataset reads of
    each epoch.

    For datasets that fit in device memory beside the model's state.
    Restrictions, as in the JAX package: pixel-only batches
    (`default_collate`: the pretraining workloads, whose masks are drawn
    in the step), and no host-side split of the batch for gradient
    accumulation (the Trainer splits it on the device). Pass
    `input_dtype` so float volumes are stored already cast; the Trainer
    attaches its device before the first epoch (`attach_device`); until
    then volumes are kept on the CPU."""

    def __init__(self, *args, input_dtype: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if self.collate is not default_collate:
            raise ValueError(
                "DeviceCachedBatchLoader caches pixel-only batches "
                "(default_collate); fine-tune loaders with label columns "
                "should use the host BatchLoader")
        self.input_dtype = input_dtype
        self.device: Optional[torch.device] = None
        self.host_loads: Dict[int, int] = {}
        self._dev: Dict[int, tuple] = {}

    def attach_device(self, device) -> None:
        """The device volumes are kept on; called by the Trainer."""
        self.device = torch.device(device)

    def _volume_on_device(self, idx: int) -> tuple:
        entry = self._dev.get(idx)
        if entry is None:
            ex = self.ds[idx]
            self.host_loads[self._epoch] = (
                self.host_loads.get(self._epoch, 0) + 1)
            px = torch.as_tensor(ex["image"])[None]
            if "image_scale" not in ex and self.input_dtype not in (
                    None, "uint8"):
                px = px.to(getattr(torch, self.input_dtype))
            dev = self.device or torch.device("cpu")
            # a native volume is a transposed view: laid out on the device
            entry = (px.to(dev).contiguous(),)
            if "image_scale" in ex:
                entry += (torch.tensor([ex["image_scale"]],
                                       dtype=torch.float32, device=dev),
                          torch.tensor([ex["image_offset"]],
                                       dtype=torch.float32, device=dev))
            self._dev[idx] = entry
        return entry

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self.host_loads.setdefault(self._epoch, 0)
        for i in range(len(self)):
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            vols = [self._volume_on_device(int(j)) for j in idxs]
            parts = [torch.cat([v[k] for v in vols])
                     for k in range(len(vols[0]))]
            batch = {"pixel_values": parts[0]}
            if len(parts) == 3:
                batch[SCALE_KEY] = parts[1]
                batch[OFFSET_KEY] = parts[2]
            yield batch


def to_tensor(v) -> torch.Tensor:
    """A batch column as a tensor (a tensor passes as it is)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def prefetch_to_device(iterator, device, size: int = 2):
    """Keep `size` batches in flight on the way to `device`: on CUDA each
    host array goes through a pinned buffer and is copied on a side
    stream, which the consuming stream waits on, so the copy overlaps the
    step. Tensors already on the device pass through; on the CPU this is
    a conversion to tensors."""
    device = torch.device(device)
    stream = (torch.cuda.Stream(device) if device.type == "cuda"
              else None)

    def put(batch):
        if stream is None:
            return {k: to_tensor(v).to(device)
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                t = to_tensor(v)
                if t.device.type == "cpu":
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    it = iter(iterator)
    buf = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        batch, event = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in batch.values():
                if t.device.type == "cuda":
                    t.record_stream(current)
        yield batch
