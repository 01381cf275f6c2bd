"""Embedding encoders and the manifest runner of the encoder zoo.

Counterpart of `smb_vision_tpu/inference/runner.py`: `BaseEncoder`
(create_dataset / setup_model / generate_embedding hooks),
`SmbVisionEncoder` (the first-party VideoMAE encoder, encoder-only
forward), which the embedding server drives, and `BaseEncoderRunner`,
which checks a manifest, skips the uids already written (resume), embeds
the rest in batches (the last one padded to the batch size), quarantines
an item that fails to load or a batch that fails to embed under its own
uid in error_files.json, and writes through `inference.embed`'s
`EmbeddingWriter` (npy or parquet). The zoo's other encoders are in
`inference/encoders.py`.
"""

from __future__ import annotations

import abc
import json
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from smb_vision_tpu_torch.inference.embed import EmbeddingWriter
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class BaseEncoder(abc.ABC):
    """One embedding model and its preprocessing."""

    model_id: str = "base-encoder"

    @abc.abstractmethod
    def create_dataset(self, items: List[Dict]) -> Any:
        """items: [{'uid': ..., 'image_path' | 'image': ...}] -> dataset"""

    @abc.abstractmethod
    def setup_model(self) -> None:
        """Build the model and load its weights."""

    @abc.abstractmethod
    def generate_embedding(self, batch: np.ndarray) -> np.ndarray:
        """(N, ...) pixels -> (N, ...) embeddings."""

    def process_batch(self, batch_items: List[Dict], pixels, scale=None,
                      offset=None) -> List[np.ndarray]:
        """One embedding per item of a batch (pixels may hold padding
        rows past the items); uint8 pixels come with their per-volume
        scale and offset."""
        extra = {} if scale is None else {"scale": scale, "offset": offset}
        emb = np.asarray(self.generate_embedding(pixels, **extra))
        return [emb[i] for i in range(len(batch_items))]


def resolve_device(name: str) -> torch.device:
    """torch.device for a --device value: "cuda" (or "cuda:N") needs CUDA,
    else a CPU run must ask for "cpu"."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} but CUDA is not available; pass --device cpu "
            "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda or cpu")
    return device


class SmbVisionEncoder(BaseEncoder):
    """First-party CT encoder: VideoMAE backbone, encoder-only forward on
    `device`, with random weights from `seed` when no checkpoint is
    given."""

    def __init__(self, checkpoint: Optional[str] = None,
                 config_path: Optional[str] = None,
                 model_id: str = "smb-vision-tpu-base",
                 pipeline: str = "smb-vision", dtype: str = "bfloat16",
                 attn_impl: str = "auto", device: str = "cuda",
                 seed: int = 0):
        self.checkpoint = checkpoint
        self.config_path = config_path
        self.model_id = model_id
        self.pipeline = pipeline
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.seed = seed
        self.model = None

    def _config(self):
        from smb_vision_tpu_torch.models.configs import VideoMAEConfig

        if self.config_path:
            config = VideoMAEConfig.from_json(self.config_path)
            config.update({"dtype": self.dtype,
                           "attn_impl": self.attn_impl})
        else:
            config = VideoMAEConfig(num_channels=1, tubelet_size=16,
                                    dtype=self.dtype,
                                    attn_impl=self.attn_impl)
        return config

    def create_dataset(self, items: List[Dict], out_dtype: str = "float32",
                       cache_dir: Optional[str] = None):
        """CTDataset at the model's own grid, preprocessing on the
        encoder's device, with its volume cache in `cache_dir` if given."""
        from smb_vision_tpu_torch.data.dataset import CTDataset
        from smb_vision_tpu_torch.data.preprocess import (
            CT_PIPELINES,
            PreprocessConfig,
        )

        cfg = self._config()
        base = CT_PIPELINES[self.pipeline]
        pipe = PreprocessConfig(
            target_spacing=base.target_spacing,
            target_size=(cfg.image_size, cfg.image_size, cfg.num_frames),
            layout=base.layout)
        norm = [{"image": it.get("image_path", it.get("image")), **it}
                for it in items]
        return CTDataset(items=norm, pipeline=pipe, cache_dir=cache_dir,
                         out_dtype=out_dtype, device=self.device)

    def setup_model(self) -> None:
        from smb_vision_tpu_torch.models.videomae import VideoMAEModel

        model = VideoMAEModel(self._config())
        if self.checkpoint:
            from smb_vision_tpu_torch.models.convert import (
                load_backbone_into,
            )

            load_backbone_into(model, self.checkpoint)
        else:
            model.init_weights(torch.Generator().manual_seed(self.seed))
        self.model = model.to(self.device).eval()

    def to_device(self, batch, scale=None, offset=None) -> torch.Tensor:
        """Copy a pixel batch (N, D, C, H, W) to the device: float pixels
        as they are, uint8 codes decoded there to bfloat16 with their
        per-volume scale and offset (data/quantization.py)."""
        from smb_vision_tpu_torch.data.quantization import dequantize_pixels

        px = torch.as_tensor(batch).to(self.device)
        if scale is None:
            return px
        return dequantize_pixels(
            px, torch.as_tensor(np.asarray(scale, np.float32)),
            torch.as_tensor(np.asarray(offset, np.float32)), torch.bfloat16)

    def encode(self, px: torch.Tensor) -> torch.Tensor:
        """(N, D, C, H, W) device pixels -> (N, L, hidden) float32 on the
        device."""
        with torch.inference_mode():
            out, _ = self.model(px)
            return out.float()

    def generate_embedding(self, batch, scale=None,
                           offset=None) -> np.ndarray:
        """batch (N, D, C, H, W) float, or uint8 codes with per-volume
        `scale` and `offset` -> (N, L, hidden) float32."""
        return self.encode(self.to_device(batch, scale, offset)).cpu().numpy()


class BaseEncoderRunner:
    """Checks the manifest, resumes, batches, collects errors, writes."""

    def __init__(self, encoder: BaseEncoder, output_dir: str,
                 fmt: str = "parquet", batch_size: int = 1,
                 num_workers: int = 8):
        self.encoder = encoder
        self.writer = EmbeddingWriter(output_dir, fmt=fmt,
                                      model_id=encoder.model_id)
        self.batch_size = batch_size
        self.num_workers = num_workers

    @staticmethod
    def load_input_json(path: str) -> List[Dict]:
        """A manifest {"images": [{uid, image_path}, ...]} or a bare list;
        every item needs a uid and an image_path (or image)."""
        with open(path) as f:
            blob = json.load(f)
        items = blob["images"] if isinstance(blob, dict) else blob
        for it in items:
            if "uid" not in it or not (it.get("image_path")
                                       or it.get("image")):
                raise ValueError(
                    f"manifest items need uid + image_path: got {it}")
        return items

    def run(self, items: List[Dict], resume: bool = True) -> Dict:
        """Embed every item whose uid is not written yet -> {"embedded",
        "failed", "skipped"}."""
        done = self.writer.existing_uids() if resume else set()
        todo = [it for it in items if str(it["uid"]) not in done]
        if done:
            logger.info("resume: skipping %d processed uids", len(done))
        self.encoder.setup_model()
        ds = self.encoder.create_dataset(todo)
        if hasattr(ds, "__len__") and len(ds) != len(todo):
            # the loop pairs todo[i] with ds[i]: a dataset that drops items
            # would write embeddings under shifted uids
            raise ValueError(
                f"create_dataset returned {len(ds)} items for {len(todo)} "
                "manifest entries; datasets must preserve 1:1 index pairing")
        errors: List[Dict] = []
        n_ok = 0

        def load(i):
            try:
                return i, ds[i], None
            except Exception as e:  # noqa: BLE001 -- quarantined per item
                return i, None, {"item": todo[i], "error": str(e),
                                 "trace": traceback.format_exc(limit=3)}

        with ThreadPoolExecutor(self.num_workers) as pool:
            batch: List = []
            for i, ex, err in pool.map(load, range(len(todo))):
                if err:
                    errors.append(err)
                    continue
                batch.append((todo[i], ex["image"], ex.get("image_scale"),
                              ex.get("image_offset")))
                if len(batch) == self.batch_size:
                    n_ok += self._flush(batch, errors)
                    batch = []
            if batch:
                n_ok += self._flush(batch, errors)
        self.writer.finalize(errors)
        stats = {"embedded": n_ok, "failed": len(errors),
                 "skipped": len(done)}
        logger.info("%s", stats)
        return stats

    def _flush(self, batch, errors) -> int:
        """Embed one batch, padded to batch_size by repeating its last
        volume (the model runs at one batch shape), and write it."""
        from smb_vision_tpu_torch.data.dataset import (
            pad_to_batch,
            stack_pixels,
        )

        items = [b[0] for b in batch]
        px = pad_to_batch(stack_pixels([b[1] for b in batch]),
                          self.batch_size)
        scale = offset = None
        if batch[0][2] is not None:
            scale, offset = (pad_to_batch(np.asarray(
                [b[j] for b in batch], np.float32), self.batch_size)
                for j in (2, 3))
        try:
            embs = self.encoder.process_batch(items, px, scale, offset)
        except Exception as e:  # noqa: BLE001 -- recorded, the run goes on
            logger.error("embedding a batch of %d failed: %s", len(items), e)
            errors.extend({"item": it, "error": str(e)} for it in items)
            return 0
        for it, emb in zip(items, embs):
            self.writer.write(it, emb)
        return len(items)
