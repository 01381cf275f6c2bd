"""Embedding encoders: an encoder interface and the first-party encoder.

Counterpart of `smb_vision_tpu/inference/runner.py`: `BaseEncoder`
(create_dataset / setup_model / generate_embedding hooks) and
`SmbVisionEncoder` (the first-party VideoMAE encoder, encoder-only
forward), which the embedding server drives. The zoo's other encoders
(SigLIP, Merlin) and `BaseEncoderRunner`, the manifest runner they share,
are not ported yet (ROADMAP.md queue 1 item 8, Zoo).
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional

import numpy as np
import torch


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
