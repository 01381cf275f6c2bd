"""The encoder zoo's external-model encoders: SigLIP (2D X-rays) and
Merlin (CT volumes), behind `BaseEncoder`.

Counterpart of `smb_vision_tpu/inference/encoders.py`. The backend flags
keep the JAX package's values, so its command lines run here unchanged:
backend "jax" names the first-party tower, which in this package is the
PyTorch one (`models/siglip.py`, `models/resnet3d.py`) on `device`;
backend "torch" names the third-party model (transformers'
SiglipVisionModel from a local checkpoint, or the external `merlin`
package). Each encoder runs on `device` ("cuda" by default; a CPU run asks
for "cpu"). Merlin's CT volumes go through the "merlin" pipeline
(224 x 224 x 160, "CHWD"); uint8 pixels are decoded on the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from smb_vision_tpu_torch.inference.runner import BaseEncoder, resolve_device
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)
_BACKENDS = ("jax", "torch")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         "valid: 'jax', 'torch'")


class SiglipEncoder(BaseEncoder):
    """2D X-ray embeddings from a SigLIP vision tower in a local HF
    checkpoint directory (config.json and weights): the MAP-pooled vector,
    or the mean of the tokens for a checkpoint without the head. The
    image size comes from config.json."""

    def __init__(self, model_path: str, model_id: str = "siglip",
                 image_size: int = 384, backend: str = "jax",
                 dtype: str = "bfloat16",
                 attn_impl: str = "auto", device: str = "cuda"):
        _check_backend(backend)
        self.model_path = model_path
        self.model_id = model_id
        self.image_size = image_size
        self.backend = backend
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.model = None

    def create_dataset(self, items: List[Dict]):
        from smb_vision_tpu_torch.data.image2d import Image2DDataset

        return Image2DDataset(items, image_size=self.image_size)

    def _load_vision_config(self):
        """The checkpoint's config.json: a SiglipVisionConfig, or a
        SiglipConfig's nested vision_config."""
        from smb_vision_tpu_torch.models.configs import SiglipVisionConfig

        path = os.path.join(self.model_path, "config.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no config.json in {self.model_path}: SiglipEncoder needs "
                "a local HF checkpoint directory (zero-egress environments "
                "cannot pull from the hub)")
        with open(path) as fh:
            d = json.load(fh)
        cfg = SiglipVisionConfig.from_dict(d.get("vision_config", d))
        cfg.update({"dtype": self.dtype, "attn_impl": self.attn_impl})
        self.image_size = cfg.image_size
        return cfg

    def setup_model(self) -> None:
        # the config first, whatever the backend: the runner builds the
        # dataset after this, at the checkpoint's image size
        config = self._load_vision_config()
        if not config.vision_use_head:
            logger.warning(
                "%s has vision_use_head=False (no MAP pooling head): "
                "embeddings fall back to MEAN token pooling, a different "
                "embedding space from MAP-pooled checkpoints",
                self.model_path)
        if self.backend == "torch":
            try:
                from transformers import AutoModel
            except ImportError as e:
                raise RuntimeError("SiglipEncoder(backend='torch') needs "
                                   "transformers installed") from e
            model = AutoModel.from_pretrained(self.model_path,
                                              local_files_only=True)
            model = getattr(model, "vision_model", model)
            self.model = model.to(self.device).eval()
            return
        from smb_vision_tpu_torch.models.convert import (
            convert_hf_siglip,
            load_hf_checkpoint_numpy,
            params_from_flax,
        )
        from smb_vision_tpu_torch.models.siglip import SiglipVisionModel

        flat = convert_hf_siglip(load_hf_checkpoint_numpy(self.model_path),
                                 config.num_hidden_layers)
        if not flat:
            raise ValueError(
                f"no SigLIP vision tensors found in {self.model_path}")
        model = SiglipVisionModel(config)
        model.load_state_dict(params_from_flax(flat, whole=True))
        self.model = model.to(self.device).eval()

    def to_device(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch)).to(self.device)

    def encode(self, px: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) device pixels -> (N, hidden) float32 on the
        device: the pooled output, or the tokens' mean without a head."""
        with torch.inference_mode():
            if self.backend == "torch":
                out = self.model(pixel_values=px)
                tokens, pooled = out.last_hidden_state, out.pooler_output
            else:
                tokens, pooled = self.model(px)
            if pooled is None:
                return tokens.float().mean(dim=1)
            return pooled.float()

    def generate_embedding(self, batch) -> np.ndarray:
        return self.encode(self.to_device(batch)).cpu().numpy()


class MerlinEncoder(BaseEncoder):
    """Merlin's CT image embeddings (batch, tokens, dim). backend "jax":
    the first-party inflated-3D ResNet from `checkpoint`, a local torch
    state dict of the image tower (.pt / .safetensors; the
    `encode_image.i3_resnet.*` nesting is found, and the architecture is
    read from the weights' shapes). backend "torch": the external `merlin`
    package. Volumes go through the "merlin" CT pipeline, at target_size
    when given (the tower is fully convolutional)."""

    def __init__(self, model_id: str = "merlin",
                 checkpoint: Optional[str] = None, backend: str = "jax",
                 dtype: str = "bfloat16", target_size=None,
                 device: str = "cuda"):
        _check_backend(backend)
        self.model_id = model_id
        self.checkpoint = checkpoint
        self.backend = backend
        self.dtype = dtype
        self.target_size = target_size
        self.device = resolve_device(device)
        self.model = None
        self.config = None

    def pipeline(self):
        """The "merlin" CT pipeline, its grid replaced by target_size
        (every other field kept)."""
        from smb_vision_tpu_torch.data.preprocess import CT_PIPELINES

        pipe = CT_PIPELINES["merlin"]
        if self.target_size is not None:
            pipe = dataclasses.replace(pipe,
                                       target_size=tuple(self.target_size))
        return pipe

    def create_dataset(self, items: List[Dict], out_dtype: str = "float32",
                       cache_dir: Optional[str] = None):
        from smb_vision_tpu_torch.data.dataset import CTDataset

        norm = [{"image": it.get("image_path", it.get("image")), **it}
                for it in items]
        return CTDataset(items=norm, pipeline=self.pipeline(),
                         cache_dir=cache_dir, out_dtype=out_dtype,
                         device=self.device)

    def setup_model(self) -> None:
        if self.backend == "torch":
            try:
                import merlin  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "MerlinEncoder(backend='torch') needs the external "
                    "`merlin` package (https://github.com/StanfordMIMI/"
                    "Merlin); install it, or use backend='jax' with a "
                    "local image-encoder checkpoint") from e
            self.model = merlin.models.Merlin().to(self.device).eval()
            return
        if not self.checkpoint:
            raise ValueError(
                "MerlinEncoder(backend='jax') needs `checkpoint`: a local "
                "torch state dict (.pt/.safetensors) holding the Merlin "
                "image tower (i3d resnet); zero-egress environments "
                "cannot pull it from the hub")
        from smb_vision_tpu_torch.models.convert import (
            convert_torch_resnet3d,
            load_hf_checkpoint_numpy,
            params_from_flax,
            resnet3d_config_from_state_dict,
        )
        from smb_vision_tpu_torch.models.resnet3d import ResNet3D

        flat = load_hf_checkpoint_numpy(self.checkpoint)
        # the embedding surface: the tower only, never a classifier head
        cfg = resnet3d_config_from_state_dict(flat, num_labels=0,
                                              dtype=self.dtype)
        model = ResNet3D(cfg)
        model.load_state_dict(params_from_flax(
            convert_torch_resnet3d(flat, cfg), whole=True))
        self.model = model.to(self.device).eval()
        self.config = cfg

    def to_device(self, batch, scale=None, offset=None) -> torch.Tensor:
        """(N, C, a0, a1, a2) pixels to the device: float as they are,
        uint8 codes decoded there to bfloat16 with their per-volume
        affine."""
        from smb_vision_tpu_torch.data.quantization import dequantize_pixels

        px = torch.as_tensor(batch).to(self.device)
        if scale is None:
            return px
        return dequantize_pixels(
            px, torch.as_tensor(np.asarray(scale, np.float32)),
            torch.as_tensor(np.asarray(offset, np.float32)), torch.bfloat16)

    def encode(self, px: torch.Tensor) -> torch.Tensor:
        """Device pixels -> (N, L, hidden) float32 tokens on the device."""
        with torch.inference_mode():
            out = self.model(px)
            return (out[0] if isinstance(out, tuple) else out).float()

    def generate_embedding(self, batch, scale=None,
                           offset=None) -> np.ndarray:
        """batch (N, C, a0, a1, a2) float, or uint8 codes with per-volume
        `scale` and `offset` (backend "jax") -> (N, L, hidden) float32."""
        if scale is not None and self.backend == "torch":
            raise ValueError("uint8 affine shipping is a jax-backend "
                             "feature; backend='torch' takes float pixels")
        return self.encode(self.to_device(batch, scale, offset)).cpu().numpy()
