"""VideoMAE-3D encoder.

Counterpart of `smb_vision_tpu/models/videomae.py::VideoMAEModel`, the
unmasked branch (batch embedding). The masked branch, the pretraining
decoder and the classification head belong to later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.layers import (
    Encoder,
    LayerNorm,
    not_ported,
    trunc_normal_,
)
from smb_vision_tpu_torch.ops.patches import patch_embed, sincos_position_table


def compute_dtype(config: VideoMAEConfig) -> torch.dtype:
    dt = getattr(torch, str(config.dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown compute dtype {config.dtype!r}")
    return dt


class VideoMAEModel(nn.Module):
    """Patch embed + sincos positions + transformer stack. Input
    (B, T, C, H, W) pixels; output (B, seq_len, hidden) in the compute
    dtype, and None in place of the JAX model's token order (which only
    the masked branch produces)."""

    def __init__(self, config: VideoMAEConfig):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        self.patch_embed_kernel = nn.Parameter(torch.empty(
            cfg.hidden_size, cfg.num_channels, cfg.tubelet_size,
            cfg.patch_size, cfg.patch_size))
        self.patch_embed_bias = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.register_buffer(
            "pos", sincos_position_table(cfg.seq_len, cfg.hidden_size),
            persistent=False)
        self.encoder = Encoder(
            num_layers=cfg.num_hidden_layers, hidden_size=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size, act=cfg.hidden_act,
            bias_mode="qv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
            attn_impl=cfg.attn_impl, mlp_impl=cfg.mlp_impl,
            glue_impl=cfg.glue_impl, fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing, quant8=cfg.quant8,
            sequence_parallel=cfg.sequence_parallel)
        self.layernorm = (None if cfg.use_mean_pooling
                          else LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         dt))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Truncated normal (initializer_range) for the patch kernel and
        every Linear weight; zero biases; LayerNorm at identity."""
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name == "patch_embed_kernel" or (
                    name.endswith(".weight") and p.dim() == 2):
                trunc_normal_(p, std, generator)
            elif "norm" in name and name.endswith(".weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, pixel_values, bool_masked_pos=None):
        if bool_masked_pos is not None:
            raise not_ported("the masked (MIM) branch of VideoMAEModel",
                             "queue 1, MIM slice")
        x = patch_embed(pixel_values, self.patch_embed_kernel,
                        self.patch_embed_bias, dtype=self.dtype)
        x = x + self.pos.to(self.dtype)
        x = self.encoder(x)
        if self.layernorm is not None:
            x = self.layernorm(x)
        return x, None
