"""The SigLIP vision tower: 2D X-ray embeddings for the encoder zoo.

Counterpart of `smb_vision_tpu/models/siglip.py`, the architecture of
transformers' SiglipVisionTransformer:

- a Conv2d patch embedding (stride == kernel: `ops.patches.patch_embed_2d`)
  plus learned position embeddings, no CLS token;
- the shared pre-LN `Encoder` (q/k/v and output biases, gelu-tanh MLP:
  act "gelu_new", which kernel K2 takes as its act 1), so the tower runs
  on the hand-written attention (K1) and MLP half-block (K2) kernels;
- a final post_layernorm;
- the MAP head: one learned probe cross-attends over the tokens (the
  plain attention, as the JAX head does for its one query), then LN and a
  residual MLP (plain under "auto"); the pooled output is the probe's.

Parameter names are the JAX package's (`patch_embedding`, `patch_bias`,
`position_embedding`, `encoder.layer_i...`, `post_layernorm`, `head.*`),
so `convert.params_from_flax` carries its weights across.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from smb_vision_tpu_torch.models.configs import SiglipVisionConfig
from smb_vision_tpu_torch.models.layers import (
    Attention,
    Encoder,
    LayerNorm,
    Mlp,
    trunc_normal_,
)
from smb_vision_tpu_torch.models.videomae import compute_dtype
from smb_vision_tpu_torch.ops.patches import patch_embed_2d

# HF's activation name: gelu_pytorch_tanh is the tanh-approximate gelu
_ACT_ALIASES = {"gelu_pytorch_tanh": "gelu_new"}


def _act(name: str) -> str:
    return _ACT_ALIASES.get(name, name)


class SiglipMAPHead(nn.Module):
    """Multihead-attention pooling (transformers
    SiglipMultiheadAttentionPoolingHead): the probe's cross-attention over
    the tokens, then LN and a residual MLP; returns (B, hidden)."""

    def __init__(self, config: SiglipVisionConfig, dtype: torch.dtype):
        super().__init__()
        cfg = config
        self.probe = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.attention = Attention(cfg.hidden_size, cfg.num_attention_heads,
                                   "qkv", dtype=dtype, attn_impl="xla")
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   dtype)
        # one row a sample: the plain MLP under "auto", as in the JAX head
        self.mlp = Mlp(cfg.hidden_size, cfg.intermediate_size,
                       act=_act(cfg.hidden_act), dtype=dtype,
                       mlp_impl="xla" if cfg.mlp_impl == "auto"
                       else cfg.mlp_impl)
        self.dtype = dtype

    def forward(self, x):
        probe = self.probe.expand(x.shape[0], -1, -1).to(self.dtype)
        h = self.attention(probe, kv=x)
        h = h + self.mlp(self.layernorm(h))
        return h[:, 0]


class SiglipVisionModel(nn.Module):
    """(B, C, H, W) pixels -> (last_hidden_state (B, N, hidden),
    pooler_output (B, hidden) or None without the head). H and W must be
    config.image_size (no position interpolation)."""

    def __init__(self, config: SiglipVisionConfig):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        h = cfg.hidden_size
        self.patch_embedding = nn.Parameter(torch.empty(
            h, cfg.num_channels, cfg.patch_size, cfg.patch_size))
        self.patch_bias = nn.Parameter(torch.zeros(h))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.seq_len, h))
        self.encoder = Encoder(
            num_layers=cfg.num_hidden_layers, hidden_size=h,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size, act=_act(cfg.hidden_act),
            bias_mode="qkv", layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
            attn_impl=cfg.attn_impl, mlp_impl=cfg.mlp_impl,
            glue_impl=cfg.glue_impl, remat=cfg.gradient_checkpointing)
        self.post_layernorm = LayerNorm(h, cfg.layer_norm_eps, dt)
        self.head = SiglipMAPHead(cfg, dt) if cfg.vision_use_head else None

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initialisers: lecun-normal patch kernel,
        truncated normal (0.02) for the positions, the probe and every
        Linear weight; zero biases; LayerNorms at identity."""
        fan_in = self.patch_embedding[0].numel()
        trunc_normal_(self.patch_embedding, (1.0 / fan_in) ** 0.5 / .87962566,
                      generator)
        for name, p in self.named_parameters():
            if name == "patch_embedding":
                continue
            if name in ("position_embedding", "head.probe") or (
                    name.endswith(".weight") and p.dim() == 2):
                trunc_normal_(p, 0.02, generator)
            elif "norm" in name and name.endswith(".weight"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, pixel_values
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg, dt = self.config, self.dtype
        h, w = pixel_values.shape[-2:]
        if (h, w) != (cfg.image_size, cfg.image_size):
            raise ValueError(
                f"input {h}x{w} != configured image_size {cfg.image_size} "
                "(fixed-shape contract; resize in the data pipeline)")
        x = patch_embed_2d(pixel_values, self.patch_embedding,
                           self.patch_bias, dtype=dt)
        x = (x.float() + self.position_embedding[None]).to(dt)
        x = self.post_layernorm(self.encoder(x))
        pooled = self.head(x) if self.head is not None else None
        return x, pooled
