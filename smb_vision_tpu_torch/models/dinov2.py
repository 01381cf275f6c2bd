"""DINOv2 over 3D volumes: the backbone and the classification model.

Counterpart of `smb_vision_tpu/models/dinov2.py`: a Conv3d patch embed over
(B, C, H, W, D) input (the dinov2 pipeline does not permute), with the
sequence in (h, w, d) order, depth fastest; an optional mask token that
replaces masked patch embeddings before the CLS token and the positions
are added; a CLS token and learned 3D position embeddings sized from the
config's grid; LayerScale blocks with an optional SwiGLU FFN (kernel K9
under mlp_impl "pallas"); and the cat[CLS, mean(patches)] -> Linear(2 x
hidden -> labels) head in float32. Parameter names follow the JAX tree
(`dinov2.patch_embed_kernel`, `dinov2.cls_token`,
`dinov2.position_embeddings_3d`, `dinov2.encoder.layer_i.*`,
`dinov2.layernorm`, `classifier`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from smb_vision_tpu_torch.models.configs import Dinov2Config
from smb_vision_tpu_torch.models.layers import (
    Encoder,
    LayerNorm,
    Linear,
    trunc_normal_,
)
from smb_vision_tpu_torch.models.videomae import (
    classification_loss,
    compute_dtype,
)
from smb_vision_tpu_torch.parallel.pipeline import PipeStages


def _patchify_chw(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W, D) -> (B, N, C*p^3): each patch vector in (c, dh, dw,
    dd) order, the sequence h-major with depth fastest (a Conv3d's
    flatten)."""
    b, c, h, w, d = pixel_values.shape
    p = patch
    x = pixel_values.reshape(b, c, h // p, p, w // p, p, d // p, p)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (h // p) * (w // p) * (d // p), c * p ** 3)


def _linear_resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize`'s linear method along one
    axis: half-pixel centres, the triangle kernel widened by in/out when
    shrinking (anti-aliasing), columns normalised to sum 1, and outputs
    whose sample falls outside the input zeroed."""
    inv = n_in / n_out
    widen = max(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    x = (f[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs()
    w = torch.clamp(1.0 - x / widen, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_position_embeddings_3d(pos: torch.Tensor,
                                  old_grid: Sequence[int],
                                  new_grid: Sequence[int]) -> torch.Tensor:
    """Trilinear resize of a (1, N+1, D) learned position table between
    patch grids, as `jax.image.resize(method="trilinear")` computes it; the
    CLS row passes through."""
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    d = pos.shape[-1]
    vol = patch_pos.reshape(*old_grid, d).double()
    wa, wb, wc = (_linear_resize_weights(a, b)
                  for a, b in zip(old_grid, new_grid))
    vol = torch.einsum("abcd,ax,by,cz->xyzd", vol, wa, wb, wc)
    vol = vol.reshape(1, -1, d).to(pos.dtype)
    return torch.cat([cls_pos, vol], dim=1)


class Dinov2Model(nn.Module):
    """Patch embed (+ mask token) + CLS + learned 3D positions + the
    transformer stack + the final LayerNorm: pixels (B, C, H, W, D) ->
    (B, 1 + seq_len, hidden) in the compute dtype. pipe: the stack holds
    one pipeline stage's layers (`models/pipelined.py`)."""

    def __init__(self, config: Dinov2Config,
                 pipe: Optional[PipeStages] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = compute_dtype(cfg)
        h, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed_kernel = nn.Parameter(
            torch.empty(h, cfg.num_channels, p, p, p))
        self.patch_embed_bias = nn.Parameter(torch.zeros(h))
        self.mask_token = (nn.Parameter(torch.zeros(1, h))
                           if cfg.use_mask_token else None)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.position_embeddings_3d = nn.Parameter(
            torch.zeros(1, cfg.seq_len + 1, h))
        self.encoder = Encoder(
            num_layers=cfg.num_hidden_layers, hidden_size=h,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size, act=cfg.hidden_act,
            # q, k and v all carry a bias in DINOv2
            bias_mode="qkv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps,
            layerscale_value=cfg.layerscale_value,
            drop_path_rate=cfg.drop_path_rate,
            use_swiglu=cfg.use_swiglu_ffn, dtype=self.dtype,
            attn_impl=cfg.attn_impl, mlp_impl=cfg.mlp_impl,
            glue_impl=cfg.glue_impl, fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing, pipe=pipe)
        self.layernorm = LayerNorm(h, cfg.layer_norm_eps, self.dtype)

    def forward(self, pixel_values, bool_masked_pos=None, generator=None):
        """bool_masked_pos: optional (B, seq_len) bool, True where the
        patch embedding is replaced by the mask token; generator draws the
        DropPath keep masks in training."""
        cfg, dt = self.config, self.dtype
        patches = _patchify_chw(pixel_values, cfg.patch_size)
        wmat = self.patch_embed_kernel.reshape(cfg.hidden_size, -1).t()
        x = torch.matmul(patches.to(dt), wmat.to(dt)).float()
        x = (x + self.patch_embed_bias.float()).to(dt)
        if bool_masked_pos is not None:
            if self.mask_token is None:
                raise ValueError("bool_masked_pos given but use_mask_token "
                                 "is False in the config")
            x = torch.where(bool_masked_pos[..., None],
                            self.mask_token[None].to(dt), x)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings_3d.to(dt)
        x = self.encoder(x, generator=generator)
        return self.layernorm(x)


def init_dinov2_(module: nn.Module, config: Dinov2Config,
                 generator: Optional[torch.Generator]) -> None:
    """The JAX package's initialisers: truncated normal (initializer_range)
    for the patch kernel and every Linear weight, N(0, 1) for the CLS token
    and the position table, LayerScale at layerscale_value, LayerNorm at
    identity, zero biases and mask token."""
    for name, p in module.named_parameters():
        if name.endswith("patch_embed_kernel") or (
                name.endswith(".weight") and p.dim() == 2):
            trunc_normal_(p, config.initializer_range, generator)
        elif name.endswith(("cls_token", "position_embeddings_3d")):
            p.normal_(0.0, 1.0, generator=generator)
        elif name.endswith(("layerscale1", "layerscale2")):
            p.fill_(config.layerscale_value)
        elif "norm" in name and name.endswith(".weight"):
            p.fill_(1.0)
        else:
            p.zero_()


class Dinov2ForImageClassification(nn.Module):
    """The backbone, then logits = classifier(cat[CLS, mean(patches)]) in
    float32, and the loss of config.problem_type when labels are given."""

    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.config = config
        self.dinov2 = Dinov2Model(config)
        self.classifier = Linear(2 * config.hidden_size, config.num_labels,
                                 True, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        init_dinov2_(self, self.config, generator)
        return self

    def forward(self, pixel_values, labels=None, generator=None) -> dict:
        cfg = self.config
        seq = self.dinov2(pixel_values, generator=generator)
        pooled = torch.cat([seq[:, 0], seq[:, 1:].mean(dim=1)], dim=-1)
        logits = self.classifier(pooled.float())
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = classification_loss(logits, labels, cfg.num_labels,
                                              cfg.problem_type)
        return out
