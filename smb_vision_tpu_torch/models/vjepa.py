"""V-JEPA2 for 3D volumes: the encoder, the predictor and the masked-L1
loss of pretraining.

Counterpart of `smb_vision_tpu/models/vjepa.py` (`apply_masks`,
`VJEPA2Encoder`, `VJEPA2Predictor`, `VJEPA2Model`, `vjepa_loss`). The
predictor has the JAX package's two paths: the dense one of training
(input = where(target, mask token, embed(encoder output)) over all N
tokens in their natural order, RoPE ids arange(N), no gather), and the
reference's index-list path (context and target index lists, stacked
(B*M) rows, RoPE ids from the lists). The RoPE tables are computed once
per forward and shared by every layer. Parameter names follow the JAX
tree (`encoder.patch_embed_kernel`, `encoder.encoder.layer_i.*`,
`encoder.layernorm`, `predictor.predictor_embeddings`,
`predictor.mask_tokens`, `predictor.stack.layer_i.*`,
`predictor.layernorm`, `predictor.proj`). Fine-tuning adds
`VJEPA2AttentivePooler` (self-attention layers over the tokens, then one
cross-attention from a learned query) and `VJEPA2ForVideoClassification`
(`vjepa2.encoder.*`, `pooler.*`, `classifier`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from smb_vision_tpu_torch.parallel.collectives import data_mean
from smb_vision_tpu_torch.models.configs import VJEPA2Config
from smb_vision_tpu_torch.models.layers import (
    Attention,
    Encoder,
    LayerNorm,
    Linear,
    Mlp,
    trunc_normal_,
)
from smb_vision_tpu_torch.models.videomae import (
    _init_,
    classification_loss,
    compute_dtype,
)
from smb_vision_tpu_torch.ops.patches import patch_embed
from smb_vision_tpu_torch.parallel.pipeline import PipeStages
from smb_vision_tpu_torch.ops.rope3d import rope3d_cos_sin


def apply_masks(x: torch.Tensor, masks: List[torch.Tensor]) -> torch.Tensor:
    """Gather token subsets: x (B, N, D) and a list of (B, L) index arrays
    -> (B*len(masks), L, D), the lists stacked on the batch axis."""
    return torch.cat([torch.gather(x, 1, m[..., None].expand(
        -1, -1, x.shape[-1])) for m in masks], dim=0)


def _stack(cfg: VJEPA2Config, dt, hidden: int, heads: int, layers: int,
           ratio: float, pipe: Optional[PipeStages] = None) -> Encoder:
    return Encoder(
        num_layers=layers, hidden_size=hidden, num_heads=heads,
        intermediate_size=int(hidden * ratio), act=cfg.hidden_act,
        bias_mode="qkv" if cfg.qkv_bias else "none",
        layer_norm_eps=cfg.layer_norm_eps,
        drop_path_rate=cfg.drop_path_rate, dtype=dt,
        attn_impl=cfg.attn_impl, mlp_impl=cfg.mlp_impl,
        glue_impl=cfg.glue_impl, fused_qkv=cfg.fused_qkv,
        remat=cfg.gradient_checkpointing,
        sequence_parallel=cfg.sequence_parallel, sp_variant=cfg.sp_variant,
        pipe=pipe)


class VJEPA2Encoder(nn.Module):
    """Tubelet embed + RoPE transformer stack + final LayerNorm: pixels
    (B, T, C, H, W) -> (B, N, hidden) in the compute dtype. pipe: the
    stack holds one pipeline stage's layers."""

    def __init__(self, config: VJEPA2Config,
                 pipe: Optional[PipeStages] = None):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        self.patch_embed_kernel = nn.Parameter(torch.empty(
            cfg.hidden_size, cfg.in_chans, cfg.tubelet_size, cfg.patch_size,
            cfg.patch_size))
        self.patch_embed_bias = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.encoder = _stack(cfg, dt, cfg.hidden_size,
                              cfg.num_attention_heads, cfg.num_hidden_layers,
                              cfg.mlp_ratio, pipe)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dt)

    def forward(self, pixel_values, generator=None):
        cfg = self.config
        x = patch_embed(pixel_values, self.patch_embed_kernel,
                        self.patch_embed_bias, dtype=self.dtype)
        ids = torch.arange(x.shape[1], device=x.device)
        rope = rope3d_cos_sin(ids, cfg.crop_size // cfg.patch_size,
                              cfg.head_dim, dtype=self.dtype)
        x = self.encoder(x, rope=rope, generator=generator)
        return self.layernorm(x)


class VJEPA2Predictor(nn.Module):
    """Narrow transformer that predicts the target tokens' encodings from
    the context's. pipe: the stack holds one pipeline stage's layers."""

    def __init__(self, config: VJEPA2Config,
                 pipe: Optional[PipeStages] = None):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        ph = cfg.pred_hidden_size
        self.predictor_embeddings = Linear(cfg.hidden_size, ph, True, dt)
        self.mask_tokens = nn.Parameter(
            torch.zeros(cfg.pred_num_mask_tokens, 1, 1, ph))
        self.stack = _stack(cfg, dt, ph, cfg.pred_num_attention_heads,
                            cfg.pred_num_hidden_layers, cfg.pred_mlp_ratio,
                            pipe)
        self.layernorm = LayerNorm(ph, cfg.layer_norm_eps, dt)
        self.proj = Linear(ph, cfg.hidden_size, True, dt)

    def forward(self, encoder_hidden_states, *, target_bool=None,
                context_mask: Optional[List[torch.Tensor]] = None,
                target_mask: Optional[List[torch.Tensor]] = None,
                mask_index: int = 1, generator=None):
        cfg, dt = self.config, self.dtype
        grid_hw = cfg.crop_size // cfg.patch_size
        mtok = self.mask_tokens[mask_index % cfg.pred_num_mask_tokens].to(dt)
        if target_bool is not None:
            # dense path: context = ~target, natural token order
            x = self.predictor_embeddings(encoder_hidden_states)
            x = torch.where(target_bool[..., None], mtok, x)
            ids = torch.arange(x.shape[1], device=x.device)
            rope = rope3d_cos_sin(ids, grid_hw, cfg.pred_head_dim, dtype=dt)
            x = self.stack(x, rope=rope, generator=generator)
            return self.proj(self.layernorm(x))
        # index-list path: context rows first, then the target rows
        ctx = self.predictor_embeddings(
            apply_masks(encoder_hidden_states, context_mask))
        n_ctx = ctx.shape[1]
        tm = torch.cat(target_mask, dim=0)                 # (B*M, Lt)
        cm = torch.cat(context_mask, dim=0)                # (B*M, Lc)
        tgt = mtok.expand(ctx.shape[0], tm.shape[1], -1)
        x = torch.cat([ctx, tgt], dim=1)
        rope = rope3d_cos_sin(torch.cat([cm, tm], dim=1), grid_hw,
                              cfg.pred_head_dim, dtype=dt)
        x = self.stack(x, rope=rope, generator=generator)
        return self.proj(self.layernorm(x)[:, n_ctx:])


class VJEPA2Model(nn.Module):
    """Encoder and predictor. forward returns a dict with
    `last_hidden_state`, and `predictor_output` unless skip_predictor: on
    the dense path (target_bool (B, N) bool, True = target) also
    `target_bool`; on the index-list path (context_mask / target_mask
    lists of (B, L) indices; both None: every token) also
    `masked_hidden_state` and `target_hidden_state`. generator draws the
    DropPath keep masks in training (encoder first, then predictor).
    predictor=False builds the encoder only (the classification backbone,
    which always skips the predictor). pipe: the encoder's and the
    predictor's stacks hold one pipeline stage's layers."""

    def __init__(self, config: VJEPA2Config, predictor: bool = True,
                 pipe: Optional[PipeStages] = None):
        super().__init__()
        self.config = config
        self.encoder = VJEPA2Encoder(config, pipe)
        self.predictor = (VJEPA2Predictor(config, pipe) if predictor
                          else None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Truncated normal (initializer_range) for the patch kernel and
        every Linear weight; zero biases; LayerNorm at identity; mask
        tokens zero, or truncated normal without
        pred_zero_init_mask_tokens."""
        cfg = self.config
        _init_(self, cfg.initializer_range, generator)
        if self.predictor is not None and not cfg.pred_zero_init_mask_tokens:
            trunc_normal_(self.predictor.mask_tokens, cfg.initializer_range,
                          generator)
        return self

    def forward(self, pixel_values, *, target_bool=None, context_mask=None,
                target_mask=None, skip_predictor: bool = False,
                mask_index: int = 1, generator=None) -> dict:
        if self.predictor is None and not skip_predictor:
            raise ValueError("this VJEPA2Model has no predictor: pass "
                             "skip_predictor=True")
        enc = self.encoder(pixel_values, generator=generator)
        out = {"last_hidden_state": enc}
        if target_bool is not None:
            out["target_bool"] = target_bool
            if not skip_predictor:
                out["predictor_output"] = self.predictor(
                    enc, target_bool=target_bool, mask_index=mask_index,
                    generator=generator)
            return out
        if context_mask is None and target_mask is None:
            b, n = enc.shape[:2]
            full = torch.arange(n, device=enc.device).expand(b, n)
            context_mask, target_mask = [full], [full]
        out["masked_hidden_state"] = apply_masks(enc, context_mask)
        out["target_hidden_state"] = apply_masks(enc, target_mask)
        if not skip_predictor:
            out["predictor_output"] = self.predictor(
                enc, context_mask=context_mask, target_mask=target_mask,
                mask_index=mask_index, generator=generator)
        return out


class VJEPA2AttentivePooler(nn.Module):
    """num_pooler_layers self-attention layers over the tokens (LN ->
    attention -> residual; LN -> MLP -> residual), then one cross-attention
    from a learned query: the keys and values are the LayerNormed tokens,
    the residual is the query, and the cross-attention has no output
    projection; then LN -> MLP -> residual. Returns (B, hidden)."""

    def __init__(self, config: VJEPA2Config):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        inter = int(h * cfg.mlp_ratio)

        def mlp():
            return Mlp(h, inter, act=cfg.hidden_act, dtype=dt,
                       mlp_impl=cfg.mlp_impl)

        for i in range(cfg.num_pooler_layers):
            self.add_module(f"self_layer_{i}_norm1", LayerNorm(h, eps, dt))
            self.add_module(f"self_layer_{i}_attn", Attention(
                h, cfg.num_attention_heads, "qkv", dtype=dt,
                attn_impl=cfg.attn_impl))
            self.add_module(f"self_layer_{i}_norm2", LayerNorm(h, eps, dt))
            self.add_module(f"self_layer_{i}_mlp", mlp())
        self.query_tokens = nn.Parameter(torch.zeros(1, 1, h))
        self.cross_norm1 = LayerNorm(h, eps, dt)
        # one query: the plain attention, as in the JAX package
        self.cross_attn = Attention(h, cfg.num_attention_heads, "qkv",
                                    dtype=dt, attn_impl="xla",
                                    out_proj=False)
        self.cross_norm2 = LayerNorm(h, eps, dt)
        self.cross_mlp = mlp()

    def forward(self, x):
        for i in range(self.config.num_pooler_layers):
            p = f"self_layer_{i}_"
            x = x + getattr(self, p + "attn")(getattr(self, p + "norm1")(x))
            x = x + getattr(self, p + "mlp")(getattr(self, p + "norm2")(x))
        q = self.query_tokens.to(self.dtype).expand(x.shape[0], -1, -1)
        h = q + self.cross_attn(q, kv=self.cross_norm1(x))
        h = h + self.cross_mlp(self.cross_norm2(h))
        return h[:, 0]


class VJEPA2ForVideoClassification(nn.Module):
    """The encoder, the attentive pooler and a float32 Linear head; the
    loss's problem type follows num_labels and the labels' dtype."""

    def __init__(self, config: VJEPA2Config):
        super().__init__()
        self.config = config
        self.vjepa2 = VJEPA2Model(config, predictor=False)
        self.pooler = VJEPA2AttentivePooler(config)
        self.classifier = Linear(config.hidden_size, config.num_labels, True,
                                 torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """As VJEPA2Model's, and a truncated normal query token."""
        _init_(self, self.config.initializer_range, generator)
        trunc_normal_(self.pooler.query_tokens, self.config.initializer_range,
                      generator)
        return self

    def forward(self, pixel_values, labels=None, generator=None) -> dict:
        enc = self.vjepa2(pixel_values, skip_predictor=True,
                          generator=generator)["last_hidden_state"]
        logits = self.classifier(self.pooler(enc).float())
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = classification_loss(
                logits, labels, self.config.num_labels, None)
        return out


def vjepa_loss(predictor_dense: torch.Tensor, teacher_enc: torch.Tensor,
               target_bool: torch.Tensor, valid=None) -> torch.Tensor:
    """Masked L1: mean |pred - teacher| over the target positions, in f32,
    over the global batch on a mesh (`parallel.collectives.data_mean`).
    valid: optional (B,) 0/1 row weights; rows of 0 (the Trainer's eval
    padding) leave both the sum and the target count."""
    diff = (predictor_dense.float() - teacher_enc.float()).abs()
    w = target_bool.to(torch.float32)
    if valid is not None:
        w = w * valid.to(torch.float32)[:, None]
    w = w[..., None]
    num = (diff * w).sum()
    den = w.sum() * diff.shape[-1]
    return data_mean(num, den, local=num / torch.clamp(den, min=1.0))
