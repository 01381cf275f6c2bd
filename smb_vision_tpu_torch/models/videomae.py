"""VideoMAE-3D: the encoder, masked-image-modeling pretraining and the
classification model.

Counterpart of `smb_vision_tpu/models/videomae.py`: `VideoMAEModel` (both
branches: every token for batch embedding, the visible tokens only for
MIM), `VideoMAEForPreTraining` (encoder on the visible tokens, a narrow
decoder over the whole sequence, MSE on the per-patch-normalised pixels of
the masked patches), `VideoMAEForVideoClassification` (mean-pool,
`fc_norm`, tabular features fused at the head) and the fine-tuning losses
`classification_loss` (cross-entropy, BCE, MSE by problem type).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from smb_vision_tpu_torch.parallel.collectives import data_mean
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.layers import (
    Encoder,
    LayerNorm,
    Linear,
    trunc_normal_,
)
from smb_vision_tpu_torch.parallel.pipeline import PipeStages
from smb_vision_tpu_torch.ops.patches import (
    extract_patches,
    normalize_pixel_targets,
    patch_embed,
    sincos_position_table,
)


def compute_dtype(config: VideoMAEConfig) -> torch.dtype:
    dt = getattr(torch, str(config.dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown compute dtype {config.dtype!r}")
    return dt


def _init_(module: nn.Module, std: float,
           generator: Optional[torch.Generator]) -> None:
    """Truncated normal (std) for patch kernels, mask tokens and every
    Linear weight; zero biases; LayerNorm at identity."""
    for name, p in module.named_parameters():
        if name.endswith(("patch_embed_kernel", "mask_token")) or (
                name.endswith(".weight") and p.dim() == 2):
            trunc_normal_(p, std, generator)
        elif "norm" in name and name.endswith(".weight"):
            p.fill_(1.0)
        else:
            p.zero_()


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D) rows idx (B, n) -> (B, n, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class VideoMAEModel(nn.Module):
    """Patch embed + sincos positions + transformer stack. Input
    (B, T, C, H, W) pixels. Unmasked: output (B, seq_len, hidden) in the
    compute dtype and None. With bool_masked_pos (B, seq_len) and
    num_masked, the exact masked count per sample: only the visible tokens
    are encoded, (B, seq_len - num_masked, hidden), and the token order
    (B, seq_len), visible tokens first, is returned for the decoder. pipe:
    the encoder holds one pipeline stage's layers (`parallel/pipeline.py`,
    `models/pipelined.py`)."""

    def __init__(self, config: VideoMAEConfig,
                 pipe: Optional[PipeStages] = None):
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
            sequence_parallel=cfg.sequence_parallel,
            sp_variant=cfg.sp_variant, pipe=pipe)
        self.layernorm = (None if cfg.use_mean_pooling
                          else LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         dt))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Truncated normal (initializer_range) for the patch kernel and
        every Linear weight; zero biases; LayerNorm at identity."""
        _init_(self, self.config.initializer_range, generator)
        return self

    def forward(self, pixel_values, bool_masked_pos=None,
                num_masked: int = 0, generator=None):
        cfg, dt = self.config, self.dtype
        order = None
        if bool_masked_pos is not None and num_masked > 0:
            # stable sort: visible tokens first in their original order,
            # as boolean indexing with ~mask; the pixel patches (which need
            # no gradient) are gathered before the embed product, so it
            # runs on the visible rows only
            n = cfg.seq_len
            order = torch.argsort(bool_masked_pos.to(torch.int32), dim=-1,
                                  stable=True)
            vis_idx = order[:, :n - num_masked]
            patches = extract_patches(pixel_values, cfg.tubelet_size,
                                      cfg.patch_size, channel_major=True)
            patches = _gather_rows(patches.detach(), vis_idx)
            wmat = self.patch_embed_kernel.reshape(cfg.hidden_size, -1).t()
            x = torch.matmul(patches.to(dt), wmat.to(dt)).float()
            x = (x + self.patch_embed_bias.float()).to(dt)
            pos = self.pos.to(dt).expand(x.shape[0], -1, -1)
            x = x + _gather_rows(pos, vis_idx)
        else:
            x = patch_embed(pixel_values, self.patch_embed_kernel,
                            self.patch_embed_bias, dtype=dt)
            x = x + self.pos.to(dt)
        x = self.encoder(x, generator=generator)
        if self.layernorm is not None:
            x = self.layernorm(x)
        return x, order


class VideoMAEForPreTraining(nn.Module):
    """SimMIM-style pretraining: encode the visible tokens, map them to the
    decoder width, re-insert a learned mask token (plus the decoder's
    sincos positions) at the masked places, run the decoder over the whole
    sequence, project the masked tokens to pixels and take the MSE against
    the per-patch-normalised pixels of the masked patches. Parameter names
    follow the JAX model's tree (`videomae.*`, `encoder_to_decoder`,
    `mask_token`, `decoder.layer_i.*`, `decoder_norm`, `decoder_head`).
    pipe: both stacks hold one pipeline stage's layers."""

    def __init__(self, config: VideoMAEConfig,
                 pipe: Optional[PipeStages] = None):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        dh = cfg.decoder_hidden_size
        self.videomae = VideoMAEModel(cfg, pipe)
        self.encoder_to_decoder = Linear(cfg.hidden_size, dh, False, dt)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dh))
        self.register_buffer("pos_dec", sincos_position_table(
            cfg.seq_len, dh), persistent=False)
        self.decoder = Encoder(
            num_layers=cfg.decoder_num_hidden_layers, hidden_size=dh,
            num_heads=cfg.decoder_num_attention_heads,
            intermediate_size=cfg.decoder_intermediate_size,
            act=cfg.hidden_act, bias_mode="qv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
            attn_impl=cfg.attn_impl, mlp_impl=cfg.mlp_impl,
            glue_impl=cfg.glue_impl, fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing, quant8=cfg.quant8,
            sequence_parallel=cfg.sequence_parallel,
            sp_variant=cfg.sp_variant, pipe=pipe)
        self.decoder_norm = LayerNorm(dh, cfg.layer_norm_eps, dt)
        self.decoder_head = Linear(dh, cfg.patch_dim, True, dt)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        _init_(self, self.config.initializer_range, generator)
        return self

    def forward(self, pixel_values, bool_masked_pos, num_masked: int,
                valid=None):
        """valid: optional (B,) 0/1 row weights: rows of 0 (the Trainer's
        eval padding) stay out of the loss mean."""
        cfg, dt = self.config, self.dtype
        b = pixel_values.shape[0]
        n = cfg.seq_len
        enc, order = self.videomae(pixel_values, bool_masked_pos, num_masked)
        x = self.encoder_to_decoder(enc)
        vis_idx, mask_idx = order[:, :n - num_masked], order[:, n - num_masked:]
        pos = self.pos_dec.to(dt).expand(b, -1, -1)
        x = torch.cat([x + _gather_rows(pos, vis_idx),
                       self.mask_token.to(dt) + _gather_rows(pos, mask_idx)],
                      dim=1)
        x = self.decoder(x)
        h = self.decoder_norm(x[:, -num_masked:])
        logits = self.decoder_head(h)

        # labels: the masked patches' pixels, per-patch normalised after
        # the gather (normalisation is per row); no gradient
        with torch.no_grad():
            patches = extract_patches(pixel_values, cfg.tubelet_size,
                                      cfg.patch_size,
                                      channel_major=cfg.num_channels == 1)
            labels = _gather_rows(patches, mask_idx)
            labels = (normalize_pixel_targets(labels) if cfg.norm_pix_loss
                      else labels.float())
        sq = (logits.float() - labels) ** 2
        loss = (data_mean(sq.sum(), sq.new_tensor(float(sq.numel())),
                          local=sq.mean()) if valid is None
                else row_weighted_mean(sq.mean(dim=(1, 2)), valid))
        return {"loss": loss, "logits": logits}


class VideoMAEForVideoClassification(nn.Module):
    """Mean-pool over the tokens + fc_norm (LayerNorm, eps 1e-5), or the
    first token without mean pooling; the tabular features concatenated
    after it; a Linear head in the compute dtype; float32 logits."""

    def __init__(self, config: VideoMAEConfig):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        self.videomae = VideoMAEModel(cfg)
        self.fc_norm = (LayerNorm(cfg.hidden_size, 1e-5, dt)
                        if cfg.use_mean_pooling else None)
        self.classifier = Linear(
            cfg.hidden_size + cfg.additional_features_size, cfg.num_labels,
            True, dt)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        _init_(self, self.config.initializer_range, generator)
        return self

    def forward(self, pixel_values, additional_features=None, labels=None,
                generator=None) -> dict:
        cfg = self.config
        enc, _ = self.videomae(pixel_values, generator=generator)
        pooled = (self.fc_norm(enc.mean(dim=1)) if self.fc_norm is not None
                  else enc[:, 0])
        width = (0 if additional_features is None
                 else additional_features.shape[-1])
        if width != cfg.additional_features_size:
            raise ValueError(f"expected additional_features of size "
                             f"{cfg.additional_features_size}, got {width}")
        if additional_features is not None:
            pooled = torch.cat(
                [pooled, additional_features.to(pooled.dtype)], dim=-1)
        logits = self.classifier(pooled).float()
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = classification_loss(logits, labels, cfg.num_labels,
                                              cfg.problem_type)
        return out


def classification_loss(logits, labels, num_labels: int,
                        problem_type: Optional[str], valid=None):
    """Mean loss of the problem type: "regression" (MSE),
    "single_label_classification" (cross-entropy on integer labels),
    "multi_label_classification" (BCE with logits); None infers it from
    num_labels and the labels' dtype. valid: optional (B,) 0/1 row
    weights; rows of 0 (the Trainer's eval padding) leave the mean."""
    if problem_type is None:
        integer = not (labels.dtype.is_floating_point
                       or labels.dtype == torch.bool)
        problem_type = ("regression" if num_labels == 1 else
                        "single_label_classification" if integer
                        else "multi_label_classification")
    logits = logits.float()
    if problem_type == "regression":
        labels = labels.float()
        if num_labels == 1:
            row = (logits.squeeze(-1) - labels.squeeze()) ** 2
        else:
            row = ((logits - labels) ** 2).mean(dim=-1)
    elif problem_type == "single_label_classification":
        logp = torch.log_softmax(logits, dim=-1)
        row = -logp.gather(-1, labels.long()[:, None])[:, 0]
    elif problem_type == "multi_label_classification":
        labels = labels.float()
        row = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs()))).mean(dim=-1)
    else:
        raise ValueError(f"unknown problem_type {problem_type}")
    return row_weighted_mean(row, valid)


def row_weighted_mean(row: torch.Tensor, valid) -> torch.Tensor:
    """Mean of per-row losses over the valid rows (valid=None: all), over
    the global batch on a mesh (`parallel.collectives.data_mean`)."""
    if valid is None:
        return data_mean(row.sum(), row.new_tensor(float(row.numel())),
                         local=row.mean())
    v = valid.to(torch.float32)
    return data_mean((row * v).sum(), v.sum(),
                     local=(row * v).sum() / torch.clamp(v.sum(), min=1.0))
