"""Model configurations.

Counterpart of `smb_vision_tpu/models/configs.py`. Field names mirror the
HuggingFace configs, so JSON config files written by the JAX package load
here unchanged (keys the port has no field for are ignored): VideoMAE,
V-JEPA2, the 3D DINOv2, the SigLIP vision tower and Merlin's inflated-3D
ResNet.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class BaseConfig:
    def update(self, updates: dict) -> "BaseConfig":
        """HF-style in-place update; unknown keys are ignored."""
        names = {f.name for f in dataclasses.fields(self)}
        for k, v in updates.items():
            if k in names:
                setattr(self, k, v)
        return self

    def apply_overrides(self, overrides: Optional[str]) -> "BaseConfig":
        """A CLI's --config_overrides: a comma list of key=value, each value
        read as JSON where it parses (else kept as a string)."""
        for kv in (overrides or "").split(","):
            if not kv:
                continue
            k, v = kv.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            self.update({k.strip(): v})
        return self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_type"] = getattr(self, "model_type", "")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BaseConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "BaseConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)


@dataclass
class VideoMAEConfig(BaseConfig):
    """3D ViT over CT volumes: depth as frames, with tubelet_size ==
    patch_size giving cubic patches."""

    model_type: str = "videomae"

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 1
    num_frames: int = 160          # volume depth
    tubelet_size: int = 16

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0           # read by neither model
    attention_probs_dropout_prob: float = 0.0  # read by neither model
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    use_mean_pooling: bool = True

    # decoder (pretraining)
    decoder_num_attention_heads: int = 6
    decoder_hidden_size: int = 384
    decoder_num_hidden_layers: int = 4
    decoder_intermediate_size: int = 1536
    norm_pix_loss: bool = True

    # classification head
    num_labels: int = 2
    problem_type: Optional[str] = None
    additional_features_size: int = 0

    # framework knobs (not in the HF config)
    dtype: str = "bfloat16"         # compute dtype
    # attention: auto | pallas | pallas_i8bwd | pallas_int8 | pallas_int8pv
    # | xla ("pallas*" name the hand-written kernels, as in the JAX package)
    attn_impl: str = "auto"
    mlp_impl: str = "auto"          # auto | pallas | pallas_bwd | xla
    glue_impl: str = "auto"         # "pallas": glue kernels K10a/K10b
    fused_qkv: bool = False         # one q/k/v product (plain)
    gradient_checkpointing: bool = False   # remat each block in training
    # tokens split over the mesh's model axis (parallel/context.py)
    sequence_parallel: bool = False
    sp_variant: str = "gather"      # gather (all-gather kv) | ring
    # W8A8 transformer projections (ops/quant.py; inference only: the
    # quantisation round is not differentiable)
    quant8: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(T', H', W') patch grid; token index t*H'*W' + h*W' + w."""
        return (
            self.num_frames // self.tubelet_size,
            self.image_size // self.patch_size,
            self.image_size // self.patch_size,
        )

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.tubelet_size * self.patch_size ** 2


@dataclass
class VJEPA2Config(BaseConfig):
    """V-JEPA2 (encoder + predictor) over 3D volumes: depth as frames,
    and run_vjepa sets in_chans=1 and tubelet_size=patch_size."""

    model_type: str = "vjepa2"

    patch_size: int = 16
    crop_size: int = 256
    frames_per_clip: int = 64
    tubelet_size: int = 2
    in_chans: int = 3

    hidden_size: int = 1024
    num_attention_heads: int = 16
    num_hidden_layers: int = 24
    drop_path_rate: float = 0.0
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    attention_probs_dropout_prob: float = 0.0  # read by no model
    hidden_act: str = "gelu"
    initializer_range: float = 0.02
    attention_dropout: float = 0.0             # read by no model
    num_pooler_layers: int = 3                 # attentive pooler depth

    # predictor
    pred_hidden_size: int = 384
    pred_num_attention_heads: int = 12
    pred_num_hidden_layers: int = 12
    pred_num_mask_tokens: int = 10
    pred_zero_init_mask_tokens: bool = True
    pred_mlp_ratio: float = 4.0

    # classification
    num_labels: int = 2

    # framework knobs, as VideoMAEConfig's
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    mlp_impl: str = "auto"
    glue_impl: str = "auto"         # "pallas": glue kernels K10a/K10b
    fused_qkv: bool = False         # one q/k/v product (plain)
    gradient_checkpointing: bool = False
    # tokens split over the mesh's model axis (parallel/context.py)
    sequence_parallel: bool = False
    sp_variant: str = "gather"      # gather (all-gather kv) | ring

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(T', H', W') patch grid; token index t*H'*W' + h*W' + w."""
        g = self.crop_size // self.patch_size
        return (self.frames_per_clip // self.tubelet_size, g, g)

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pred_head_dim(self) -> int:
        return self.pred_hidden_size // self.pred_num_attention_heads


@dataclass
class Dinov2Config(BaseConfig):
    """DINOv2 over 3D volumes: a Conv3d patch embed of (B, C, H, W, D)
    input, a CLS token, learned 3D position embeddings sized from the
    grid, LayerScale blocks with an optional SwiGLU FFN."""

    model_type: str = "dinov2"

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 1
    depth: int = 160                # volume depth

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0           # read by no model
    attention_probs_dropout_prob: float = 0.0  # read by no model
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    layerscale_value: float = 1.0
    drop_path_rate: float = 0.0
    use_swiglu_ffn: bool = False
    use_mask_token: bool = True     # the masked-embedding path

    num_labels: int = 2
    problem_type: Optional[str] = None
    additional_features_size: int = 0  # the DINOv2 head fuses none

    # framework knobs, as VideoMAEConfig's ("pallas" with use_swiglu_ffn:
    # the SwiGLU half-block kernel K9)
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    mlp_impl: str = "auto"
    glue_impl: str = "auto"         # "pallas": glue kernels K10a/K10b
    fused_qkv: bool = False         # one q/k/v product (plain)
    gradient_checkpointing: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(H', W', D') patch grid: the token order is h-major with depth
        FASTEST, token index h*W'*D' + w*D' + d (unlike VideoMAE's)."""
        return (self.image_size // self.patch_size,
                self.image_size // self.patch_size,
                self.depth // self.patch_size)

    @property
    def seq_len(self) -> int:
        """Patches; the CLS token comes on top."""
        h, w, d = self.grid
        return h * w * d

    @property
    def intermediate_size(self) -> int:
        """The FFN width: mlp_ratio x hidden, or for SwiGLU 2/3 of it
        rounded up to a multiple of 8."""
        if self.use_swiglu_ffn:
            return (int(self.hidden_size * self.mlp_ratio * 2 / 3) + 7) \
                // 8 * 8
        return self.hidden_size * self.mlp_ratio


@dataclass
class SiglipVisionConfig(BaseConfig):
    """The SigLIP vision tower (2D X-ray embeddings). Field names mirror
    transformers.SiglipVisionConfig, so an HF config.json (or its nested
    vision_config) loads as is; defaults are SigLIP-base-patch16-384."""

    model_type: str = "siglip_vision_model"

    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    attention_dropout: float = 0.0
    # the MAP pooling head (a probe's cross-attention and an MLP)
    vision_use_head: bool = True

    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    mlp_impl: str = "auto"
    glue_impl: str = "auto"
    gradient_checkpointing: bool = False

    @property
    def grid(self) -> Tuple[int, int]:
        g = self.image_size // self.patch_size
        return (g, g)

    @property
    def seq_len(self) -> int:
        h, w = self.grid
        return h * w


@dataclass
class ResNet3DConfig(BaseConfig):
    """The inflated-3D (I3D) ResNet of Merlin's image tower (ResNet-152 by
    default). The three volume axes are (a0, a1, a2) in checkpoint order,
    (H, W, D) = (224, 224, 160) for the "merlin" CT pipeline. Axis-0
    kernel sizes are read from a checkpoint's shapes
    (`convert.resnet3d_config_from_state_dict`); axis-0 strides cannot be,
    so they are fields with the I3D defaults: the stem and pool follow the
    spatial stride, and a stage's downsampling stride applies to axis 0
    with temporal_downsample."""

    model_type: str = "resnet3d"

    num_channels: int = 1
    # bottleneck blocks per stage; (3, 8, 36, 3) is ResNet-152
    stage_sizes: Tuple[int, ...] = (3, 8, 36, 3)
    base_width: int = 64            # stem channels; stage i has base * 2^i
    expansion: int = 4              # a bottleneck's out = width * expansion

    # stem: conv (stem_kernel_t, 7, 7) stride (stem_stride_t, 2, 2), k//2
    # padding, then max-pool (pool_kernel_t, 3, 3) stride
    # (pool_stride_t, 2, 2) padding (pool_kernel_t//2, 1, 1)
    stem_kernel_t: int = 7
    stem_stride_t: int = 2
    pool_kernel_t: int = 3
    pool_stride_t: int = 2
    conv2_kernel_t: int = 3
    temporal_downsample: bool = True

    bn_eps: float = 1e-5

    num_labels: int = 0             # 0: no classifier head (an encoder)

    dtype: str = "bfloat16"

    @property
    def hidden_size(self) -> int:
        return self.base_width * (2 ** (len(self.stage_sizes) - 1)) \
            * self.expansion
