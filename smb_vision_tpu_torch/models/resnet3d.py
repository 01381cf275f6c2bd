"""The inflated-3D (I3D) ResNet of Merlin's CT image tower.

Counterpart of `smb_vision_tpu/models/resnet3d.py`, in NCDHW with
`F.conv3d` (cuDNN on the card; the JAX tower's convolutions are XLA ops,
not Pallas kernels):

- torch-conv geometry: symmetric k//2 padding per axis, the stride on the
  bottleneck's 3x3 (ResNet v1.5), so torchvision-schema checkpoints
  convert weight for weight (`convert.convert_torch_resnet3d`);
- the stem's max-pool pads with -inf, as flax's `max_pool` does;
- frozen BatchNorm: the running statistics and the affine are buffers,
  applied as one multiply-add in float32; they get no gradient and no
  weight decay (`train.optim.is_decayed` exempts `.bn.`);
- parameters float32, convolutions in the compute dtype.

Names are the JAX package's (`stem.conv`, `stem.bn`, `layer{i}_{j}.cb{c}`,
`layer{i}_{j}.downsample`, `head`): a conv's `weight` is the torch
(O, I, k0, k1, k2) layout of the JAX (k0, k1, k2, I, O) `kernel`, a BN's
`weight` its `scale`, so `convert.params_from_flax` carries them across.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from smb_vision_tpu_torch.models.configs import ResNet3DConfig
from smb_vision_tpu_torch.models.videomae import compute_dtype


def _pad3(k: Tuple[int, int, int]) -> Tuple[int, int, int]:
    return tuple(d // 2 for d in k)


class FrozenBatchNorm(nn.Module):
    """Inference-form BatchNorm: (x - mean) * weight / sqrt(var + eps) +
    bias, folded into one multiply-add in float32, output in the compute
    dtype. weight, bias, mean and var are buffers."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.var + self.eps)
        shift = self.bias - self.mean * inv
        shape = (1, -1, 1, 1, 1)
        return (x.float() * inv.reshape(shape)
                + shift.reshape(shape)).to(self.dtype)


class ConvBN(nn.Module):
    """conv3d (no bias, k//2 padding) -> frozen BN."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, int, int],
                 stride=(1, 1, 1), eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, kernel, stride=stride,
                              padding=_pad3(kernel), bias=False)
        self.bn = FrozenBatchNorm(features, eps, dtype)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return self.bn(F.conv3d(x.to(dt), self.conv.weight.to(dt),
                                stride=self.conv.stride,
                                padding=self.conv.padding))


class Bottleneck3D(nn.Module):
    """1x1x1 reduce -> (k_t, 3, 3) conv carrying the stride -> 1x1x1
    expand, the residual identity or projected, ReLU after the add."""

    def __init__(self, cin: int, width: int, stride, conv2_kernel_t: int,
                 expansion: int, eps: float, dtype: torch.dtype,
                 project: bool):
        super().__init__()
        out_f = width * expansion
        self.cb1 = ConvBN(cin, width, (1, 1, 1), eps=eps, dtype=dtype)
        self.cb2 = ConvBN(width, width, (conv2_kernel_t, 3, 3), stride,
                          eps=eps, dtype=dtype)
        self.cb3 = ConvBN(width, out_f, (1, 1, 1), eps=eps, dtype=dtype)
        self.downsample = (ConvBN(cin, out_f, (1, 1, 1), stride, eps=eps,
                                  dtype=dtype) if project else None)

    def forward(self, x):
        h = F.relu(self.cb1(x))
        h = F.relu(self.cb2(h))
        h = self.cb3(h)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


class ResNet3D(nn.Module):
    """(B, C, a0, a1, a2) pixels -> (tokens (B, L, hidden): the last
    stage's map flattened in (a0, a1, a2) order with channels last;
    pooled (B, hidden) float32, their mean) and, with num_labels > 0, the
    head's float32 logits."""

    def __init__(self, config: ResNet3DConfig):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        self.stem = ConvBN(cfg.num_channels, cfg.base_width,
                           (cfg.stem_kernel_t, 7, 7),
                           (cfg.stem_stride_t, 2, 2), cfg.bn_eps, dt)
        self.blocks = []
        cin = cfg.base_width
        for i, n_blocks in enumerate(cfg.stage_sizes):
            width = cfg.base_width * 2 ** i
            sp = 1 if i == 0 else 2
            st = sp if cfg.temporal_downsample else 1
            for j in range(n_blocks):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, Bottleneck3D(
                    cin, width, (st, sp, sp) if j == 0 else (1, 1, 1),
                    cfg.conv2_kernel_t, cfg.expansion, cfg.bn_eps, dt,
                    project=j == 0))
                self.blocks.append(name)
                cin = width * cfg.expansion
        self.head = (nn.Linear(cfg.hidden_size, cfg.num_labels)
                     if cfg.num_labels > 0 else None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's defaults: lecun-normal conv kernels and head, zero head
        bias; BN at identity."""
        for name, p in self.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                nn.init.trunc_normal_(
                    p, std=(1.0 / fan_in) ** 0.5 / .87962566,
                    a=-2 * (1.0 / fan_in) ** 0.5 / .87962566,
                    b=2 * (1.0 / fan_in) ** 0.5 / .87962566,
                    generator=generator)
            else:
                p.zero_()
        return self

    def forward(self, pixel_values):
        cfg = self.config
        if pixel_values.ndim != 5:
            raise ValueError(f"expected (B, C, a0, a1, a2) pixels, got "
                             f"{tuple(pixel_values.shape)}")
        x = F.relu(self.stem(pixel_values))
        pk, ps = cfg.pool_kernel_t, cfg.pool_stride_t
        pad = _pad3((pk, 3, 3))
        # -inf padding (flax max_pool): pad explicitly, then pool unpadded
        x = F.pad(x, (pad[2], pad[2], pad[1], pad[1], pad[0], pad[0]),
                  value=float("-inf"))
        x = F.max_pool3d(x, (pk, 3, 3), stride=(ps, 2, 2))
        for name in self.blocks:
            x = getattr(self, name)(x)
        b = x.shape[0]
        tokens = x.permute(0, 2, 3, 4, 1).reshape(b, -1, cfg.hidden_size)
        pooled = tokens.float().mean(dim=1)
        if self.head is not None:
            return tokens, pooled, self.head(pooled)
        return tokens, pooled
