"""Trace capture and analytic FLOP counts for MFU accounting.

Counterpart of `smb_vision_tpu/utils/profiling.py` (`trace` on
`torch.profiler`, `transformer_flops`, `mim_flops_per_sample`,
`vjepa_flops_per_sample`), the fine-tuning count
`classification_flops_per_sample`, and the dense bf16 peak of the card the
Trainer divides by."""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Optional

# dense bf16 tensor-core peaks (NVIDIA data sheets, no sparsity), matched
# on the lower-cased device name in order: the PCIe and NVL parts of the
# H100 are slower than the SXM part ("NVIDIA H100 80GB HBM3")
_PEAK_BF16 = (("h100 pcie", 756e12), ("h100 nvl", 835e12), ("h100", 989e12))


@contextlib.contextmanager
def trace(log_dir, enabled: bool = True):
    """Capture a `torch.profiler` trace of the block (the host, and the
    CUDA devices when present) and write it as a Chrome trace,
    `log_dir/trace_<pid>.json` (chrome://tracing, Perfetto, TensorBoard).
    CUDA work is waited for before the trace stops."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}.json"))


def transformer_flops(seq_len: int, hidden: int, layers: int,
                      intermediate: Optional[int] = None,
                      fwd_only: bool = False) -> float:
    """Forward FLOPs of a pre-LN transformer stack on `seq_len` tokens:
    qkv/proj (8*N*D^2) + attention (4*N^2*D) + mlp (4*N*D*I) per layer.
    Training (fwd+bwd) multiplies by 3."""
    intermediate = intermediate or 4 * hidden
    per_layer = (8 * seq_len * hidden * hidden
                 + 4 * seq_len * seq_len * hidden
                 + 4 * seq_len * hidden * intermediate)
    total = per_layer * layers
    return total if fwd_only else 3 * total


def mim_flops_per_sample(config, mask_ratio: float) -> float:
    """Train-step FLOPs per sample of VideoMAEForPreTraining: the encoder on
    the visible tokens + the decoder on the whole sequence + the patch
    embedding (the remat recompute is not counted)."""
    n = config.seq_len
    n_vis = int(n * (1 - mask_ratio))
    enc = transformer_flops(n_vis, config.hidden_size,
                            config.num_hidden_layers,
                            config.intermediate_size)
    dec = transformer_flops(n, config.decoder_hidden_size,
                            config.decoder_num_hidden_layers,
                            config.decoder_intermediate_size)
    embed = 3 * 2 * n * config.patch_dim * config.hidden_size
    return enc + dec + embed


def vjepa_flops_per_sample(config) -> float:
    """Train-step FLOPs per sample of V-JEPA: the student encoder (forward
    and backward) + the EMA teacher's encoder (forward) + the predictor
    (forward and backward), all on the whole sequence (the remat
    recompute is not counted)."""
    n = config.seq_len
    inter = int(config.hidden_size * config.mlp_ratio)
    student = transformer_flops(n, config.hidden_size,
                                config.num_hidden_layers, inter)
    teacher = transformer_flops(n, config.hidden_size,
                                config.num_hidden_layers, inter,
                                fwd_only=True)
    pred = transformer_flops(n, config.pred_hidden_size,
                             config.pred_num_hidden_layers,
                             int(config.pred_hidden_size
                                 * config.pred_mlp_ratio))
    return student + teacher + pred


def classification_flops_per_sample(config) -> float:
    """Train-step FLOPs per sample of fine-tuning: the backbone (forward
    and backward) on its whole sequence (DINOv2: the patches and the CLS
    token), the patch embedding, and for V-JEPA2 the attentive pooler's
    self-attention layers (its one-query cross-attention and the heads are
    not counted, nor is the remat recompute). A SwiGLU FFN counts its three
    products, 6*N*D*I a layer forward: the JAX package's
    `encoder_flops_per_sample` sizes SwiGLU's I but counts two products,
    4*N*D*I."""
    hidden, layers = config.hidden_size, config.num_hidden_layers
    if config.model_type == "dinov2":
        n = config.seq_len + 1
        inter = config.intermediate_size
        patch_dim = config.num_channels * config.patch_size ** 3
    elif config.model_type == "vjepa2":
        n = config.seq_len
        inter = int(hidden * config.mlp_ratio)
        patch_dim = (config.in_chans * config.tubelet_size
                     * config.patch_size ** 2)
    else:
        n, inter, patch_dim = (config.seq_len, config.intermediate_size,
                               config.patch_dim)
    total = transformer_flops(n, hidden, layers, inter)
    if getattr(config, "use_swiglu_ffn", False):
        total += 3 * 2 * n * hidden * inter * layers   # the gate product
    if config.model_type == "vjepa2":
        total += transformer_flops(n, hidden, config.num_pooler_layers,
                                   inter)
    return total + 3 * 2 * n * patch_dim * hidden


def device_peak_flops(device) -> Optional[float]:
    """Dense bf16 FLOP/s of a CUDA device from its name; None for the CPU
    and for a card this table does not know."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_BF16:
        if key in name:
            return peak
    return None
