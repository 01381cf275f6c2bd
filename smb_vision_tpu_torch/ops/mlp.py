"""Transformer MLP: the plain PyTorch versions and the fused kernels.

Counterpart of `smb_vision_tpu/ops/mlp.py`. Public functions keep the JAX
package's weight layout, w1 (K, F) and w2 (F, K). Two hand-written CUDA
kernels (`csrc/mlp_fwd.cu`) stand behind them:

- K6 `mlp_fused`: y = act(x w1 + b1) w2 + b2 (replaces `_mlp_kernel`);
- K2 `mlp_block_fused`: y = x + act(LN(x) w1 + b1) w2 + b2, the whole MLP
  half-block (replaces `_mlp_block_kernel`).

Both keep the (M, F) intermediate on the SM. Each wrapper runs the plain
version for CPU tensors and launches its kernel for CUDA tensors; there is
no fallback between the two. `launches` on each wrapper counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smb_vision_tpu_torch.ops import _build

_ACTS = {"gelu": 0, "gelu_new": 1}
_KERNEL_K = (128, 256, 384, 512, 768, 1024)
_KERNEL_F_STEP = 32


def act_fn(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported mlp act {name!r}")


def _mlp_xla(x, w1, b1, w2, b2, act: str):
    """Plain MLP with the numerics of flax's nn.Dense chain: operands and
    results in x.dtype."""
    dt = x.dtype
    h = torch.matmul(x, w1.to(dt))
    if b1 is not None:
        h = h + b1.to(dt)
    h = act_fn(act)(h)
    y = torch.matmul(h, w2.to(dt))
    if b2 is not None:
        y = y + b2.to(dt)
    return y


def _mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, act: str, eps: float):
    """x + mlp(LayerNorm(x)): LayerNorm statistics, scale and bias in f32,
    the MLP in x.dtype."""
    xn = F.layer_norm(x.float(), (x.shape[-1],), lnw.float(), lnb.float(),
                      eps)
    return x + _mlp_xla(xn.to(x.dtype), w1, b1, w2, b2, act)


def kernel_maps(k: int, f: int, act: str) -> bool:
    """Whether the fused kernels take this (K, F, act); rows are free."""
    return k in _KERNEL_K and f % _KERNEL_F_STEP == 0 and act in _ACTS


def _launch_mlp(x2, lnw, lnb, w1, b1, w2, b2, act, eps, name):
    """x2 (M, K) and w1 (K, F), w2 (F, K) in any float dtype; returns bf16.
    The kernel wants the Linear layout (F, K) / (K, F) in bf16: for weights
    that are transposed views of a Linear's bf16 weight the conversion
    below copies nothing."""
    m, k = x2.shape
    f = w1.shape[1]
    if not kernel_maps(k, f, act):
        raise ValueError(f"{name}: no kernel for K={k}, F={f}, act={act!r} "
                         f"(K in {_KERNEL_K}, F a multiple of "
                         f"{_KERNEL_F_STEP}, act in {tuple(_ACTS)})")
    if w1.shape != (k, f) or w2.shape != (f, k):
        raise ValueError(f"{name}: w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)} do not fit x {tuple(x2.shape)}")
    dev = x2.device
    bf16 = torch.bfloat16
    x2 = x2.to(bf16).contiguous()
    w1t = w1.to(bf16).t().contiguous()
    w2t = w2.to(bf16).t().contiguous()
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    if lnw is not None:
        lnw = lnw.float().contiguous()
        lnb = lnb.float().contiguous()
    for t in (w1t, w2t, b1, b2):
        if t.device != dev:
            raise ValueError(f"{name}: weights on {t.device}, x on {dev}")
    out = torch.empty((m, k), dtype=bf16, device=dev)
    rc = _build.lib().smb_mlp_fwd(
        x2.data_ptr(), _build.ptr(lnw), _build.ptr(lnb), w1t.data_ptr(),
        b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), out.data_ptr(), m, k,
        f, float(eps), int(lnw is not None), _ACTS[act],
        _build.stream_ptr(dev))
    _build.check(rc, name)
    return out


def mlp_fused(x2, w1, b1, w2, b2, *, act: str = "gelu"):
    """K6 on (M, K) rows, bf16 result. CPU tensors take the plain
    `_mlp_xla` in bf16; CUDA tensors launch the kernel or raise."""
    if x2.device.type == "cpu":
        bf16 = torch.bfloat16
        return _mlp_xla(x2.to(bf16), w1, b1, w2, b2, act)
    if x2.device.type != "cuda":
        raise ValueError(f"mlp_fused runs on cpu or cuda, not {x2.device}")
    out = _launch_mlp(x2, None, None, w1, b1, w2, b2, act, 0.0, "mlp_fwd")
    mlp_fused.launches += 1
    return out


mlp_fused.launches = 0


def mlp_block_fused(x2, lnw, lnb, w1, b1, w2, b2, *, act: str = "gelu",
                    eps: float = 1e-6):
    """K2 on (M, K) rows, bf16 result. CPU tensors take the plain
    `_mlp_block_xla` in bf16; CUDA tensors launch the kernel or raise."""
    if x2.device.type == "cpu":
        return _mlp_block_xla(x2.to(torch.bfloat16), lnw, lnb, w1, b1, w2,
                              b2, act, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"mlp_block_fused runs on cpu or cuda, not "
                         f"{x2.device}")
    out = _launch_mlp(x2, lnw, lnb, w1, b1, w2, b2, act, eps,
                      "mlp_block_fwd")
    mlp_block_fused.launches += 1
    return out


mlp_block_fused.launches = 0


def _route(impl: str, x, w1, b1, b2, act: str, kernel_impls) -> bool:
    """True when the call goes to a fused kernel. 'auto' takes it only for
    bf16 inputs whose shape maps: the kernels compute in bf16, so an f32
    model must not silently degrade. A forced kernel impl that cannot map
    raises."""
    maps = (b1 is not None and b2 is not None
            and kernel_maps(x.shape[-1], w1.shape[1], act))
    if impl == "auto":
        return maps and x.dtype == torch.bfloat16
    if impl in kernel_impls:
        if not maps:
            raise ValueError(
                f"mlp impl={impl!r} cannot map x={tuple(x.shape)}, "
                f"w1={tuple(w1.shape)}, act={act!r}: K in {_KERNEL_K}, "
                f"F a multiple of {_KERNEL_F_STEP}, biases present")
        return True
    return False


def mlp_forward(x, w1, b1, w2, b2, *, act: str = "gelu", impl: str = "auto"):
    """Transformer MLP y = act(x w1 + b1) w2 + b2; x (..., K), w1 (K, F),
    b1 (F,), w2 (F, K), b2 (K,). impl: "auto" (K6 for bf16 inputs whose
    shape maps, else plain) | "pallas" | "pallas_bwd" (K6: this is the
    forward that runs when nothing is differentiated) | "xla" (plain)."""
    if impl not in ("auto", "pallas", "pallas_bwd", "xla"):
        raise ValueError(f"unknown mlp impl {impl!r}; "
                         "valid: 'auto', 'pallas', 'pallas_bwd', 'xla'")
    if not _route(impl, x, w1, b1, b2, act, ("pallas", "pallas_bwd")):
        return _mlp_xla(x, w1, b1, w2, b2, act)
    y = mlp_fused(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, act=act)
    return y.reshape(x.shape).to(x.dtype)


def mlp_block_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                      act: str = "gelu", eps: float = 1e-6,
                      impl: str = "auto"):
    """Whole MLP half-block y = x + act(LN(x) w1 + b1) w2 + b2 (LayerScale
    folds into w2/b2 at the caller). impl: "auto" (K2 for bf16 inputs
    whose shape maps, else plain) | "pallas" (K2) | "xla" (plain)."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown mlp impl {impl!r}; "
                         "valid: 'auto', 'pallas', 'xla'")
    if not _route(impl, x, w1, b1, b2, act, ("pallas",)):
        return _mlp_block_xla(x, ln_scale, ln_bias, w1, b1, w2, b2, act,
                              eps)
    y = mlp_block_fused(x.reshape(-1, x.shape[-1]), ln_scale, ln_bias, w1,
                        b1, w2, b2, act=act, eps=eps)
    return y.reshape(x.shape).to(x.dtype)
