"""Multi-head attention: the plain PyTorch versions and the flash kernels.

Counterpart of `smb_vision_tpu/ops/attention.py`. The public functions keep
the JAX package's `(B, N, H, D)` layout. Two hand-written CUDA kernels
(`csrc/flash_fwd.cu`) stand behind them:

- K1 `flash_attention`: bf16 flash forward with an optional row
  logsumexp (replaces `_fwd_kernel`);
- K3 `flash_attention_int8`: the same forward with `q k^T` on int8 with
  per-(batch, head) symmetric scales (replaces `_fwd_i8_kernel`, pv=False).

Each wrapper runs its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor; there is no fallback between the two.
`launches` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from smb_vision_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# query rows per chunk of the plain version: bounds its (B, H, rows, Nk)
# f32 score block at ~1 GiB (12 heads x 1024 x 20,480 at batch 1)
_PLAIN_SCORE_ELEMS = 1 << 28
_KERNEL_HEAD_DIMS = (64, 128)


def _plain_chunk(b: int, h: int, nk: int) -> int:
    return max(1, _PLAIN_SCORE_ELEMS // max(1, b * h * nk))


def xla_attention(q, k, v, *, scale: Optional[float] = None, bias=None,
                  with_lse: bool = False):
    """Plain O(N^2) attention, processed in query chunks so that no full
    (N, N) score matrix per head is ever held. q: (B, Nq, H, D); k, v:
    (B, Nk, H, D). Scores and softmax in f32, p cast to v's dtype for the
    p v product (the numerics of the JAX `xla_attention`). bias: optional
    additive (B|1, H|1, Nq, Nk). with_lse also returns lse2 (B, H, Nq), the
    row logsumexp in log2 units of the scores scaled by scale*log2(e)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, nq, h, _ = q.shape
    nk = k.shape[1]
    kt = k.float().permute(0, 2, 3, 1)                  # (B, H, D, Nk)
    vh = v.permute(0, 2, 1, 3)                          # (B, H, Nk, D)
    step = _plain_chunk(b, h, nk)
    outs, lses = [], []
    for s0 in range(0, nq, step):
        qc = q[:, s0:s0 + step].float().permute(0, 2, 1, 3)
        s = torch.matmul(qc, kt) * scale                # (B, H, c, Nk) f32
        if bias is not None:
            s = s + bias[..., s0:s0 + step, :].float()
        if with_lse:
            lses.append(torch.logsumexp(s, dim=-1) * LOG2E)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.matmul(p, vh).to(v.dtype))    # (B, H, c, D)
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3).contiguous()
    if with_lse:
        return out, torch.cat(lses, dim=-1)
    return out


def quantize_qk(q, k, scale: float):
    """Per-(batch, head) symmetric int8 quantisation of the scores'
    operands, as the JAX `_fwd_i8` does it: q is pre-scaled by
    scale*log2(e), so q8 k8^T * sq * sk is a score in log2 units.
    Returns q8, k8 (int8, the input layout) and sq, sk (f32, (B, H))."""
    def quant(x, mult):
        xf = x.float() * mult
        s = xf.abs().amax(dim=(1, 3)) / 127.0           # (B, H)
        s = torch.where(s == 0, torch.ones_like(s), s)
        x8 = torch.clamp(torch.round(xf / s[:, None, :, None]), -127, 127)
        return x8.to(torch.int8), s

    q8, sq = quant(q, scale * LOG2E)
    k8, sk = quant(k, 1.0)
    return q8, k8, sq, sk


def int8_attention_plain(q8, k8, sq, sk, v):
    """Plain version of K3 on quantised operands: exact integer scores
    (|q8 k8^T| < 2^24 is exact in f32), times sq*sk, exp2 softmax in f32,
    p rounded to bf16 for the p v product and for its row sum."""
    b, nq, h, _ = q8.shape
    nk = k8.shape[1]
    kt = k8.float().permute(0, 2, 3, 1)
    vh = v.float().permute(0, 2, 1, 3)
    ss = (sq * sk)[:, :, None, None]
    step = _plain_chunk(b, h, nk)
    outs = []
    for s0 in range(0, nq, step):
        qc = q8[:, s0:s0 + step].float().permute(0, 2, 1, 3)
        st = torch.matmul(qc, kt) * ss
        p = torch.exp2(st - st.amax(dim=-1, keepdim=True))
        p = p.to(torch.bfloat16).float()
        o = torch.matmul(p, vh) / p.sum(dim=-1, keepdim=True)
        outs.append(o.to(v.dtype))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3).contiguous()


def _check_qkv(q, k, v, qk_dtype):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Nq, H, D) and k, v (B, Nk, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head width")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head width "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype != qk_dtype or k.dtype != qk_dtype or v.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes q, k {qk_dtype} and v bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(
                (s * t.element_size()) % 16 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             "rows 16-byte aligned; got strides "
                             f"{t.stride()}")


def _launch_flash(q, k, v, sq, sk, out, lse, int8: bool, scale_log2: float):
    b, nq, h, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    rc = _build.lib().smb_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(sq),
        _build.ptr(sk), out.data_ptr(), _build.ptr(lse), b, h, nq,
        k.shape[1], d, int(int8), ctypes.cast(strides, ctypes.c_void_p),
        scale_log2, _build.stream_ptr(q.device))
    _build.check(rc, "flash_fwd_i8" if int8 else "flash_fwd")


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    with_lse: bool = False):
    """K1: bf16 flash-attention forward. q (B, Nq, H, D), k, v (B, Nk, H,
    D) -> out (B, Nq, H, D) [, lse2 (B, H, Nq) f32]. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return xla_attention(q, k, v, scale=scale, with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_qkv(q, k, v, torch.bfloat16)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch_flash(q, k, v, None, None, out, lse, False, scale * LOG2E)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def flash_attention_int8(q, k, v, *, scale: Optional[float] = None):
    """K3: flash forward with int8 scores. Quantises q and k per (batch,
    head) in plain torch (`quantize_qk`), then runs the kernel on CUDA
    tensors or `int8_attention_plain` on CPU tensors. Forward only."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q8, k8, sq, sk = quantize_qk(q, k, scale)
    if q.device.type == "cpu":
        return int8_attention_plain(q8, k8, sq, sk, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 runs on cpu or cuda, not "
                         f"{q.device}")
    _check_qkv(q8, k8, v, torch.int8)
    out = torch.empty(v.shape[:1] + q.shape[1:], dtype=torch.bfloat16,
                      device=q.device)
    _launch_flash(q8, k8, v, sq.contiguous(), sk.contiguous(), out, None,
                  True, 0.0)
    flash_attention_int8.launches += 1
    return out


flash_attention_int8.launches = 0

_IMPLS = ("auto", "xla", "pallas", "pallas_i8bwd", "pallas_int8",
          "pallas_int8pv")


def _auto_impl(q, bias) -> str:
    """What "auto" runs: K1 for bf16 inputs without bias whose head width
    the kernel takes, else the plain version (the kernels compute in bf16,
    so an f32 model must not silently degrade)."""
    maps = (bias is None and q.dtype == torch.bfloat16
            and q.shape[-1] in _KERNEL_HEAD_DIMS)
    return "pallas" if maps else "xla"


def attention(q, k, v, *, scale: Optional[float] = None, bias=None,
              impl: str = "auto"):
    """Multi-head attention, (B, Nq, H, D) x (B, Nk, H, D) -> (B, Nq, H, D).

    impl: "auto" (K1 where it maps, see `_auto_impl`, else plain) | "pallas"
    and "pallas_i8bwd" (K1; the int8 backward is training work) |
    "pallas_int8" (K3) | "xla" (plain). "pallas_int8pv" is not ported yet.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; valid: "
                         + ", ".join(repr(i) for i in _IMPLS))
    if impl == "pallas_int8pv":
        raise NotImplementedError(
            "attn_impl='pallas_int8pv' (int8 p@v, kernel K8; ROADMAP.md "
            "queue 1, K8 and K10) is not ported yet; use 'pallas_int8'")
    if impl == "auto":
        impl = _auto_impl(q, bias)
    if impl == "xla":
        return xla_attention(q, k, v, scale=scale, bias=bias)
    if bias is not None:
        raise NotImplementedError("the flash kernels take no bias; use "
                                  "impl='xla' for masked attention")
    if impl == "pallas_int8":
        return flash_attention_int8(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


def attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                       impl: str = "auto") -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Attention that also returns lse2 (B, H, Nq): the row logsumexp in
    log2 units of the scores scaled by scale*log2(e), so that the softmax
    weights are p = exp2(s*scale*log2(e) - lse2). The int8 spellings
    coerce to K1, as in the JAX package (the int8 kernel exposes no lse)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        impl = _auto_impl(q, None)
    if impl == "xla":
        return xla_attention(q, k, v, scale=scale, with_lse=True)
    return flash_attention(q, k, v, scale=scale, with_lse=True)
