"""Attention half-block glue: the LayerNorm + q/k/v projection prologue and
the output projection + residual epilogue around the attention core, the
plain PyTorch versions and the kernels.

Counterpart of `smb_vision_tpu/ops/attn_glue.py`. Public functions keep the
JAX package's signatures and weight layout, (in, out). Two hand-written
CUDA kernels (`csrc/attn_glue.cu`, wgmma + TMA GEMMs on the core of
`csrc/gemm_sm90.cuh`) stand behind them:

- K10a `qkv_ln_fused`: q, k, v = LN(x) W{q,k,v} + b{q,k,v} (replaces
  `_qkv_ln_kernel`): a LayerNorm row pass into a bf16 workspace of a chunk
  of rows (`glue_chunk_rows`), then one GEMM over the 3K columns;
- K10b `out_res_fused`: o = res + y Wo + bo, LayerScale folded into Wo and
  bo by the caller (replaces `_out_res_kernel`): K2's second product
  (`csrc/mlp_fwd.cu`).

Numerics as the kernels': LayerNorm statistics in f32 with var = E[x^2] -
mean^2, bf16 operands, f32 accumulation and bias, one rounding to bf16.
As in the JAX package (`_qkv_fused` and `_out_fused` cast x, res and y to
bf16 whatever their dtype), "pallas" takes and returns bf16 values for any
compute dtype: an f32 model on the glue gets q, k, v and its residual
stream rounded to bf16 at every block, cast back to f32.
Under autograd both take the JAX package's recompute backward: the plain
XLA composition (`_qkv_xla`, `_out_xla`) run again and differentiated.
"auto" is the plain path, as the JAX `Block` fuses only on an explicit
glue_impl "pallas". Each wrapper runs its plain version for CPU tensors and
launches its kernel for CUDA tensors; there is no fallback between the
two. `launches` on each wrapper counts launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from smb_vision_tpu_torch.ops import _build
from smb_vision_tpu_torch.ops.attention import needs_grad
from smb_vision_tpu_torch.ops.mlp import (
    _TILE_ROWS,
    _device_of,
    _recompute_grads,
    mlp_chunk_rows,
)

_IMPLS = ("auto", "pallas", "xla")
_K_STEP = 128
# K10a runs its rows in chunks through a bf16 (chunk, K) workspace for
# LN(x) of at most this many bytes (but one 128-row tile), so it does not
# grow with M: one chunk at the embed shape and the MIM decoder's batch 2
_WS_BYTES = 32 << 20


def _ln_xla(x, lnw, lnb, eps: float):
    """LayerNorm with f32 statistics, var = E[x^2] - mean^2, f32 result."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + eps) * lnw.float() + lnb.float()


def _qkv_xla(x, lnw, lnb, wq, wk, wv, bq, bk, bv, eps: float):
    """LN (f32 statistics) and three projections with flax Dense's
    numerics: products and biases in x.dtype. Weights (in, out)."""
    dt = x.dtype
    xn = _ln_xla(x, lnw.reshape(-1), lnb.reshape(-1), eps).to(dt)
    return tuple(torch.matmul(xn, w.to(dt)) + b.reshape(-1).to(dt)
                 for w, b in ((wq, bq), (wk, bk), (wv, bv)))


def _out_xla(res, y, wo, bo):
    dt = res.dtype
    return res + (torch.matmul(y.to(dt), wo.to(dt)) + bo.reshape(-1).to(dt))


def _qkv_ln_plain(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps: float):
    """Plain version of K10a with the kernel's numerics: xn = LN(x) in f32
    rounded to bf16, the products of bf16 operands in f32, plus the f32
    bias, rounded once to bf16."""
    bf16 = torch.bfloat16
    xn = _ln_xla(x2.to(bf16), lnw, lnb, eps).to(bf16).float()
    return tuple((torch.matmul(xn, w.to(bf16).float()) + b.float()).to(bf16)
                 for w, b in ((wq, bq), (wk, bk), (wv, bv)))


def _out_res_plain(res2, y2, wo, bo):
    """Plain version of K10b: y wo of bf16 operands in f32, plus bo and the
    residual in f32, rounded once to bf16."""
    bf16 = torch.bfloat16
    o = (torch.matmul(y2.to(bf16).float(), wo.to(bf16).float()) + bo.float()
         + res2.to(bf16).float())
    return o.to(bf16)


def glue_maps(k: int) -> bool:
    """Whether "pallas" maps feature dim k (any multiple of 128); rows are
    free."""
    return k > 0 and k % _K_STEP == 0


def glue_chunk_rows(m: int, k: int) -> int:
    """Rows of one chunk of K10a at M = m rows of feature dim k: all of
    them while LN(x) in bf16 fits `_WS_BYTES`; past it, the fewest chunks
    of near-equal size under that many bytes, whole 128-row tiles but the
    last (`mlp_chunk_rows`)."""
    cap = max(_TILE_ROWS, _WS_BYTES // (2 * k) // _TILE_ROWS * _TILE_ROWS)
    return mlp_chunk_rows(m, cap)


def _glue_workspace(m: int, k: int, dev):
    """(chunk, xn) of a K10a launch over m rows: the chunk's rows and the
    bf16 (chunk, k) workspace of LN(x)."""
    chunk = glue_chunk_rows(m, k)
    return chunk, torch.empty((chunk, k), dtype=torch.bfloat16, device=dev)


def _linear_layout(w, k: int, name: str, dev):
    """w (in, out) as the kernels read it: bf16 (out, in), contiguous and
    aligned. For the transposed view of a Linear's bf16 weight this copies
    nothing."""
    if w.shape != (k, k):
        raise ValueError(f"{name}: weight {tuple(w.shape)}, feature dim {k}")
    if w.device != dev:
        raise ValueError(f"{name}: weight on {w.device}, rows on {dev}")
    return _aligned(w.to(torch.bfloat16).t())


def _aligned(t):
    """t contiguous at a 16-byte aligned address, as TMA and the LayerNorm
    pass's vector loads read it (a copy only for a misaligned view)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32_row(b, k: int, name: str, dev):
    b = _aligned(b.reshape(-1).float())
    if b.shape != (k,) or b.device != dev:
        raise ValueError(f"{name}: vector {tuple(b.shape)} on {b.device}, "
                         f"feature dim {k} on {dev}")
    return b


def _qkv_fwd(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps: float):
    """K10a or its plain version, by the device of x2; no autograd. The
    kernel's rows run in chunks of `glue_chunk_rows` through a workspace
    allocated here."""
    if _device_of(x2, "qkv_ln_fused", wq, wk, wv, bq, bk, bv) == "cpu":
        return _qkv_ln_plain(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps)
    m, k = x2.shape
    dev = x2.device
    bf16 = torch.bfloat16
    x2 = _aligned(x2.to(bf16))
    ws = [_linear_layout(w, k, "qkv_ln_fwd", dev) for w in (wq, wk, wv)]
    vecs = [_f32_row(b, k, "qkv_ln_fwd", dev)
            for b in (lnw, lnb, bq, bk, bv)]
    outs = [torch.empty((m, k), dtype=bf16, device=dev) for _ in range(3)]
    chunk, xn = _glue_workspace(m, k, dev)
    rc = _build.lib().smb_qkv_ln_fwd(
        x2.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        *(w.data_ptr() for w in ws), *(b.data_ptr() for b in vecs[2:]),
        *(o.data_ptr() for o in outs), m, k, float(eps),
        _build.stream_ptr(dev), xn.data_ptr(), chunk)
    _build.check(rc, "qkv_ln_fwd")
    qkv_ln_fused.launches += 1
    return tuple(outs)


def _out_fwd(res2, y2, wo, bo):
    """K10b or its plain version, by the device of y2; no autograd."""
    if _device_of(y2, "out_res_fused", wo, bo) == "cpu":
        return _out_res_plain(res2, y2, wo, bo)
    m, k = y2.shape
    dev = y2.device
    bf16 = torch.bfloat16
    if res2.shape != (m, k) or res2.device != dev:
        raise ValueError(f"out_res_fwd: residual {tuple(res2.shape)} on "
                         f"{res2.device}, y {tuple(y2.shape)} on {dev}")
    res2 = _aligned(res2.to(bf16))
    y2 = _aligned(y2.to(bf16))
    w = _linear_layout(wo, k, "out_res_fwd", dev)
    b = _f32_row(bo, k, "out_res_fwd", dev)
    out = torch.empty((m, k), dtype=bf16, device=dev)
    rc = _build.lib().smb_out_res_fwd(
        res2.data_ptr(), y2.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, k, _build.stream_ptr(dev))
    _build.check(rc, "out_res_fwd")
    out_res_fused.launches += 1
    return out


class _QkvLnFused(torch.autograd.Function):
    """K10a forward; the backward recomputes the plain composition under
    autograd (`smb_vision_tpu/ops/attn_glue.py` `_qkv_fused_bwd`)."""

    @staticmethod
    def forward(ctx, x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps):
        ctx.save_for_backward(x2, lnw, lnb, wq, wk, wv, bq, bk, bv)
        ctx.eps = eps
        return _qkv_fwd(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        eps = ctx.eps
        grads = _recompute_grads(lambda *a: _qkv_xla(*a, eps),
                                 ctx.saved_tensors, (gq, gk, gv))
        return (*grads, None)


class _OutResFused(torch.autograd.Function):
    """K10b forward; the backward recomputes the plain composition under
    autograd (`smb_vision_tpu/ops/attn_glue.py` `_out_fused_bwd`)."""

    @staticmethod
    def forward(ctx, res2, y2, wo, bo):
        ctx.save_for_backward(res2, y2, wo, bo)
        return _out_fwd(res2, y2, wo, bo)

    @staticmethod
    def backward(ctx, go):
        return _recompute_grads(_out_xla, ctx.saved_tensors, go)


def qkv_ln_fused(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, *, eps: float = 1e-6):
    """K10a on (M, K) rows: (q, k, v), each (M, K) bf16; weights (K, K) in
    the (in, out) layout, biases (K,). CPU tensors take `_qkv_ln_plain`;
    CUDA tensors launch the kernel or raise. Under autograd the backward
    recomputes `_qkv_xla`."""
    if needs_grad(x2, lnw, lnb, wq, wk, wv, bq, bk, bv):
        return _QkvLnFused.apply(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps)
    return _qkv_fwd(x2, lnw, lnb, wq, wk, wv, bq, bk, bv, eps)


qkv_ln_fused.launches = 0


def out_res_fused(res2, y2, wo, bo):
    """K10b on (M, K) rows: res + y wo + bo, (M, K) bf16; wo (K, K) in the
    (in, out) layout. CPU tensors take `_out_res_plain`; CUDA tensors launch
    the kernel or raise. Under autograd the backward recomputes
    `_out_xla`."""
    if needs_grad(res2, y2, wo, bo):
        return _OutResFused.apply(res2, y2, wo, bo)
    return _out_fwd(res2, y2, wo, bo)


out_res_fused.launches = 0


def _route(impl: str, x) -> bool:
    """True for the kernel. "auto" and "xla" take the plain composition;
    "pallas" on a feature dim the kernel does not take raises."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown glue impl {impl!r}; "
                         "valid: 'auto', 'pallas', 'xla'")
    if impl != "pallas":
        return False
    k = x.shape[-1]
    if not glue_maps(k):
        raise ValueError(
            f"glue impl='pallas' cannot map shape x={tuple(x.shape)}: the "
            f"feature dim must divide by {_K_STEP}")
    return True


def qkv_ln_forward(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, *,
                   eps: float = 1e-6, impl: str = "auto"):
    """q, k, v = LayerNorm(x) W + b, each shaped like x; weights (K, K) in
    the (in, out) layout. A missing bias (bias_mode "qv" has no k bias) is
    a zeros row. impl: "pallas" (K10a, recompute backward) | "auto" | "xla"
    (both the plain composition, as the JAX package resolves "auto" off its
    TPU). "pallas" raises "cannot map" where K % 128 != 0. The kernel masks
    ragged row tiles itself, so any row count maps; the JAX package also
    refuses some shapes on VMEM grounds (K 1,536, for one), which the port
    does not."""
    k = x.shape[-1]
    fused = _route(impl, x)
    zeros = torch.zeros((k,), dtype=torch.float32, device=x.device)
    bq, bk, bv = (zeros if b is None else b for b in (bq, bk, bv))
    x2 = x.reshape(-1, k)
    if not fused:
        outs = _qkv_xla(x2, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv, eps)
        return tuple(o.reshape(x.shape) for o in outs)
    outs = qkv_ln_fused(x2, ln_scale, ln_bias, wq, wk, wv, bq, bk, bv,
                        eps=eps)
    return tuple(o.reshape(x.shape).to(x.dtype) for o in outs)


def attn_out_residual(res, y, wo, bo, *, layerscale: Optional[
        torch.Tensor] = None, impl: str = "auto"):
    """res + (y wo + bo) [* layerscale, folded into wo and bo], the
    attention half-block's residual epilogue; wo (K, K) in the (in, out)
    layout. impl as `qkv_ln_forward` ("pallas": K10b)."""
    if layerscale is not None:
        wo = wo * layerscale[None, :].to(wo.dtype)
        bo = bo * layerscale.to(bo.dtype)
    k = res.shape[-1]
    fused = _route(impl, y)
    res2, y2 = res.reshape(-1, k), y.reshape(-1, k)
    if not fused:
        return _out_xla(res2, y2, wo, bo).reshape(res.shape)
    return out_res_fused(res2, y2, wo, bo).reshape(res.shape).to(res.dtype)
