"""Transformer MLP: the plain PyTorch versions and the fused kernels.

Counterpart of `smb_vision_tpu/ops/mlp.py`. Public functions keep the JAX
package's weight layout, w1 (K, F) and w2 (F, K). Five hand-written CUDA
kernels stand behind them:

- K6 `mlp_fused` (`csrc/mlp_fwd.cu`): y = act(x w1 + b1) w2 + b2 (replaces
  `_mlp_kernel`);
- K2 `mlp_block_fused` (`csrc/mlp_fwd.cu`): y = x + act(LN(x) w1 + b1) w2
  + b2, the whole MLP half-block (replaces `_mlp_block_kernel`);
- K5a `mlp_train_fused` (`csrc/mlp_fwd.cu`): K6 that also stores the
  pre-activation h = x w1 + b1 in bf16 (replaces `_mlp_train_kernel`);
- K5b `mlp_bwd_fused` (`csrc/mlp_bwd.cu`): dx, dh and a = act(h) from h and
  dL/dy (replaces `_mlp_bwd_kernel`);
- K9 `swiglu_block_fused` (`csrc/mlp_fwd.cu`): y = x + (silu(LN(x) w1a +
  b1a) * (LN(x) w1b + b1b)) w2 + b2, the DINOv2 SwiGLU half-block
  (replaces `_swiglu_block_kernel`).

All five are two wgmma GEMMs on one core (`csrc/gemm_sm90.cuh`). K6, K2,
K5a and K9 pass their (M, F) activation (K9: the gate silu(h1) * h2)
through a bf16 workspace of a chunk of rows (`mlp_chunk_rows`,
`_mlp_workspace`); K5b's second product reads the dh it emits, so it
needs none. Under autograd K6, K2 and K9 take the JAX package's recompute
backward (the plain version differentiated again), and mlp_impl
"pallas_bwd" trains through K5a + K5b, the counterpart of
`_mlp_fused_tb`. Each wrapper runs the plain version for CPU tensors and
launches its kernel for CUDA tensors; there is no fallback between the
two. `launches` on each wrapper counts calls that launched the kernel
(K5a's and K5b's also by K, `launches_by_width`).

Widths. All five take every K that is a multiple of 128, the JAX
kernels' rule, and F a multiple of 32, under autograd too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smb_vision_tpu_torch.ops import _build
from smb_vision_tpu_torch.ops.attention import _count_launch, needs_grad

_ACTS = {"gelu": 0, "gelu_new": 1}
_KERNEL_K_STEP = 128
_KERNEL_F_STEP = 32
# K2, K6, K5a and K9 run their rows in chunks of at most this many through
# a bf16 (rows, F) workspace (and, for K2 and K9, a (rows, K) one for
# LN(x)), so the workspace does not grow with M: 201 MB at F 3,072, 268 MB
# at F 4,096
_CHUNK_ROWS = 32768
_TILE_ROWS = 128   # the kernels' row tile


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


def act_and_grad(h, act: str):
    """(act(h), act'(h)) in f32; the exact GELU's derivative uses the real
    erf: 0.5*(1 + erf(h/sqrt2)) + h*pdf(h)."""
    h = h.float()
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
        pdf = 0.3989422804014327 * torch.exp(-0.5 * h * h)
        return h * cdf, cdf + h * pdf
    if act == "gelu_new":
        c = 0.7978845608028654
        t = torch.tanh(c * (h + 0.044715 * h * h * h))
        du = c * (1.0 + 3.0 * 0.044715 * h * h)
        return 0.5 * h * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du
    raise ValueError(f"unsupported mlp act {act!r}")


def _mlp_train_plain(x2, w1, b1, w2, b2, act: str):
    """Plain version of K5a: (y, h) with h = x w1 + b1 (bf16 product, bias
    in f32) returned in bf16, the activation taken of the f32 h and
    rounded to bf16 before the second product, as the kernel does."""
    bf16 = torch.bfloat16
    h = torch.matmul(x2.to(bf16), w1.to(bf16)).float() + b1.float()
    a = act_fn(act)(h).to(bf16)
    y = torch.matmul(a, w2.to(bf16)).float() + b2.float()
    return y.to(bf16), h.to(bf16)


def _mlp_bwd_plain(h, g2, w1, w2, act: str):
    """Plain version of K5b: from h (M, F) and g2 = dL/dy (M, K), both
    bf16, return dx (M, K), dh and a (M, F), all bf16:
    a = act(h), dh = (g2 w2^T) * act'(h), dx = dh w1^T."""
    bf16 = torch.bfloat16
    a, d = act_and_grad(h, act)
    da = torch.matmul(g2.to(bf16), w2.to(bf16).t()).float()
    dh = (da * d).to(bf16)
    dx = torch.matmul(dh, w1.to(bf16).t())
    return dx.to(bf16), dh, a.to(bf16)


def _recompute_grads(fn, inputs, grad_out):
    """Gradients of fn(*inputs) against grad_out, by running fn again under
    autograd: the recompute backward of the JAX package's K6 and K2
    (`jax.vjp` of the plain forward). None where an input needs none."""
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(
            t.requires_grad) for t in inputs]
        y = fn(*xs)
    want = [x for x in xs if x is not None and x.requires_grad]
    grads = iter(torch.autograd.grad(y, want, grad_out, allow_unused=True))
    return tuple(next(grads) if x is not None and x.requires_grad else None
                 for x in xs)


def _mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, act: str, eps: float):
    """x + mlp(LayerNorm(x)): LayerNorm statistics, scale and bias in f32,
    the MLP in x.dtype."""
    xn = F.layer_norm(x.float(), (x.shape[-1],), lnw.float(), lnb.float(),
                      eps)
    return x + _mlp_xla(xn.to(x.dtype), w1, b1, w2, b2, act)


def kernel_maps(k: int, f: int, act: str) -> bool:
    """Whether the fused kernels take this (K, F, act), forward and
    training alike; rows are free."""
    return (k > 0 and k % _KERNEL_K_STEP == 0 and f > 0
            and f % _KERNEL_F_STEP == 0 and act in _ACTS)


def _check_mlp_shape(k: int, f: int, act: str, name: str) -> None:
    if not kernel_maps(k, f, act):
        raise ValueError(f"{name}: no kernel for K={k}, F={f}, act={act!r} "
                         f"(K a multiple of {_KERNEL_K_STEP}, F a multiple "
                         f"of {_KERNEL_F_STEP}, act in {tuple(_ACTS)})")


def mlp_chunk_rows(m: int, cap: int = _CHUNK_ROWS) -> int:
    """Rows of one chunk of K2, K6, K5a and K9 (and, with its own cap, of
    K10a) at M = m rows: all of them up to `cap` (whole row tiles); past
    it, the fewest chunks of at most that many rows, of near-equal size
    and whole row tiles but the last."""
    if m <= cap:
        return m
    chunks = -(-m // cap)
    per = -(-m // chunks)
    return min(cap, -(-per // _TILE_ROWS) * _TILE_ROWS)


def _mlp_workspace(m: int, k: int, f: int, ln: bool, dev):
    """(chunk, ws, xn) of a K2, K6, K5a or K9 launch over m rows: the
    chunk's rows, the bf16 (chunk, f) workspace of the activation and,
    with ln, the bf16 (chunk, k) one of LN(x); else xn is None."""
    chunk = mlp_chunk_rows(m)
    ws = torch.empty((chunk, f), dtype=torch.bfloat16, device=dev)
    xn = (torch.empty((chunk, k), dtype=torch.bfloat16, device=dev)
          if ln else None)
    return chunk, ws, xn


def _launch_mlp(x2, lnw, lnb, w1, b1, w2, b2, act, eps, name,
                spill: bool = False):
    """x2 (M, K) and w1 (K, F), w2 (F, K) in any float dtype; returns bf16
    y, and with spill also the bf16 pre-activation h (M, F) (K5a). The
    kernel wants the Linear layout (F, K) / (K, F) in bf16: for weights
    that are transposed views of a Linear's bf16 weight the conversion
    below copies nothing. The rows run in chunks of `mlp_chunk_rows(M)`
    through workspaces allocated here."""
    m, k = x2.shape
    f = w1.shape[1]
    _check_mlp_shape(k, f, act, name)
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
    h = torch.empty((m, f), dtype=bf16, device=dev) if spill else None
    chunk, ws, xn = _mlp_workspace(m, k, f, lnw is not None, dev)
    rc = _build.lib().smb_mlp_fwd(
        x2.data_ptr(), _build.ptr(lnw), _build.ptr(lnb), w1t.data_ptr(),
        b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), out.data_ptr(),
        _build.ptr(h), m, k, f, float(eps), int(lnw is not None),
        _ACTS[act], _build.stream_ptr(dev), ws.data_ptr(), _build.ptr(xn),
        chunk)
    _build.check(rc, name)
    return (out, h) if spill else out


def _device_of(x2, name: str, *operands) -> str:
    """The device type the wrapper runs on. A DTensor operand (a weight
    still split over the mesh) raises: the kernels take whole plain
    tensors, gathered before the call, never a copy made here."""
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x2.device}")
    if any(hasattr(t, "placements") for t in (x2, *operands)):
        raise TypeError(f"{name}: a DTensor operand; the kernels take the "
                        "whole weights (gathered at use), as plain tensors")
    return x2.device.type


def _mlp_fwd(x2, w1, b1, w2, b2, act: str):
    """K6 or its plain version, by the device of x2; no autograd."""
    if _device_of(x2, "mlp_fused", w1, b1, w2, b2) == "cpu":
        return _mlp_xla(x2.to(torch.bfloat16), w1, b1, w2, b2, act)
    out = _launch_mlp(x2, None, None, w1, b1, w2, b2, act, 0.0, "mlp_fwd")
    mlp_fused.launches += 1
    return out


def _mlp_block_fwd(x2, lnw, lnb, w1, b1, w2, b2, act: str, eps: float):
    """K2 or its plain version, by the device of x2; no autograd."""
    if _device_of(x2, "mlp_block_fused", w1, b1, w2, b2) == "cpu":
        return _mlp_block_xla(x2.to(torch.bfloat16), lnw, lnb, w1, b1, w2,
                              b2, act, eps)
    out = _launch_mlp(x2, lnw, lnb, w1, b1, w2, b2, act, eps,
                      "mlp_block_fwd")
    mlp_block_fused.launches += 1
    return out


class _MlpFused(torch.autograd.Function):
    """K6 forward; the backward recomputes the plain chain under autograd
    (`smb_vision_tpu/ops/mlp.py` `_mlp_fused_bwd`)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, act):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        ctx.act = act
        return _mlp_fwd(x2, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, gy):
        act = ctx.act
        grads = _recompute_grads(
            lambda x, *w: _mlp_xla(x.to(torch.bfloat16), *w, act),
            ctx.saved_tensors, gy)
        return (*grads, None)


class _MlpBlockFused(torch.autograd.Function):
    """K2 forward; the backward recomputes the plain half-block under
    autograd (`smb_vision_tpu/ops/mlp.py` `_mlp_block_fused_bwd`)."""

    @staticmethod
    def forward(ctx, x2, lnw, lnb, w1, b1, w2, b2, act, eps):
        ctx.save_for_backward(x2, lnw, lnb, w1, b1, w2, b2)
        ctx.act, ctx.eps = act, eps
        return _mlp_block_fwd(x2, lnw, lnb, w1, b1, w2, b2, act, eps)

    @staticmethod
    def backward(ctx, gy):
        act, eps = ctx.act, ctx.eps
        grads = _recompute_grads(
            lambda x, *w: _mlp_block_xla(x.to(torch.bfloat16), *w, act, eps),
            ctx.saved_tensors, gy)
        return (*grads, None, None)


def mlp_fused(x2, w1, b1, w2, b2, *, act: str = "gelu"):
    """K6 on (M, K) rows, bf16 result. CPU tensors take the plain
    `_mlp_xla` in bf16; CUDA tensors launch the kernel or raise. Under
    autograd the backward recomputes the plain version."""
    if needs_grad(x2, w1, b1, w2, b2):
        return _MlpFused.apply(x2, w1, b1, w2, b2, act)
    return _mlp_fwd(x2, w1, b1, w2, b2, act)


mlp_fused.launches = 0


def mlp_block_fused(x2, lnw, lnb, w1, b1, w2, b2, *, act: str = "gelu",
                    eps: float = 1e-6):
    """K2 on (M, K) rows, bf16 result. CPU tensors take the plain
    `_mlp_block_xla` in bf16; CUDA tensors launch the kernel or raise.
    Under autograd the backward recomputes the plain version."""
    if needs_grad(x2, lnw, lnb, w1, b1, w2, b2):
        return _MlpBlockFused.apply(x2, lnw, lnb, w1, b1, w2, b2, act, eps)
    return _mlp_block_fwd(x2, lnw, lnb, w1, b1, w2, b2, act, eps)


mlp_block_fused.launches = 0


def mlp_train_fused(x2, w1, b1, w2, b2, *, act: str = "gelu"):
    """K5a on (M, K) rows: (y (M, K), h (M, F)), both bf16, h = x w1 + b1
    the pre-activation the backward reads. CPU tensors take
    `_mlp_train_plain`; CUDA tensors launch the kernel or raise."""
    if _device_of(x2, "mlp_train_fused", w1, b1, w2, b2) == "cpu":
        return _mlp_train_plain(x2, w1, b1, w2, b2, act)
    y, h = _launch_mlp(x2, None, None, w1, b1, w2, b2, act, 0.0,
                       "mlp_train_fwd", spill=True)
    _count_launch(mlp_train_fused, x2.shape[1])
    return y, h


mlp_train_fused.launches = 0
mlp_train_fused.launches_by_width = {}


def mlp_bwd_fused(h, g2, w1, w2, *, act: str = "gelu"):
    """K5b: from the spilled h (M, F) and g2 = dL/dy (M, K) return dx
    (M, K), dh and a = act(h) (M, F), all bf16; w1 (K, F), w2 (F, K).
    CPU tensors take `_mlp_bwd_plain`; CUDA tensors launch the kernel or
    raise."""
    if _device_of(h, "mlp_bwd_fused", w1, w2) == "cpu":
        return _mlp_bwd_plain(h, g2, w1, w2, act)
    m, f = h.shape
    k = g2.shape[1]
    _check_mlp_shape(k, f, act, "mlp_bwd")
    if g2.shape != (m, k) or w1.shape != (k, f) or w2.shape != (f, k):
        raise ValueError(f"mlp_bwd: h {tuple(h.shape)}, g {tuple(g2.shape)}"
                         f", w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} do "
                         "not fit")
    for t in (g2, w1, w2):
        if t.device != h.device:
            raise ValueError(f"mlp_bwd: operands on {t.device}, h on "
                             f"{h.device}")
    bf16 = torch.bfloat16
    # the kernel reads the Linear layouts (F, K) and (K, F): for transposed
    # views of a Linear's bf16 weights the conversion below copies nothing
    h, g2 = h.to(bf16).contiguous(), g2.to(bf16).contiguous()
    w1t = w1.to(bf16).t().contiguous()
    w2t = w2.to(bf16).t().contiguous()
    dx = torch.empty((m, k), dtype=bf16, device=h.device)
    dh = torch.empty((m, f), dtype=bf16, device=h.device)
    a = torch.empty_like(dh)
    rc = _build.lib().smb_mlp_bwd(
        h.data_ptr(), g2.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
        dx.data_ptr(), dh.data_ptr(), a.data_ptr(), m, k, f, _ACTS[act],
        _build.stream_ptr(h.device))
    _build.check(rc, "mlp_bwd")
    _count_launch(mlp_bwd_fused, k)
    return dx, dh, a


mlp_bwd_fused.launches = 0
mlp_bwd_fused.launches_by_width = {}


def _weight_grad(a, b):
    """a^T b of two bf16 (M, .) tensors with a float32 result, as the JAX
    `_mlp_fused_tb_bwd` takes dw1 and dw2 (`preferred_element_type=
    jnp.float32`): on CUDA one bf16 GEMM with f32 accumulation and an f32
    output (cuBLAS, on the tensor cores); on the CPU, whose `mm` has no
    bf16 -> f32 kernel, the f32 product of the same operands."""
    if a.device.type == "cuda":
        return torch.mm(a.t(), b, out_dtype=torch.float32)
    return torch.matmul(a.t().float(), b.float())


class _MlpTrain(torch.autograd.Function):
    """mlp_impl "pallas_bwd" under autograd: K5a forward, K5b backward, and
    the weight gradients as plain products outside the kernel
    (`smb_vision_tpu/ops/mlp.py` `_mlp_fused_tb`). dw1 = x^T dh and dw2 =
    a^T g are products of the bf16 operands kept in f32 (`_weight_grad`),
    as the JAX package keeps them, then cast to the weights' dtype; db1
    and db2 are f32 sums."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, act):
        xb = x2.to(torch.bfloat16).contiguous()
        y, h = mlp_train_fused(xb, w1, b1, w2, b2, act=act)
        ctx.save_for_backward(xb, h, w1, w2)
        ctx.act = act
        ctx.dtypes = (x2.dtype, b1.dtype, b2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        xb, h, w1, w2 = ctx.saved_tensors
        x_dt, b1_dt, b2_dt = ctx.dtypes
        g2 = gy.to(torch.bfloat16).contiguous()
        dx, dh, a = mlp_bwd_fused(h, g2, w1, w2, act=ctx.act)
        need = ctx.needs_input_grad
        dw1 = _weight_grad(xb, dh).to(w1.dtype) if need[1] else None
        db1 = dh.float().sum(0).to(b1_dt) if need[2] else None
        dw2 = _weight_grad(a, g2).to(w2.dtype) if need[3] else None
        db2 = g2.float().sum(0).to(b2_dt) if need[4] else None
        return dx.to(x_dt), dw1, db1, dw2, db2, None


def mlp_pallas_bwd(x2, w1, b1, w2, b2, *, act: str = "gelu"):
    """mlp_impl "pallas_bwd" on (M, K) rows, bf16 result: K5a + K5b under
    autograd; K6 when nothing is differentiated (eval, no_grad, the
    forward half of a checkpointed block run without grad), since the h
    spill exists only for the backward."""
    if needs_grad(x2, w1, b1, w2, b2):
        return _MlpTrain.apply(x2, w1, b1, w2, b2, act)
    return mlp_fused(x2, w1, b1, w2, b2, act=act)


def auto_routes(k: int, f: int, act: str, dtype) -> bool:
    """Whether mlp impl 'auto' sends an MLP of (K, F, act) in dtype to a
    fused kernel: only in bf16 (the kernels compute in bf16, so an f32
    model must not silently degrade) and at a shape that maps."""
    return dtype == torch.bfloat16 and kernel_maps(k, f, act)


def _route(impl: str, x, w1, b1, b2, act: str, kernel_impls) -> bool:
    """True when the call goes to a fused kernel: under 'auto' as
    `auto_routes` decides, with both biases; a forced kernel impl that
    cannot map raises."""
    k, f = x.shape[-1], w1.shape[1]
    maps = b1 is not None and b2 is not None and kernel_maps(k, f, act)
    if impl == "auto":
        return maps and auto_routes(k, f, act, x.dtype)
    if impl in kernel_impls:
        if not maps:
            raise ValueError(
                f"mlp impl={impl!r} cannot map x={tuple(x.shape)}, "
                f"w1={tuple(w1.shape)}, act={act!r}: K a multiple of "
                f"{_KERNEL_K_STEP}, F a multiple of {_KERNEL_F_STEP}, "
                "biases present")
        return True
    return False


def mlp_forward(x, w1, b1, w2, b2, *, act: str = "gelu", impl: str = "auto"):
    """Transformer MLP y = act(x w1 + b1) w2 + b2; x (..., K), w1 (K, F),
    b1 (F,), w2 (F, K), b2 (K,). impl: "auto" (K6 for bf16 inputs whose
    shape maps, else plain) | "pallas" (K6, recompute backward) |
    "pallas_bwd" (K5a + K5b under autograd, K6 otherwise) | "xla"
    (plain)."""
    if impl not in ("auto", "pallas", "pallas_bwd", "xla"):
        raise ValueError(f"unknown mlp impl {impl!r}; "
                         "valid: 'auto', 'pallas', 'pallas_bwd', 'xla'")
    if not _route(impl, x, w1, b1, b2, act, ("pallas", "pallas_bwd")):
        return _mlp_xla(x, w1, b1, w2, b2, act)
    fused = mlp_pallas_bwd if impl == "pallas_bwd" else mlp_fused
    y = fused(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, act=act)
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


def _swiglu_block_xla(x, lnw, lnb, w_in, b_in, w_out, b_out, eps: float):
    """x + SwiGLU(LayerNorm(x)) with the numerics of the JAX package's
    `_swiglu_block_xla`: LayerNorm statistics (E[x^2] - mean^2), scale and
    bias in f32; the products, silu and gate in x.dtype. w_in (K, 2F) holds
    the silu half, then the gate half; w_out (F, K)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = ((xf - mu) * torch.rsqrt(var + eps) * lnw.float()
          + lnb.float()).to(dt)
    h1, h2 = (torch.matmul(xn, w_in.to(dt)) + b_in.to(dt)).chunk(2, dim=-1)
    return x + (torch.matmul(F.silu(h1) * h2, w_out.to(dt)) + b_out.to(dt))


def _swiglu_block_plain(x2, lnw, lnb, w_in, b_in, w_out, b_out,
                        eps: float):
    """Plain version of K9 with the kernel's numerics: LayerNorm in f32,
    xn rounded to bf16; h = xn w_in + b_in from bf16 operands in f32; g =
    silu(h1) * h2 rounded to bf16; the w_out product in f32, plus b_out
    and the residual in f32, rounded once to bf16."""
    bf16 = torch.bfloat16
    xf = x2.to(bf16).float()
    xn = F.layer_norm(xf, (xf.shape[-1],), lnw.float(), lnb.float(), eps)
    h = (torch.matmul(xn.to(bf16).float(), w_in.to(bf16).float())
         + b_in.float())
    h1, h2 = h.chunk(2, dim=-1)
    g = (F.silu(h1) * h2).to(bf16).float()
    y = torch.matmul(g, w_out.to(bf16).float()) + b_out.float() + xf
    return y.to(bf16)


def swiglu_kernel_maps(k: int, f: int) -> bool:
    """Whether K9 takes this (K, F), forward and under autograd alike; rows
    are free."""
    return (k > 0 and k % _KERNEL_K_STEP == 0 and f > 0
            and f % _KERNEL_F_STEP == 0)


def _swiglu_block_fwd(x2, lnw, lnb, w_in, b_in, w_out, b_out, eps: float):
    """K9 or its plain version, by the device of x2; no autograd."""
    if _device_of(x2, "swiglu_block_fused", w_in, b_in,
                  w_out, b_out) == "cpu":
        return _swiglu_block_plain(x2, lnw, lnb, w_in, b_in, w_out, b_out,
                                   eps)
    m, k = x2.shape
    f = w_out.shape[0]
    if not swiglu_kernel_maps(k, f):
        raise ValueError(f"swiglu_block_fwd: no kernel for K={k}, F={f} (K "
                         f"a multiple of {_KERNEL_K_STEP}, F a multiple of "
                         f"{_KERNEL_F_STEP})")
    if w_in.shape != (k, 2 * f) or w_out.shape != (f, k):
        raise ValueError(f"swiglu_block_fwd: w_in {tuple(w_in.shape)}, w_out "
                         f"{tuple(w_out.shape)} do not fit x "
                         f"{tuple(x2.shape)}")
    dev = x2.device
    bf16 = torch.bfloat16
    # the kernel reads the Linear layouts (2F, K) and (K, F): for transposed
    # views of a Linear's bf16 weights the conversion below copies nothing
    x2 = x2.to(bf16).contiguous()
    w1t = w_in.to(bf16).t().contiguous()
    w2t = w_out.to(bf16).t().contiguous()
    b_in, b_out = b_in.float().contiguous(), b_out.float().contiguous()
    lnw, lnb = lnw.float().contiguous(), lnb.float().contiguous()
    for t in (w1t, w2t, b_in, b_out, lnw, lnb):
        if t.device != dev:
            raise ValueError(f"swiglu_block_fwd: weights on {t.device}, x on "
                             f"{dev}")
    out = torch.empty((m, k), dtype=bf16, device=dev)
    chunk, ws, xn = _mlp_workspace(m, k, f, True, dev)
    rc = _build.lib().smb_swiglu_fwd(
        x2.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1t.data_ptr(),
        b_in.data_ptr(), w2t.data_ptr(), b_out.data_ptr(), out.data_ptr(),
        m, k, f, float(eps), _build.stream_ptr(dev), ws.data_ptr(),
        xn.data_ptr(), chunk)
    _build.check(rc, "swiglu_block_fwd")
    swiglu_block_fused.launches += 1
    return out


class _SwigluBlockFused(torch.autograd.Function):
    """K9 forward; the backward recomputes the plain half-block under
    autograd (`smb_vision_tpu/ops/mlp.py` `_swiglu_block_fused_bwd`)."""

    @staticmethod
    def forward(ctx, x2, lnw, lnb, w_in, b_in, w_out, b_out, eps):
        ctx.save_for_backward(x2, lnw, lnb, w_in, b_in, w_out, b_out)
        ctx.eps = eps
        return _swiglu_block_fwd(x2, lnw, lnb, w_in, b_in, w_out, b_out, eps)

    @staticmethod
    def backward(ctx, gy):
        eps = ctx.eps
        grads = _recompute_grads(
            lambda x, *w: _swiglu_block_xla(x.to(torch.bfloat16), *w, eps),
            ctx.saved_tensors, gy)
        return (*grads, None)


def swiglu_block_fused(x2, lnw, lnb, w_in, b_in, w_out, b_out, *,
                       eps: float = 1e-6):
    """K9 on (M, K) rows, bf16 result; w_in (K, 2F), w_out (F, K). CPU
    tensors take `_swiglu_block_plain`; CUDA tensors launch the kernel or
    raise. Under autograd the backward recomputes the plain half-block
    `_swiglu_block_xla`, as the JAX package's does."""
    if needs_grad(x2, lnw, lnb, w_in, b_in, w_out, b_out):
        return _SwigluBlockFused.apply(x2, lnw, lnb, w_in, b_in, w_out,
                                       b_out, eps)
    return _swiglu_block_fwd(x2, lnw, lnb, w_in, b_in, w_out, b_out, eps)


swiglu_block_fused.launches = 0


def swiglu_block_forward(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, *,
                         eps: float = 1e-6, impl: str = "auto"):
    """SwiGLU half-block y = x + (silu(h1) * h2) w_out + b_out, [h1 | h2] =
    LN(x) w_in + b_in (the DINOv2 use_swiglu_ffn FFN; LayerScale folds into
    w_out/b_out at the caller). impl: "pallas" (K9, recompute backward) |
    "auto" | "xla" (plain). "auto" is plain, as the JAX package resolves
    it; "pallas" on a shape K9 does not take raises."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown mlp impl {impl!r}; "
                         "valid: 'auto', 'pallas', 'xla'")
    if impl != "pallas":
        return _swiglu_block_xla(x, ln_scale, ln_bias, w_in, b_in, w_out,
                                 b_out, eps)
    k, f2 = w_in.shape
    if f2 % 2 or not swiglu_kernel_maps(x.shape[-1], f2 // 2):
        raise ValueError(
            f"swiglu block impl='pallas' cannot map x={tuple(x.shape)}, "
            f"w_in={tuple(w_in.shape)}: K a multiple of {_KERNEL_K_STEP}, "
            f"F a multiple of {_KERNEL_F_STEP}")
    y = swiglu_block_fused(x.reshape(-1, x.shape[-1]), ln_scale, ln_bias,
                           w_in, b_in, w_out, b_out, eps=eps)
    return y.reshape(x.shape).to(x.dtype)
