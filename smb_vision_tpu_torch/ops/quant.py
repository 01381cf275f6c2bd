"""W8A8: int8 weights and activations for the inference projections.

Counterpart of `smb_vision_tpu/ops/quant.py` (`w8a8_dot`). x @ W^T with
activations quantised per row (per token) and the weight per output
channel, both symmetric with dynamic abs-max scales:

    sx = max|x_row| * f32(1/127)   (1 where that is 0)
    x8 = clip(round(x / sx), -127, 127)    (a true division, ties to even)
    y  = f32(x8 w8^T as int32) * (sx sw)   (the scales multiplied first)

cast to the output dtype. The JAX package's `max / 127.` runs under jit,
where XLA folds a division by a constant into a multiply by its f32
reciprocal (`INV127`); its `x / sx` divides by a tensor and stays a
division. `QuantDense` (`models/layers.py::QuantLinear` here) then adds
the bias in the output dtype, a second rounding. The weight is an
`nn.Linear` weight (out, in), so its per-channel quantisation is the
per-row one of its rows.

Two hand-written CUDA kernels stand behind it, where the JAX package
leaves both steps to XLA (no Pallas kernel):

- `quantize_rows_kernel` (`csrc/quant.cu`): `quantize_rows_plain`, bit
  for bit, for bf16 or f32 rows at any K, the codes zero-padded to a
  multiple of 16 columns (`K_ALIGN`, what TMA reads: zeros are exact in
  the int32 product);
- `w8a8_gemm_kernel` (`csrc/w8a8.cu`): the s8 x s8 -> s32 product on
  int8 wgmma with the dequantisation and the bias in its epilogue, in
  QuantDense's order of operations, so that on the same codes it is
  `w8a8_linear_plain` bit for bit; bf16 or f32 out.

Each wrapper runs the plain version for tensors on the CPU and launches
its kernel for CUDA tensors; there is no fallback between the two.
Inference only: under autograd every route raises (the rounding has zero
gradient almost everywhere). `launches` on each kernel wrapper counts its
launches. `WeightCodes` keeps a weight's codes until the weight changes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from smb_vision_tpu_torch.ops import _build
from smb_vision_tpu_torch.ops.attention import INV127, needs_grad

# contraction columns of the codes are padded with zeros to a multiple of
# this (TMA reads rows whose stride is a multiple of 16 bytes)
K_ALIGN = 16
# output columns of a bf16 result are stored with a row stride of a
# multiple of this (the TMA store's 16 bytes)
_OUT_ALIGN = 8


def padded_k(k: int) -> int:
    return -(-k // K_ALIGN) * K_ALIGN


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if autograd would differentiate a W8A8 call on these tensors."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} (W8A8, quant8) is inference-only and has no backward: "
            "its rounding has zero gradient almost everywhere; run it under "
            "torch.no_grad() or unset quant8")


def quantize_rows_plain(x, kpad: Optional[int] = None):
    """Per-row symmetric int8 quantisation of x (..., K) flattened to
    (rows, K), as the JAX `w8a8_dot` computes it under jit: s = max|x_row|
    * f32(1/127) (1 where that is 0), x8 = clip(round(x / s), -127, 127),
    ties to even. Returns x8 (rows, kpad) int8, zeros past K (kpad
    defaults to K), and s (rows,) f32. The plain version of
    `quantize_rows_kernel`."""
    k = x.shape[-1]
    xf = x.reshape(-1, k).float()
    s = xf.abs().amax(dim=1) * INV127
    s = torch.where(s == 0, torch.ones_like(s), s)
    x8 = torch.clamp(torch.round(xf / s[:, None]), -127, 127).to(torch.int8)
    if kpad is not None and kpad != k:
        x8 = torch.nn.functional.pad(x8, (0, kpad - k))
    return x8.contiguous(), s


def quantize_rows_kernel(x, kpad: Optional[int] = None):
    """`quantize_rows_plain` of a CUDA bf16 or f32 tensor (..., K) by its
    kernel (`csrc/quant.cu`, one warp a row), the same codes and scales bit
    for bit; kpad (a multiple of K_ALIGN, at least K; default
    `padded_k(K)`) columns of codes, zeros past K. The last dim must be
    contiguous. Raises for a tensor that is not on CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows_kernel runs on cuda, not "
                         f"{x.device}; quantize_rows_plain is the plain "
                         "version")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("quantize_rows_kernel takes bfloat16 or float32 "
                         f"rows, not {x.dtype}")
    k = x.shape[-1]
    kpad = padded_k(k) if kpad is None else kpad
    if kpad < k or kpad % K_ALIGN:
        raise ValueError(f"quantize_rows_kernel: kpad {kpad} must be a "
                         f"multiple of {K_ALIGN} and at least K {k}")
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    x8 = torch.empty((rows, kpad), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return x8, s
    rc = _build.lib().smb_quantize_rows(
        x2.data_ptr(), rows, k, x2.stride(0), int(x2.dtype == torch.float32),
        kpad, s.data_ptr(), x8.data_ptr(), _build.stream_ptr(x.device))
    _build.check(rc, "quantize_rows")
    quantize_rows_kernel.launches += 1
    return x8, s


quantize_rows_kernel.launches = 0


def quantize_rows(x, kpad: Optional[int] = None):
    """`quantize_rows_plain` of a CPU tensor, its kernel for a CUDA one."""
    if x.device.type == "cuda":
        return quantize_rows_kernel(x, kpad)
    return quantize_rows_plain(x, kpad)


def w8a8_linear_plain(x8, sx, w8, sw, bias=None,
                      dtype: torch.dtype = torch.bfloat16):
    """Plain version of `w8a8_gemm_kernel` on codes: y = f32(x8 w8^T) *
    (sx sw), rounded to dtype, then + bias (in dtype: a second rounding),
    as `QuantDense` computes it. x8 (M, K), w8 (N, K) int8; sx (M,), sw
    (N,) f32; bias (N,) or None. Returns (M, N) in dtype. The integer
    product runs in float64, exactly: every product and partial sum is an
    integer below 2^31, which float64 holds in any order of summation (and
    a float64 matmul runs on the CPU and the card alike)."""
    acc = torch.matmul(x8.double(), w8.double().t()).float()
    y = (acc * (sx[:, None] * sw[None, :])).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def w8a8_gemm_kernel(x8, sx, w8, sw, bias=None,
                     dtype: torch.dtype = torch.bfloat16):
    """`w8a8_linear_plain` by its kernel (`csrc/w8a8.cu`), bit for bit: x8
    (M, Kp) and w8 (N, Kp) int8 contiguous with Kp a multiple of K_ALIGN;
    sx (M,), sw (N,) f32; bias (N,) (cast to dtype) or None; dtype bf16 or
    f32. Returns (M, N) in dtype (a bf16 result whose N is no multiple of
    8 is a view of a wider allocation). Raises for tensors not on CUDA."""
    if x8.device.type != "cuda":
        raise ValueError(f"w8a8_gemm_kernel runs on cuda, not {x8.device}; "
                         "w8a8_linear_plain is the plain version")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w8a8_gemm_kernel writes bfloat16 or float32, not "
                         f"{dtype}")
    m, kp = x8.shape
    n = w8.shape[0]
    if x8.dtype != torch.int8 or w8.dtype != torch.int8 \
            or w8.shape[1] != kp or kp % K_ALIGN \
            or not (x8.is_contiguous() and w8.is_contiguous()):
        raise ValueError("w8a8_gemm_kernel takes contiguous int8 codes (M, "
                         f"Kp) and (N, Kp), Kp a multiple of {K_ALIGN}; got "
                         f"{x8.dtype} {tuple(x8.shape)} and {w8.dtype} "
                         f"{tuple(w8.shape)}")
    if sx.shape != (m,) or sw.shape != (n,):
        raise ValueError(f"w8a8_gemm_kernel: scales {tuple(sx.shape)} and "
                         f"{tuple(sw.shape)} do not fit ({m}, {n})")
    dev = x8.device
    ld = n if dtype == torch.float32 else -(-n // _OUT_ALIGN) * _OUT_ALIGN
    out = torch.empty((m, ld), dtype=dtype, device=dev)
    if m == 0:
        return out[:, :n]
    sx, sw = sx.float().contiguous(), sw.float().contiguous()
    b = None if bias is None else bias.to(dtype).contiguous()
    rc = _build.lib().smb_w8a8_gemm(
        x8.data_ptr(), w8.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        _build.ptr(b), out.data_ptr(), m, n, kp, ld,
        int(dtype == torch.float32), _build.stream_ptr(dev))
    _build.check(rc, "w8a8_gemm")
    w8a8_gemm_kernel.launches += 1
    return out if ld == n else out[:, :n]


w8a8_gemm_kernel.launches = 0


def w8a8_linear(x, codes: Tuple[torch.Tensor, torch.Tensor], bias=None):
    """QuantDense on a quantised weight: x (..., K) -> (..., N) in x's
    dtype, x quantised per row, codes = (w8 (N, Kp), sw (N,)) as
    `quantize_rows` gives them for the weight, + bias in x's dtype. By the
    kernels on CUDA tensors (x bf16 or f32), the plain versions on CPU
    tensors. Raises under autograd."""
    refuse_autograd("w8a8_linear", x, bias)
    w8, sw = codes
    lead, k = x.shape[:-1], x.shape[-1]
    if w8.shape[1] != padded_k(k):
        raise ValueError(f"w8a8_linear: codes {tuple(w8.shape)} do not fit "
                         f"K {k}")
    x8, sx = quantize_rows(x, w8.shape[1])
    if x.device.type == "cuda":
        y = w8a8_gemm_kernel(x8, sx, w8, sw, bias, x.dtype)
    else:
        y = w8a8_linear_plain(x8, sx, w8, sw, bias, x.dtype)
    return y.reshape(*lead, w8.shape[0])


def w8a8_dot(x, weight):
    """The JAX `w8a8_dot` with an nn.Linear weight: x (..., K) (bf16 or
    f32 on CUDA), weight (N, K) -> x W^T (..., N) in x.dtype, both
    quantised (x per row, W per output channel), by the kernels on CUDA
    tensors. Raises under autograd."""
    refuse_autograd("w8a8_dot", x, weight)
    return w8a8_linear(x, quantize_rows(weight, padded_k(x.shape[-1])))


class WeightCodes:
    """The codes of one or more stacked weights, quantised at the first
    call and kept while none of the weights changes: the cache is keyed by
    each tensor's identity, storage, device and version counter
    (`_version`, which every in-place write bumps: an optimizer step,
    `load_state_dict`'s copies), so a changed weight is quantised again.
    An inference tensor (made under `torch.inference_mode`) counts no
    versions, so weights among which one is such are quantised at every
    call, as the JAX package does."""

    def __init__(self):
        self._key = None
        self._codes = None
        self._weights = ()   # held, so that no other tensor takes their ids

    @staticmethod
    def _key_of(weights: Sequence[torch.Tensor]):
        return tuple((id(w), w.data_ptr(), w.device, w.dtype,
                      tuple(w.shape), w._version) for w in weights)

    def get(self, weights: Sequence[torch.Tensor]):
        """(w8 (sum N, Kp), sw (sum N,)) of the weights stacked by rows."""
        fresh = any(w.is_inference() for w in weights)
        key = None if fresh else self._key_of(weights)
        if fresh or key != self._key:
            with torch.no_grad():
                w = weights[0] if len(weights) == 1 else torch.cat(
                    list(weights))
                codes = quantize_rows(w.detach(), padded_k(w.shape[-1]))
            if fresh:
                return codes
            self._key, self._codes, self._weights = key, codes, tuple(weights)
        return self._codes
