"""Multi-head attention: the plain PyTorch versions and the flash kernels.

Counterpart of `smb_vision_tpu/ops/attention.py`. The public functions keep
the JAX package's `(B, N, H, D)` layout. Five hand-written CUDA kernels
stand behind them, at every head width up to 128:

- K1 `flash_attention` (`csrc/flash_fwd.cu`): bf16 flash forward with the
  row logsumexp (replaces `_fwd_kernel`), on wgmma with q, k, v read by
  TMA (`_tma_geometry`);
- K4 `flash_attention_bwd` (`csrc/flash_bwd.cu`): its backward, dq and
  dk/dv in two passes (replaces `_bwd_dq_kernel` and `_bwd_dkv_kernel`),
  on wgmma and TMA as K1;
- K3 `flash_attention_int8` (`csrc/flash_fwd.cu`): the forward with `q k^T`
  on int8 with per-(batch, head) symmetric scales (replaces
  `_fwd_i8_kernel`, pv=False), K1's design on int8 wgmma. Forward only, as
  in the JAX package;
- K7 `flash_attention_bwd_i8` (`csrc/flash_bwd.cu`): K4 with the score
  recompute and `do v^T` on int8 wgmma (replaces `_bwd_dq_i8_kernel` and
  `_bwd_dkv_i8_kernel`; attn_impl "pallas_i8bwd");
- K8 `flash_attention_int8pv` (`csrc/flash_fwd.cu`): K3 with `p v` on int8
  too, p requantised per 64-key sub-block against the sub-block's max
  (replaces `_fwd_i8_kernel`, pv=True; attn_impl "pallas_int8pv"), on
  int8 wgmma with p from registers. Forward only.

The int8 operands of K3, K7 and K8 come from one more kernel,
`quantize_per_head_kernel` (`csrc/quant.cu`, R6): the per-(batch, head)
quantisation `quantize_per_head`, bit for bit, which the JAX package
leaves to XLA. It also writes v8 straight in the layout K8 reads.

Head widths. The kernels run a head of width d on the instantiation of
the next of their widths up (`_tile_width`): 32, 64, 80 and 128 for K1,
K4, K3 and K7, 32, 64 and 128 for K8. bf16 operands are read in place by
TMA maps whose global width is d (the columns past d read as zero; the
tiles of 80 columns are a 64-column panel and a 16-column one,
`_tma_geometry`), int8 codes are written by R6 at the code width of the
kernel's instantiation (`_code_width`: its width, but 96 on the tiles of
80 columns, a 64-byte panel and a 32-byte one) with zero columns past d,
and only d columns are stored. A d that is not a
multiple of 8 is padded with zeros by a copy first, as the JAX
`attention` pads it, and the outputs are cut back (the backward's: do
padded, dq, dk and dv cut). Past 128 no kernel runs: "auto" takes the
plain attention, and a forced kernel impl raises on the card.

K1 with K4 or K7 forms one `torch.autograd.Function`, the counterpart of
the JAX package's `jax.custom_vjp` around `_flash`/`_flash_i8b`/
`_flash_lse`. Each wrapper runs
its plain version for a tensor on the CPU and launches its kernel for a
CUDA tensor; there is no fallback between the two. `launches` on each
wrapper counts kernel launches (the five flash kernels also by head
width, `launches_by_width`; the quantisation once a tensor).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from smb_vision_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
# 1/127 rounded to f32. The JAX package's `max / 127.` runs under jit,
# where XLA folds a division by a constant into a multiply by its f32
# reciprocal, and PyTorch on CUDA divides a tensor by a Python scalar the
# same way: the scales multiply by it on every device
INV127 = float(torch.tensor(1.0) / 127.0)
# query rows per chunk of the plain version: bounds its (B, H, rows, Nk)
# f32 score block at ~1 GiB (12 heads x 1024 x 20,480 at batch 1)
_PLAIN_SCORE_ELEMS = 1 << 28
# the widths of the flash kernels' instantiations, by kernel: each runs any
# head width up to _FLASH_MAX_D on the next of its widths up
# (`_tile_width`). K1, K4, K3 and K7 have tiles of 80 columns (heads of 66
# to 80); K8 does not
_FLASH_HEAD_DIMS = {"K1": (32, 64, 80, 128), "K4": (32, 64, 80, 128),
                    "K3": (32, 64, 80, 128), "K7": (32, 64, 80, 128),
                    "K8": (32, 64, 128)}
_FLASH_MAX_D = 128
# the bytes of an int8 code row on an instantiation of each width: whole
# rows of the width, but 96 on the tiles of 80 columns (an int8 wgmma step
# is 32 bytes deep and 80 is 2 1/2 of them: a 64-byte panel and a 32-byte
# one, `_tma_geometry`)
_CODE_BYTES = {32: 32, 64: 64, 80: 96, 128: 128}


def _tile_width(d: int, kernel: str = "K8") -> int:
    """The head width of `kernel`'s instantiation that runs heads of width
    d (at most _FLASH_MAX_D): the next of _FLASH_HEAD_DIMS[kernel] up (by
    default K8's, whose codes R6 also writes in v's layout)."""
    return next(w for w in _FLASH_HEAD_DIMS[kernel] if d <= w)


def _code_width(d: int, kernel: str = "K8") -> int:
    """The width of the int8 code rows that `kernel` (K3, K7 or K8) reads
    for heads of width d: that of its instantiation (`_tile_width`), or 96
    on the tiles of 80 columns. R6 writes the codes at it, zeros past d."""
    return _CODE_BYTES[_tile_width(d, kernel)]


def _pad8(*ts):
    """The tensors with their head dim zero-padded to a multiple of 8 by a
    copy (the JAX `attention`'s `_pad_lanes`), or as they are where it is
    one already; zeros change no score and add output columns that are
    cut off."""
    d = ts[0].shape[-1]
    if d % 8 == 0:
        return ts
    pad = -d % 8
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


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


def quantize_per_head(x, mult: float = 1.0, zero_scale: bool = False,
                      width: Optional[int] = None):
    """Symmetric int8 quantisation of x*mult (B, N, H, D) per (batch,
    head) over all (N, D), as the JAX `_quant_per_head` (and `_fwd_i8`)
    compute it under jit: s = max|x| * f32(1/127) (1 where x is all zero),
    x8 = clip(round(x/s), -127, 127), rounding ties to even. Returns x8
    (int8, contiguous, the input layout; with width, rows of `width` >= D
    codes, zeros past D, the layout the int8 kernels read at a head width
    below their instantiation's) and s (f32, (B, H)); with zero_scale an
    all-zero head reports the scale 0 (its bytes are 0 either way). The
    plain version; `quantize_per_head_kernel` is its kernel."""
    xf = x.float() * mult
    s = xf.abs().amax(dim=(1, 3)) * INV127              # (B, H)
    zero = s == 0
    s = torch.where(zero, torch.ones_like(s), s)
    x8 = torch.clamp(torch.round(xf / s[:, None, :, None]), -127, 127)
    if zero_scale:
        s = torch.where(zero, torch.zeros_like(s), s)
    x8 = x8.to(torch.int8)
    if width is not None and width != x.shape[-1]:
        x8 = torch.nn.functional.pad(x8, (0, width - x.shape[-1]))
    return x8, s


def quantize_per_head_kernel(x, mult: float = 1.0, v_layout: bool = False,
                             zero_scale: bool = False,
                             width: Optional[int] = None):
    """R6: `quantize_per_head` of a CUDA bf16 (B, N, H, D) tensor by its
    kernel (`csrc/quant.cu`), the same int8 bytes and f32 scales bit for
    bit. The head dim must be contiguous and every row 16-byte aligned (the
    strided views of a fused projection qualify); D a multiple of 8 up to
    128. Returns x8 and s (B, H); x8 in the input's layout, contiguous, or
    with v_layout in the layout K8 reads (`quantize_v_kernel_layout` of
    the plain x8); with width (a multiple of 8, D to 128) the rows hold
    `width` codes, zeros past D, as `quantize_per_head` pads them;
    zero_scale as `quantize_per_head` takes it. Raises for a tensor that
    is not on CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_per_head_kernel runs on cuda, not "
                         f"{x.device}; quantize_per_head is the plain "
                         "version")
    d = x.shape[-1]
    width = d if width is None else width
    if x.dim() != 4 or x.dtype != torch.bfloat16 or d % 8 \
            or not d <= width <= _FLASH_MAX_D or width % 8:
        raise ValueError(f"quantize_per_head_kernel takes bfloat16 (B, N, "
                         f"H, D) with D a multiple of 8 up to "
                         f"{_FLASH_MAX_D}, and a width from D to "
                         f"{_FLASH_MAX_D} that is one too; got {x.dtype} "
                         f"{tuple(x.shape)}, width {width}")
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            (st * 2) % 16 for st in x.stride()[:3]):
        raise ValueError("quantize_per_head_kernel: the head dim must be "
                         "contiguous and rows 16-byte aligned; got strides "
                         f"{x.stride()}")
    b, n, h, d = x.shape
    dev = x.device
    npad = -(-n // PV_SUB) * PV_SUB if v_layout else 0
    x8 = torch.empty((b, h, width, npad) if v_layout else (b, n, h, width),
                     dtype=torch.int8, device=dev)
    s = torch.empty((b, h), dtype=torch.float32, device=dev)
    amax = torch.empty((b, h), dtype=torch.int32, device=dev)
    strides = (ctypes.c_longlong * 3)(*x.stride()[:3])
    rc = _build.lib().smb_quantize(
        x.data_ptr(), b, n, h, d, ctypes.cast(strides, ctypes.c_void_p),
        mult, amax.data_ptr(), s.data_ptr(), x8.data_ptr(), npad,
        int(zero_scale), _build.stream_ptr(dev), width)
    _build.check(rc, "quantize")
    quantize_per_head_kernel.launches += 1
    return x8, s


quantize_per_head_kernel.launches = 0


def _quantize(x, mult: float = 1.0, zero_scale: bool = False,
              width: Optional[int] = None):
    """`quantize_per_head` of a CPU tensor, its kernel for a CUDA one."""
    if x.device.type == "cuda":
        return quantize_per_head_kernel(x, mult, zero_scale=zero_scale,
                                        width=width)
    return quantize_per_head(x, mult, zero_scale, width)


def quantize_qk(q, k, scale: float, quant=_quantize, kernel: str = "K3"):
    """The scores' operands of K3 (or K8 with kernel="K8"), as the JAX
    `_fwd_i8` quantises them: q is pre-scaled by scale*log2(e), so q8 k8^T
    * sq * sk is a score in log2 units. Returns q8, k8 (int8, rows of the
    code width the kernel reads, `_code_width(D, kernel)`, zeros past D;
    D past the kernels' widths, where only the plain versions run) and sq,
    sk (f32, (B, H)), by the kernel on CUDA tensors
    (`quant=quantize_per_head` for the plain version there)."""
    d = q.shape[-1]
    w = _code_width(d, kernel) if d <= _FLASH_MAX_D else d
    q8, sq = quant(q, scale * LOG2E, width=w)
    k8, sk = quant(k, width=w)
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


LOG127 = math.log2(127.0)
# kv width over which K8 requantises p: the kernel's sub-block
# (csrc/flash_fwd.cu kPvSub), and the JAX kernel's sub-block at block_k 64
PV_SUB = 64


def int8pv_attention_plain(q8, k8, sq, sk, v8, sv, sub: int = PV_SUB):
    """Plain version of K8 on quantised operands (the JAX `_fwd_i8_kernel`
    with pv=True). q8, k8, v8 int8 (B, N, H, D); sq, sk, sv f32 (B, H).
    Per kv sub-block u of `sub` keys and per query row: the scores s = q8
    k8^T * sq * sk (exact integers times the scale), their max sm_u,
    p8 = floor(exp2(s - sm_u + log2 127) + 0.5) in 0..127 (keys past N
    count 0), and the integer sums n_u = p8 v8 and l_u = sum p8. Then
    o = sv * sum_u w_u n_u / sum_u w_u l_u with w_u = exp2(sm_u - max sm):
    numerator and denominator come from the same integers p8. Returns bf16
    (B, Nq, H, D)."""
    b, nq, h, _ = q8.shape
    nk, d = k8.shape[1], v8.shape[-1]
    nsub = -(-nk // sub)
    pad = nsub * sub - nk
    kt = k8.float().permute(0, 2, 3, 1)                 # (B, H, D, Nk)
    vh = v8.float().permute(0, 2, 1, 3)                 # (B, H, Nk, D)
    if pad:
        vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    vh = vh.reshape(b, h, nsub, sub, d)
    ss = (sq * sk)[:, :, None, None]
    step = _plain_chunk(b, h, nsub * sub)
    outs = []
    for s0 in range(0, nq, step):
        qc = q8[:, s0:s0 + step].float().permute(0, 2, 1, 3)
        st = torch.matmul(qc, kt) * ss                  # (B, H, c, Nk)
        if pad:
            st = torch.nn.functional.pad(st, (0, pad), value=-math.inf)
        st = st.reshape(*st.shape[:3], nsub, sub)
        sm = st.amax(dim=-1, keepdim=True)              # (B, H, c, U, 1)
        p8 = torch.floor(torch.exp2(st - sm + LOG127) + 0.5)
        num = torch.einsum("bhcus,bhusd->bhcud", p8, vh)
        den = p8.sum(dim=-1, keepdim=True)
        w = torch.exp2(sm - sm.amax(dim=-2, keepdim=True))
        o = (num * w).sum(-2) / (den * w).sum(-2)
        outs.append((o * sv[:, :, None, None]).to(torch.bfloat16))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3).contiguous()


def quantize_v_kernel_layout(v8, width: Optional[int] = None):
    """v8 (B, N, H, D) int8 in the layout K8 reads: (B, H, W, N_pad), W the
    row count `width` (D by default; zero rows past D), keys
    contiguous (integer wgmma reads its B operand K-major), N padded with
    zeros to a multiple of the requantisation sub-block (PV_SUB), and
    within each group of 32 keys the key order the kernel's int8 p
    fragments take. A thread's p8 (the s32 score accumulator's layout)
    holds keys {2t, 2t+1, 8+2t, 9+2t} (and the same + 16) of a 32-key step,
    and its A fragment of the k32 step is the bytes at k 4t..4t+3 (and
    16+4t..), so key half*16 + hi*8 + 2t + lo is stored at half*16 + 4t +
    2*hi + lo. The plain version of what `quantize_per_head_kernel` writes
    with v_layout."""
    if width is not None and width != v8.shape[-1]:
        v8 = torch.nn.functional.pad(v8, (0, width - v8.shape[-1]))
    b, n, h, d = v8.shape
    n_pad = -(-n // PV_SUB) * PV_SUB
    vt = v8.permute(0, 2, 3, 1)                          # (B, H, D, N)
    if n_pad != n:
        vt = torch.nn.functional.pad(vt, (0, n_pad - n))
    vt = vt.reshape(b, h, d, n_pad // 32, 2, 2, 4, 2)   # half, hi, t, lo
    return vt.permute(0, 1, 2, 3, 4, 6, 5, 7).reshape(b, h, d, n_pad) \
        .contiguous()


def _check_qkv(q, k, v, qk_dtype, kernel: str = "K1"):
    """Raise for operands a flash kernel does not take: a head width that
    is a multiple of 8 up to _FLASH_MAX_D (the wrappers pad any other up
    to one), q and k of qk_dtype, v bf16, rows 16-byte aligned."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Nq, H, D) and k, v (B, Nk, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head width")
    if d % 8 or d > _FLASH_MAX_D:
        raise ValueError(f"flash kernel {kernel} takes a head width that is "
                         f"a multiple of 8 up to {_FLASH_MAX_D}, got {d}")
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


# the TMA boxes of the wgmma kernels: bf16 (K1, K4, and the bf16 operands
# of K3 and K7) in panels of 64 columns, one 128-byte swizzle span, or on
# the instantiation of head width 32 rows of 32 columns (64 bytes) in the
# 64-byte swizzle, and on the tiles of 80 columns (K1, K4, K3, K7) a
# second map of the last 16 (32 bytes) in the 32-byte swizzle; the map's
# global width is the head's, so the columns of the boxes past it read as
# zero; int8 (K3, K7, K8) in whole rows of 32, 64 or 128 bytes, swizzled
# by their width, or rows of 96 (the tiles of 80 columns) by two maps, the
# first 64 bytes in the 64-byte swizzle and the last 32 in the 32-byte
# one; up to 256 rows of one (batch, head)
_TMA_BOX_COLS = 64
_TMA_TAIL_COLS = 16
_TMA_I8_TAIL = 32
_TMA_MAX_ROWS = 256


def _tma_geometry(t, rows: int, kernel: str = "K8"):
    """The tensor map `kernel`'s launch builds (`csrc/sm90.cuh::make_map`,
    `make_map_head`, `make_map_i8`) for a bf16 or int8 (B, N, H, D) tensor
    read by TMA in boxes of `rows` rows: dims (D, H, N, B), byte strides of
    H, N and B (a dim of size 1 is never stepped, so its stride is 16), box
    (cols, 1, rows, 1) and the swizzle in bytes: 64 bf16 columns with the
    128-byte swizzle (32 columns with the 64-byte swizzle for D up to 32,
    the instantiation of width 32), or a whole int8 row of D = 32, 64 or
    128 bytes with the swizzle of its width. On the tiles of 80 columns
    (`kernel` K1, K4, K3 or K7) a bf16 tensor has a second map
    (`make_map_tail`), "tail": the same dims and strides, boxes of 16
    columns at column 64 with the 32-byte swizzle; an int8 row of D = 96
    (their codes) is read by boxes of its first 64 bytes with the 64-byte
    swizzle and a "tail" map (`make_map_i8_tail`) of boxes of the last 32
    at byte 64 with the 32-byte swizzle. A bf16 D is a multiple of 8 up to
    128; the box columns past D read as zero. TMA takes a 16-byte-aligned
    base and stride multiples of 16 below 2^40; anything else raises here,
    before the launch, instead of failing the descriptor encode."""
    b, n, h, d = t.shape
    code_widths = tuple(_CODE_BYTES.values())
    if t.dtype == torch.int8:
        if t.stride(-1) != 1 or d not in code_widths:
            raise ValueError(f"TMA reads int8 (B, N, H, D) with D in "
                             f"{code_widths} and contiguous; got shape "
                             f"{tuple(t.shape)}, strides {t.stride()}")
        cols = _TMA_BOX_COLS if d == _CODE_BYTES[80] else d
    elif t.dtype == torch.bfloat16:
        if t.stride(-1) != 1 or d % 8 or not 0 < d <= _FLASH_MAX_D:
            raise ValueError(f"TMA reads (B, N, H, D) with D a multiple of "
                             f"8 up to {_FLASH_MAX_D} and contiguous; got "
                             f"shape {tuple(t.shape)}, strides "
                             f"{t.stride()}")
        cols = 32 if d <= 32 else _TMA_BOX_COLS
    else:
        raise TypeError(f"TMA maps bfloat16 or int8 tensors, not {t.dtype}")
    if not 1 <= rows <= _TMA_MAX_ROWS:
        raise ValueError(f"TMA box rows {rows} outside 1..{_TMA_MAX_ROWS}")
    if t.data_ptr() % 16:
        raise ValueError("TMA needs a 16-byte-aligned base; got "
                         f"{t.data_ptr() % 16} bytes past it")
    dims = (d, h, n, b)
    strides = []
    for size, st in zip(dims[1:], (t.stride(2), t.stride(1), t.stride(0))):
        nbytes = 16 if size == 1 else st * t.element_size()
        if nbytes <= 0 or nbytes % 16 or nbytes >= 1 << 40:
            raise ValueError(f"TMA needs byte strides that are multiples of "
                             f"16 below 2^40; got strides {t.stride()} of a "
                             f"{t.dtype} tensor")
        strides.append(nbytes)
    geometry = {"dims": dims, "strides": tuple(strides),
                "box": (cols, 1, rows, 1),
                "swizzle": cols * t.element_size()}
    if t.dtype == torch.bfloat16 and _tile_width(d, kernel) == 80:
        geometry["tail"] = {"col": _TMA_BOX_COLS,
                            "box": (_TMA_TAIL_COLS, 1, rows, 1),
                            "swizzle": _TMA_TAIL_COLS * 2}
    elif d == _CODE_BYTES[80] and t.dtype == torch.int8:
        geometry["tail"] = {"col": _TMA_BOX_COLS,
                            "box": (_TMA_I8_TAIL, 1, rows, 1),
                            "swizzle": _TMA_I8_TAIL}
    return geometry


def _count_launch(wrapper, d: int) -> None:
    """One launch of the wrapper's kernel at width d (a head's; K5a's and
    K5b's K): `launches` counts all of them, `launches_by_width` those of
    each width."""
    wrapper.launches += 1
    wrapper.launches_by_width[d] = wrapper.launches_by_width.get(d, 0) + 1


def needs_grad(*tensors) -> bool:
    """Whether autograd will differentiate a call on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _delta(do, out, g_lse):
    """delta = rowsum(do*out) (B, H, Nq) f32, less g_lse*log2(e) when lse2
    has a cotangent too (`smb_vision_tpu/ops/attention.py::_bwd`)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float() * LOG2E
    return delta.contiguous()


def attention_bwd_plain(q, k, v, out, lse, do, *, scale: float,
                        g_lse=None):
    """Plain version of K4: the flash backward by its formula, in f32,
    chunked over queries like `xla_attention` (no (N, N) block is held):
      p = exp2(s*scale*log2(e) - lse2), delta = rowsum(do*out)
          [- g_lse*log2(e) when lse2 has a cotangent too],
      ds = p*(dp - delta), dq = scale*ds k, dk = scale*ds^T q, dv = p^T do.
    q, out, do (B, Nq, H, D); k, v (B, Nk, H, D); lse, g_lse (B, H, Nq).
    Returns dq, dk, dv in the dtypes of q, k, v."""
    b, nq, h, _ = q.shape
    nk = k.shape[1]
    kf = k.float().permute(0, 2, 1, 3)                  # (B, H, Nk, D)
    vf = v.float().permute(0, 2, 1, 3)
    delta = _delta(do, out, g_lse)
    lse = lse.float()
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    step = _plain_chunk(b, h, nk)
    dqs = []
    for s0 in range(0, nq, step):
        qc = q[:, s0:s0 + step].float().permute(0, 2, 1, 3)
        doc = do[:, s0:s0 + step].float().permute(0, 2, 1, 3)
        s = torch.matmul(qc, kf.transpose(-1, -2))      # (B, H, c, Nk)
        p = torch.exp2(s * (scale * LOG2E) - lse[..., s0:s0 + step, None])
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - delta[..., s0:s0 + step, None])
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
        dv += torch.matmul(p.transpose(-1, -2), doc)
    dq = torch.cat(dqs, dim=2).permute(0, 2, 1, 3)
    return (dq.to(q.dtype).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def _launch_flash(q, k, v, sq, sk, out, lse, int8: bool, scale_log2: float):
    """K1 (K3 with int8) on operands the wrapper checked; D is v's head
    width (q8 and k8 rows hold its instantiation's)."""
    b, nq, h, _ = q.shape
    d = v.shape[-1]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    rc = _build.lib().smb_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(sq),
        _build.ptr(sk), out.data_ptr(), _build.ptr(lse), b, h, nq,
        k.shape[1], d, int(int8), ctypes.cast(strides, ctypes.c_void_p),
        scale_log2, _build.stream_ptr(q.device))
    _build.check(rc, "flash_fwd_i8" if int8 else "flash_fwd")


def _cut(out, d: int):
    """out (B, N, H, D') cut back to the head width d (a copy where D' is
    the padded width)."""
    return out if out.shape[-1] == d else out[..., :d].contiguous()


def _flash_fwd(q, k, v, scale: float, with_lse: bool):
    """K1 or its plain version, by the device of q; no autograd."""
    if q.device.type == "cpu":
        return xla_attention(q, k, v, scale=scale, with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    d0 = q.shape[-1]
    q, k, v = _pad8(q, k, v)
    _check_qkv(q, k, v, torch.bfloat16)
    for t in (q, k, v):
        _tma_geometry(t, 128, "K1")
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch_flash(q, k, v, None, None, out, lse, False, scale * LOG2E)
    _count_launch(flash_attention, d)
    return (_cut(out, d0), lse) if with_lse else _cut(out, d0)


def flash_attention_bwd(q, k, v, out, lse, do, *,
                        scale: Optional[float] = None, g_lse=None):
    """K4: the flash-attention backward. q, out, do (B, Nq, H, D); k, v
    (B, Nk, H, D); lse (B, H, Nq) f32, the forward's lse2; g_lse: an
    optional cotangent of lse2, folded into delta as the JAX package does.
    Returns dq, dk, dv. delta = rowsum(do*out) is taken in plain torch
    beforehand, as the JAX package takes it in XLA. CPU tensors take
    `attention_bwd_plain`; CUDA tensors launch the kernel or raise (a D
    that is no multiple of 8 padded by a copy, dq, dk and dv cut back)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, do, scale=scale,
                                   g_lse=g_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    d0 = q.shape[-1]
    do = do.to(torch.bfloat16)
    q, k, v, out, do = _pad8(q, k, v, out, do)
    _check_qkv(q, k, v, torch.bfloat16, "K4")
    b, nq, h, d = q.shape
    nk = k.shape[1]
    do = do.contiguous()
    if do.shape != q.shape or lse.shape != (b, h, nq):
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)} and "
                         f"lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    for t in (q, k, v, do):
        _tma_geometry(t, 128, "K4")
    delta = _delta(do, out, g_lse)
    lse = lse.float().contiguous()
    dq = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((b, nk, h, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])
    rc = _build.lib().smb_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, nq, nk, d, ctypes.cast(strides, ctypes.c_void_p),
        scale, scale * LOG2E, _build.stream_ptr(q.device))
    _build.check(rc, "flash_bwd")
    _count_launch(flash_attention_bwd, d)
    return _cut(dq, d0), _cut(dk, d0), _cut(dv, d0)


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_width = {}


def _i8_operands(q, k, v, do, scale: float, quant=_quantize,
                 width: Optional[int] = None):
    """The int8 operands of K7, quantised as the JAX `_bwd` (i8=True)
    does: q8 of q*scale*log2(e), k8, v8, do8, and the scale products sqk =
    sq*sk, sdv = sdo*sv (f32, (B, H)); by the kernel on CUDA tensors
    (`quant=quantize_per_head` for the plain version); with width, the
    codes' rows hold `width` bytes, zeros past D (K7's,
    `_code_width(D, "K7")`)."""
    q8, sq = quant(q, scale * LOG2E, width=width)
    k8, sk = quant(k, width=width)
    v8, sv = quant(v, width=width)
    # a head whose cotangent is all zero (a pipeline's bubble tick, a
    # stage's masked outputs) takes the scale 0, not the guard's 1: the
    # kernel reads dp * sdv - delta in one FFMA whose bias rounds by half a
    # unit of sdv, noise against an exact zero there
    do8, sdo = quant(do, zero_scale=True, width=width)
    return q8, k8, v8, do8, (sq * sk).contiguous(), (sdo * sv).contiguous()


def attention_bwd_i8_plain(q, k, v, out, lse, do, *, scale: float,
                           g_lse=None, width: Optional[int] = None):
    """Plain version of K7, its formula in f32 on the quantised integers
    (|q8 k8^T| <= 127^2 * 128 < 2^24 is exact in f32), query-chunked like
    `attention_bwd_plain`:
      s = q8 k8^T * sqk, p = exp2(s - lse2), dp = do8 v8^T * sdv,
      ds = bf16(p (dp - delta)), dq = scale ds k, dk = scale ds^T q,
      dv = bf16(p)^T do,
    with q, k, do as given (bf16 on the card), the codes in rows of
    `width` (K7's code width `_code_width(D, "K7")` by default, D past the
    kernels' widths; the zero columns change no sum). Returns dq, dk, dv
    in the dtypes of q, k, v."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if width is None:
        width = _code_width(d, "K7") if d <= _FLASH_MAX_D else d
    q8, k8, v8, do8, sqk, sdv = _i8_operands(q, k, v, do, scale,
                                             quantize_per_head, width)
    k8t = k8.float().permute(0, 2, 3, 1)                # (B, H, D, Nk)
    v8t = v8.float().permute(0, 2, 3, 1)
    kf = k.float().permute(0, 2, 1, 3)                  # (B, H, Nk, D)
    delta = _delta(do, out, g_lse)
    lse = lse.float()
    sqk, sdv = sqk[..., None, None], sdv[..., None, None]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(kf)
    step = _plain_chunk(b, h, nk)
    dqs = []
    for s0 in range(0, nq, step):
        sl = slice(s0, s0 + step)
        s = torch.matmul(q8[:, sl].float().permute(0, 2, 1, 3), k8t) * sqk
        p = torch.exp2(s - lse[..., sl, None])
        dp = torch.matmul(do8[:, sl].float().permute(0, 2, 1, 3), v8t) * sdv
        ds = (p * (dp - delta[..., sl, None])).to(torch.bfloat16).float()
        p = p.to(torch.bfloat16).float()
        qc = q[:, sl].float().permute(0, 2, 1, 3)
        doc = do[:, sl].float().permute(0, 2, 1, 3)
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
        dv += torch.matmul(p.transpose(-1, -2), doc)
    dq = torch.cat(dqs, dim=2).permute(0, 2, 1, 3)
    return (dq.to(q.dtype).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_attention_bwd_i8(q, k, v, out, lse, do, *,
                           scale: Optional[float] = None, g_lse=None):
    """K7: the flash-attention backward with int8 score recompute, the
    arguments and results of `flash_attention_bwd`. The int8 operands and
    their scales come from the quantisation kernel beforehand (rows of the
    instantiation's width, zeros past D), delta from plain torch, as the
    JAX package makes them in XLA. CPU tensors take
    `attention_bwd_i8_plain`; CUDA tensors launch the kernels or raise (a
    D that is no multiple of 8 padded by a copy, dq, dk and dv cut
    back)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale,
                                      g_lse=g_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_i8 runs on cpu or cuda, not "
                         f"{q.device}")
    d0 = q.shape[-1]
    do = do.to(torch.bfloat16)
    q, k, v, out, do = _pad8(q, k, v, out, do)
    _check_qkv(q, k, v, torch.bfloat16, "K7")
    b, nq, h, d = q.shape
    do = do.contiguous()
    if do.shape != q.shape or lse.shape != (b, h, nq):
        raise ValueError(f"flash_attention_bwd_i8: do {tuple(do.shape)} and "
                         f"lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    for t in (q, k, do):
        _tma_geometry(t, 128, "K7")
    ops = _i8_operands(q, k, v, do, scale, width=_code_width(d, "K7"))
    dq, dk, dv = _launch_bwd_i8(q, k, do, out, lse, ops, scale, g_lse)
    return _cut(dq, d0), _cut(dk, d0), _cut(dv, d0)


def _launch_bwd_i8(q, k, do, out, lse, ops, scale: float, g_lse=None):
    """K7's kernel on its quantised operands ops = (q8, k8, v8, do8, sqk,
    sdv), as `_i8_operands` makes them (rows of `_code_width(D, "K7")`
    codes for q's head width D, a multiple of 8); returns dq, dk, dv."""
    q8, k8, v8, do8, sqk, sdv = ops
    b, nq, h, d = q.shape
    nk = k.shape[1]
    w = _code_width(d, "K7")
    if q8.shape[-1] != w:
        raise ValueError(f"K7: codes of width {q8.shape[-1]} for heads of "
                         f"{d}; _i8_operands writes {w} with its width")
    for t in (q8, k8, v8, do8):
        _tma_geometry(t, 128)
    delta = _delta(do, out, g_lse)
    lse = lse.float().contiguous()
    dq = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q.device)
    dk = torch.empty((b, nk, h, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    ts = (q8, k8, v8, do8, k, q, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 30)(*(s for t in ts
                                         for s in t.stride()[:3]))
    rc = _build.lib().smb_flash_bwd_i8(
        q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), do8.data_ptr(),
        k.data_ptr(), q.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), sqk.data_ptr(), sdv.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, d,
        ctypes.cast(strides, ctypes.c_void_p), scale,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_bwd_i8")
    _count_launch(flash_attention_bwd_i8, d)
    return dq, dk, dv


flash_attention_bwd_i8.launches = 0
flash_attention_bwd_i8.launches_by_width = {}


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K4 backward, or K7 with int8_backward. Differentiable
    through both outputs: the lse2 cotangent folds into delta
    (`smb_vision_tpu/ops/attention.py` `_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, int8_backward):
        out, lse = _flash_fwd(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.int8_backward = int8_backward
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        bwd = (flash_attention_bwd_i8 if ctx.int8_backward
               else flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, g_out, scale=ctx.scale,
                         g_lse=g_lse)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    with_lse: bool = False, int8_backward: bool = False):
    """K1: bf16 flash-attention forward. q (B, Nq, H, D), k, v (B, Nk, H,
    D) -> out (B, Nq, H, D) [, lse2 (B, H, Nq) f32]. Under autograd its
    backward is K4, or K7 with int8_backward. CPU tensors take the plain
    versions; CUDA tensors launch the kernels or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if needs_grad(q, k, v):
        out, lse = _FlashAttention.apply(q, k, v, scale, int8_backward)
        return (out, lse) if with_lse else out
    return _flash_fwd(q, k, v, scale, with_lse)


flash_attention.launches = 0
flash_attention.launches_by_width = {}


def flash_attention_int8(q, k, v, *, scale: Optional[float] = None):
    """K3: flash forward with int8 scores. Quantises q and k per (batch,
    head) (`quantize_qk`: the quantisation kernel on CUDA tensors), then
    runs the kernel on CUDA tensors, or `int8_attention_plain` on the plain
    quantisation of CPU tensors. Forward only: under autograd it raises
    rather than return a result with no gradient."""
    if needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention_int8 (kernel K3, attn_impl='pallas_int8') is "
            "forward-only and has no backward; run it under "
            "torch.no_grad() or train with attn_impl 'pallas' or 'auto'")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return int8_attention_plain(*quantize_qk(q, k, scale), v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 runs on cpu or cuda, not "
                         f"{q.device}")
    d0 = q.shape[-1]
    q, k, v = _pad8(q, k, v)
    _check_qkv(q, k, v, torch.bfloat16, "K3")
    _tma_geometry(v, 128, "K3")
    return _cut(_launch_int8(*quantize_qk(q, k, scale), v), d0)


def _launch_int8(q8, k8, sq, sk, v):
    """K3's kernel on its quantised operands, as `quantize_qk` makes them
    (rows of the code width `_code_width(D, "K3")` for v's head width D, a
    multiple of 8)."""
    d = v.shape[-1]
    if q8.shape[-1] != _code_width(d, "K3"):
        raise ValueError(f"K3: codes of width {q8.shape[-1]} for heads of "
                         f"{d}; quantize_qk writes {_code_width(d, 'K3')}")
    for t in (q8, k8):
        _tma_geometry(t, 128)
    out = torch.empty(q8.shape[:3] + (d,), dtype=torch.bfloat16,
                      device=v.device)
    _launch_flash(q8, k8, v, sq.contiguous(), sk.contiguous(), out, None,
                  True, 0.0)
    _count_launch(flash_attention_int8, d)
    return out


flash_attention_int8.launches = 0
flash_attention_int8.launches_by_width = {}


def flash_attention_int8pv(q, k, v, *, scale: Optional[float] = None):
    """K8: flash forward with int8 scores and int8 p v. Quantises q and k
    as `quantize_qk`, and v per (batch, head), as the JAX `_fwd_i8` does
    (pv=True): on CUDA tensors by the quantisation kernel (v8 straight in
    the layout K8 reads), then runs K8; on CPU tensors by
    `quantize_per_head`, then `int8pv_attention_plain`. Forward only: under
    autograd it raises rather than return a result with no gradient."""
    if needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention_int8pv (kernel K8, attn_impl='pallas_int8pv') "
            "is forward-only and has no backward; run it under "
            "torch.no_grad() or train with attn_impl 'pallas' or 'auto'")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return int8pv_attention_plain(*quantize_qk(q, k, scale, kernel="K8"),
                                      *quantize_per_head(v))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8pv runs on cpu or cuda, not "
                         f"{q.device}")
    d0 = q.shape[-1]
    q, k, v = _pad8(q, k, v)
    _check_qkv(q, k, v, torch.bfloat16, "K8")
    q8, k8, sq, sk = quantize_qk(q, k, scale, kernel="K8")
    vt8, sv = quantize_per_head_kernel(v, v_layout=True,
                                       width=q8.shape[-1])
    return _cut(_launch_int8pv(q8, k8, sq, sk, vt8, sv, v.shape[-1]), d0)


def _launch_int8pv(q8, k8, sq, sk, vt8, sv, d: Optional[int] = None):
    """K8's kernel on its quantised operands: q8, k8 as `quantize_qk`
    makes them for K8, vt8 in `quantize_v_kernel_layout` at the codes'
    width; d, the head width (a multiple of 8; the codes' width by
    default), is the output's."""
    for t in (q8, k8):
        _tma_geometry(t, 128)
    b, nq, h, w = q8.shape
    d = w if d is None else d
    if w != _code_width(d, "K8") or vt8.shape[2] != w:
        raise ValueError(f"K8: codes of width {w} and v8 rows "
                         f"{vt8.shape[2]} for heads of {d}; R6 writes "
                         f"{_code_width(d, 'K8')}")
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device=q8.device)
    sq, sk, sv = sq.contiguous(), sk.contiguous(), sv.contiguous()
    strides = (ctypes.c_longlong * 6)(*q8.stride()[:3], *k8.stride()[:3])
    rc = _build.lib().smb_flash_fwd_i8pv(
        q8.data_ptr(), k8.data_ptr(), vt8.data_ptr(), sq.data_ptr(),
        sk.data_ptr(), sv.data_ptr(), out.data_ptr(), b, h, nq, k8.shape[1],
        vt8.shape[-1], d, ctypes.cast(strides, ctypes.c_void_p),
        _build.stream_ptr(q8.device))
    _build.check(rc, "flash_fwd_i8pv")
    _count_launch(flash_attention_int8pv, d)
    return out


flash_attention_int8pv.launches = 0
flash_attention_int8pv.launches_by_width = {}

_IMPLS = ("auto", "xla", "pallas", "pallas_i8bwd", "pallas_int8",
          "pallas_int8pv")


def _auto_impl(q, bias) -> str:
    """What "auto" runs: K1 (and K4 under autograd) for bf16 inputs
    without bias whose head width the kernels take, any up to
    _FLASH_MAX_D, else the plain version (the kernels compute in bf16, so
    an f32 model must not silently degrade)."""
    maps = (bias is None and q.dtype == torch.bfloat16
            and q.shape[-1] <= _FLASH_MAX_D)
    return "pallas" if maps else "xla"


def attention(q, k, v, *, scale: Optional[float] = None, bias=None,
              impl: str = "auto"):
    """Multi-head attention, (B, Nq, H, D) x (B, Nk, H, D) -> (B, Nq, H, D).

    impl: "auto" (K1 where it maps, see `_auto_impl`, else plain) | "pallas"
    (K1, backward K4) | "pallas_i8bwd" (K1, int8-score backward K7) |
    "pallas_int8" (K3, forward only) | "pallas_int8pv" (K8: int8 scores
    and int8 p v, forward only) | "xla" (plain).
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; valid: "
                         + ", ".join(repr(i) for i in _IMPLS))
    if impl == "auto":
        impl = _auto_impl(q, bias)
    if impl == "xla":
        return xla_attention(q, k, v, scale=scale, bias=bias)
    if bias is not None:
        raise NotImplementedError("the flash kernels take no bias; use "
                                  "impl='xla' for masked attention")
    if impl == "pallas_int8":
        return flash_attention_int8(q, k, v, scale=scale)
    if impl == "pallas_int8pv":
        return flash_attention_int8pv(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale,
                           int8_backward=impl == "pallas_i8bwd")


def attention_with_lse(q, k, v, *, scale: Optional[float] = None,
                       impl: str = "auto") -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Attention that also returns lse2 (B, H, Nq): the row logsumexp in
    log2 units of the scores scaled by scale*log2(e), so that the softmax
    weights are p = exp2(s*scale*log2(e) - lse2). The int8-forward
    spellings coerce to K1, as in the JAX package (the int8 kernel exposes
    no lse); "pallas_i8bwd" keeps its int8-score backward K7, whose delta
    takes the lse2 cotangent as K4's does."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        impl = _auto_impl(q, None)
    if impl == "xla":
        return xla_attention(q, k, v, scale=scale, with_lse=True)
    return flash_attention(q, k, v, scale=scale, with_lse=True,
                           int8_backward=impl == "pallas_i8bwd")
