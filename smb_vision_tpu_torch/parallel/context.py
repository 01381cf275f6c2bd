"""Context (sequence) parallelism for full attention.

Counterpart of `smb_vision_tpu/parallel/context.py`. The token axis is
split over the mesh's "model" axis (`parallel/collectives.token_split_sizes`:
as `torch.tensor_split` cuts it, so a token count the axis does not divide
gives uneven shards); each rank holds q, k and v of its shard, and the
attention kernels run on it:

- `context_parallel_attention`: k and v all-gathered (one collective of
  both), one kernel call on the rank's queries against every key;
- `ring_attention`: k and v rotate around the ring (`ring_shift`), the
  kernel runs on each block with its lse2 (`attention_with_lse`), and the
  normalised partials merge by log-sum-exp in float32, in log2 units, as
  the JAX function does. Under autograd the lse2 cotangent of each block
  folds into the backward kernel's delta (K4, or K7 for "pallas_i8bwd").

Both take the shards' lengths (`token_sizes`, default even) and, inside a
checkpointed block, a `Replay`, so the recompute reads the forward's
collectives back. Without a mesh or with one model rank they are the
attention of one device.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from smb_vision_tpu_torch.ops.attention import attention, attention_with_lse
from smb_vision_tpu_torch.parallel.collectives import (
    Replay,
    axis_group,
    gather_tokens,
    ring_shift,
)
from smb_vision_tpu_torch.parallel.mesh import MODEL_AXIS


def _sizes(q: torch.Tensor, g, token_sizes: Optional[List[int]]):
    _, n, r = g
    sizes = list(token_sizes) if token_sizes is not None \
        else [q.shape[1]] * n
    if len(sizes) != n or sizes[r] != q.shape[1]:
        raise ValueError(f"token shards {sizes} do not match {n} ranks, "
                         f"rank {r} holding {q.shape[1]} queries")
    return sizes


def context_parallel_attention(q, k, v, *, mesh=None,
                               axis: str = MODEL_AXIS,
                               scale: Optional[float] = None,
                               impl: str = "auto",
                               token_sizes: Optional[List[int]] = None,
                               replay: Optional[Replay] = None):
    """q, k, v: this rank's token shard, (B, N_r, H, D). k and v are
    gathered over `axis` and `attention(q, k_all, v_all, impl=impl)` runs
    on the rank's queries; returns its (B, N_r, H, D) shard of the output."""
    g = axis_group(mesh, axis)
    if g is None:
        return attention(q, k, v, scale=scale, impl=impl)
    sizes = _sizes(q, g, token_sizes)
    kv = gather_tokens(torch.stack([k, v]), sizes, dim=2, sum_grad=True,
                       mesh=mesh, axis=axis, replay=replay)
    return attention(q, kv[0], kv[1], scale=scale, impl=impl)


def _merge(a, b):
    """Two normalised partials over disjoint key blocks: softmax weights
    w_x = exp2(lse2_x - lse2_total), in float32."""
    out_a, lse_a = a
    out_b, lse_b = b
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp2(lse_a - m)
    wb = torch.exp2(lse_b - m)
    denom = wa + wb

    def bw(w):   # (B, H, Q) -> (B, Q, H, 1), over the head width
        return (w / denom)[..., None].transpose(1, 2)

    return out_a * bw(wa) + out_b * bw(wb), m + torch.log2(denom)


def ring_attention(q, k, v, *, mesh=None, axis: str = MODEL_AXIS,
                   scale: Optional[float] = None, impl: str = "auto",
                   token_sizes: Optional[List[int]] = None,
                   replay: Optional[Replay] = None):
    """Ring attention over `axis`: this rank's queries against its own k/v
    block, then against each block that arrives from rank - 1 (n - 1
    shifts of k and v together), every block through
    `attention_with_lse` (the kernels for impl "auto", "pallas",
    "pallas_i8bwd"; the int8-forward spellings run K1, as in the JAX
    package), merged in float32 and cast back to q's dtype. Uneven shards:
    each received block has the sender's length."""
    g = axis_group(mesh, axis)
    if g is None:
        return attention(q, k, v, scale=scale, impl=impl)
    _, n, r = g
    sizes = _sizes(q, g, token_sizes)

    def block(kv):
        out, lse2 = attention_with_lse(q, kv[0], kv[1], scale=scale,
                                       impl=impl)
        return out.float(), lse2

    kv = torch.stack([k, v])
    acc = block(kv)
    for step in range(1, n):
        src = (r - step) % n
        shape = kv.shape[:2] + (sizes[src],) + kv.shape[3:]
        kv = ring_shift(kv, 1, shape, mesh=mesh, axis=axis, replay=replay)
        acc = _merge(acc, block(kv))
    return acc[0].to(q.dtype)
