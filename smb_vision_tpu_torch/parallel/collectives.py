"""Batch-wide quantities of one step over the data axis of the ambient
mesh (`parallel.mesh.use_mesh`).

The JAX package runs one program over the global batch, so its losses,
masks and risk sets are the global batch's by construction. Here each rank
holds its rows, and these helpers put the global quantity back together.
The convention, for every loss of the port: each rank's loss VALUE is the
global batch's loss, and its gradient is the rank's share of the global
gradient times the data-axis size n, so the mean over ranks that the
gradient sync takes (explicit all-reduce, FSDP2's reduce-scatter) is the
gradient of the global loss:

- `data_mean(num, den, local)`: a ratio of sums (the masked L1 of V-JEPA,
  a row-weighted mean, the MIM mean over masked patches);
- `gather_rows(x)`: every rank's rows in rank order, with a backward that
  sums the cotangents of all ranks (the Cox risk sets);
- `share_rows(t, n_accum)`: this rank's rows of a tensor drawn for the
  global batch (the step's masks, the DropPath keep masks).

Without an ambient mesh, or with one data rank, each is the identity of
the single-process code, so a one-device run computes exactly what it did.

Over the model axis, for sequence parallelism and the pipeline
(`parallel/context.py`, `parallel/pipeline.py`), through the process
group's own collectives (DTensor's functional ones crash under gloo on
CUDA tensors, and gloo's send and recv fail on them:
`scripts/torch_gloo_cuda_probe.py`), so one code path serves gloo on the
CPU, gloo on CUDA and NCCL:

- `ring_shift(t)`: t to rank + 1, one `all_to_all_single` with one
  non-empty split; its backward shifts the cotangent back;
- `gather_tokens(x, sizes)`: the token shards (uneven allowed) of every
  rank; its backward keeps this rank's slice, summed over the ranks first
  for the k and v that every rank's queries read;
- `split_tokens(x, sizes)`: this rank's shard of a tensor held whole; its
  backward gathers the shards' cotangents.

Inside a checkpointed block a `Replay` keeps the forward's outputs of
these, so the recompute reads them instead of communicating again.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from smb_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    current_mesh,
)


def data_group():
    """(process group, size, rank) of the ambient mesh's data axis, or
    None when there is one data rank."""
    mesh = current_mesh()
    if mesh is None or mesh[DATA_AXIS].size() == 1:
        return None
    sub = mesh[DATA_AXIS]
    return sub.get_group(), sub.size(), sub.get_local_rank()


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of t over the group, out of place; no gradient."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def data_mean(num: torch.Tensor, den: torch.Tensor,
              local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(num) / sum(den) over the data axis, with the gradient n x this
    rank's share. local: the single-process expression of the same
    quantity (num / den up to rounding), returned unchanged with one data
    rank."""
    g = data_group()
    if g is None:
        return local if local is not None else num / den
    group, n, _ = g
    den_all = torch.clamp(_sum(den.float(), group), min=1.0)
    num_all = _sum(num.float(), group)
    scaled = num.float() * (n / den_all)
    return scaled + (num_all / den_all - scaled).detach()


class _GatherRows(torch.autograd.Function):
    """all_gather of equal row blocks along dim 0; the backward sums the
    cotangent over the ranks (every rank computed the same global loss
    from the gathered rows) and keeps this rank's block: an all-reduce
    and a slice, the reduce-scatter that every backend has."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.group, ctx.r, ctx.rows = group, r, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[ctx.r * ctx.rows:(ctx.r + 1) * ctx.rows], None, None, None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of x, in rank order (differentiable)."""
    g = data_group()
    if g is None:
        return x
    return _GatherRows.apply(x, *g)


def share_rows(t: torch.Tensor, n_accum: int = 1) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch. The
    global batch is laid out (n_accum, data ranks, rows a rank's
    micro-batch), as the JAX Trainer splits a global batch into
    micro-batches and each micro-batch over the data axis; so a rank
    holds, in each micro-batch, its contiguous block."""
    g = data_group()
    if g is None:
        return t
    _, n, r = g
    rows = t.shape[0]
    if rows % (n * n_accum):
        raise ValueError(f"{rows} global rows do not split into {n_accum} "
                         f"micro-batches over {n} data ranks")
    per = rows // (n * n_accum)
    return t.reshape(n_accum, n, per, *t.shape[1:])[:, r].reshape(
        n_accum * per, *t.shape[1:])


def global_rows(local_rows: int) -> int:
    """Rows of the global batch whose share a rank holds local_rows of."""
    g = data_group()
    return local_rows * (g[1] if g is not None else 1)


class _GatherShards(torch.autograd.Function):
    """The whole tensor from equal pieces split on `dim` over `group`
    (one all_gather_into_tensor). The backward keeps this rank's piece of
    the cotangent: as it is, where every rank of the group computed the
    same cotangent (the same tokens), or with sum_grad summed over the
    group first (each rank's cotangent covers its own token shard of a
    sequence-parallel stack): an all-reduce and a slice, the
    reduce-scatter that every backend has."""

    @staticmethod
    def forward(ctx, x, group, n, r, dim, sum_grad):
        ctx.group, ctx.sum_grad = group, sum_grad
        ctx.r, ctx.dim, ctx.size = r, dim, x.shape[dim]
        x = x.contiguous()
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
        return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = g.contiguous().clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.r * ctx.size, ctx.size).contiguous(),
                None, None, None, None, None)


def gather_shards(t: torch.Tensor, sum_grad: bool = False) -> torch.Tensor:
    """A parameter stored split over one mesh axis (a DTensor, Shard(d))
    as the whole plain tensor, differentiably, through the process
    group's own all_gather_into_tensor (DTensor's functional collectives
    crash under gloo on CUDA tensors); the gradient goes back as this
    rank's piece, summed over the axis first with sum_grad (a weight used
    on each rank's own tokens). Any other DTensor through full_tensor."""
    from torch.distributed.tensor import Replicate

    split = [i for i, pl in enumerate(t.placements)
             if not (pl.is_replicate() or pl.is_partial())]
    if len(split) == 1 and type(t.placements[split[0]]).__name__ == "Shard":
        mesh = t.device_mesh
        i = split[0]
        group = mesh.get_group(i)
        return _GatherShards.apply(
            t.to_local(), group, mesh.size(i),
            mesh.get_coordinate()[i], t.placements[i].dim, sum_grad)
    return t.full_tensor(grad_placements=[Replicate()] * t.device_mesh.ndim)


# -- the model axis: token shards (sequence parallelism) and the stage ring
# (the pipeline) ------------------------------------------------------------

def axis_group(mesh=None, axis: str = MODEL_AXIS):
    """(process group, size, rank) of `axis` of `mesh` (the ambient mesh
    when None), or None when the axis has one rank."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or mesh[axis].size() == 1:
        return None
    sub = mesh[axis]
    return sub.get_group(), sub.size(), sub.get_local_rank()


def token_split_sizes(n: int, parts: int) -> List[int]:
    """The lengths of `parts` token shards of n tokens, as
    `torch.tensor_split` cuts them (the first n % parts one longer).
    Refuses a split that leaves a rank no token: its attention would have
    no key (lse2 = -inf)."""
    if n < parts:
        raise ValueError(f"{n} tokens do not split over {parts} ranks of "
                         "the model axis: a rank would hold no token")
    return [n // parts + (i < n % parts) for i in range(parts)]


class Replay:
    """The outputs of the collectives of one checkpointed call, in call
    order. The call's recompute in the backward (`torch.utils.checkpoint`)
    reads them back instead of communicating again, so a collective never
    runs inside a recompute, where ranks could reach it in different
    orders."""

    def __init__(self):
        self.outs: List[torch.Tensor] = []
        self.at: Optional[int] = None

    def rewind(self) -> None:
        """The forward is over: the next calls replay."""
        self.at = 0

    def run(self, fn, *args):
        if self.at is None:
            out = fn(*args)
            self.outs.append(out)
            return out
        out = self.outs[self.at]
        self.at += 1
        return out


def _replayed(replay: Optional[Replay], fn, *args):
    return fn(*args) if replay is None else replay.run(fn, *args)


def _shift(t: torch.Tensor, group, n: int, r: int, shift: int,
           recv_shape) -> torch.Tensor:
    """Send t to rank r + shift of the group and receive from rank
    r - shift a tensor of recv_shape: one all_to_all_single with one
    non-empty split each way, which gloo (CPU and CUDA tensors) and NCCL
    both run."""
    send = t.contiguous().reshape(-1)
    out = t.new_empty(tuple(recv_shape))
    ins, outs = [0] * n, [0] * n
    ins[(r + shift) % n] = send.numel()
    outs[(r - shift) % n] = out.numel()
    dist.all_to_all_single(out.view(-1), send, output_split_sizes=outs,
                           input_split_sizes=ins, group=group)
    return out


class _RingShift(torch.autograd.Function):
    """ppermute to rank + shift; the backward shifts the cotangent back."""

    @staticmethod
    def forward(ctx, t, group, n, r, shift, recv_shape):
        ctx.group, ctx.n, ctx.r, ctx.shift = group, n, r, shift
        ctx.shape = tuple(t.shape)
        return _shift(t, group, n, r, shift, recv_shape)

    @staticmethod
    def backward(ctx, g):
        return (_shift(g, ctx.group, ctx.n, ctx.r, -ctx.shift, ctx.shape),
                None, None, None, None, None)


def ring_shift(t: torch.Tensor, shift: int = 1, recv_shape=None, *,
               mesh=None, axis: str = MODEL_AXIS,
               replay: Optional[Replay] = None) -> torch.Tensor:
    """t sent to rank + shift of the model axis, differentiably; returns
    what rank - shift sent, of recv_shape (default t's: even shards). The
    identity with one model rank."""
    g = axis_group(mesh, axis)
    if g is None:
        return t
    shape = tuple(t.shape) if recv_shape is None else tuple(recv_shape)
    return _replayed(replay, _RingShift.apply, t, *g, shift, shape)


def _gather_uneven(x: torch.Tensor, group, n: int, sizes: List[int],
                   dim: int) -> torch.Tensor:
    """The shards of every rank, of `sizes` along dim, concatenated in
    rank order: one all_gather_into_tensor of the shards padded to the
    longest (the padding is cut off before any use)."""
    x = x.movedim(dim, 0)
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    x = x.contiguous()
    out = x.new_empty((n * top,) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    parts = [out[i * top:i * top + s] for i, s in enumerate(sizes)]
    return torch.cat(parts).movedim(0, dim)


class _GatherTokens(torch.autograd.Function):
    """all_gather of uneven token shards. backward: this rank's slice of
    the cotangent; with sum_grad, of the cotangent summed over the ranks
    first (in float32), the transpose of the gather when each rank's
    cotangent is its own (the k and v of its queries)."""

    @staticmethod
    def forward(ctx, x, group, n, r, sizes, dim, sum_grad):
        ctx.group, ctx.dim, ctx.sum_grad = group, dim, sum_grad
        ctx.lo, ctx.size = sum(sizes[:r]), sizes[r]
        return _gather_uneven(x, group, n, sizes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            dt = g.dtype
            g = g.float().contiguous()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
            g = g.to(dt)
        return (g.narrow(ctx.dim, ctx.lo, ctx.size).contiguous(),
                None, None, None, None, None, None)


def gather_tokens(x: torch.Tensor, sizes: List[int], dim: int = 1, *,
                  sum_grad: bool = False, mesh=None,
                  axis: str = MODEL_AXIS,
                  replay: Optional[Replay] = None) -> torch.Tensor:
    """Every model rank's token shard of x (lengths `sizes` along dim,
    uneven allowed) in rank order, differentiably. The backward gives this
    rank its slice of the cotangent: as it is, where every rank computed
    the same thing from the whole (a stack's output), or summed over the
    ranks with sum_grad (the k and v that each rank's queries read)."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    group, n, r = g
    if x.shape[dim] != sizes[r]:
        raise ValueError(f"rank {r} holds {x.shape[dim]} tokens, the split "
                         f"{sizes} gives it {sizes[r]}")
    return _replayed(replay, _GatherTokens.apply, x, group, n, r,
                     list(sizes), dim, sum_grad)


class _SplitTokens(torch.autograd.Function):
    """This rank's token shard of a tensor every rank holds whole; the
    backward all-gathers the shards' cotangents, so the whole cotangent
    reaches every rank's copy."""

    @staticmethod
    def forward(ctx, x, group, n, r, sizes, dim):
        ctx.group, ctx.n, ctx.sizes, ctx.dim = group, n, sizes, dim
        return x.narrow(dim, sum(sizes[:r]), sizes[r]).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather_uneven(g, ctx.group, ctx.n, ctx.sizes, ctx.dim),
                None, None, None, None, None)


def split_tokens(x: torch.Tensor, sizes: List[int], dim: int = 1, *,
                 mesh=None, axis: str = MODEL_AXIS) -> torch.Tensor:
    """This model rank's shard (lengths `sizes` along dim) of x, which
    every rank of the model axis holds whole (differentiable)."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    group, n, r = g
    return _SplitTokens.apply(x, group, n, r, list(sizes), dim)
