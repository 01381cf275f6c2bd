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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from smb_vision_tpu_torch.parallel.mesh import DATA_AXIS, current_mesh


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
    (one all_gather_into_tensor); the backward keeps this rank's piece of
    the cotangent, which every rank of the group computed alike."""

    @staticmethod
    def forward(ctx, x, group, n, r, dim):
        ctx.r, ctx.dim, ctx.size = r, dim, x.shape[dim]
        x = x.contiguous()
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
        return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.r * ctx.size, ctx.size).contiguous(),
                None, None, None, None)


def gather_shards(t: torch.Tensor) -> torch.Tensor:
    """A parameter stored split over one mesh axis (a DTensor, Shard(d))
    as the whole plain tensor, differentiably, through the process
    group's own all_gather_into_tensor (DTensor's functional collectives
    crash under gloo on CUDA tensors); the gradient goes back as this
    rank's piece. Any other DTensor through full_tensor."""
    from torch.distributed.tensor import Replicate

    split = [i for i, pl in enumerate(t.placements)
             if not (pl.is_replicate() or pl.is_partial())]
    if len(split) == 1 and type(t.placements[split[0]]).__name__ == "Shard":
        mesh = t.device_mesh
        i = split[0]
        group = mesh.get_group(i)
        return _GatherShards.apply(
            t.to_local(), group, mesh.size(i),
            mesh.get_coordinate()[i], t.placements[i].dim)
    return t.full_tensor(grad_placements=[Replicate()] * t.device_mesh.ndim)
