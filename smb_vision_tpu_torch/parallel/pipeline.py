"""Pipeline parallelism (GPipe) over the mesh's "model" axis.

Counterpart of `smb_vision_tpu/parallel/pipeline.py`. A layer stack of L
layers is split into S contiguous stages, one a rank of the model axis;
each rank builds and holds only its L/S layers (`PipeStages.layers`), and
microbatches stream through the stages. `pipeline_apply` is the JAX
function's schedule, the same program on every rank:

- T = M + S - 1 ticks; on each, stage 0 injects microbatch min(t, M - 1),
  every stage applies its layers (each layer checkpointed with remat:
  `torch.utils.checkpoint` around the layer, never around a collective),
  the last stage keeps the output of tick t as microbatch t - (S - 1),
  and every stage's result goes to stage + 1 (`collectives.ring_shift`).
  Bubble ticks compute on a clamped microbatch or zeros, and their
  results reach no output;
- the last stage's outputs are broadcast to every stage at the end.

The gradients: the broadcast's backward keeps the cotangent on the last
stage (zeros elsewhere), so no rank counts it twice; and the input's
backward broadcasts stage 0's cotangent (the one stage that injects) to
every stage. So whatever runs before and after the pipeline computes the
same gradient on every rank, and only the data axis averages gradients.
Every rank runs every tick's layers, shift and masked keep, so the
backward reaches each shift on every rank in the same order.

`stack_layer_params` / `unstack_layer_params` convert a stack's per-layer
tensors (`layer_{i}.<name>`) to and from the JAX package's stacked layout
(a leading layer axis), the layout its pipelined trees hold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from smb_vision_tpu_torch.parallel.collectives import axis_group, ring_shift
from smb_vision_tpu_torch.parallel.mesh import MODEL_AXIS


@dataclass(frozen=True)
class PipeStages:
    """Stage `stage` of `stages` along the model axis, and the
    microbatches a batch streams in."""

    stages: int
    stage: int
    microbatches: int = 1

    def layers(self, num_layers: int) -> range:
        """The global indices of this stage's layers; raises when the
        stack does not divide into the stages."""
        if self.stages < 1 or not 0 <= self.stage < self.stages:
            raise ValueError(f"stage {self.stage} of {self.stages}")
        if num_layers % self.stages:
            raise ValueError(f"{num_layers} layers do not divide into "
                             f"{self.stages} pipe stages")
        per = num_layers // self.stages
        return range(self.stage * per, (self.stage + 1) * per)


def stack_layer_params(layer_params: Dict[str, torch.Tensor],
                       prefix: str = "layer_") -> Tuple[Dict[str, torch.Tensor],
                                                        int]:
    """{"layer_0.<name>": t, ..., "layer_{L-1}.<name>": t} -> ({"<name>":
    (L, ...) stacked}, L). Every layer must carry the same names."""
    by_layer: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in layer_params.items():
        if not k.startswith(prefix):
            continue
        i, _, rest = k[len(prefix):].partition(".")
        by_layer.setdefault(int(i), {})[rest] = v
    if not by_layer:
        raise ValueError(f"no '{prefix}*' entries in {list(layer_params)}")
    n = len(by_layer)
    if sorted(by_layer) != list(range(n)):
        raise ValueError(f"layers {sorted(by_layer)} are not 0..{n - 1}")
    names = set(by_layer[0])
    if any(set(t) != names for t in by_layer.values()):
        raise ValueError("the layers do not carry the same tensors")
    return {k: torch.stack([by_layer[i][k] for i in range(n)])
            for k in sorted(names)}, n


def unstack_layer_params(stacked: Dict[str, torch.Tensor], num_layers: int,
                         prefix: str = "layer_") -> Dict[str, torch.Tensor]:
    """Inverse of stack_layer_params."""
    return {f"{prefix}{i}.{k}": v[i] for i in range(num_layers)
            for k, v in stacked.items()}


class _FromFirstStage(torch.autograd.Function):
    """The pipeline's input, held alike by every stage: the identity; the
    backward broadcasts stage 0's cotangent (the stage that injects) to
    every stage."""

    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.broadcast(g, src=ctx.src, group=ctx.group)
        return g, None, None


class _FromLastStage(torch.autograd.Function):
    """The last stage's outputs on every stage (one broadcast); the
    backward keeps the cotangent on the last stage only, where the
    outputs were made, and passes zeros elsewhere."""

    @staticmethod
    def forward(ctx, y, group, src, last):
        ctx.last = last
        y = y.contiguous().clone()
        dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def pipeline_apply(layer_fn: Callable[..., torch.Tensor],
                   stage_layers: Sequence[Any], x: torch.Tensor, *,
                   num_microbatches: int, mesh=None,
                   axis: str = MODEL_AXIS, remat: bool = False,
                   extra: Any = None,
                   with_mb_index: bool = False) -> torch.Tensor:
    """Run this stage's layers (`stage_layers`, in order) over x through
    the S-stage GPipe schedule, S = the size of `axis` of `mesh` (the
    ambient mesh when None; one stage without one).

    layer_fn(layer, h) -> h applies one layer and must keep h's shape and
    dtype; with extra, layer_fn(layer, h, extra); with_mb_index,
    layer_fn(layer, h, extra, mb), mb the index of the microbatch flowing
    through this stage (t - stage: outside 0..M-1 on bubble ticks, whose
    results are dropped). x: this rank's (B, ...) rows, B % M == 0. Returns
    the last layer's output (B, ...) on every stage."""
    g = axis_group(mesh, axis)
    n_stages, stage = (1, 0) if g is None else g[1:]
    m = num_microbatches
    b = x.shape[0]
    if not (1 <= m <= b and b % m == 0):
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    remat = remat and torch.is_grad_enabled()

    def apply(layer, h, mb):
        args = (layer, h)
        if with_mb_index:
            args += (extra, mb)
        elif extra is not None:
            args += (extra,)
        if remat:
            return torch.utils.checkpoint.checkpoint(
                layer_fn, *args, use_reentrant=False)
        return layer_fn(*args)

    if g is not None:
        group = g[0]
        ranks = dist.get_process_group_ranks(group)
        x = _FromFirstStage.apply(x, group, ranks[0])
    x_mb = x.reshape((m, b // m) + x.shape[1:])
    first = torch.tensor(stage == 0, device=x.device)
    act = torch.zeros_like(x_mb[0])
    outs = []
    ticks = m + n_stages - 1
    for t in range(ticks):
        # every stage computes where(stage 0, inject, received), so each
        # shift's output is in every rank's graph
        act = torch.where(first, x_mb[min(t, m - 1)], act)
        y = act
        for layer in stage_layers:
            y = apply(layer, y, t - stage)
        if y.shape != act.shape or y.dtype != act.dtype:
            raise ValueError(f"layer_fn must preserve shape/dtype: "
                             f"{tuple(act.shape)}/{act.dtype} -> "
                             f"{tuple(y.shape)}/{y.dtype}")
        if t >= n_stages - 1:
            outs.append(y)
        if n_stages > 1 and t < ticks - 1:
            act = ring_shift(y, 1, mesh=mesh, axis=axis)
    out = torch.stack(outs).reshape(x.shape)
    if g is None:
        return out
    return _FromLastStage.apply(out, g[0], ranks[-1],
                                stage == n_stages - 1)


def stage_ranks_state(state: Dict[str, torch.Tensor], group,
                      contribute: bool) -> Dict[str, torch.Tensor]:
    """Rank 0's union of the state_dicts of the ranks that contribute
    (one a stage), over `group` (a CPU group: the dicts go as objects);
    the other ranks get an empty dict. Stages hold disjoint layer names
    and the same whole tensors elsewhere."""
    mine = ({k: v.detach().cpu() for k, v in state.items()} if contribute
            else {})
    parts = [None] * dist.get_world_size(group) if dist.get_rank() == 0 \
        else None
    dist.gather_object(mine, parts, dst=0, group=group)
    if parts is None:
        return {}
    out: Dict[str, torch.Tensor] = {}
    for part in parts:
        out.update(part)
    return out
