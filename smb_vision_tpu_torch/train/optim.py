"""The optimizer and learning-rate schedule of the training recipes, and
the EMA teacher update of V-JEPA.

Counterpart of `smb_vision_tpu/train/optim.py`: `optax.chain(
clip_by_global_norm(c), adamw(schedule, mask=decay_mask))` with a linear
warmup into a cosine, linear or constant decay; the two-tier learning
rates of fine-tuning (`optax.multi_transform` there: one AdamW and one
schedule a tier, clipped by the global norm over every tier); and
`ema_update`. The schedule is evaluated at the number of updates already
made, as optax counts, so warmup starts at lr 0 on the first update.
optim "adamw8bit" keeps the moments as int8 blocks (`train/quantized.py`)
behind the same clip, tiers and schedule.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from smb_vision_tpu_torch.train.quantized import AdamW8bit

# two-tier fine-tuning groups, by parameter name (the JAX package's
# head_regex and backbone_regex defaults)
_HEAD = re.compile("classifier")
_BACKBONE = re.compile("videomae|dinov2|vjepa2")


OPTIMIZERS = {"adamw": torch.optim.AdamW, "adamw8bit": AdamW8bit}


def is_decayed(name: str) -> bool:
    """Weight decay applies to every parameter but biases and norms (HF
    Trainer's rule, as the JAX package's `decay_mask`): the mask token and
    the patch kernel are decayed. A frozen BatchNorm's statistics and
    affine (`bn.` in a ResNet3D name, `/bn/` in the JAX package's path)
    are not, whether they are buffers or parameters."""
    name = name.lower()
    return not ("bias" in name or "norm" in name or ".bn." in name
                or "/bn/" in name)


def make_schedule(learning_rate: float, total_steps: int,
                  warmup_ratio: float = 0.0, warmup_steps: int = 0,
                  schedule: str = "cosine",
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """lr as a function of the number of updates made, as optax's
    join_schedules([linear 0 -> lr over warmup], [decay]) with warmup =
    warmup_steps or ceil(total_steps * warmup_ratio)."""
    warmup = warmup_steps or math.ceil(total_steps * warmup_ratio)
    decay_steps = max(total_steps - warmup, 1)
    if schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {schedule}")

    def after(count: int) -> float:
        frac = min(max(count, 0), decay_steps) / decay_steps
        if schedule == "cosine":
            alpha = min_lr / learning_rate if learning_rate else 0.0
            cos = 0.5 * (1.0 + math.cos(math.pi * frac))
            return learning_rate * ((1.0 - alpha) * cos + alpha)
        if schedule == "linear":
            return learning_rate + (min_lr - learning_rate) * frac
        return learning_rate

    def lr(count: int) -> float:
        if warmup and count < warmup:
            return learning_rate * count / warmup
        return after(count - warmup)

    return lr


class ClippedAdamW:
    """Global-norm gradient clipping, then AdamW (decoupled weight decay on
    the `is_decayed` parameters; `optim` "adamw" or "adamw8bit", the moments
    in float32 or in int8 blocks), then the schedule: one `step()` is one
    optax update. `tier_of(name)` puts each parameter in one tier of
    `schedules`, which holds a "default" tier. `state_dict` holds the
    moments and the update count.

    On a mesh (`place`, after `parallel.sharding.apply_policy`) a step
    first averages over the data axis the gradients FSDP2 does not reduce
    (and sums a sequence-parallel stack's over the model axis), and the
    clip takes the norm of the whole gradient: each rank's squared norms
    of its pieces, weighted by how many ranks hold the same piece (a
    pipeline stage's layers: the data axis's), summed over the world in
    one all-reduce."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], *,
                 schedules: Dict[str, Callable[[int], float]],
                 tier_of: Callable[[str], str], weight_decay: float,
                 b1: float, b2: float, eps: float,
                 grad_clip: Optional[float], optim: str = "adamw"):
        self.schedules = schedules
        self.tier_of = tier_of
        self.weight_decay = weight_decay
        self.hyper = dict(betas=(b1, b2), eps=eps)
        self.optim = optim
        self.grad_clip = grad_clip
        self.updates = 0
        self.mesh, self.fsdp_ids = None, set()
        self.model_sums, self.stage_ids = set(), set()
        self._build(named_params)

    def _build(self, named_params) -> None:
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params = [p for _, p in named]
        # a DTensor and a plain tensor never share a group, nor do
        # DTensors of different placements: each group's foreach update
        # runs over like tensors
        def kind(p):
            return (str(getattr(p, "placements", "")),
                    str(getattr(p, "device_mesh", "")))

        groups = []
        for tier in self.schedules:
            for decayed in (True, False):
                members = [(n, p) for n, p in named
                           if self.tier_of(n) == tier
                           and is_decayed(n) == decayed]
                for k in dict.fromkeys(kind(p) for _, p in members):
                    groups.append({
                        "params": [p for _, p in members if kind(p) == k],
                        "weight_decay": self.weight_decay if decayed
                        else 0.0, "tier": tier})
        self.opt = OPTIMIZERS[self.optim](
            [g for g in groups if g["params"]],
            lr=self.schedules["default"](0), **self.hyper)

    def place(self, mesh, fsdp_ids, named_params=None, model_sums=(),
              stage_ids=()) -> None:
        """Take the mesh for the gradient sync and the clip, before the
        first update; with named_params, rebuild over those placed
        parameters (FSDP2 and DTensor TP replace the parameter objects).
        model_sums: the ids whose gradients are summed over the model axis
        (`sharding.model_sum_ids`); stage_ids: those one pipeline stage
        holds (`sharding.stage_param_ids`)."""
        if self.updates:
            raise ValueError("place the optimizer before its first update")
        self.mesh, self.fsdp_ids = mesh, set(fsdp_ids)
        self.model_sums, self.stage_ids = set(model_sums), set(stage_ids)
        if named_params is not None:
            self._build(named_params)

    @property
    def lr(self) -> float:
        """The lr the next update takes (the default tier's)."""
        return self.schedules["default"](self.updates)

    @torch.no_grad()
    def clip_(self) -> None:
        """Scale every gradient by max_norm / ||g|| when the global norm
        ||g|| is at least max_norm (optax.clip_by_global_norm)."""
        if not self.grad_clip:
            return
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.mesh is None:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        else:
            from smb_vision_tpu_torch.parallel.mesh import (
                MODEL_AXIS,
                axis_size,
            )
            from smb_vision_tpu_torch.parallel.sharding import (
                local,
                replication,
            )

            world = dist.get_world_size()
            stages = axis_size(self.mesh, MODEL_AXIS)
            staged = [id(p) in self.stage_ids for p in self.params
                      if p.grad is not None]
            norms = torch.stack(torch._foreach_norm(
                [local(g).float() for g in grads]))
            weights = torch.tensor(
                [(stages if s else 1) / replication(g, world)
                 for g, s in zip(grads, staged)], device=norms.device)
            sq = (norms * norms * weights).sum()
            dist.all_reduce(sq, op=dist.ReduceOp.SUM)
            norm = sq.sqrt()
            grads = [local(g) for g in grads]
        scale = torch.where(norm < self.grad_clip, 1.0,
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        if self.mesh is not None:
            from smb_vision_tpu_torch.parallel.sharding import sync_gradients

            sync_gradients(self.params, self.mesh, self.fsdp_ids,
                           self.model_sums)
        for g in self.opt.param_groups:
            g["lr"] = self.schedules[g["tier"]](self.updates)
        self.clip_()
        self.opt.step()
        self.updates += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"adamw": self.opt.state_dict(), "updates": self.updates}

    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.updates = int(state["updates"])


def make_optimizer(named_params, *, learning_rate: float, total_steps: int,
                   weight_decay: float = 0.01, warmup_ratio: float = 0.0,
                   warmup_steps: int = 0, schedule: str = "cosine",
                   min_lr: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, grad_clip: Optional[float] = 1.0,
                   vision_lr: Optional[float] = None,
                   merger_lr: Optional[float] = None,
                   optim: str = "adamw") -> ClippedAdamW:
    """Global-norm clip (default 1.0), then AdamW with eps 1e-8 over the
    model's named parameters, on `make_schedule`'s learning rate.

    Two-tier fine-tuning, as the JAX package groups it: with merger_lr set,
    parameters whose name holds "classifier" train at merger_lr; with
    vision_lr set, the other parameters of the backbone wrapper
    (videomae, dinov2, vjepa2) train at vision_lr; everything else (e.g.
    the fc_norm neck) stays at
    learning_rate. Either tier may be set alone; each tier runs the same
    warmup and decay on its own peak, and clipping takes the global norm
    over every tier. optim "adamw8bit" stores the moments as int8 blocks
    (`AdamW8bit`), clipped before it as the JAX package's `clipped` chain
    does."""
    if optim not in OPTIMIZERS:
        raise ValueError(f"unknown optim {optim!r}")

    def sched(lr):
        return make_schedule(lr, total_steps, warmup_ratio, warmup_steps,
                             schedule, min_lr)

    tiers = {"default": sched(learning_rate)}
    if vision_lr is not None:
        tiers["vision"] = sched(vision_lr)
    if merger_lr is not None:
        tiers["head"] = sched(merger_lr)

    def tier_of(name: str) -> str:
        # a head name never falls into the backbone tier, even with
        # merger_lr unset
        if _HEAD.search(name):
            return "head" if merger_lr is not None else "default"
        if _BACKBONE.search(name):
            return "vision" if vision_lr is not None else "default"
        return "default"

    return ClippedAdamW(
        named_params, schedules=tiers, tier_of=tier_of,
        weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
        grad_clip=grad_clip, optim=optim)


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               momentum: float) -> None:
    """EMA teacher update, in place: t = t*m + s*(1 - m) for every
    parameter, in the teacher's dtype (f32), as the JAX `ema_update`
    computes it. Run once per optimizer step, after the update."""
    for m in (teacher, student):
        # FSDP2 leaves a root that ran forward only (the teacher) whole:
        # back to its shards, so both hold the same pieces
        if hasattr(m, "reshard"):
            m.reshard()
    for t, s in zip(teacher.parameters(), student.parameters()):
        # sharded teacher and student hold the same pieces: the update is
        # local
        t, s = _local(t), _local(s)
        t.copy_(t * momentum + s.to(t.dtype) * (1.0 - momentum))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t
