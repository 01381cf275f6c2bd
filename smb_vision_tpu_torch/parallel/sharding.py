"""Parameter sharding policies: "dp", "fsdp", "tp" and "fsdp+tp".

Counterpart of `smb_vision_tpu/parallel/sharding.py`. The JAX package
gives GSPMD a sharding a parameter and lets XLA place the collectives;
here each policy is explicit work on a (data, model) `DeviceMesh`:

- "dp": parameters replicated; after the backward the gradients are
  averaged over the data axis (`sync_gradients`, one all-reduce a dtype).
- "fsdp" (ZeRO-3): FSDP2 `fully_shard` on each transformer `Block`, then
  on the root, over the data axis. FSDP2 shards dimension 0 where the JAX
  package shards the largest divisible dimension: the stored pieces
  differ, the numbers are the same. Which parameters it shards follows
  the JAX rule (at least `min_fsdp_size` elements and a dimension that
  divides over the data axis); the others stay replicated, outside FSDP2,
  and `sync_gradients` averages their gradients. With a process group
  FSDP2 is applied even at one data rank, so a one-GPU run under a
  launcher pays its hooks and gathers as a larger one does.
- "tp": the JAX package's Megatron rules (`_TP_COL`, `_TP_ROW`,
  `_TP_COL_BIAS`, on its flat parameter paths) over the model axis. On
  the plain route of a module (attn_impl "xla" for an attention with an
  output projection; mlp_impl "xla" for a GELU MLP) q, k, v / fc1 are
  DTensor `ColwiseParallel` and proj / fc2 `RowwiseParallel`: each rank
  computes its share of the heads and of the hidden columns. Every other
  parameter that the rules split (a kernel route, the SwiGLU weights, the
  V-JEPA predictor embedding, a cross-attention without output
  projection) is stored split over the model axis and gathered whole at
  use (`models/layers.Linear.gather_at_use`), as a Pallas kernel under
  GSPMD sees whole weights in the JAX package (`ops/partition.py`): no
  kernel gets a share of the work the JAX package does not split.
- "fsdp+tp": both, tensor parallelism over "model" and FSDP2 over "data"
  on the 2-D mesh.

- "pipeline": a model built with `pipe` (`models/pipelined.py`) holds one
  stage's layers a rank of the model axis; nothing is moved (each stage
  built only its own layers), and the gradients are averaged over the
  data axis, whose ranks hold the same stage. "pipeline+fsdp": and FSDP2
  over "data" on the root for the parameters outside the stacks (the
  stacks' stay whole on their stage), as the JAX package shards only the
  non-stack tables over "data" then.

Sequence parallelism (a model whose stacks are `sequence_parallel`) runs
under every policy but the pipeline's, with the tokens on the model axis:
each rank's gradient of a stack parameter covers its tokens only. Under
"dp" and "fsdp" `sync_gradients` sums those over the model axis
(`model_sum_ids`); every other parameter's gradient is already whole on
every rank of a model group. Under "tp" and "fsdp+tp" every Linear of a
sequence-parallel stack that the rules split is stored split and gathered
whole at use, whatever its route (the Megatron pair would need the
activations whole over the model axis), with `sum_grad`: the gather's
backward sums the whole weight's gradient over the model axis and keeps
this rank's piece (a reduce-scatter), so the split parameters leave
`model_sum_ids` and the others (LayerNorms, LayerScale, a row layer's
bias) stay in it. The kernels see the whole weights and the rank's token
shard, as under "dp".

LoRA (a model whose adapted weights are `torch.nn.utils.parametrize`d,
`train/lora.py`): the frozen base is placed by the policy's classes, under
the base weight's name; every trainable parameter (the adapters, the head)
stays replicated, outside FSDP2, and `sync_gradients` averages its
gradient over the data axis, as the JAX Trainer replicates its `lora`
tree. An adapted Linear always gathers its base at use (the merge,
`LoraDelta`, adds the adapters' delta to the whole weight): never the
Megatron pair.

`param_placements` gives each parameter's class as the JAX
`param_shardings` would, by its flat name, so a test holds the two
together. Optimizer state follows the parameters: torch AdamW's moments
are DTensors of the parameter's placements; `AdamW8bit` keeps its int8
blocks over the local shards (`train/quantized.py`).
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Set, Tuple

import torch
import torch.distributed as dist
from torch import nn

from smb_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
)

# the state_dict path of a parametrized weight's base tensor (LoRA)
_ORIGINAL = ".parametrizations.weight.original"

POLICIES = ("dp", "fsdp", "tp", "fsdp+tp", "pipeline", "pipeline+fsdp")

# the JAX package's Megatron rules, on its flat paths
# (`params/videomae/encoder/layer_0/attention/query/kernel`):
# column split (the output dim) / row split (the input dim)
_TP_COL = re.compile(
    r"(attention/(query|key|value)|mlp/fc1|mlp/weights_in|"
    r"predictor_embeddings)/kernel$")
_TP_ROW = re.compile(r"(attention/proj|mlp/fc2|mlp/weights_out)/kernel$")
_TP_COL_BIAS = re.compile(
    r"(attention/(query|key|value)|mlp/fc1|mlp/weights_in|"
    r"predictor_embeddings)/bias$")


class Placement(NamedTuple):
    """A parameter's class: tp "col" (split on its output features),
    "row" (on its input features) or None; data: sharded over "data";
    stage: held by one pipeline stage of the model axis."""

    tp: Optional[str]
    data: bool
    stage: bool = False


def jax_path(name: str, ndim: int) -> str:
    """A parameter's name here -> its flat path in the JAX package's tree
    (`models/convert.params_to_flax`'s renaming, joined by '/'); a
    parametrized weight's base tensor goes by the weight's name."""
    if name.endswith(_ORIGINAL):
        name = name[:-len(_ORIGINAL)] + ".weight"
    if name.endswith(".weight"):
        base = name[:-len(".weight")]
        if ndim in (2, 5):
            name = base + ".kernel"
        elif ndim == 1:
            name = base + ".scale"
    return "params/" + name.replace(".", "/")


def jax_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of a parameter in the JAX package's layout: a Linear
    (out, in) is (in, out); a Conv3d (O, I, k0, k1, k2) is (k0, k1, k2,
    I, O)."""
    s = tuple(t.shape)
    if t.dim() == 2:
        return s[::-1]
    if t.dim() == 5:
        return (s[2], s[3], s[4], s[1], s[0])
    return s


def _mesh_shape(mesh) -> Tuple[int, int]:
    if isinstance(mesh, tuple):
        return mesh
    return axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)


def _tp_class(path: str, jshape, n_model: int) -> Optional[str]:
    if not jshape:
        return None
    if _TP_COL.search(path) and jshape[-1] % n_model == 0:
        return "col"
    if _TP_ROW.search(path) and jshape[0] % n_model == 0:
        return "row"
    if _TP_COL_BIAS.search(path) and jshape[-1] % n_model == 0:
        return "col"
    return None


def _fsdp_dim(jshape, tp: Optional[str], n_data: int) -> Optional[int]:
    """The JAX `_fsdp_spec` choice: the largest dimension not split by
    tp that divides over n_data (None: none does)."""
    taken = {"col": len(jshape) - 1, "row": 0}.get(tp)
    for i in sorted(range(len(jshape)), key=lambda i: -jshape[i]):
        if i != taken and jshape[i] % n_data == 0 and jshape[i] >= n_data:
            return i
    return None


def lora_trainable(model: nn.Module) -> Set[str]:
    """The names of the parameters a LoRA run trains (every trainable one
    of a model with a parametrized weight), which every policy keeps
    replicated; none for any other model."""
    from torch.nn.utils import parametrize

    if not any(parametrize.is_parametrized(m) for m in model.modules()):
        return set()
    return {n for n, p in model.named_parameters() if p.requires_grad}


def param_placements(model: nn.Module, mesh, policy: str = "dp",
                     min_fsdp_size: int = 2 ** 16) -> Dict[str, Placement]:
    """{name: Placement} of every parameter, by the JAX package's rules
    on its flat path and shape; a LoRA run's trainable parameters are
    replicated (`lora_trainable`). mesh: a DeviceMesh, None (one device)
    or a (data, model) shape."""
    check_policy(policy)
    n_data, n_model = _mesh_shape(mesh)
    use_tp = "tp" in policy and n_model > 1
    use_fsdp = "fsdp" in policy and n_data > 1
    staged = _stage_names(model) if "pipeline" in policy else set()
    trained = lora_trainable(model)
    out = {}
    for name, p in model.named_parameters():
        if name in trained:
            out[name] = Placement(None, False)
            continue
        js = jax_shape(p)
        tp = _tp_class(jax_path(name, p.dim()), js, n_model) \
            if use_tp else None
        stage = name in staged
        data = (use_fsdp and not stage and p.numel() >= min_fsdp_size
                and _fsdp_dim(js, tp, n_data) is not None)
        out[name] = Placement(tp, bool(data), stage)
    return out


def _stacks(model: nn.Module, which: str) -> Dict[str, nn.Module]:
    """The Encoders of model that are pipelined over more than one stage
    ("pipe") or sequence parallel ("sp"), by name."""
    from smb_vision_tpu_torch.models.layers import Encoder

    return {n: m for n, m in model.named_modules()
            if isinstance(m, Encoder) and (
                (m.pipe is not None and m.pipe.stages > 1) if which == "pipe"
                else m.sequence_parallel)}


def _stage_names(model: nn.Module) -> Set[str]:
    return {f"{n}.{pn}" if n else pn
            for n, m in _stacks(model, "pipe").items()
            for pn, _ in m.named_parameters()}


def stage_param_ids(model: nn.Module) -> Set[int]:
    """The parameters one pipeline stage holds (its stacks' layers)."""
    return {id(p) for m in _stacks(model, "pipe").values()
            for p in m.parameters()}


def _model_split(p: torch.Tensor) -> bool:
    """A DTensor split over the mesh's model axis (tensor parallelism)."""
    if not hasattr(p, "placements"):
        return False
    names = p.device_mesh.mesh_dim_names or ()
    return any(n == MODEL_AXIS and is_split(pl)
               for n, pl in zip(names, p.placements))


def model_sum_ids(model: nn.Module, mesh) -> Set[int]:
    """The parameters whose gradients `sync_gradients` sums over the model
    axis: those of the sequence-parallel stacks, when the axis has more
    than one rank, but the ones split over it (their gather's backward
    sums them: `collectives.gather_shards`)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return set()
    return {id(p) for m in _stacks(model, "sp").values()
            for p in m.parameters() if not _model_split(p)}


def check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"sharding_policy {policy!r}: expected one of "
                         + ", ".join(POLICIES))


def _attention_plain(mod) -> bool:
    """An attention whose projections run as module calls on the plain
    route, with an output projection to close the Megatron pair."""
    return (mod.attn_impl == "xla" and not mod.fused_qkv
            and mod.proj is not None)


def _block_of(model: nn.Module) -> Dict[str, nn.Module]:
    from smb_vision_tpu_torch.models.layers import Block

    return {n: m for n, m in model.named_modules() if isinstance(m, Block)}


def _split(t: torch.Tensor, tp_mesh, dim: int) -> nn.Parameter:
    from torch.distributed.tensor import Shard, distribute_tensor

    return nn.Parameter(distribute_tensor(t.detach(), tp_mesh, [Shard(dim)]),
                        requires_grad=t.requires_grad)


def _apply_tp(model: nn.Module, tp_mesh, classes: Dict[str, Placement],
              n_model: int) -> None:
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )
    from torch.nn.utils import parametrize

    from smb_vision_tpu_torch.models.layers import Attention, Linear, Mlp

    blocks = _block_of(model)
    glue = {f"{n}.attention" for n, b in blocks.items()
            if b.glue_impl == "pallas"}
    # the modules of the sequence-parallel stacks: their ranks hold
    # different tokens, so every split weight is gathered at use there and
    # its gradient summed over the model axis
    sp = {".".join(x for x in (n, sub) if x)
          for n, m in _stacks(model, "sp").items()
          for sub, _ in m.named_modules()}
    lora = bool(lora_trainable(model))
    done: Set[str] = set()

    def cls(lin_name: str) -> Optional[str]:
        p = classes.get(lin_name + ".weight") or classes.get(
            lin_name + _ORIGINAL)
        return p.tp if p else None

    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if name in sp or lora:
            continue
        if isinstance(mod, Attention) and _attention_plain(mod) \
                and name not in glue:
            pair = {"query": "col", "key": "col", "value": "col",
                    "proj": "row"}
        elif isinstance(mod, Mlp) and mod.mlp_impl == "xla":
            pair = {"fc1": "col", "fc2": "row"}
        else:
            continue
        if any(cls(pre + c) != want for c, want in pair.items()):
            continue
        if isinstance(mod, Attention) and mod.num_heads % n_model:
            raise ValueError(
                f"tp: {pre}query.weight: {mod.num_heads} heads do not split "
                f"over model={n_model}")
        parallelize_module(mod, tp_mesh, {
            c: ColwiseParallel() if want == "col" else RowwiseParallel()
            for c, want in pair.items()})
        done.update(pre + c for c in pair)

    # every other split parameter: stored split, gathered at use (an
    # adapted weight's base: the merge gathers it, `train/lora.LoraDelta`)
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear) or name in done:
            continue
        tp = cls(name)
        if tp is None:
            continue
        dim = 0 if tp == "col" else 1
        if parametrize.is_parametrized(mod, "weight"):
            plist = mod.parametrizations.weight
            plist.original = _split(plist.original, tp_mesh, dim)
        else:
            mod.weight = _split(mod.weight, tp_mesh, dim)
        b = classes.get(name + ".bias")
        if mod.bias is not None and b is not None and b.tp == "col":
            mod.bias = _split(mod.bias, tp_mesh, 0)
        mod.gather_at_use = True
        mod.sum_grad = name in sp


def apply_policy(model: nn.Module, mesh, policy: str = "dp",
                 min_fsdp_size: int = 2 ** 16) -> Set[int]:
    """Place `model` on `mesh` under `policy`, in place. Returns the ids
    of the parameters whose gradients FSDP2 reduces (`sync_gradients`
    averages the others). The model must be on the mesh's device."""
    check_policy(policy)
    if mesh is None:
        return set()
    n_data, n_model = _mesh_shape(mesh)
    staged = _stacks(model, "pipe")
    if staged and "pipeline" not in policy:
        raise ValueError(f"a model pipelined over the model axis trains "
                         f"under sharding_policy pipeline or "
                         f"pipeline+fsdp, not {policy!r}")
    classes = param_placements(model, mesh, policy, min_fsdp_size)
    if "tp" in policy and n_model > 1:
        _apply_tp(model, mesh[MODEL_AXIS], classes, n_model)
    if "fsdp" not in policy:
        return set()
    from torch.distributed.fsdp import fully_shard

    replicated = set()
    trained = lora_trainable(model)
    for name, p in model.named_parameters():
        tp = classes[name].tp
        if (classes[name].stage or name in trained
                or p.numel() < min_fsdp_size
                or _fsdp_dim(jax_shape(p), tp, n_data) is None):
            replicated.add(p)
    dm = mesh[DATA_AXIS]
    if "pipeline" not in policy:
        for block in _block_of(model).values():
            fully_shard(block, mesh=dm, ignored_params=replicated)
    fully_shard(model, mesh=dm, ignored_params=replicated)
    return {id(p) for p in model.parameters() if p not in replicated}


def local(t: torch.Tensor) -> torch.Tensor:
    """The local piece of a DTensor, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def sync_gradients(params, mesh, fsdp_ids: Set[int],
                   model_sums: Set[int] = frozenset()) -> None:
    """Average over the data axis the gradients that FSDP2 does not
    reduce (every gradient under "dp" and "tp"), then sum over the model
    axis those of `model_sums` (the sequence-parallel stacks'): one
    all-reduce a dtype and axis, over the flattened local gradients."""
    n = axis_size(mesh, DATA_AXIS)
    if n > 1:
        _all_reduce([local(p.grad) for p in params
                     if p.grad is not None and id(p) not in fsdp_ids],
                    mesh[DATA_AXIS].get_group(), n)
    if model_sums and axis_size(mesh, MODEL_AXIS) > 1:
        _all_reduce([local(p.grad) for p in params
                     if p.grad is not None and id(p) in model_sums],
                    mesh[MODEL_AXIS].get_group(), 1)


def _all_reduce(grads, group, divide: int) -> None:
    """Each gradient summed over group and divided by `divide`, in place:
    one all-reduce a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        # gloo has no AVG: sum, then divide
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if divide != 1:
            flat.div_(divide)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def replication(t: torch.Tensor, world: int) -> int:
    """How many ranks of the world hold the same piece of t: world for a
    plain (replicated) tensor; for a DTensor, world over the number of
    distinct pieces."""
    if not hasattr(t, "placements"):
        return world
    pieces = 1
    mesh = t.device_mesh
    for i, pl in enumerate(t.placements):
        if is_split(pl):
            pieces *= mesh.size(i)
    return world // pieces


def is_split(pl) -> bool:
    """A placement that splits the tensor: Shard, or FSDP2's
    _StridedShard over a tensor-parallel split (not is_shard() to
    torch)."""
    return not (pl.is_replicate() or pl.is_partial())


def state_block_axes(placement: Placement, shape, sizes: Dict[str, int]):
    """The mesh axes the 8-bit moments of a parameter of this class split
    their block axis over (`train/quantized.py`): the axes the parameter
    is split over, when its block count divides over them, else none (the
    JAX package's `quantized_spec`)."""
    axes = ([DATA_AXIS] if placement.data else []) + (
        [MODEL_AXIS] if placement.tp else [])
    n = 1
    for a in axes:
        n *= sizes[a]
    numel = 1
    for s in shape:
        numel *= s
    blocks = -(-numel // 256)
    return axes if axes and blocks % n == 0 else []
