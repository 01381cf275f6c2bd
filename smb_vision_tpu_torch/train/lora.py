"""LoRA fine-tuning.

Counterpart of `smb_vision_tpu/train/lora.py`. Adapters sit on the Linear
weights whose JAX-package path (`params/videomae/encoder/layer_0/attention/
query/kernel`: the `params_to_flax` name with "/" between its parts)
matches the target regex, q/k/v/proj and the MLP's fc1/fc2 or SwiGLU's
weights_in/weights_out by default. A is (in, r) ~ N(0, 1/r) and B (r, out)
is 0, the flax kernel layout, so the adapted model starts at the base
model; the merged weight is W + ((A @ B) * alpha / rank)^T in the Linear's
(out, in) layout.

The merge is a `torch.nn.utils.parametrize` parametrization of each
adapted Linear's `weight`: every route that reads `.weight` (the Linear
itself, the fused projections, the glue kernels, the MLP and SwiGLU
half-block kernels through their autograd Functions, and the remat
recompute) gets the merged tensor, and the adapters their gradient from
there. The base parameters are frozen (`requires_grad=False`); the head
(HEAD_REGEX: classifier, fc_norm, pooler) trains directly. alpha and rank
(`lora_meta`) are neither trained nor decayed.

`lora.safetensors` holds `adapters.<path>.a`, `adapters.<path>.b`,
`head.<path>` and `meta.alpha`, `meta.rank` under the JAX package's names,
so a file written by either package loads into the other.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from smb_vision_tpu_torch.models.convert import (
    load_backbone_into,
    read_safetensors,
)
from smb_vision_tpu_torch.train.classification import (
    make_classification_workload,
)

DEFAULT_TARGETS = (r"attention/(query|key|value|proj)/kernel$"
                   r"|mlp/(fc1|fc2|weights_in|weights_out)/kernel$")
HEAD_REGEX = r"classifier|fc_norm|pooler"
_PARAMETRIZED = ".parametrizations.weight."


def jax_path(name: str, ndim: int) -> str:
    """The JAX package's path of a state_dict entry: `params/` and the
    dotted name with "/", a 2-D `.weight` as `/kernel`, a 1-D one (a norm)
    as `/scale`."""
    if name.endswith(".weight") and ndim in (1, 2):
        name = name[:-len(".weight")] + (".kernel" if ndim == 2
                                         else ".scale")
    return "params/" + name.replace(".", "/")


class LoraDelta(nn.Module):
    """The parametrization of one adapted Linear weight W (out, in):
    W + ((a @ b) * scale)^T, a (in, r), b (r, out)."""

    def __init__(self, fan_in: int, fan_out: int, rank: int, scale: float,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        a = torch.randn((fan_in, rank), generator=generator, device=device)
        self.a = nn.Parameter(a / float(np.float32(np.sqrt(rank))))
        self.b = nn.Parameter(torch.zeros((rank, fan_out), device=device))
        self.scale = scale

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return w + ((self.a @ self.b) * self.scale).t().to(w.dtype)


def adapted(model: nn.Module) -> Dict[str, Tuple[nn.Module, LoraDelta]]:
    """{JAX path of the base weight: (its Linear, its LoraDelta)}."""
    out = {}
    for name, mod in model.named_modules():
        if parametrize.is_parametrized(mod, "weight"):
            delta = mod.parametrizations.weight[0]
            if isinstance(delta, LoraDelta):
                out[jax_path(name + ".weight", 2)] = (mod, delta)
    return out


def init_lora(model: nn.Module, generator: Optional[torch.Generator] = None,
              rank: int = 8, alpha: float = 16.0,
              targets: str = DEFAULT_TARGETS) -> Dict[str, LoraDelta]:
    """Register an adapter on every 2-D weight whose JAX path matches
    `targets`, freeze every other parameter but the head's, and return
    {path: LoraDelta}. Nothing matching is an error."""
    pat = re.compile(targets)
    scale = alpha / rank
    hits = [(name, p) for name, p in model.named_parameters()
            if p.ndim == 2 and name.endswith(".weight")
            and pat.search(jax_path(name, 2))]
    if not hits:
        raise ValueError(
            f"no parameters matched LoRA targets {targets!r}: adapters "
            "would train nothing; check the target regex against the "
            "model's param paths")
    head = re.compile(HEAD_REGEX)
    for name, p in model.named_parameters():
        p.requires_grad_(bool(head.search(jax_path(name, p.ndim))))
    out = {}
    for name, p in hits:
        mod = model.get_submodule(name[:-len(".weight")])
        fan_out, fan_in = p.shape
        delta = LoraDelta(fan_in, fan_out, rank, scale, generator, p.device)
        parametrize.register_parametrization(mod, "weight", delta)
        mod.parametrizations.weight.original.requires_grad_(False)
        out[jax_path(name, 2)] = delta
    return out


def head_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """{JAX path: parameter} of the head (HEAD_REGEX), which trains
    directly; an adapted weight is never in it."""
    pat = re.compile(HEAD_REGEX)
    return {jax_path(n, p.ndim): p for n, p in model.named_parameters()
            if _PARAMETRIZED not in n and pat.search(jax_path(n, p.ndim))}


def lora_named_parameters(model: nn.Module
                          ) -> List[Tuple[str, nn.Parameter]]:
    """The trainable parameters under the JAX package's names of its
    trainable tree (`adapters/<path>/a`, `adapters/<path>/b`,
    `head/<path>`), which its optimizer tiers and decay mask read: an
    adapter of the backbone is in the vision tier, `head/.../classifier/...`
    in the head tier."""
    out = []
    for path, (_, d) in adapted(model).items():
        out += [(f"adapters/{path}/a", d.a), (f"adapters/{path}/b", d.b)]
    out += [(f"head/{path}", p) for path, p in head_parameters(model).items()]
    return out


def lora_size(model: nn.Module) -> int:
    """The adapters' parameter count."""
    return sum(d.a.numel() + d.b.numel()
               for _, d in adapted(model).values())


def base_state_dict(model: nn.Module, merged: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The model's state_dict under its own names, without the adapters:
    each adapted weight is the frozen base's, or with merged=True the
    merged W + delta."""
    out = {}
    for k, v in model.state_dict().items():
        if _PARAMETRIZED not in k:
            out[k] = v
        elif k.endswith(_PARAMETRIZED + "original"):
            out[k[:-len(_PARAMETRIZED + "original")] + ".weight"] = v
    if merged:
        with torch.no_grad():
            for name, mod in model.named_modules():
                if parametrize.is_parametrized(mod, "weight"):
                    out[name + ".weight"] = mod.weight.detach()
    return out


def lora_tensors(model: nn.Module, meta: Dict[str, float]
                 ) -> Dict[str, np.ndarray]:
    """The `lora.safetensors` tensors: adapters, head and meta, float32,
    under the JAX package's names and layouts (a head kernel is the
    transposed Linear weight)."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    out = {}
    for path, (_, d) in adapted(model).items():
        out[f"adapters.{path}.a"] = arr(d.a)
        out[f"adapters.{path}.b"] = arr(d.b)
    for path, p in head_parameters(model).items():
        out[f"head.{path}"] = np.ascontiguousarray(arr(p).T)
    for k in ("alpha", "rank"):
        out[f"meta.{k}"] = np.asarray(meta[k], np.float32)
    return out


@torch.no_grad()
def load_lora(model: nn.Module, path: Union[str, Path]) -> Dict[str, float]:
    """Copy a `lora.safetensors` (either package's) into the model's
    adapters and head; returns its meta {"alpha", "rank"}. Every adapter
    and head tensor of the model must be in the file with its shape, and
    the file's alpha / rank must be the model's scale."""
    flat = read_safetensors(path)
    meta = {k: float(flat[f"meta.{k}"]) for k in ("alpha", "rank")}
    targets = [(f"adapters.{p}.{ab}", getattr(d, ab))
               for p, (_, d) in adapted(model).items() for ab in "ab"]
    targets += [(f"head.{p}", t) for p, t in head_parameters(model).items()]
    for key, t in targets:
        if key not in flat:
            raise KeyError(f"{path} has no tensor {key!r}")
        arr = flat[key].T if key.startswith("head.") else flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}: {key!r} has shape {arr.shape}, the "
                             f"model {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    for _, d in adapted(model).values():
        if not np.isclose(d.scale, meta["alpha"] / meta["rank"]):
            raise ValueError(f"{path}: alpha / rank {meta} is not the "
                             f"adapters' scale {d.scale}")
    return meta


def make_lora_classification_workload(config, *, task_type: str, tx,
                                      rank: int = 8, alpha: float = 16.0,
                                      targets: str = DEFAULT_TARGETS,
                                      grad_accum: int = 1,
                                      accum_dtype: Optional[torch.dtype]
                                      = None, device="cpu"):
    """The classification workload (`make_classification_workload`) where
    only the adapters and the head train. Returns (model, init_fn,
    step_fn, eval_fn); init_fn(seed, backbone=None) initialises the model
    from seed, loads `backbone` (a checkpoint path, `load_backbone_into`)
    into the base, registers the adapters (A drawn from seed) and builds
    the optimizer over `lora_named_parameters`. State: {"model",
    "optimizer", "step", "lora_meta" {alpha, rank}, "base_head" (the head
    as initialised: the frozen base `save_model` writes)}."""
    if getattr(config, "quant8", False):
        raise ValueError(
            "quant8 is an inference-only fast path: the W8A8 rounding has "
            "zero gradient almost everywhere, so LoRA adapters behind "
            "QuantDense would silently stop learning. Unset config.quant8 "
            "for fine-tuning.")
    model, _, step_fn, eval_fn = make_classification_workload(
        config, task_type=task_type, tx=tx, grad_accum=grad_accum,
        accum_dtype=accum_dtype, device=device)
    device = torch.device(device)

    def init_fn(seed: int, backbone: Optional[str] = None) -> dict:
        gen = torch.Generator(device=device).manual_seed(seed)
        model.init_weights(gen)
        model.to(device)
        if backbone:
            load_backbone_into(model, backbone)
        init_lora(model, gen, rank=rank, alpha=alpha, targets=targets)
        return {"model": model,
                "optimizer": tx(lora_named_parameters(model)), "step": 0,
                "lora_meta": {"alpha": float(alpha), "rank": float(rank)},
                "base_head": {k: p.detach().clone() for k, p
                              in head_parameters(model).items()}}

    return model, init_fn, step_fn, eval_fn
