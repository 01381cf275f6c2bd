"""Pipeline-parallel model application: the encoders and the pretraining
models with their layer stacks streamed through GPipe stages
(`parallel/pipeline.py`) over the mesh's "model" axis.

Counterpart of `smb_vision_tpu/models/pipelined.py`. A model built with
`pipe=PipeStages(S, s, M)` holds, in each of its stacks, only stage s's
layers, under their dense names (`videomae.encoder.layer_6...`), and
everything else whole: its forward is the dense model's, with each stack
run by `Encoder.pipelined`. So the stage's state_dict is a subset of the
dense one (`stage_state`), a checkpoint keyed by those names resumes at
any stage count, and the export of the stages merged
(`Trainer.full_model_state`, `parallel.pipeline.stage_ranks_state`) is
the dense export. The
functions below are the JAX package's, on such models; the JAX package's
stacked layout (a leading layer axis on a `*_stacked` tree) is
`to_/from_pipeline_pretrain_params` and `to_/from_pipeline_vjepa_params`.
DropPath in training draws every layer's masks for the whole batch in
layer order, as the dense stack does (`Encoder.draw_masks`), so a
pipelined step draws what a dense one draws from the same generator.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from smb_vision_tpu_torch.models.layers import Encoder
from smb_vision_tpu_torch.parallel.mesh import use_mesh
from smb_vision_tpu_torch.parallel.pipeline import (
    stack_layer_params,
    unstack_layer_params,
)


@contextlib.contextmanager
def _on(mesh):
    """The mesh given, or the ambient one when None."""
    if mesh is None:
        yield
    else:
        with use_mesh(mesh):
            yield


def set_microbatches(model: torch.nn.Module, num_microbatches: int) -> None:
    """The microbatch count of every pipelined stack of `model` (the
    eval step may stream fewer than the train step)."""
    for m in model.modules():
        if isinstance(m, Encoder) and m.pipe is not None:
            m.microbatches = num_microbatches


def stage_state(model: torch.nn.Module,
                dense: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of a dense state_dict that a stage-built `model`
    holds (its own names); raises naming a missing one."""
    out = {}
    for k in model.state_dict():
        if k not in dense:
            raise KeyError(f"the dense state has no {k!r}")
        out[k] = dense[k]
    return out


def pipelined_encoder(enc: Encoder, x, *, num_microbatches: int,
                      mesh=None, axis: str = "model", rope=None,
                      remat: bool = False, deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
    """Apply an Encoder stack through the pipeline: `enc` holds this
    stage's layers (built with `pipe`; a dense Encoder is one stage).
    Equal to the dense stack's forward on the same weights. With
    drop_path_rate > 0 and deterministic=False, `generator` draws the
    DropPath masks (every layer's, in order, for the whole batch)."""
    if axis != "model":
        raise ValueError(f"the pipeline runs over the model axis, not "
                         f"{axis!r}")
    if enc.sequence_parallel:
        raise ValueError(
            "pipelined_encoder streams microbatches through stages; build "
            "the Encoder with sequence_parallel=False (the pipeline "
            "composes with the data axis, not the sequence axis)")
    if not deterministic and enc.drop_path_rate > 0 and generator is None:
        raise ValueError(
            "pipelined_encoder with drop_path_rate > 0 and "
            "deterministic=False needs generator (the stochastic-depth "
            "masks' generator)")
    was = enc.training
    enc.train(not deterministic)
    try:
        with _on(mesh):
            return enc.pipelined(x, rope=rope, generator=generator,
                                 num_microbatches=num_microbatches,
                                 remat=remat)
    finally:
        enc.train(was)


def _microbatches(model, num_microbatches: Optional[int]):
    if num_microbatches is not None:
        set_microbatches(model, num_microbatches)


def _pipeline_encode(model, enc: Encoder, inputs, *, num_microbatches: int,
                     mesh, axis: str, remat: bool):
    """model(inputs), in eval mode, with its stack `enc` streaming
    num_microbatches microbatches and recomputing as `remat` says."""
    if axis != "model":
        raise ValueError(f"the pipeline runs over the model axis, not "
                         f"{axis!r}")
    set_microbatches(model, num_microbatches)
    was, was_remat = model.training, enc.remat
    model.eval()
    enc.remat = remat
    try:
        with _on(mesh):
            return model(inputs)
    finally:
        model.train(was)
        enc.remat = was_remat


def videomae_pipeline_encode(config, model, pixel_values, *,
                             num_microbatches: int, mesh=None,
                             axis: str = "model", remat: bool = False):
    """VideoMAEModel's embedding forward (every token) with the stack
    pipelined; `model` a (stage-built) VideoMAEModel. Equal to
    `model(pixel_values)[0]` of the dense model."""
    return _pipeline_encode(model, model.encoder, pixel_values,
                            num_microbatches=num_microbatches, mesh=mesh,
                            axis=axis, remat=remat)[0]


def vjepa2_pipeline_encode(config, model, pixel_values_videos, *,
                           num_microbatches: int, mesh=None,
                           axis: str = "model", remat: bool = False):
    """VJEPA2Encoder's forward with the stack pipelined (the RoPE tables
    go to every stage); `model` a (stage-built) VJEPA2Encoder."""
    return _pipeline_encode(model, model.encoder, pixel_values_videos,
                            num_microbatches=num_microbatches, mesh=mesh,
                            axis=axis, remat=remat)


def dinov2_pipeline_encode(config, model, pixel_values, *,
                           num_microbatches: int, mesh=None,
                           axis: str = "model", remat: bool = False):
    """Dinov2Model's forward (CHW patchify, CLS token, learned 3D
    positions, LayerScale / SwiGLU blocks) with the stack pipelined;
    `model` a (stage-built) Dinov2Model."""
    return _pipeline_encode(model, model.encoder, pixel_values,
                            num_microbatches=num_microbatches, mesh=mesh,
                            axis=axis, remat=remat)


# -- the JAX package's stacked layouts ----------------------------------------

def _stack_under(sd: Dict[str, torch.Tensor], stack: str,
                 stacked: str) -> Dict[str, torch.Tensor]:
    """sd with the `{stack}.layer_i.*` entries replaced by
    `{stacked}.*` (a leading layer axis)."""
    pre = stack + "."
    layers = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    out = {k: v for k, v in sd.items() if not k.startswith(pre)}
    st, _ = stack_layer_params(layers)
    out.update({f"{stacked}.{k}": v for k, v in st.items()})
    return out


def _unstack_under(sd: Dict[str, torch.Tensor], stacked: str,
                   stack: str) -> Dict[str, torch.Tensor]:
    pre = stacked + "."
    st = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    out = {k: v for k, v in sd.items() if not k.startswith(pre)}
    n = next(iter(st.values())).shape[0]
    out.update({f"{stack}.{k}": v
                for k, v in unstack_layer_params(st, n).items()})
    return out


def to_pipeline_pretrain_params(sd: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A VideoMAEForPreTraining state_dict -> the JAX package's pipelined
    layout: `videomae.encoder.layer_i.*` -> `videomae.encoder_stacked.*`
    and `decoder.layer_i.*` -> `decoder_stacked.*` (leading layer axis);
    the rest unchanged. Inverse: `from_pipeline_pretrain_params`."""
    out = _stack_under(sd, "videomae.encoder", "videomae.encoder_stacked")
    return _stack_under(out, "decoder", "decoder_stacked")


def from_pipeline_pretrain_params(sd: Dict[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
    out = _unstack_under(sd, "videomae.encoder_stacked", "videomae.encoder")
    return _unstack_under(out, "decoder_stacked", "decoder")


def to_pipeline_vjepa_params(sd: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A VJEPA2Model state_dict (the student or the teacher) -> the JAX
    package's pipelined layout: `encoder.encoder_stacked.*` and
    `predictor.stack_stacked.*`. Inverse: `from_pipeline_vjepa_params`."""
    out = _stack_under(sd, "encoder.encoder", "encoder.encoder_stacked")
    if any(k.startswith("predictor.stack.") for k in out):
        out = _stack_under(out, "predictor.stack", "predictor.stack_stacked")
    return out


def from_pipeline_vjepa_params(sd: Dict[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    out = _unstack_under(sd, "encoder.encoder_stacked", "encoder.encoder")
    if any(k.startswith("predictor.stack_stacked.") for k in out):
        out = _unstack_under(out, "predictor.stack_stacked",
                             "predictor.stack")
    return out


# -- pretraining --------------------------------------------------------------

def videomae_pipeline_pretrain(config, model, pixel_values, bool_masked_pos,
                               num_masked: int, *,
                               num_microbatches: Optional[int] = None,
                               mesh=None, valid=None) -> dict:
    """VideoMAEForPreTraining's forward (loss and logits) with the encoder
    and decoder stacks pipelined; `model` built with `pipe` (its stacks
    remat as its config's gradient_checkpointing says). Equal to the
    dense model's."""
    _microbatches(model, num_microbatches)
    with _on(mesh):
        return model(pixel_values, bool_masked_pos, num_masked, valid=valid)


def vjepa2_pipeline_pretrain(config, model, teacher, pixel_values_videos,
                             target_bool, *,
                             num_microbatches: Optional[int] = None,
                             mesh=None, mask_index: int = 1,
                             generator=None, valid=None):
    """The V-JEPA2 pretraining loss (the dense target_bool formulation)
    with the student's encoder and predictor and the EMA teacher's encoder
    pipelined; `model` and `teacher` built with `pipe`. DropPath runs in
    the student as its training mode says (masks from `generator`); the
    teacher encodes without it and without gradient."""
    from smb_vision_tpu_torch.models.vjepa import vjepa_loss

    _microbatches(model, num_microbatches)
    _microbatches(teacher, num_microbatches)
    with _on(mesh):
        out = model(pixel_values_videos, target_bool=target_bool,
                    mask_index=mask_index, generator=generator)
        with torch.no_grad():
            tgt = teacher(pixel_values_videos, target_bool=target_bool,
                          skip_predictor=True)["last_hidden_state"]
        return vjepa_loss(out["predictor_output"], tgt, target_bool,
                          valid=valid)
