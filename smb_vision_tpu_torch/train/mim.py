"""MIM (SimMIM-style) pretraining workload.

Counterpart of `smb_vision_tpu/train/mim.py::make_mim_workload` and
`make_pipelined_mim_workload`: the model, its initialisation, the train
step and the eval step of VideoMAEForPreTraining, dense or with both
stacks pipelined over the mesh's model axis. The block mask of a step
comes from the generator the Trainer seeds for that step; `step_fn` also
takes an explicit mask.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu_torch.ops.masking import mim_mask, num_masked_tokens
from smb_vision_tpu_torch.parallel.collectives import global_rows, share_rows
from smb_vision_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_rank,
    axis_size,
)
from smb_vision_tpu_torch.parallel.pipeline import PipeStages
from smb_vision_tpu_torch.train.trainer import accumulate_gradients


def make_mim_workload(config: VideoMAEConfig, *, mask_patch_size: int,
                      mask_ratio: float, tx: Callable, grad_accum: int = 1,
                      accum_dtype: Optional[torch.dtype] = None,
                      device="cpu", pipe: Optional[PipeStages] = None,
                      eval_microbatches: int = 0):
    """Returns (model, init_fn, step_fn, eval_fn).

    tx(named_parameters) -> optimizer (train/optim.py `make_optimizer`
    with its arguments bound). init_fn(seed) -> state {"model",
    "optimizer", "step"}; step_fn(state, batch, generator=None, mask=None)
    -> {"loss"}: one optimizer update on batch["pixel_values"], with the
    given (B, N) bool mask or one drawn from generator; eval_fn(state,
    batch) -> {"loss"} under a fixed mask (seed 0), honouring
    batch["valid_mask"]. pipe: the model holds this pipeline stage's
    layers (`make_pipelined_mim_workload`), initialised as the dense
    model's of the same seed; eval_microbatches: the eval step's count
    (default the train step's)."""
    if config.quant8:
        raise ValueError(
            "quant8 is an inference-only fast path: its rounding has zero "
            "gradient almost everywhere, so training with it would go "
            "nowhere. Unset config.quant8 for pretraining.")
    device = torch.device(device)
    model = VideoMAEForPreTraining(config, pipe)
    num_masked = num_masked_tokens(
        config.image_size, config.num_frames, mask_patch_size,
        config.patch_size, mask_ratio)

    def gen_mask(generator: torch.Generator, batch: int) -> torch.Tensor:
        return mim_mask(generator, batch, input_size=config.image_size,
                        depth=config.num_frames,
                        mask_patch_size=mask_patch_size,
                        model_patch_size=config.patch_size,
                        mask_ratio=mask_ratio)

    def init_fn(seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        if pipe is None:
            model.init_weights(gen)
        else:
            # the stage's share of the dense model's initialisation
            from smb_vision_tpu_torch.models.pipelined import stage_state

            dense = VideoMAEForPreTraining(config).init_weights(gen)
            model.load_state_dict(stage_state(model, dense.state_dict()))
            del dense
        model.to(device)
        return {"model": model, "optimizer": tx(model.named_parameters()),
                "step": 0}

    def loss_fn(batch) -> torch.Tensor:
        return model(batch["pixel_values"], batch["mask"], num_masked,
                     valid=batch.get("valid_mask"))["loss"]

    def step_fn(state, batch, generator=None, mask=None) -> dict:
        opt = state["optimizer"]
        px = batch["pixel_values"]
        if mask is None:
            # drawn for the global batch, this rank's rows kept
            mask = share_rows(gen_mask(generator, global_rows(px.shape[0])),
                              grad_accum)
        if not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.array(mask, dtype=bool))
        mask = mask.to(px.device)
        model.train()
        opt.zero_grad()
        params = [p for p in model.parameters() if p.requires_grad]
        loss = accumulate_gradients(loss_fn, params,
                                    {"pixel_values": px, "mask": mask},
                                    grad_accum, accum_dtype)
        opt.step()
        state["step"] += 1
        return {"loss": loss}

    @torch.no_grad()
    def eval_fn(state, batch) -> dict:
        px = batch["pixel_values"]
        mask = share_rows(gen_mask(torch.Generator().manual_seed(0),
                                   global_rows(px.shape[0])))
        model.eval()
        if pipe is None:
            return {"loss": loss_fn({**batch, "mask": mask.to(px.device)})}
        from smb_vision_tpu_torch.models.pipelined import set_microbatches

        set_microbatches(model, eval_microbatches or pipe.microbatches)
        try:
            return {"loss": loss_fn({**batch, "mask": mask.to(px.device)})}
        finally:
            set_microbatches(model, pipe.microbatches)

    return model, init_fn, step_fn, eval_fn


def make_pipelined_mim_workload(config: VideoMAEConfig, *,
                                mask_patch_size: int, mask_ratio: float,
                                tx: Callable, mesh, num_microbatches: int,
                                eval_microbatches: int = 0,
                                remat: bool = True, device="cpu"):
    """MIM pretraining with the encoder and decoder stacks pipelined
    (GPipe) over the mesh's model axis: each rank holds layers/S of both
    stacks and the rest whole, under the dense names, so its checkpoints
    and exports are the dense model's (sharding policy "pipeline" or
    "pipeline+fsdp"). Microbatching replaces gradient accumulation; remat
    checkpoints each layer of the stages. Returns (model, init_fn, step_fn,
    eval_fn) as make_mim_workload."""
    if getattr(config, "quant8", False):
        raise ValueError("quant8 is inference-only; unset it for "
                         "pretraining (see make_mim_workload)")
    if config.sequence_parallel:
        raise ValueError("pipeline parallelism composes with the data "
                         "axis, not sequence parallelism; unset "
                         "config.sequence_parallel")
    pipe = PipeStages(axis_size(mesh, MODEL_AXIS),
                      axis_rank(mesh, MODEL_AXIS), num_microbatches)
    for n in (config.num_hidden_layers, config.decoder_num_hidden_layers):
        pipe.layers(n)
    config = dataclasses.replace(config, gradient_checkpointing=remat)
    return make_mim_workload(
        config, mask_patch_size=mask_patch_size, mask_ratio=mask_ratio,
        tx=tx, device=device, pipe=pipe,
        eval_microbatches=eval_microbatches)
