"""V-JEPA2 pretraining workload.

Counterpart of `smb_vision_tpu/train/vjepa.py::make_vjepa_workload`: the
student model, its EMA teacher, the train step and the eval step. Each
sample gets its own multi-block target mask, drawn in the step from the
generator the Trainer seeds for that step (after the mask, the same
generator draws the DropPath keep masks); `step_fn` also takes an explicit
mask. The teacher starts as a copy of the whole student, runs forward-only
under no_grad (with its own attn_impl if teacher_attn_impl is given, e.g.
"pallas_int8": kernel K3, and the MLP's K6 through the pallas_bwd primal
rule), and takes the EMA update once per optimizer step, after the update.
`make_pipelined_vjepa_workload` pipelines the student's and the teacher's
stacks over the mesh's model axis (`models/pipelined.py`); each rank's
teacher holds its stage's layers, and its EMA reads the student's layers
of the same stage.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from smb_vision_tpu_torch.models.configs import VJEPA2Config
from smb_vision_tpu_torch.models.vjepa import VJEPA2Model, vjepa_loss
from smb_vision_tpu_torch.ops.masking import vjepa_target_mask
from smb_vision_tpu_torch.parallel.collectives import global_rows, share_rows
from smb_vision_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_rank,
    axis_size,
)
from smb_vision_tpu_torch.parallel.pipeline import PipeStages
from smb_vision_tpu_torch.train.optim import ema_update
from smb_vision_tpu_torch.train.trainer import accumulate_gradients

EMA_MOMENTUM = 0.99925  # the reference recipe's


def make_vjepa_workload(config: VJEPA2Config, *, tx: Callable,
                        grad_accum: int = 1,
                        accum_dtype: Optional[torch.dtype] = None,
                        ema_momentum: float = EMA_MOMENTUM,
                        pred_mask_scale=(0.2, 0.8), aspect_ratio=(0.3, 3.0),
                        num_blocks: int = 3, inv_block: bool = False,
                        teacher_attn_impl: Optional[str] = None,
                        device="cpu", pipe: Optional[PipeStages] = None,
                        eval_microbatches: int = 0):
    """Returns (model, init_fn, step_fn, eval_fn).

    tx(named_parameters) -> optimizer (train/optim.py `make_optimizer`
    with its arguments bound). init_fn(seed) -> state {"model", "teacher",
    "optimizer", "step"}; step_fn(state, batch, generator=None, mask=None)
    -> {"loss"}: one optimizer update and one EMA update on
    batch["pixel_values"], with the given (B, N) bool target mask or one
    drawn from generator; eval_fn(state, batch) -> {"loss"}: eval mode (no
    DropPath) under a fixed target mask (seed 0), honouring
    batch["valid_mask"]. pipe: the student and the teacher hold this
    pipeline stage's layers (`make_pipelined_vjepa_workload`), initialised
    as the dense model's of the same seed; eval_microbatches: the eval
    step's count (default the train step's)."""
    device = torch.device(device)
    model = VJEPA2Model(config, pipe=pipe)
    tconfig = (dataclasses.replace(config, attn_impl=teacher_attn_impl)
               if teacher_attn_impl else config)
    teacher = VJEPA2Model(tconfig, pipe=pipe).requires_grad_(False)

    def gen_mask(generator: torch.Generator, batch: int) -> torch.Tensor:
        return vjepa_target_mask(generator, batch, grid=config.grid,
                                 pred_mask_scale=pred_mask_scale,
                                 aspect_ratio=aspect_ratio,
                                 num_blocks=num_blocks, inv_block=inv_block)

    def init_fn(seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        if pipe is None:
            model.init_weights(gen)
        else:
            # the stage's share of the dense model's initialisation
            from smb_vision_tpu_torch.models.pipelined import stage_state

            dense = VJEPA2Model(config).init_weights(gen)
            model.load_state_dict(stage_state(model, dense.state_dict()))
            del dense
        model.to(device)
        teacher.load_state_dict(model.state_dict())
        teacher.to(device).eval()
        return {"model": model, "teacher": teacher,
                "optimizer": tx(model.named_parameters()), "step": 0}

    def loss_for(px, target, generator=None, valid=None) -> torch.Tensor:
        out = model(px, target_bool=target, generator=generator)
        with torch.no_grad():
            tgt = teacher(px, target_bool=target,
                          skip_predictor=True)["last_hidden_state"]
        return vjepa_loss(out["predictor_output"], tgt, target, valid=valid)

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
        loss = accumulate_gradients(
            lambda b: loss_for(b["pixel_values"], b["mask"], generator),
            params, {"pixel_values": px, "mask": mask}, grad_accum,
            accum_dtype)
        opt.step()
        ema_update(state["teacher"], model, ema_momentum)
        state["step"] += 1
        return {"loss": loss}

    @torch.no_grad()
    def eval_fn(state, batch) -> dict:
        px = batch["pixel_values"]
        mask = share_rows(gen_mask(torch.Generator().manual_seed(0),
                                   global_rows(px.shape[0])))
        model.eval()
        if pipe is not None:
            from smb_vision_tpu_torch.models.pipelined import set_microbatches

            for m in (model, teacher):
                set_microbatches(m, eval_microbatches or pipe.microbatches)
        try:
            return {"loss": loss_for(px, mask.to(px.device),
                                     valid=batch.get("valid_mask"))}
        finally:
            if pipe is not None:
                for m in (model, teacher):
                    set_microbatches(m, pipe.microbatches)

    return model, init_fn, step_fn, eval_fn


def make_pipelined_vjepa_workload(config: VJEPA2Config, *, tx: Callable,
                                  mesh, num_microbatches: int,
                                  eval_microbatches: int = 0,
                                  remat: bool = True, **kw):
    """V-JEPA2 pretraining with the student's encoder and predictor and
    the EMA teacher's encoder GPipe-pipelined over the mesh's model axis
    (`models/pipelined.vjepa2_pipeline_pretrain`'s computation): each rank
    holds layers/S of every stack, under the dense names (sharding policy
    "pipeline" or "pipeline+fsdp"). Microbatching replaces gradient
    accumulation; remat checkpoints each layer of the stages. kw: as
    make_vjepa_workload's. Returns (model, init_fn, step_fn, eval_fn)."""
    if config.sequence_parallel:
        raise ValueError("pipeline parallelism composes with the data "
                         "axis, not sequence parallelism; unset "
                         "config.sequence_parallel")
    if kw.get("grad_accum", 1) != 1:
        raise ValueError("the pipeline's microbatches replace gradient "
                         "accumulation; pass grad_accum 1")
    pipe = PipeStages(axis_size(mesh, MODEL_AXIS),
                      axis_rank(mesh, MODEL_AXIS), num_microbatches)
    for n in (config.num_hidden_layers, config.pred_num_hidden_layers):
        pipe.layers(n)
    config = dataclasses.replace(config, gradient_checkpointing=remat)
    return make_vjepa_workload(config, tx=tx, pipe=pipe,
                               eval_microbatches=eval_microbatches, **kw)
