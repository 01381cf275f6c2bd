"""Fine-tuning workload: classification, multi-label classification,
regression and Cox survival on the VideoMAE, DINOv2 and V-JEPA2 heads.

Counterpart of `smb_vision_tpu/train/classification.py`. Task types and
label plumbing follow the reference collate:
- classification: integer labels, cross-entropy;
- multilabel_classification: (B, L) float multi-hot labels, BCE;
- regression: float labels, MSE;
- survival / cox_regression: the items' `os` (duration) and `os_event`,
  the Cox partial likelihood of the one-logit head over the batch (each
  micro-batch is its own risk set under gradient accumulation, as in the
  JAX package).
Only the VideoMAE head fuses tabular `additional_features`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from smb_vision_tpu_torch.models.dinov2 import Dinov2ForImageClassification
from smb_vision_tpu_torch.models.videomae import (
    VideoMAEForVideoClassification,
    classification_loss,
)
from smb_vision_tpu_torch.models.vjepa import VJEPA2ForVideoClassification
from smb_vision_tpu_torch.train.losses import cox_loss
from smb_vision_tpu_torch.train.trainer import accumulate_gradients

TASK_TYPES = ("classification", "multilabel_classification", "regression",
              "survival", "cox_regression")
MODELS = {"videomae": VideoMAEForVideoClassification,
          "dinov2": Dinov2ForImageClassification,
          "vjepa2": VJEPA2ForVideoClassification}


def is_survival(task_type: str) -> bool:
    return task_type in ("survival", "cox_regression")


def problem_type_for(task_type: str, num_labels: int) -> Optional[str]:
    """The head's problem_type of a task type; None for survival, whose
    one-logit head takes the Cox loss in the workload."""
    if task_type not in TASK_TYPES:
        raise ValueError(f"unknown task_type {task_type!r}; valid: "
                         + ", ".join(TASK_TYPES))
    return {"classification": "single_label_classification",
            "multilabel_classification": "multi_label_classification",
            "regression": "regression"}.get(task_type)


def collate_classification(examples: List[Dict], *, task_type: str,
                           label_columns: List[str],
                           additional_feature_columns: Optional[List[str]]
                           ) -> Dict[str, np.ndarray]:
    """A batch dict of numpy arrays: pixel_values (with the per-sample
    affine of uint8 volumes under SCALE_KEY / OFFSET_KEY), the labels of
    the task type (labels, or duration and event for survival) and, with
    feature columns, additional_features (B, n_columns) float32."""
    from smb_vision_tpu_torch.data.dataset import default_collate

    out = default_collate(examples)
    if additional_feature_columns:
        out["additional_features"] = np.asarray(
            [[float(e[c]) for c in additional_feature_columns]
             for e in examples], dtype=np.float32)
    if task_type == "multilabel_classification":
        out["labels"] = np.asarray(
            [[float(e[c]) for c in label_columns] for e in examples],
            dtype=np.float32)
    elif is_survival(task_type):
        out["duration"] = np.asarray([float(e["os"]) for e in examples],
                                     dtype=np.float32)
        out["event"] = np.asarray([float(e["os_event"]) for e in examples],
                                  dtype=np.float32)
    else:
        vals = [e[label_columns[0]] for e in examples]
        out["labels"] = np.asarray(
            vals, dtype=np.float32 if task_type == "regression" else np.int32)
    return out


def make_classification_workload(config, *, task_type: str, tx,
                                 grad_accum: int = 1,
                                 accum_dtype: Optional[torch.dtype] = None,
                                 device="cpu"):
    """Returns (model, init_fn, step_fn, eval_fn) for config's model family
    (config.model_type: videomae | dinov2 | vjepa2), its problem_type and
    num_labels already set.

    tx(named_parameters) -> optimizer (train/optim.py `make_optimizer`
    with its arguments bound: two-tier rates by the parameters' names).
    init_fn(seed) -> state {"model", "optimizer", "step"}; step_fn(state,
    batch, generator=None) -> {"loss"}: one optimizer update over
    grad_accum micro-batches, generator drawing the DropPath keep masks;
    eval_fn(state, batch) -> {"loss", "logits", "labels"} in eval mode,
    honouring batch["valid_mask"] (padded rows leave the loss: the Cox
    risk sets and the per-row means)."""
    if task_type not in TASK_TYPES:
        raise ValueError(f"unknown task_type {task_type!r}")
    if getattr(config, "quant8", False):
        raise ValueError("quant8 is an inference-only path: unset it for "
                         "fine-tuning")
    device = torch.device(device)
    with device:       # built and seeded on the device: no host copy
        model = MODELS[config.model_type](config)
    survival = is_survival(task_type)
    features = config.model_type == "videomae"

    def init_fn(seed: int) -> dict:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
        model.to(device)
        return {"model": model, "optimizer": tx(model.named_parameters()),
                "step": 0}

    def loss_of(batch, generator=None):
        kwargs = {}
        if features and "additional_features" in batch:
            kwargs["additional_features"] = batch["additional_features"]
        labels = None if survival else batch["labels"]
        out = model(batch["pixel_values"], labels=labels,
                    generator=generator, **kwargs)
        valid = batch.get("valid_mask")
        if survival:
            loss = cox_loss(out["logits"].squeeze(-1), batch["duration"],
                            batch["event"], valid=valid)
        elif valid is None:
            loss = out["loss"]
        else:
            loss = classification_loss(
                out["logits"], labels, config.num_labels,
                getattr(config, "problem_type", None), valid=valid)
        return loss, out

    def step_fn(state, batch, generator=None) -> dict:
        opt = state["optimizer"]
        model.train()
        opt.zero_grad()
        params = [p for p in model.parameters() if p.requires_grad]
        loss = accumulate_gradients(lambda b: loss_of(b, generator)[0],
                                    params, batch, grad_accum, accum_dtype)
        opt.step()
        state["step"] += 1
        return {"loss": loss}

    @torch.no_grad()
    def eval_fn(state, batch) -> dict:
        model.eval()
        loss, out = loss_of(batch)
        labels = ({"duration": batch["duration"], "event": batch["event"]}
                  if survival else batch["labels"])
        return {"loss": loss, "logits": out["logits"], "labels": labels}

    return model, init_fn, step_fn, eval_fn
