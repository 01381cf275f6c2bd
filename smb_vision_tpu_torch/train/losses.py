"""Task losses beyond the heads' cross-entropy, BCE and MSE: the Cox
partial likelihood of survival fine-tuning.

Counterpart of `smb_vision_tpu/train/losses.py`: sort by descending
duration, then loss = -sum((log_h - log_cumsum_exp(log_h)) * event) /
(sum(event) + eps). The risk sets are the batch's own (a within-batch
quantity; under gradient accumulation each micro-batch is its own risk
set, as in the JAX package). On a mesh (`parallel.mesh.use_mesh`) the
batch is the global one: the risk sets span every data rank's rows."""

from __future__ import annotations

from typing import Optional

import torch

from smb_vision_tpu_torch.parallel.collectives import gather_rows


def cox_ph_loss_sorted(log_h: torch.Tensor, events: torch.Tensor,
                       eps: float = 1e-7) -> torch.Tensor:
    """Negative Cox partial log-likelihood of risks already sorted by
    descending duration, in float32."""
    events = events.reshape(-1).float()
    log_h = log_h.reshape(-1).float()
    gamma = log_h.max()
    log_cumsum_h = torch.log(torch.cumsum(torch.exp(log_h - gamma), 0)
                             + eps) + gamma
    return -((log_h - log_cumsum_h) * events).sum() / (events.sum() + eps)


def cox_loss(risk_scores: torch.Tensor, durations: torch.Tensor,
             events: torch.Tensor, eps: float = 1e-7,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cox loss of (B,) risk scores. valid: optional (B,) 1 = real row,
    0 = the Trainer's eval padding; a padded row leaves both sides of the
    likelihood: its event is zeroed and its risk set to -1e30, so exp()
    underflows to 0 in every risk set (a finite sentinel: -inf times a
    zero event would be NaN)."""
    risk = risk_scores.reshape(-1).float()
    events = events.reshape(-1).float()
    durations = durations.reshape(-1)
    # on a mesh the risk sets are the global batch's: every rank gathers
    # every rank's rows (the risks with their gradient) and computes the
    # same global loss
    risk = gather_rows(risk)
    events = gather_rows(events).detach()
    durations = gather_rows(durations).detach()
    if valid is not None:
        valid = gather_rows(valid.reshape(-1).float()).detach()
    if valid is not None:
        v = valid.reshape(-1).float()
        events = events * v
        risk = torch.where(v > 0, risk, torch.full_like(risk, -1e30))
    order = torch.argsort(-durations, stable=True)
    return cox_ph_loss_sorted(risk[order], events[order], eps)
