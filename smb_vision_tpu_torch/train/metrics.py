"""Evaluation metrics, on the host in numpy over the gathered eval
outputs.

Counterpart of `smb_vision_tpu/train/metrics.py` (numpy only, a copy kept
in the port): Harrell's C-index, micro precision / recall / F1, accuracy,
binary ROC-AUC, MSE, and the combined_score mean.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def concordance_index(durations, risk_scores, events) -> float:
    """Harrell's C-index. Pairs (i, j) are comparable when the one with the
    shorter duration has an observed event; concordant when the
    shorter-duration subject has the higher risk. Ties in risk count 0.5.
    (lifelines.utils.concordance_index semantics; note lifelines expects
    *predicted survival times* — the reference passes risk scores directly,
    we score risk with the standard sign convention: higher risk ~ shorter
    survival.)"""
    durations = np.asarray(durations, dtype=np.float64).reshape(-1)
    risk = np.asarray(risk_scores, dtype=np.float64).reshape(-1)
    events = np.asarray(events).reshape(-1).astype(bool)

    # vectorised over (event i, any j) pairs — the O(n^2) Python loop this
    # replaces took minutes at realistic cohort sizes
    di = durations[events][:, None]                 # (n_events, 1)
    ri = risk[events][:, None]
    # i has an event; comparable if j survived longer (or was censored at
    # the same time — j's event is known to be later)
    comparable = (di < durations[None, :]) | (
        (di == durations[None, :]) & ~events[None, :])
    # i == j pairs have durations[i] == durations[j] and events[j]=True ->
    # never comparable, so no self-pair exclusion is needed
    den = float(comparable.sum())
    if den == 0.0:
        return 0.5
    num = float((comparable & (ri > risk[None, :])).sum()) \
        + 0.5 * float((comparable & (ri == risk[None, :])).sum())
    return num / den


def _micro_prf(y_true: np.ndarray, y_pred: np.ndarray):
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return precision, recall, f1


def roc_auc_binary(scores, labels) -> float:
    """AUC via the rank statistic (ties averaged)."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1).astype(bool)
    n_pos, n_neg = int(labels.sum()), int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (r + r + (j - i)) / 2.0
        r += (j - i) + 1
        i = j + 1
    pos_rank_sum = ranks[labels].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _with_combined(result: Dict[str, float]) -> Dict[str, float]:
    if len(result) > 1:
        result["combined_score"] = float(np.mean(list(result.values())))
    return result


def compute_metrics(task_type: str, predictions, labels) -> Dict[str, float]:
    predictions = np.asarray(predictions)

    if task_type in ("survival", "cox_regression"):
        risk = predictions.squeeze()
        return {"c_index": concordance_index(
            labels["duration"], risk, labels["event"])}

    if task_type == "multilabel_classification":
        labels = np.asarray(labels)
        preds = (predictions > 0).astype(int)
        precision, recall, f1 = _micro_prf(labels.astype(int), preds)
        return _with_combined(
            {"f1": f1, "precision": precision, "recall": recall})

    if task_type == "classification":
        labels = np.asarray(labels)
        preds = predictions.argmax(axis=1)
        result = {"accuracy": float((preds == labels).mean())}
        if predictions.ndim > 1 and predictions.shape[1] == 2:
            # rank by the logit MARGIN z1 - z0 (the softmax-probability
            # ordering); the raw z1 column is a different, wrong ordering
            # — and for >2 classes binary AUC is meaningless, so skip it
            result["roc_auc"] = roc_auc_binary(
                predictions[:, 1] - predictions[:, 0], labels)
        elif predictions.ndim == 1:
            result["roc_auc"] = roc_auc_binary(predictions, labels)
        return _with_combined(result)

    # regression
    labels = np.asarray(labels)
    preds = predictions.squeeze()
    return _with_combined(
        {"mse": float(np.mean((preds - labels.squeeze()) ** 2))})
