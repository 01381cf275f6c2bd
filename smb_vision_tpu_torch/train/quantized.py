"""AdamW with 8-bit moment state.

Counterpart of `smb_vision_tpu/train/quantized.py` (`scale_by_adam8bit`
inside `adamw8bit`). Each parameter's two Adam moments are stored as int8
codes over 256-element blocks of the flattened, zero-padded parameter,
(nb, 256), with one float32 scale a block, (nb, 1), the JAX package's
layout:

- the first moment mu on the signed cubic map, code = round(127 *
  cbrt(mu / blockmax)), rounded half to even;
- the second moment nu stored as sqrt(nu), on the same map;
- a block whose max is 0 keeps scale 0 and divides by 1.

Every step dequantises both moments, updates them in float32, quantises
them again and applies `-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`
(the decay on the `is_decayed` parameters only, as `add_decayed_weights`
with the decay mask). The moments take ~0.26 of float32 AdamW's bytes.

PyTorch has no cube root: `sign(x) * |x| ** (1/3)` can sit one ulp from
`jnp.cbrt`, so a code on a rounding tie may differ from the JAX package's
by one step (tests/test_torch_adamw8bit.py counts them).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

BLOCK = 256
# the update runs over a group's moments in chunks of at most this many
# rows (whole parameters; one larger parameter is a chunk alone): 64 MiB a
# float32 temporary, where one pass over all of them would hold several
# copies of every moment at once
CHUNK_ROWS = 1 << 16
# the state of a parameter beside its "step": dtype and row width
KEYS = {"mu": (torch.int8, BLOCK), "mu_scale": (torch.float32, 1),
        "nu": (torch.int8, BLOCK), "nu_scale": (torch.float32, 1)}


def _rows(ts, rows) -> torch.Tensor:
    """The tensors flattened to float32, each zero-padded to its `rows`
    of BLOCK, stacked: (sum(rows), BLOCK)."""
    parts = []
    for t, nb in zip(ts, rows):
        flat = t.reshape(-1).float()
        parts.append(flat)
        if nb * BLOCK > flat.numel():
            parts.append(flat.new_zeros(nb * BLOCK - flat.numel()))
    return torch.cat(parts).view(-1, BLOCK)


def _quantize_rows(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = b.abs().amax(dim=1, keepdim=True)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    norm = b / safe
    norm = torch.sign(norm) * norm.abs().pow(1.0 / 3.0)
    codes = torch.clamp(torch.round(norm * 127.0), -127, 127)
    return codes.to(torch.int8), scale


def _dequantize_rows(codes: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    norm = codes.float() / 127.0
    return norm * norm * norm * scales


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 (nb, BLOCK), scales float32 (nb, 1)) of x on the signed
    cubic map (the JAX `_quantize` with mapping "cubic")."""
    return _quantize_rows(_rows([x], [-(-x.numel() // BLOCK)]))


def dequantize(codes: torch.Tensor, scales: torch.Tensor,
               shape) -> torch.Tensor:
    """Inverse of `quantize`: float32 of `shape`."""
    return _dequantize_rows(codes, scales).reshape(-1)[
        :math.prod(shape)].reshape(shape)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW on int8 blockwise moments. Groups take lr, betas, eps and
    weight_decay as torch.optim.AdamW's do; a parameter without a gradient
    is skipped. Each parameter's state holds "step" (the update count, on
    the host), "mu", "mu_scale", "nu" and "nu_scale" in the JAX layout;
    `state_dict` carries them, so a resume is bitwise.

    A group's parameters with a gradient update together: their moments
    live in one (rows, BLOCK) int8 buffer each, with one (rows, 1) scale
    buffer, and the per-parameter state tensors are views of them. The
    update is plain PyTorch, about thirty launches a chunk of CHUNK_ROWS
    rows whatever the number of parameters in it. The parameters of a
    group that update together share one count: one whose count differs
    from the others' (it had no gradient at some update) raises."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self._packs = {}

    def _pack(self, params) -> dict:
        """The flat buffers of `params`, from their state (zeros where
        they have none), and their per-parameter views as the state."""
        rows = [-(-p.numel() // BLOCK) for p in params]
        states = [self.state.get(p) for p in params]
        counts = {int(s["step"]) if s else 0 for s in states}
        if len(counts) > 1:
            raise ValueError(f"AdamW8bit: a group's parameters with a "
                             f"gradient update together, but their counts "
                             f"differ ({sorted(counts)}): a parameter had "
                             f"no gradient at some update")
        dev = params[0].device

        def flat(key, dtype, width):
            return torch.cat([
                s[key].to(dev, dtype) if s else torch.zeros(
                    (nb, width), dtype=dtype, device=dev)
                for s, nb in zip(states, rows)])

        pack = {k: flat(k, *KEYS[k]) for k in KEYS}
        count = torch.tensor(counts.pop(), dtype=torch.int32)
        chunks, lo, r0, r = [], 0, 0, 0
        for i, (p, nb) in enumerate(zip(params, rows)):
            self.state[p] = {"step": count, **{
                k: pack[k][r:r + nb] for k in KEYS}}
            if r + nb - r0 > CHUNK_ROWS and r > r0:
                chunks.append((lo, i, r0, r))
                lo, r0 = i, r
            r += nb
        chunks.append((lo, len(params), r0, r))
        pack.update(ids=[id(p) for p in params], rows=rows, chunks=chunks,
                    count=count)
        return pack

    def load_state_dict(self, state_dict) -> None:
        """torch.optim.Optimizer's, but the codes stay int8 and the scales
        float32 (the base class casts every state tensor to its
        parameter's dtype) and the count stays on the host."""
        saved = state_dict["state"]
        super().load_state_dict({**state_dict, "state": {}})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for p, i in zip(params, ids):
            if i in saved:
                st = saved[i]
                self.state[p] = {
                    "step": torch.tensor(int(st["step"]), dtype=torch.int32),
                    **{k: st[k].to(p.device, KEYS[k][0]) for k in KEYS}}
        self._packs = {}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit.step takes no closure")
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            pack = self._packs.get(gi)
            if pack is None or pack["ids"] != [id(p) for p in params]:
                pack = self._packs[gi] = self._pack(params)
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            pack["count"] += 1
            # the bias corrections in float32 on the host (the count
            # lives there), as the JAX update computes them
            count = np.float32(int(pack["count"]))
            bc1 = float(np.float32(1) - np.float32(b1) ** count)
            bc2 = float(np.float32(1) - np.float32(b2) ** count)
            for lo, hi, r0, r1 in pack["chunks"]:
                ps, rows = params[lo:hi], pack["rows"][lo:hi]
                mu, mu_s, nu, nu_s = (pack[k][r0:r1] for k in KEYS)
                g = _rows([p.grad for p in ps], rows)
                m = _dequantize_rows(mu, mu_s)
                m = b1 * m + (1 - b1) * g
                v = _dequantize_rows(nu, nu_s)
                v = b2 * (v * v) + (1 - b2) * (g * g)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                for codes, scales, x in ((mu, mu_s, m),
                                         (nu, nu_s, torch.sqrt(v))):
                    c, s = _quantize_rows(x)
                    codes.copy_(c)
                    scales.copy_(s)
                if wd:
                    upd = upd + wd * _rows(ps, rows)
                upd = (upd * -lr).reshape(-1)
                cast, views, off = {}, [], 0
                for p, nb in zip(ps, rows):
                    if p.dtype not in cast:
                        cast[p.dtype] = upd.to(p.dtype)
                    views.append(cast[p.dtype][off:off + p.numel()]
                                 .view(p.shape))
                    off += nb * BLOCK
                torch._foreach_add_(ps, views)
