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

Sharded parameters (`parallel/sharding.py`; DTensors). The blocks are
always those of the whole flattened parameter, so the moments are the
single-process moments, and their block axis is split over the mesh axes
the parameter is split over, where the block count divides, as the JAX
package's `quantized_spec` places them; otherwise every rank keeps them
whole. Three layouts:
- "local": the local piece is a contiguous run of whole blocks (a dim-0
  split into multiples of 256 elements: FSDP2's, a column split under
  tensor parallelism); the rank's blocks are its piece's, and a step
  needs no communication;
- "rows": the block count divides over the pieces but a piece is not its
  blocks (a row split, a 2-D split, a piece of a partial block); the rank
  gathers the gradient and the parameter, updates its rows of blocks and
  gathers the update;
- "full": the block count does not divide; every rank updates all the
  blocks from the gathered gradient and keeps its piece of the update.
`state_dict` gives the "local" and "rows" moments as DTensors split on
the block axis, of the single-process shape, so a checkpoint's gathered
state is the single-process state byte for byte and resumes at any world
size.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from smb_vision_tpu_torch.parallel.sharding import is_split
from smb_vision_tpu_torch.parallel.sharding import local as _local

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
        rows = [_layout(p)[1] for p in params]
        states = [self.state.get(p) for p in params]
        counts = {int(s["step"]) if s else 0 for s in states}
        if len(counts) > 1:
            raise ValueError(f"AdamW8bit: a group's parameters with a "
                             f"gradient update together, but their counts "
                             f"differ ({sorted(counts)}): a parameter had "
                             f"no gradient at some update")
        dev = _local(params[0]).device

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
                    **{k: _local(st[k]).to(_local(p).device, KEYS[k][0])
                       for k in KEYS}}
        self._packs = {}

    def state_dict(self):
        """torch.optim.Optimizer's; the "local" and "rows" blocks as
        DTensors split on the block axis, of the single-process shape."""
        out = super().state_dict()
        params = [p for g in self.param_groups for p in g["params"]]
        for i, st in out["state"].items():
            p = params[i]
            mode, _, nb = _layout(p)
            if mode not in ("local", "rows"):
                continue
            from torch.distributed.tensor import DTensor

            out["state"][i] = {**st, **{
                k: DTensor.from_local(
                    st[k], p.device_mesh, _block_placements(p),
                    run_check=False, shape=(nb, st[k].shape[1]),
                    stride=st[k].stride())
                for k in KEYS}}
        return out

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
                g = _rows([_work(p.grad, p) for p in ps], rows)
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
                    upd = upd + wd * _rows([_work(p, p) for p in ps], rows)
                upd = upd * -lr
                cast, views, off = {}, [], 0
                for p, nb in zip(ps, rows):
                    if p.dtype not in cast:
                        cast[p.dtype] = upd.to(p.dtype)
                    views.append(_own_update(cast[p.dtype][off:off + nb], p))
                    off += nb
                torch._foreach_add_([_local(p) for p in ps], views)


def _split_dims(p):
    """The mesh dims a DTensor is split over."""
    return [i for i, pl in enumerate(getattr(p, "placements", ()))
            if is_split(pl)]


def _pieces(p) -> int:
    """The number of distinct pieces a DTensor is split into."""
    return math.prod(p.device_mesh.size(i) for i in _split_dims(p))


def _layout(p):
    """(mode, this rank's block rows, the parameter's block count): mode
    "plain" (not a DTensor), "local", "rows" or "full" (module
    docstring)."""
    nb = -(-p.numel() // BLOCK)
    if not hasattr(p, "placements"):
        return "plain", nb, nb
    n = _pieces(p)
    if n == 1:
        return "local", nb, nb
    dims = _split_dims(p)
    pl = p.placements[dims[0]]
    if (len(dims) == 1 and type(pl).__name__ == "Shard" and pl.dim == 0
            and p.shape[0] % n == 0 and _local(p).numel() % BLOCK == 0):
        return "local", nb // n, nb
    if nb % n == 0:
        return "rows", nb // n, nb
    return "full", nb, nb


def _block_index(p) -> int:
    """This rank's index among the pieces of p, the first split mesh dim
    major (the order of DTensor's Shard(0) over those dims)."""
    coord = p.device_mesh.get_coordinate()
    r = 0
    for i in _split_dims(p):
        r = r * p.device_mesh.size(i) + coord[i]
    return r


def _block_placements(p):
    from torch.distributed.tensor import Replicate, Shard

    dims = set(_split_dims(p))
    return [Shard(0) if i in dims else Replicate()
            for i in range(p.device_mesh.ndim)]


def _work(t: torch.Tensor, p) -> torch.Tensor:
    """The tensor (gradient or parameter) this rank forms its blocks
    over, flattened: its local piece ("plain", "local"), its rows of the
    whole tensor's blocks ("rows"), or the whole tensor ("full")."""
    mode, rows, nb = _layout(p)
    if mode in ("plain", "local"):
        return _local(t).reshape(-1)
    flat = t.full_tensor().reshape(-1)
    if mode == "full":
        return flat
    flat = torch.nn.functional.pad(flat, (0, nb * BLOCK - flat.numel()))
    r = _block_index(p)
    return flat[r * rows * BLOCK:(r + 1) * rows * BLOCK]


def _own_update(upd_rows: torch.Tensor, p) -> torch.Tensor:
    """This rank's piece of the update of p, from its update rows (rows,
    BLOCK): the rows themselves ("plain", "local"), else the whole update
    (gathered over the pieces in "rows" mode) cut to its piece."""
    mode, rows, nb = _layout(p)
    if mode in ("plain", "local"):
        local = _local(p)
        return upd_rows.reshape(-1)[:local.numel()].view(local.shape)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = p.device_mesh
    if mode == "rows":
        upd_rows = DTensor.from_local(
            upd_rows, mesh, _block_placements(p), run_check=False,
            shape=(nb, BLOCK), stride=upd_rows.stride()).full_tensor()
    full = upd_rows.reshape(-1)[:p.numel()].view(p.shape)
    return DTensor.from_local(
        full, mesh, [Replicate()] * mesh.ndim, run_check=False
    ).redistribute(mesh, p.placements).to_local()
