"""Transformer building blocks.

Counterpart of `smb_vision_tpu/models/layers.py`. Parameters are float32
and named after the JAX package's parameter tree (`attention.query`,
`norm1`, `mlp.fc1`, ...), in PyTorch's layouts: Linear weights (out, in),
LayerNorm `weight`/`bias`. Compute runs in the configured dtype, with
LayerNorm statistics in float32. Attention, the attention glue and the MLP
half-block route to the hand-written kernels through `ops.attention`,
`ops.attn_glue` and `ops.mlp`, whose
autograd Functions carry the kernels' backward; with quant8 (inference
only) the projections run on W8A8 (`QuantLinear`, `ops.quant`); an
Encoder with remat checkpoints each block, as `nn.remat(Block)` does.
Attention takes an
optional 3D rotary table (V-JEPA2), and DropPath draws its per-sample keep
masks outside the checkpointed blocks, so the recompute sees the same ones.

Sequence parallelism (`sequence_parallel`): an Encoder cuts its input and
its RoPE tables into token shards over the mesh's "model" axis, runs its
blocks on the rank's shard, whose self-attention gathers k and v
(`sp_variant` "gather") or rotates them ("ring", `parallel/context.py`),
and gathers the shards back where the stack ends. Pipeline parallelism
(`pipe`): an Encoder holds one stage's layers under their dense names and
streams microbatches through the stages (`parallel/pipeline.py`).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from smb_vision_tpu_torch.ops.attention import attention
from smb_vision_tpu_torch.ops.attn_glue import (
    attn_out_residual,
    qkv_ln_forward,
)
from smb_vision_tpu_torch.ops.mlp import (
    act_fn,
    auto_routes,
    mlp_block_forward,
    mlp_forward,
    swiglu_block_forward,
)
from smb_vision_tpu_torch.ops.quant import (
    WeightCodes,
    refuse_autograd,
    w8a8_linear,
)
from smb_vision_tpu_torch.ops.rope3d import apply_rope3d
from smb_vision_tpu_torch.parallel import context
from smb_vision_tpu_torch.parallel.collectives import (
    Replay,
    axis_group,
    gather_shards,
    gather_tokens,
    global_rows,
    share_rows,
    split_tokens,
    token_split_sizes,
)
from smb_vision_tpu_torch.parallel.pipeline import PipeStages, pipeline_apply

_MLP_IMPLS = ("auto", "pallas", "pallas_bwd", "xla")
SP_VARIANTS = ("gather", "ring")


class TokenShards:
    """A sequence-parallel stack's split of N tokens over the model axis
    of the ambient mesh: `sizes` (`token_split_sizes`), this rank's
    `rank` and first token `lo`, the attention's `variant`, and the
    `Replay` of one checkpointed block call (`with_replay`)."""

    def __init__(self, n: int, variant: str):
        g = axis_group()
        parts, self.rank = (1, 0) if g is None else g[1:]
        self.sizes = token_split_sizes(n, parts)
        self.lo = sum(self.sizes[:self.rank])
        self.variant = variant
        self.replay: Optional[Replay] = None

    def with_replay(self) -> "TokenShards":
        out = copy.copy(self)
        out.replay = Replay()
        return out

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's tokens of a table every rank holds (no gradient)."""
        return t.narrow(dim, self.lo, self.sizes[self.rank])

    def attend(self, q, k, v, impl: str):
        fn = (context.ring_attention if self.variant == "ring"
              else context.context_parallel_attention)
        return fn(q, k, v, impl=impl, token_sizes=self.sizes,
                  replay=self.replay)


def trunc_normal_(t: torch.Tensor, std: float, generator=None):
    """Truncated normal at +-2 std, in place (the JAX package's init)."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def _full(t, sum_grad: bool = False):
    """A parameter stored split over the model axis (a DTensor) as the
    whole plain tensor, gathered at use; the gradient goes back as this
    rank's piece: as it is where every rank of a model group computes the
    same gradient, summed over the group first with sum_grad (each rank's
    covers its own tokens). Any other tensor as it is."""
    if t is None or not hasattr(t, "full_tensor"):
        return t
    return gather_shards(t, sum_grad)


class Linear(nn.Linear):
    """nn.Linear that computes in a given dtype from float32 parameters.
    With `gather_at_use` (tensor parallelism on a kernel route, or in a
    sequence-parallel stack, `parallel/sharding.py`), weight and bias are
    stored split over the model axis and `weight_full` / `bias_full`
    gather them whole, so the kernels see whole weights, as under GSPMD in
    the JAX package; `sum_grad` (set in a sequence-parallel stack, whose
    ranks hold different tokens) sums the gathered weight's gradient over
    the model axis before each rank keeps its piece."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.gather_at_use = False
        self.sum_grad = False

    def weight_full(self):
        return (_full(self.weight, self.sum_grad) if self.gather_at_use
                else self.weight)

    def bias_full(self):
        return (_full(self.bias, self.sum_grad) if self.gather_at_use
                else self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        b = self.bias_full()
        b = None if b is None else b.to(dt)
        return F.linear(x.to(dt), self.weight_full().to(dt), b)


class QuantLinear(Linear):
    """`Linear` on W8A8 (the JAX package's `QuantDense`, `ops/quant.py`):
    x cast to the compute dtype and quantised per row, the weight per
    output channel (its codes kept in `codes` until the weight changes),
    the int8 product dequantised to the compute dtype, then + bias in the
    compute dtype. The parameters and their names are Linear's, so every
    checkpoint loads unchanged. Inference only: under autograd it
    raises."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features, bias, dtype)
        self.codes = WeightCodes()

    def forward(self, x):
        refuse_autograd("QuantLinear", x, self.weight, self.bias)
        return w8a8_linear(x.to(self.compute_dtype),
                           self.codes.get((self.weight_full(),)),
                           self.bias_full())


def _stacked_bias(linears):
    """The biases of `linears` stacked (float32), zeros for a missing one;
    None when none has one."""
    biases = [lin.bias_full() for lin in linears]
    if all(b is None for b in biases):
        return None
    dev = next(b for b in biases if b is not None).device
    return torch.cat([
        torch.zeros(lin.out_features, dtype=torch.float32, device=dev)
        if b is None else b.float() for lin, b in zip(linears, biases)])


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, scale and bias; output in the
    compute dtype."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Attention(nn.Module):
    """Multi-head attention. bias_mode: "qkv" (bias on q, k and v), "qv" (on
    q and v only: the VideoMAE q/v-bias), "none". out_proj=False leaves out
    the output projection (the V-JEPA2 pooler's cross-attention).
    fused_qkv runs the projections as one product on the concatenated
    weights (q, k and v for self-attention; k and v for cross-attention), a
    plain `F.linear`, as the JAX package leaves it to XLA; the parameters
    stay three Linears. quant8 makes the four projections `QuantLinear`s
    (W8A8, inference only; fused_qkv is then ignored, as in the JAX
    package); a self-attention's q, k and v share one quantisation of x and
    one product on their stacked codes, which is bit for bit the three
    apart (a row's scale depends only on x, a channel's only on its own
    weight row; a missing bias adds zeros)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 bias_mode: str = "qkv", out_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", out_proj: bool = True,
                 fused_qkv: bool = False, quant8: bool = False):
        super().__init__()
        if bias_mode not in ("qkv", "qv", "none"):
            raise ValueError(f"unknown bias_mode {bias_mode!r}")
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} does not split into "
                             f"{num_heads} heads")
        h = hidden_size
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.fused_qkv = fused_qkv
        self.quant8 = quant8
        self.dtype = dtype
        lin = QuantLinear if quant8 else Linear
        self.query = lin(h, h, bias_mode != "none", dtype)
        self.key = lin(h, h, bias_mode == "qkv", dtype)
        self.value = lin(h, h, bias_mode != "none", dtype)
        self.proj = lin(h, h, out_bias, dtype) if out_proj else None
        self.qkv_codes = WeightCodes() if quant8 else None

    def _fused(self, inp, linears):
        """One product of inp with the stacked weights of `linears`; biases
        stacked with zeros for a missing one, added only if any is there."""
        dt = self.dtype
        w = torch.cat([lin.weight_full() for lin in linears]).to(dt)
        b = _stacked_bias(linears)
        return F.linear(inp.to(dt), w, None if b is None else b.to(dt))

    def _quant_qkv(self, x):
        """q, k, v of a quant8 self-attention: one row quantisation of x
        and one W8A8 product on the stacked codes of the three weights."""
        lins = (self.query, self.key, self.value)
        refuse_autograd("quant8 attention", x,
                        *(p for lin in lins for p in lin.parameters()))
        codes = self.qkv_codes.get([lin.weight_full() for lin in lins])
        return w8a8_linear(x.to(self.dtype), codes, _stacked_bias(lins)) \
            .split(x.shape[-1], dim=-1)

    def forward(self, x, rope: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                kv: Optional[torch.Tensor] = None,
                sp: Optional[TokenShards] = None):
        """rope: optional (cos, sin) tables, (N, D) or (B, N, D), applied to
        q and k (`ops.rope3d.apply_rope3d`); kv: keys and values come from
        these tokens instead of x (cross-attention, never sequence
        parallel); sp: x is this rank's token shard of a
        sequence-parallel stack."""
        b, n, h = x.shape
        src = x if kv is None else kv
        d = h // self.num_heads
        if self.quant8 and kv is None:
            q, k, v = self._quant_qkv(x)
        elif self.quant8:
            q, k, v = self.query(x), self.key(src), self.value(src)
        elif self.fused_qkv and kv is None:
            q, k, v = self._fused(x, (self.query, self.key, self.value)) \
                .split(h, dim=-1)
        elif self.fused_qkv:
            q = self._fused(x, (self.query,))
            k, v = self._fused(src, (self.key, self.value)).split(h, dim=-1)
        else:
            q, k, v = self.query(x), self.key(src), self.value(src)
        # the heads this rank holds: all of them, or a share under the
        # Megatron split of tensor parallelism (q, k, v split by columns)
        heads = q.shape[-1] // d
        q = q.reshape(b, n, heads, d)
        k = k.reshape(b, src.shape[1], heads, d)
        v = v.reshape(b, src.shape[1], heads, d)
        out = self._attend(q, k, v, rope, None if kv is not None else sp)
        out = out.reshape(b, n, heads * d)
        return out if self.proj is None else self.proj(out)

    def _attend(self, q, k, v, rope, sp: Optional[TokenShards] = None):
        if rope is not None:
            q = apply_rope3d(q, *rope)
            k = apply_rope3d(k, *rope)
        if sp is not None:
            return sp.attend(q, k, v, self.attn_impl)
        return attention(q, k, v, impl=self.attn_impl)

    def glue_forward(self, x, lnw, lnb, eps: float, lam=None, rope=None,
                     sp: Optional[TokenShards] = None):
        """The whole attention half-block through the glue kernels
        (`smb_vision_tpu/models/layers.py` `Attention` with `glue`):
        q, k, v = `qkv_ln_forward`(LN(x)) -> RoPE -> attention ->
        `attn_out_residual`(x + out Wo + bo, LayerScale lam folded in), the
        residual in the compute dtype. Reads the Linears' weights raw."""
        b, n, h = x.shape
        dt = self.dtype
        xd = x.to(dt)
        lins = (self.query, self.key, self.value)
        q, k, v = qkv_ln_forward(
            xd, lnw, lnb, *(t for lin in lins
                            for t in (lin.weight_full().to(dt).t(),
                                      lin.bias_full())),
            eps=eps, impl="pallas")
        heads = (b, n, self.num_heads, h // self.num_heads)
        out = self._attend(q.reshape(heads), k.reshape(heads),
                           v.reshape(heads), rope, sp).reshape(b, n, h)
        bo = self.proj.bias_full()
        if bo is None:
            bo = torch.zeros(h, dtype=torch.float32, device=x.device)
        return attn_out_residual(xd, out,
                                 self.proj.weight_full().to(dt).t(), bo,
                                 layerscale=lam, impl="pallas")


class Mlp(nn.Module):
    """fc1 -> act -> fc2. gelu-family MLPs route through `mlp_forward`
    (kernel K6) for "pallas"/"pallas_bwd", and for "auto" in bf16. quant8
    takes the unfused route whatever mlp_impl says, with fc1 and fc2
    `QuantLinear`s (W8A8), as the JAX package does."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 act: str = "gelu", dtype: torch.dtype = torch.bfloat16,
                 mlp_impl: str = "auto", quant8: bool = False):
        super().__init__()
        if mlp_impl not in _MLP_IMPLS:
            raise ValueError(f"unknown mlp impl {mlp_impl!r}; valid: "
                             + ", ".join(map(repr, _MLP_IMPLS)))
        self.act = act
        self.dtype = dtype
        self.mlp_impl = mlp_impl
        self.quant8 = quant8
        lin = QuantLinear if quant8 else Linear
        self.fc1 = lin(hidden_size, intermediate_size, True, dtype)
        self.fc2 = lin(intermediate_size, hidden_size, True, dtype)

    def forward(self, x):
        route = not self.quant8 and (
            self.mlp_impl in ("pallas", "pallas_bwd")
            or (self.mlp_impl == "auto" and self.dtype == torch.bfloat16))
        if route and self.act in ("gelu", "gelu_new"):
            dt = self.dtype
            return mlp_forward(x.to(dt), self.fc1.weight_full().to(dt).t(),
                               self.fc1.bias_full(),
                               self.fc2.weight_full().to(dt).t(),
                               self.fc2.bias_full(), act=self.act,
                               impl=self.mlp_impl)
        return self.fc2(act_fn(self.act)(self.fc1(x)))


class SwiGLU(nn.Module):
    """SwiGLU FFN (the DINOv2 use_swiglu_ffn path): weights_in (hidden ->
    2 x intermediate), silu of the first half times the second half,
    weights_out (intermediate -> hidden), in the compute dtype."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weights_in = Linear(hidden_size, 2 * intermediate_size, True,
                                 dtype)
        self.weights_out = Linear(intermediate_size, hidden_size, True,
                                  dtype)

    def forward(self, x):
        h1, h2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(h1) * h2)


class DropPath(nn.Module):
    """Stochastic depth per sample (`smb_vision_tpu/models/layers.py`
    `DropPath`): in training at a non-zero rate, x / keep * mask with mask
    = floor(keep + U[0, 1)) per sample, keep = 1 - rate; the identity at
    eval and at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    @property
    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def draw(self, batch: int, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        """A (batch,) 0/1 keep mask from generator (the default generator
        of `device` when None), on `device`."""
        dev = generator.device if generator is not None else device
        # drawn for the global batch, this rank's rows kept (the identity
        # on one device)
        u = share_rows(torch.rand((global_rows(batch),),
                                  generator=generator, device=dev))
        return torch.floor((1.0 - self.rate) + u).to(device)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if not self.active:
            return x
        if mask is None:
            mask = self.draw(x.shape[0], device=x.device)
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return x / (1.0 - self.rate) * mask.reshape(shape).to(x.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x += attn(LN(x)); x += mlp(LN(x)).

    With glue_impl "pallas" (and neither fused_qkv nor an active DropPath)
    the attention half-block runs through `Attention.glue_forward`: kernels
    K10a and K10b around the attention core, LayerScale folded into the
    output projection. fused_qkv runs the three projections as one
    product.
    The MLP half-block goes through `mlp_block_forward` (kernel K2) when
    mlp_impl is "pallas", or "auto" with bf16 compute; LayerScale folds
    into w2/b2. "pallas_bwd" skips that fusion, as in the JAX package, and
    routes LN + Mlp separately (kernels K5a + K5b under autograd, K6
    otherwise). With use_swiglu the FFN is `SwiGLU`, and only mlp_impl
    "pallas" fuses the half-block, through `swiglu_block_forward` (kernel
    K9), as in the JAX package. quant8 (inference only) runs the
    attention's and the MLP's projections on W8A8 (`QuantLinear`) and
    fuses neither half-block, as in the JAX package; a SwiGLU FFN stays
    unquantised there."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, act: str = "gelu",
                 bias_mode: str = "qkv", layer_norm_eps: float = 1e-6,
                 layerscale_value: Optional[float] = None,
                 drop_path_rate: float = 0.0, use_swiglu: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", mlp_impl: str = "auto",
                 fused_qkv: bool = False, glue_impl: str = "auto",
                 quant8: bool = False):
        super().__init__()
        if glue_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown glue impl {glue_impl!r}; "
                             "valid: 'auto', 'pallas', 'xla'")
        if mlp_impl not in _MLP_IMPLS:
            raise ValueError(f"unknown mlp impl {mlp_impl!r}; valid: "
                             + ", ".join(map(repr, _MLP_IMPLS)))
        self.act = act
        self.dtype = dtype
        self.mlp_impl = mlp_impl
        self.glue_impl = glue_impl
        self.fused_qkv = fused_qkv
        self.use_swiglu = use_swiglu
        self.quant8 = quant8
        self.eps = layer_norm_eps
        self.norm1 = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.attention = Attention(hidden_size, num_heads, bias_mode,
                                   dtype=dtype, attn_impl=attn_impl,
                                   fused_qkv=fused_qkv, quant8=quant8)
        self.norm2 = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.mlp = (SwiGLU(hidden_size, intermediate_size, dtype)
                    if use_swiglu else
                    Mlp(hidden_size, intermediate_size, act=act, dtype=dtype,
                        mlp_impl=mlp_impl, quant8=quant8))
        if layerscale_value is not None:
            self.layerscale1 = nn.Parameter(
                torch.full((hidden_size,), float(layerscale_value)))
            self.layerscale2 = nn.Parameter(
                torch.full((hidden_size,), float(layerscale_value)))
        else:
            self.layerscale1 = self.layerscale2 = None
        self.drop_path = DropPath(drop_path_rate)

    def _scaled(self, lam, h):
        return h if lam is None else h * lam.to(h.dtype)

    def forward(self, x, rope=None, dp_masks=None,
                sp: Optional[TokenShards] = None):
        """rope: optional (cos, sin) tables for the attention; dp_masks:
        the two DropPath keep masks (attention half, MLP half), drawn here
        when DropPath is active and none are given; sp: x is this rank's
        token shard of a sequence-parallel stack (its self-attention
        spans every shard)."""
        if self.drop_path.active and dp_masks is None:
            dp_masks = [self.drop_path.draw(x.shape[0], device=x.device)
                        for _ in range(2)]
        m1, m2 = dp_masks if dp_masks is not None else (None, None)
        # an active DropPath, or quant8, fuses neither half-block
        fusable = not self.drop_path.active and not self.quant8
        # the attention half-block through the glue kernels K10a/K10b on an
        # explicit glue_impl "pallas" only, as in the JAX package (whose
        # "auto" keeps the plain path); LayerScale folds into Wo and bo
        if self.glue_impl == "pallas" and not self.fused_qkv and fusable:
            x = self.attention.glue_forward(
                x, self.norm1.weight, self.norm1.bias, self.eps,
                lam=self.layerscale1, rope=rope, sp=sp)
        else:
            h = self.attention(self.norm1(x), rope=rope, sp=sp)
            x = x + self.drop_path(self._scaled(self.layerscale1, h), m1)

        if self.use_swiglu:
            if self.mlp_impl == "pallas" and fusable:
                return self._swiglu_fused(x)
            h = self.mlp(self.norm2(x))
            return x + self.drop_path(self._scaled(self.layerscale2, h), m2)
        route = (self.mlp_impl == "pallas"
                 or (self.mlp_impl == "auto" and auto_routes(
                     x.shape[-1], self.mlp.fc1.out_features, self.act,
                     self.dtype)))
        if route and fusable and self.act in ("gelu", "gelu_new"):
            dt = self.dtype
            w1 = self.mlp.fc1.weight_full().to(dt).t()
            w2 = self.mlp.fc2.weight_full().t()
            b2 = self.mlp.fc2.bias_full()
            if self.layerscale2 is not None:
                w2 = w2 * self.layerscale2[None, :]
                b2 = b2 * self.layerscale2
            return mlp_block_forward(
                x.to(dt), self.norm2.weight, self.norm2.bias, w1,
                self.mlp.fc1.bias_full(), w2.to(dt), b2, act=self.act,
                eps=self.eps, impl=self.mlp_impl)
        h = self.mlp(self.norm2(x))
        return x + self.drop_path(self._scaled(self.layerscale2, h), m2)

    def _swiglu_fused(self, x):
        """The SwiGLU half-block through K9, LayerScale folded into w_out
        and b_out."""
        dt = self.dtype
        # scaled in the Linear layout (K, F), so the kernel's read of it
        # copies nothing
        w_out = self.mlp.weights_out.weight_full()
        b_out = self.mlp.weights_out.bias_full()
        if self.layerscale2 is not None:
            w_out = w_out * self.layerscale2[:, None]
            b_out = b_out * self.layerscale2
        return swiglu_block_forward(
            x.to(dt), self.norm2.weight, self.norm2.bias,
            self.mlp.weights_in.weight_full().to(dt).t(),
            self.mlp.weights_in.bias_full(),
            w_out.to(dt).t(), b_out, eps=self.eps, impl="pallas")


class Encoder(nn.Module):
    """Stack of Blocks, `layer_{i}`; drop-path rate rises linearly to
    drop_path_rate over the depth. remat (gradient checkpointing) keeps
    only each block's input for the backward and runs the block again
    there (`torch.utils.checkpoint`, non-reentrant), as `nn.remat(Block)`
    does in the JAX package; it applies only while autograd records.
    `torch.utils.checkpoint` restores the default generators' state but not
    an explicit `torch.Generator`'s, so every DropPath keep mask is drawn
    here, before the checkpointed calls, and passed in.

    sequence_parallel: the blocks run on this rank's token shard of the
    ambient mesh's model axis (`TokenShards`): the input and the RoPE
    tables are cut on entry (the cut's backward all-gathers the shards'
    cotangents) and the shards gathered back on exit (its backward keeps
    this rank's slice), so the code before and after the stack is that of
    one device; inside a checkpointed block the attention's collectives
    are replayed in the recompute, never run again. Each rank's gradient
    of a block parameter is then the sum over its tokens only: the
    optimizer sums it over the model axis (`parallel/sharding.py`).

    pipe: this Encoder holds the layers of one pipeline stage
    (`PipeStages.layers`), under their dense names, and its forward is
    `pipeline_apply` over them; the DropPath masks of all num_layers
    layers are drawn for the whole batch in layer order, as the dense
    stack draws them, and each stage keeps its layers' rows of a
    microbatch."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 intermediate_size: int, act: str = "gelu",
                 bias_mode: str = "qkv", layer_norm_eps: float = 1e-6,
                 layerscale_value: Optional[float] = None,
                 drop_path_rate: float = 0.0, use_swiglu: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", mlp_impl: str = "auto",
                 remat: bool = False, fused_qkv: bool = False,
                 glue_impl: str = "auto", quant8: bool = False,
                 sequence_parallel: bool = False, sp_variant: str = "gather",
                 pipe: Optional[PipeStages] = None):
        super().__init__()
        if sp_variant not in SP_VARIANTS:
            raise ValueError(f"sp_variant {sp_variant!r}: expected one of "
                             + ", ".join(SP_VARIANTS))
        if sequence_parallel and pipe is not None:
            raise ValueError("a pipelined stack composes with the data "
                             "axis, not sequence parallelism; unset "
                             "sequence_parallel")
        self.num_layers = num_layers
        self.remat = remat
        self.drop_path_rate = drop_path_rate
        self.sequence_parallel = sequence_parallel
        self.sp_variant = sp_variant
        self.pipe = pipe
        self.microbatches = 1 if pipe is None else pipe.microbatches
        self.layer_ids = (range(num_layers) if pipe is None
                          else pipe.layers(num_layers))
        for i in self.layer_ids:
            block = Block(
                hidden_size, num_heads, intermediate_size, act=act,
                bias_mode=bias_mode, layer_norm_eps=layer_norm_eps,
                layerscale_value=layerscale_value, drop_path_rate=self.rate(i),
                use_swiglu=use_swiglu, dtype=dtype, attn_impl=attn_impl,
                mlp_impl=mlp_impl, fused_qkv=fused_qkv, glue_impl=glue_impl,
                quant8=quant8)
            block.index = i
            self.add_module(f"layer_{i}", block)

    def rate(self, i: int) -> float:
        """Layer i's DropPath rate."""
        return self.drop_path_rate * i / max(self.num_layers - 1, 1)

    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in self.layer_ids]

    def draw_masks(self, batch: int, generator, device) -> dict:
        """{layer index: its two DropPath keep masks} for the layers this
        Encoder holds, drawn in training for all num_layers layers in
        order (two a layer whose DropPath is active), as the dense stack
        draws them."""
        masks = {}
        if not self.training:
            return masks
        for i in range(self.num_layers):
            if self.rate(i) > 0.0:
                drawn = [DropPath(self.rate(i)).draw(batch, generator,
                                                     device)
                         for _ in range(2)]
                if i in self.layer_ids:
                    masks[i] = drawn
        return masks

    def forward(self, x, rope=None,
                generator: Optional[torch.Generator] = None):
        """rope: optional (cos, sin) tables shared by every layer;
        generator: draws the DropPath keep masks (two a layer, in layer
        order; the default generator of x's device when None)."""
        if self.pipe is not None:
            return self.pipelined(x, rope=rope, generator=generator)
        sp = None
        if self.sequence_parallel:
            sp = TokenShards(x.shape[1], self.sp_variant)
            x = split_tokens(x, sp.sizes)
            if rope is not None:
                rope = tuple(sp.cut(t, t.dim() - 2) for t in rope)
        remat = self.remat and torch.is_grad_enabled()
        masks = self.draw_masks(x.shape[0], generator, x.device)
        for i in self.layer_ids:
            block = getattr(self, f"layer_{i}")
            if remat:
                bsp = sp.with_replay() if sp is not None else None
                x = torch.utils.checkpoint.checkpoint(
                    block, x, rope, masks.get(i), bsp, use_reentrant=False)
                if bsp is not None:
                    bsp.replay.rewind()
            else:
                x = block(x, rope, masks.get(i), sp)
        if sp is not None:
            x = gather_tokens(x, sp.sizes)
        return x

    def pipelined(self, x, *, rope=None, generator=None,
                  num_microbatches: Optional[int] = None,
                  remat: Optional[bool] = None):
        """This stage's layers over x through `pipeline_apply` on the
        ambient mesh's model axis (whose size must be pipe.stages)."""
        pipe = self.pipe or PipeStages(1, 0)
        n_stages = 1 if axis_group() is None else axis_group()[1]
        if n_stages != pipe.stages:
            raise ValueError(f"an Encoder built for {pipe.stages} pipe "
                             f"stages on a model axis of {n_stages}")
        m = num_microbatches or self.microbatches
        masks = self.draw_masks(x.shape[0], generator, x.device)
        rows = x.shape[0] // m if x.shape[0] % m == 0 else 0

        def rows_of(t, mb):
            mb = min(max(mb, 0), m - 1)
            return t[mb * rows:(mb + 1) * rows]

        def layer_fn(block, h, rp, mb):
            mk = masks.get(block.index)
            if mk is not None:
                mk = [rows_of(t, mb) for t in mk]
            if rp is not None and rp[0].dim() == 3:
                rp = tuple(rows_of(t, mb) for t in rp)
            return block(h, rp, mk)

        return pipeline_apply(
            layer_fn, self.blocks(), x, num_microbatches=m,
            remat=self.remat if remat is None else remat, extra=rope,
            with_mb_index=True)
