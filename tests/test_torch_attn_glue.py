"""The port's attention glue (the plain versions beside kernels K10a and
K10b), the glue Block, fused_qkv, a VideoMAE encoder on the int8 p v
attention (K8) with the glue, and one MIM step with the glue, against the
JAX package on the CPU. The JAX side runs its Pallas kernels in interpret
mode, as its own tests do. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.layers import Attention as JAttention
from smb_vision_tpu.models.layers import Block as JBlock
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JPre
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.ops import attn_glue as jglue
from smb_vision_tpu.ops import rope3d as jrope
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models import layers as L
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.videomae import (
    VideoMAEForPreTraining,
    VideoMAEModel,
)
from smb_vision_tpu_torch.ops import attn_glue as G
from smb_vision_tpu_torch.ops.masking import num_masked_tokens

torch.set_num_threads(1)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16_values(x):
    """x rounded to bf16, as f32 numpy (the same values on both sides)."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))


def _qkv_args(k, m=256, k_bias=True):
    """x (m, k) on the bf16 grid, LN scale and bias, and (in, out) weights
    and biases of q, k, v; bk None without a k bias (bias_mode "qv")."""
    x = _bf16_values(_rand(1, (m, k)))
    args = [x, 1.0 + _rand(2, (k,), 0.1), _rand(3, (k,), 0.1)]
    for i in range(3):
        args += [_rand(10 + i, (k, k), k ** -0.5), _rand(20 + i, (k,), 0.1)]
    if not k_bias:
        args[6] = None
    return args


@pytest.mark.parametrize("k,k_bias", [(128, True), (128, False),
                                      (256, True), (256, False)])
def test_qkv_ln_matches_jax_kernel(k, k_bias):
    """K10a's plain version (the kernel's numerics) against the JAX kernel
    in interpret mode at M 256, bf16: q, k, v within 1e-2 of max; the
    gradients of every input through the recompute backward against
    jax.grad through the JAX custom VJP, within 2e-2 of max."""
    args = _qkv_args(k, k_bias=k_bias)
    live = [i for i, a in enumerate(args) if a is not None]
    gs = [_rand(30 + i, (256, k)) for i in range(3)]

    def jcall(*a):
        full = list(args)
        for i, v in zip(live, a):
            full[i] = v
        full[0] = full[0].astype(jnp.bfloat16)
        return jglue.qkv_ln_forward(*full, eps=1e-6, impl="pallas")

    def jloss(*a):
        return sum(jnp.sum(o.astype(jnp.float32) * g)
                   for o, g in zip(jcall(*a), gs))

    jargs = [jnp.asarray(args[i]) for i in live]
    want = jcall(*jargs)
    want_g = jax.grad(jloss, argnums=tuple(range(len(live))))(*jargs)

    leaves = [None if a is None else torch.tensor(a, requires_grad=True)
              for a in args]
    leaves[0] = torch.tensor(args[0]).to(torch.bfloat16).requires_grad_()
    before = G.qkv_ln_fused.launches
    got = G.qkv_ln_forward(*leaves, eps=1e-6, impl="pallas")
    assert G.qkv_ln_fused.launches == before           # CPU: no launch
    for o, w in zip(got, want):
        assert o.dtype == torch.bfloat16 and o.shape == (256, k)
        assert _rel(o.detach().float(), w.astype(jnp.float32)) <= 1e-2
    sum((o.float() * torch.from_numpy(g)).sum()
        for o, g in zip(got, gs)).backward()
    for i, w in zip(live, want_g):
        grad = leaves[i].grad
        assert grad is not None and grad.shape == w.shape, i
        assert _rel(grad.float(), w.astype(jnp.float32)) <= 2e-2, i


@pytest.mark.parametrize("k,layerscale", [(128, False), (128, True),
                                          (256, False), (256, True)])
def test_attn_out_residual_matches_jax_kernel(k, layerscale):
    """K10b's plain version against the JAX kernel (interpret) at M 256,
    bf16, with and without LayerScale folded into wo and bo: the output
    within 1e-2 of max, the gradients within 2e-2 of max."""
    res = _bf16_values(_rand(40, (256, k)))
    y = _bf16_values(_rand(41, (256, k)))
    args = [res, y, _rand(42, (k, k), k ** -0.5), _rand(43, (k,), 0.1)]
    lam = 0.5 + _rand(44, (k,), 0.1) if layerscale else None
    g = _rand(45, (256, k))

    def jcall(res, y, wo, bo, *ls):
        return jglue.attn_out_residual(
            res.astype(jnp.bfloat16), y.astype(jnp.bfloat16), wo, bo,
            layerscale=ls[0] if ls else None, impl="pallas")

    jargs = [jnp.asarray(a) for a in args] + (
        [jnp.asarray(lam)] if layerscale else [])
    want = jcall(*jargs)
    want_g = jax.grad(lambda *a: jnp.sum(jcall(*a).astype(jnp.float32) * g),
                      argnums=tuple(range(len(jargs))))(*jargs)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    leaves[:2] = [torch.tensor(a).to(torch.bfloat16).requires_grad_()
                  for a in args[:2]]
    ls = torch.tensor(lam, requires_grad=True) if layerscale else None
    got = G.attn_out_residual(*leaves, layerscale=ls, impl="pallas")
    assert got.dtype == torch.bfloat16 and got.shape == (256, k)
    assert _rel(got.detach().float(), want.astype(jnp.float32)) <= 1e-2
    (got.float() * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves + ([ls] if layerscale else []), want_g):
        assert _rel(t.grad.float(), w.astype(jnp.float32)) <= 2e-2


@pytest.mark.parametrize("op", ["qkv", "out"])
def test_glue_f32_rounds_to_bf16_as_jax(op):
    """An f32 caller on "pallas" gets the kernels' bf16 values back, cast
    to f32, on both sides: the JAX wrapper casts x, res and y to bf16
    before its kernel. The port's outputs are f32 on the bf16 grid, as the
    JAX kernel's (interpret) are, and agree with them within 1e-2 of max;
    an f32 path that skipped the rounding would fail the grid check."""
    k = 128
    if op == "qkv":
        args = _qkv_args(k)
        args[0] = _rand(1, (256, k))            # f32, off the bf16 grid
        want = jglue.qkv_ln_forward(*map(jnp.asarray, args), eps=1e-6,
                                    impl="pallas")
        got = G.qkv_ln_forward(*map(torch.tensor, args), eps=1e-6,
                               impl="pallas")
    else:
        args = [_rand(40, (256, k)), _rand(41, (256, k)),
                _rand(42, (k, k), k ** -0.5), _rand(43, (k,), 0.1)]
        want = (jglue.attn_out_residual(*map(jnp.asarray, args),
                                        impl="pallas"),)
        got = (G.attn_out_residual(*map(torch.tensor, args), impl="pallas"),)
    for o, w in zip(got, want):
        w = np.asarray(w)
        assert o.dtype == torch.float32 and w.dtype == np.float32
        assert np.array_equal(w, _bf16_values(w))
        assert torch.equal(o, o.to(torch.bfloat16).float())
        assert _rel(o, w) <= 1e-2


def test_glue_impls_and_refusal():
    """"auto" and "xla" are the plain composition, as the JAX package
    resolves them off its TPU; "pallas" refuses a feature dim of 96 as the
    JAX wrapper does ("cannot map"), and an unknown impl raises."""
    args = [torch.tensor(a) for a in _qkv_args(128, m=64)]
    want = G._qkv_xla(*args[:3], *args[3::2], *args[4::2], 1e-6)
    for impl in ("auto", "xla"):
        got = G.qkv_ln_forward(*args, eps=1e-6, impl=impl)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    x96 = np.zeros((128, 96), np.float32)
    w96 = np.zeros((96, 96), np.float32)
    b96 = np.zeros((96,), np.float32)
    with pytest.raises(ValueError, match="cannot map"):
        jglue.qkv_ln_forward(x96, b96, b96, w96, b96, w96, b96, w96, b96,
                             impl="pallas")
    with pytest.raises(ValueError, match="cannot map"):
        jglue.attn_out_residual(x96, x96, w96, b96, impl="pallas")
    t96 = [torch.from_numpy(a) for a in (x96, w96, b96)]
    with pytest.raises(ValueError, match="cannot map"):
        G.qkv_ln_forward(t96[0], t96[2], t96[2], *[t96[1], t96[2]] * 3,
                         impl="pallas")
    with pytest.raises(ValueError, match="cannot map"):
        G.attn_out_residual(t96[0], t96[0], t96[1], t96[2], impl="pallas")
    with pytest.raises(ValueError, match="unknown glue impl"):
        G.attn_out_residual(*args[:2], args[3], args[4], impl="fused")
    assert G.glue_maps(1536) and G.glue_maps(768) and G.glue_maps(2816)
    assert not G.glue_maps(96) and not G.glue_maps(0)


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)


def _block_pair(x, rope=None, **kw):
    """A JAX Block (128 wide, 2 heads of 64, MLP 256) with perturbed random
    params, and the port's Block holding the same weights."""
    jparams = _perturbed(jax.jit(JBlock(128, 2, 256, dtype=jnp.float32,
                                        attn_impl="xla", mlp_impl="xla",
                                        **kw).init)(
        jax.random.PRNGKey(0), x, rope))
    state = convert.params_from_flax(
        {"params.encoder.layer_0." + k[len("params."):]: v
         for k, v in flatten_params(jparams).items()})
    block = L.Block(128, 2, 256, dtype=torch.float32, attn_impl="xla",
                    mlp_impl="xla", **kw)
    block.load_state_dict({k[len("encoder.layer_0."):]: v
                           for k, v in state.items()})
    return jparams, block


def _block_grads_match(jblock, jparams, block, x, rope, tol):
    """The JAX and the port's Block on the same input: forward and every
    parameter's gradient of sum(y * g), within tol of max."""
    g = _rand(51, x.shape)

    def jloss(p):
        return jnp.sum(jblock.apply(p, x, rope) * g)

    want = jblock.apply(jparams, x, rope)
    jgrads = jax.grad(jloss)(jparams)
    want_g = convert.params_from_flax(
        {"params.encoder.layer_0." + k[len("params."):]: v
         for k, v in flatten_params(jgrads).items()})
    trope = None if rope is None else tuple(map(torch.tensor, rope))
    y = block(torch.from_numpy(x), trope)
    assert _rel(y.detach(), want) <= tol
    (y * torch.from_numpy(g)).sum().backward()
    for name, p in block.named_parameters():
        w = want_g["encoder.layer_0." + name].numpy()
        assert p.grad is not None, name
        assert _rel(p.grad, w) <= tol, name


@pytest.mark.parametrize("layerscale", [None, 0.9])
def test_glue_block_matches_jax(layerscale):
    """Block(glue_impl="pallas") against the JAX Block(glue_impl="pallas")
    (its K10a/K10b in interpret mode) on (2, 64, 128): the output and every
    parameter's gradient within 3e-2 of max; its state_dict keys are the
    "auto" Block's (the JAX glue keeps the plain parameter tree)."""
    x = _rand(50, (2, 64, 128))
    kw = dict(layerscale_value=layerscale, bias_mode="qv",
              glue_impl="pallas")
    jparams, block = _block_pair(x, **kw)
    jblock = JBlock(128, 2, 256, dtype=jnp.float32, attn_impl="xla",
                    mlp_impl="xla", **kw)
    _block_grads_match(jblock, jparams, block, x, None, 3e-2)
    plain = L.Block(128, 2, 256, bias_mode="qv",
                    layerscale_value=layerscale)
    assert block.state_dict().keys() == plain.state_dict().keys()


def test_glue_block_with_rope_matches_jax():
    """A V-JEPA-style Block (q/k/v biases, 3D RoPE tables) through the glue
    against the JAX Block, within 3e-2 of max."""
    x = _rand(52, (2, 64, 128))
    ids = np.arange(64)
    rope = tuple(np.asarray(t) for t in jrope.rope3d_cos_sin(
        jnp.asarray(ids), 16, 64))
    kw = dict(bias_mode="qkv", glue_impl="pallas")
    jparams, block = _block_pair(x, rope, **kw)
    jblock = JBlock(128, 2, 256, dtype=jnp.float32, attn_impl="xla",
                    mlp_impl="xla", **kw)
    _block_grads_match(jblock, jparams, block, x, rope, 3e-2)


def test_glue_block_droppath_takes_plain_path(monkeypatch):
    """With DropPath active in training the Block takes the plain attention
    half (the glue cannot fold a per-sample random scale); in eval the same
    Block runs the glue."""
    calls = []
    real = L.qkv_ln_forward

    def spy(*a, **kw):
        calls.append(kw["impl"])
        return real(*a, **kw)

    monkeypatch.setattr(L, "qkv_ln_forward", spy)
    block = L.Block(128, 2, 256, drop_path_rate=0.5, glue_impl="pallas",
                    dtype=torch.float32)
    x = torch.from_numpy(_rand(53, (2, 64, 128)))
    assert block.train()(x).shape == x.shape
    assert calls == []
    block.eval()(x)
    assert calls == ["pallas"]
    fused = L.Block(128, 2, 256, glue_impl="pallas", fused_qkv=True,
                    dtype=torch.float32).eval()
    fused(x)
    assert calls == ["pallas"]        # fused_qkv skips the glue, as in JAX


@pytest.mark.parametrize("cross", [False, True])
def test_fused_qkv_attention_matches_jax(cross):
    """Attention(fused_qkv=True), one product on the concatenated weights,
    against the JAX Attention(fused_qkv=True), self- and cross-attention,
    bias_mode "qv" (a zeros k bias in the stack), float32."""
    x = _rand(60, (2, 16, 64))
    kv = _rand(61, (2, 24, 64)) if cross else None
    jattn = JAttention(64, 4, bias_mode="qv", dtype=jnp.float32,
                       attn_impl="xla", fused_qkv=True)
    params = _perturbed(jax.jit(jattn.init)(jax.random.PRNGKey(0), x, None,
                                            kv))
    want = jattn.apply(params, x, None, kv)
    attn = L.Attention(64, 4, "qv", dtype=torch.float32, attn_impl="xla",
                       fused_qkv=True)
    p = params["params"]
    with torch.no_grad():
        for name in ("query", "key", "value", "proj"):
            lin = getattr(attn, name)
            lin.weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            if lin.bias is not None:
                lin.bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
        got = attn(torch.from_numpy(x),
                   kv=None if kv is None else torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert set(attn.state_dict()) == set(L.Attention(64, 4, "qv")
                                         .state_dict())


def test_videomae_int8pv_and_glue_match_jax():
    """The slice's serving path at small size: a 2-layer, 128-wide bf16
    VideoMAEModel with attn_impl "pallas_int8pv" (K8) and glue_impl
    "pallas" (K10a, K10b; MLP half-block K2 under "auto"), on weights
    converted from the JAX model, against the JAX model running its
    kernels in interpret mode (2 x 64 = 128 rows, so its glue maps):
    within 3e-2 of max."""
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=512, dtype="bfloat16",
              attn_impl="pallas_int8pv", mlp_impl="pallas",
              glue_impl="pallas")
    base = dict(image_size=64, num_frames=64, patch_size=16, tubelet_size=16)
    jcfg = JConfig(**base, **kw)
    px = np.random.default_rng(1).uniform(
        0, 1, (2, 64, 1, 64, 64)).astype(np.float32)
    params = _perturbed(jax.jit(JModel(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), px))
    want, _ = JModel(jcfg).apply(params, px)
    model = VideoMAEModel(VideoMAEConfig(**base, **kw))
    model.load_state_dict(convert.params_from_flax(flatten_params(params)))
    with torch.no_grad():
        got, _ = model.eval()(torch.from_numpy(px))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= 3e-2


def test_mim_step_with_glue_matches_jax():
    """One MIM step (forward and backward) with glue_impl "pallas" on both
    sides, float32 elsewhere, remat on: encoder 2 x 64 visible rows and
    decoder 2 x 128 rows, 128 wide. The loss within 1e-3 relative of the
    JAX model's, every parameter's gradient within 2e-2 of its max."""
    geom = dict(image_size=64, num_frames=128, patch_size=16,
                tubelet_size=16)
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=256, decoder_hidden_size=128,
              decoder_num_hidden_layers=1, decoder_num_attention_heads=2,
              decoder_intermediate_size=256, dtype="float32",
              attn_impl="xla", mlp_impl="xla", glue_impl="pallas",
              gradient_checkpointing=True)
    mask_geo = dict(input_size=64, depth=128, mask_patch_size=32,
                    model_patch_size=16, mask_ratio=0.5)
    jcfg = JConfig(**geom, **kw)
    nm = num_masked_tokens(**mask_geo)
    px = np.random.default_rng(1).uniform(
        0, 1, (2, 128, 1, 64, 64)).astype(np.float32)
    mask = np.asarray(jmim_mask(jax.random.PRNGKey(3), 2, **mask_geo))
    params = _perturbed(jax.jit(JPre(impl_neutral(jcfg)).init,
                                static_argnums=(3,))(
        jax.random.PRNGKey(0), px, mask, nm))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: JPre(jcfg).apply(p, px, mask, nm)["loss"])(params)
    ref_grads = convert.params_from_flax(flatten_params(ref_grads),
                                         pretraining=True)
    model = VideoMAEForPreTraining(VideoMAEConfig(**geom, **kw))
    model.load_state_dict(convert.params_from_flax(
        flatten_params(params), pretraining=True))
    out = model.train()(torch.from_numpy(px), torch.from_numpy(mask), nm)
    out["loss"].backward()
    assert abs(float(out["loss"].detach()) - float(ref_loss)) <= 1e-3 * abs(
        float(ref_loss))
    for name, p in model.named_parameters():
        assert _rel(p.grad, ref_grads[name].numpy()) <= 2e-2, name
