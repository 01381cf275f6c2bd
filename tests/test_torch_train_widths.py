"""The training kernels at every width the JAX kernels take, on the CPU
against the JAX package: the routes of K4 (attn_impl "pallas" under
autograd, its plain backward) at head widths past 32 / 64 / 128 (16, 40,
72, 80, and 100, which the wrappers pad to 104) against `jax.grad` of the
JAX flash kernels in interpret mode, with a cotangent on lse2 too; K7's
("pallas_i8bwd") at d 72 and 80 against the JAX int8-score backward in
interpret mode and the f32 gradients; the "pallas_bwd" pair K5a + K5b at
K 1,280 and 1,408 against the JAX `_mlp_fused_tb` in interpret mode; and
a 2-layer VideoMAEForPreTraining and a 2-layer V-JEPA2 at ViT-H widths
(hidden 1,280, 16 heads of 80, MLP 5,120) on those routes against the
JAX models on their kernels, through the converters, on shared masks.
Inputs come from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JMimConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JVjConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JPre
from smb_vision_tpu.models.vjepa import VJEPA2Model as JVjModel
from smb_vision_tpu.models.vjepa import vjepa_loss as jvjepa_loss
from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu.ops import masking as jmasking
from smb_vision_tpu.ops import mlp as jmlp
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VideoMAEConfig, VJEPA2Config
from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu_torch.models.vjepa import VJEPA2Model, vjepa_loss
from smb_vision_tpu_torch.ops import attention as tattn
from smb_vision_tpu_torch.ops import mlp as tmlp
from smb_vision_tpu_torch.ops.masking import num_masked_tokens

torch.set_num_threads(1)

# ViT-H widths (MCG-NJU/videomae-huge, facebook/vjepa2-vith-fpc64-256):
# hidden 1,280, 16 heads of 80, MLP 5,120; 2 layers
VIT_H = dict(hidden_size=1280, num_hidden_layers=2, num_attention_heads=16)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _perturbed(params, seed=0):
    """Norms and biases moved off their init (ones and zeros), as the
    model parity tests move them."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)


@pytest.mark.parametrize("d", [16, 40, 72, 80, 100])
def test_flash_grads_widths_match_jax_pallas(d):
    """K4's route at a head width past the instantiations: a loss on out
    and on lse2 through attention_with_lse(impl="pallas") (K1 and the
    plain version of K4 on the CPU, f32), against jax.grad through the JAX
    flash kernels in interpret mode at the same width (padded to 104 at d
    100 by both packages); ragged N 100. The bound of the JAX package's
    own gradient test, as tests/test_torch_train_ops.py holds d 64."""
    q, k, v = (_rand(70 + i, (1, 100, 2, d), 0.4) for i in range(3))
    w = _rand(73, (1, 100, 2, d))

    def jloss(q, k, v):
        out, lse = jattn.attention_with_lse(q, k, v, impl="pallas",
                                            interpret=True, block_q=64,
                                            block_k=64)
        return jnp.sum(out * w) + jnp.sum(jnp.sin(lse) * lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = tattn.flash_attention_bwd.launches
    out, lse = tattn.attention_with_lse(*leaves, impl="pallas")
    ((out * torch.from_numpy(w)).sum()
     + (torch.sin(lse) * lse).sum()).backward()
    assert tattn.flash_attention_bwd.launches == before   # cpu: plain
    for t, a in zip(leaves, want):
        assert t.grad.shape == (1, 100, 2, d)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("d", [72, 80])
def test_i8bwd_widths_match_jax(d):
    """K7's route ("pallas_i8bwd" under autograd, its plain version on the
    CPU) at d 72 and 80 against jax.grad through the JAX int8-score
    backward kernels in interpret mode (the same quantised method, 1e-2 of
    max) and the f32 xla gradients (5e-2, the JAX package's own bound), as
    tests/test_torch_vjepa.py holds d 64 and 128."""
    q, k, v = (_rand(80 + i, (1, 100, 2, d), 0.4) for i in range(3))
    w = _rand(83, (1, 100, 2, d))

    def jgrads(impl):
        def loss(q, k, v):
            return jnp.sum(jattn.attention(q, k, v, impl=impl,
                                           interpret=True, block_q=64,
                                           block_k=64) * w)
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    want_i8, want_f32 = jgrads("pallas_i8bwd"), jgrads("xla")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = tattn.flash_attention_bwd_i8.launches
    (tattn.attention(*leaves, impl="pallas_i8bwd")
     * torch.from_numpy(w)).sum().backward()
    assert tattn.flash_attention_bwd_i8.launches == before   # cpu: plain
    for t, a, b in zip(leaves, want_i8, want_f32):
        assert _rel(t.grad, a) <= 1e-2
        assert _rel(t.grad, b) <= 5e-2


@pytest.mark.parametrize("k,f", [(1280, 5120), (1408, 6144)])
def test_pallas_bwd_pair_wide_k_matches_jax(k, f):
    """mlp_impl "pallas_bwd" (K5a + K5b through their plain versions) at
    ViT-H's K 1,280 (F 5,120) and ViT-g's 1,408 (F 6,144) against the JAX
    package's _mlp_fused_tb in interpret mode, ragged M 100: the forward
    and all five gradients within 3e-2 of max, the bound of
    tests/test_torch_train_ops.py (and of the JAX package's own
    tests/test_mlp_bwd.py)."""
    rng = np.random.default_rng(k)
    m = 100
    x = rng.normal(size=(m, k)).astype(np.float32)
    w1 = (rng.normal(size=(k, f)) * k ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(f, k)) * f ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(k,)) * 0.1).astype(np.float32)
    wy = rng.normal(size=(m, k)).astype(np.float32)
    bx = (jnp.asarray(x).astype(jnp.bfloat16), w1, b1, w2, b2)

    def jloss(*a):
        y = jmlp._mlp_fused_tb(*a, ("gelu", True))
        return jnp.sum(y.astype(jnp.float32) * wy)

    ref = jmlp._mlp_fused_tb(*bx, ("gelu", True))
    ref_g = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*bx)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, w1, b1, w2, b2)]
    before = (tmlp.mlp_train_fused.launches, tmlp.mlp_bwd_fused.launches)
    y = tmlp.mlp_forward(leaves[0].to(torch.bfloat16), *leaves[1:],
                         impl="pallas_bwd")
    (y.float() * torch.from_numpy(wy)).sum().backward()
    assert (tmlp.mlp_train_fused.launches,
            tmlp.mlp_bwd_fused.launches) == before      # cpu: plain
    assert y.dtype == torch.bfloat16
    assert _rel(y, np.asarray(ref.astype(jnp.float32))) <= 3e-2
    for t, g in zip(leaves, ref_g):
        assert _rel(t.grad, np.asarray(g.astype(jnp.float32))) <= 3e-2


# --- the models at ViT-H widths --------------------------------------------

MIM_GEOM = dict(image_size=64, num_frames=64, patch_size=16, tubelet_size=16)
# widths and rows the JAX "pallas_bwd" maps: K and F multiples of 128,
# rows of 128 (batch 4 of 32 visible tokens in the encoder, of 64 in the
# decoder; batch 4 of 32 tokens in the V-JEPA2 encoder and predictor)
MIM_DECODER = dict(decoder_hidden_size=128, decoder_num_hidden_layers=1,
                   decoder_num_attention_heads=2,
                   decoder_intermediate_size=256)
MIM_MASK = dict(input_size=64, depth=64, mask_patch_size=32,
                model_patch_size=16, mask_ratio=0.5)
# the kernel routes of the slice: K1 + K4 at d 80, K5a + K5b at K 1,280
MIM_IMPLS = dict(attn_impl="pallas", mlp_impl="pallas_bwd")
VJ_GEOM = dict(crop_size=64, frames_per_clip=32, patch_size=16,
               tubelet_size=16, in_chans=1, mlp_ratio=4.0,
               pred_hidden_size=128, pred_num_attention_heads=2,
               pred_num_hidden_layers=1, pred_zero_init_mask_tokens=False)
VJ_GRID = (2, 4, 4)
# the student's routes of configs/vjepa_large_384_tpu.json: K1 + K7, K5a +
# K5b (the predictor's heads of 32 too)
VJ_IMPLS = dict(attn_impl="pallas_i8bwd", mlp_impl="pallas_bwd")
# a kernel route's loss within 1e-3 relative of the JAX model's on its
# kernels (the trainer trajectory tests' bound, tests/test_torch_train.py
# and tests/test_torch_vjepa_train.py); its gradient over all parameters,
# ||g - g32|| / ||g32|| against the JAX model's float32 plain gradients,
# within 1.25 times the JAX kernels' own (PERF.md section 2's training
# rule: both compute in bf16 and on int8 codes, at other rounding points)
TOL_LOSS, TOL_GRAD_VS_F32 = 1e-3, 1.25


def _grad_error(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over all parameters."""
    assert set(got) == set(want)
    num = sum(float(((g.float() - want[n]) ** 2).sum())
              for n, g in got.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _check(loss, grads: dict, ref, ref32):
    """The port's loss and gradients against the JAX model's on its
    kernels (ref) and in float32 on the plain path (ref32), each a (loss,
    {name: gradient}) pair."""
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert abs(float(loss) - ref[0]) <= TOL_LOSS * abs(ref[0])
    port, jax_kernels = (_grad_error(g, ref32[1])
                         for g in (grads, ref[1]))
    assert port <= TOL_GRAD_VS_F32 * jax_kernels, (port, jax_kernels)


def _jax_run(loss_fn, params, converted):
    """(loss, {port name: gradient}) of the JAX loss at params."""
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), converted(flatten_params(grads))


def test_mim_vit_h_widths_matches_jax():
    """A 2-layer VideoMAEForPreTraining at ViT-H widths (the decoder
    tiny), float32 weights on the kernel routes (attention "pallas" at d
    80, MLP "pallas_bwd" at K 1,280; their plain versions on the CPU)
    against the JAX model on its kernels in interpret mode and in float32
    on the plain path, the JAX package's mask on a 64^3 volume of 64
    tokens (32 visible) at batch 4: the loss and the gradient."""
    geometry = dict(**MIM_GEOM, **VIT_H, intermediate_size=5120,
                    **MIM_DECODER, dtype="float32")
    jcfg = JMimConfig(**geometry, **MIM_IMPLS)
    nm = num_masked_tokens(**MIM_MASK)
    px = np.random.default_rng(1).uniform(
        0, 1, (4, 64, 1, 64, 64)).astype(np.float32)
    mask = np.asarray(jmasking.mim_mask(jax.random.PRNGKey(3), 4,
                                        **MIM_MASK))
    params = _perturbed(jax.jit(JPre(impl_neutral(jcfg)).init,
                                static_argnums=(3,))(
        jax.random.PRNGKey(0), px, mask, nm))
    converted = functools.partial(convert.params_from_flax,
                                  pretraining=True)
    ref, ref32 = (_jax_run(lambda p, c=c: JPre(c).apply(
        p, px, mask, nm)["loss"], params, converted)
        for c in (jcfg, impl_neutral(jcfg)))
    model = VideoMAEForPreTraining(VideoMAEConfig(**geometry,
                                                  **MIM_IMPLS)).train()
    model.load_state_dict(converted(flatten_params(params)))
    loss = model(torch.from_numpy(px), torch.from_numpy(mask), nm)["loss"]
    loss.backward()
    _check(loss.detach(), {n: p.grad for n, p in model.named_parameters()},
           ref, ref32)


def test_vjepa_vit_h_widths_matches_jax():
    """A 2-layer V-JEPA2 at facebook/vjepa2-vith-fpc64-256's encoder
    widths (hidden 1,280, 16 heads of 80, mlp_ratio 4), float32 weights on
    the _tpu preset's student routes (attention "pallas_i8bwd": K1 + K7 at
    d 80; MLP "pallas_bwd": K5a + K5b at K 1,280), the predictor tiny,
    against the JAX model on its kernels in interpret mode and in float32
    on the plain path: one target mask of the JAX package's (grid (2, 4,
    4), batch 4) and a fixed teacher, the masked-L1 loss and the
    gradient."""
    geometry = dict(**VJ_GEOM, **VIT_H, dtype="float32")
    jcfg = JVjConfig(**geometry, **VJ_IMPLS)
    px = np.random.default_rng(1).uniform(
        0, 1, (4, 32, 1, 64, 64)).astype(np.float32)
    tb = np.array(jmasking.vjepa_target_mask(jax.random.PRNGKey(3), 4,
                                             grid=VJ_GRID))
    teacher = _rand(60, (4, 32, 1280))
    params = _perturbed(jax.jit(lambda key: JVjModel(impl_neutral(
        jcfg)).init(key, px, target_bool=tb))(jax.random.PRNGKey(0)))
    converted = functools.partial(convert.params_from_flax, vjepa=True)

    def jloss(p, c):
        out = JVjModel(c).apply(p, px, target_bool=tb)
        return jvjepa_loss(out["predictor_output"], teacher, tb)

    ref, ref32 = (_jax_run(functools.partial(jloss, c=c), params,
                           converted)
                  for c in (jcfg, impl_neutral(jcfg)))
    model = VJEPA2Model(VJEPA2Config(**geometry, **VJ_IMPLS)).train()
    model.load_state_dict(converted(flatten_params(params)))
    tbt = torch.from_numpy(tb)
    out = model(torch.from_numpy(px), target_bool=tbt)
    loss = vjepa_loss(out["predictor_output"], torch.from_numpy(teacher),
                      tbt)
    loss.backward()
    _check(loss.detach(), {n: p.grad for n, p in model.named_parameters()},
           ref, ref32)
