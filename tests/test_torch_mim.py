"""The port's MIM model against the JAX package on the CPU:
VideoMAEForPreTraining in float32 on the JAX model's weights (carried by
`params_from_flax`) and the JAX package's mask, with and without remat,
the masked encoder branch, and the pretraining tree's names both ways."""

import functools

import jax
import numpy as np
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JPre
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.videomae import (
    VideoMAEForPreTraining,
    VideoMAEModel,
)
from smb_vision_tpu_torch.ops.masking import num_masked_tokens

torch.set_num_threads(1)

GEOM = dict(image_size=64, num_frames=64, patch_size=16, tubelet_size=16)
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, decoder_hidden_size=64,
            decoder_num_hidden_layers=1, decoder_num_attention_heads=2,
            decoder_intermediate_size=128, dtype="float32",
            attn_impl="xla", mlp_impl="xla")
MASK = dict(input_size=64, depth=64, mask_patch_size=32,
            model_patch_size=16, mask_ratio=0.5)


def _jax_setup(**kw):
    return _jax_setup_cached(tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_setup_cached(kw):
    """JAX config, random params (norms and biases perturbed away from
    identity and zero), pixels and a JAX mask."""
    jcfg = JConfig(**GEOM, **{**TINY, **dict(kw)})
    nm = num_masked_tokens(**MASK)
    px = np.random.default_rng(1).uniform(
        0, 1, (2, 64, 1, 64, 64)).astype(np.float32)
    mask = np.asarray(jmim_mask(jax.random.PRNGKey(3), 2, **MASK))
    params = jax.jit(JPre(jcfg).init, static_argnums=(3,))(
        jax.random.PRNGKey(0), px, mask, nm)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)
    return jcfg, params, px, mask, nm


def _port(params, **kw):
    model = VideoMAEForPreTraining(VideoMAEConfig(**GEOM, **{**TINY, **kw}))
    model.load_state_dict(convert.params_from_flax(
        flatten_params(params), pretraining=True))
    return model


def _port_loss_and_grads(model, px, mask, nm, valid=None):
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(px), torch.from_numpy(mask), nm,
                valid=None if valid is None else torch.from_numpy(valid))
    out["loss"].backward()
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_pretraining_f32_matches_jax_with_and_without_remat():
    """Loss within 1e-5 relative, every parameter's gradient within 1e-4
    of its max; remat on and off give bitwise equal loss and gradients."""
    jcfg, params, px, mask, nm = _jax_setup()

    def jloss(p):
        return JPre(jcfg).apply(p, px, mask, nm)["loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref_grads = convert.params_from_flax(flatten_params(ref_grads),
                                         pretraining=True)
    runs = {}
    for remat in (False, True):
        model = _port(params, gradient_checkpointing=remat).train()
        assert model.decoder.remat == remat
        runs[remat] = _port_loss_and_grads(model, px, mask, nm)
    out, grads = runs[False]
    assert out["logits"].shape == (2, nm, 16 ** 3)
    assert abs(float(out["loss"]) - float(ref_loss)) <= 1e-5 * abs(
        float(ref_loss))
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        want = ref_grads[name].numpy()
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-6), name
    out_r, grads_r = runs[True]
    assert torch.equal(out["loss"], out_r["loss"])
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def test_pretraining_valid_rows_and_raw_pixel_loss():
    """valid (the eval padding weights) and norm_pix_loss=False, against
    the JAX model."""
    jcfg, params, px, mask, nm = _jax_setup(norm_pix_loss=False)
    valid = np.array([1.0, 0.0], np.float32)
    ref = jax.jit(lambda p: JPre(jcfg).apply(p, px, mask, nm, valid=valid)[
        "loss"])(params)
    model = _port(params, norm_pix_loss=False).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(px), torch.from_numpy(mask), nm,
                    valid=torch.from_numpy(valid))
    np.testing.assert_allclose(float(out["loss"]), float(ref), rtol=1e-5)


def test_masked_encoder_branch_matches_jax():
    """VideoMAEModel with a mask encodes the visible tokens only and
    returns the token order, visible tokens first."""
    jcfg, params, px, mask, nm = _jax_setup()
    enc = params["params"]["videomae"]
    ref, ref_order = jax.jit(lambda p: JModel(jcfg).apply(
        {"params": p}, px, mask, nm))(enc)
    model = VideoMAEModel(VideoMAEConfig(**GEOM, **TINY))
    model.load_state_dict(convert.params_from_flax(
        flatten_params({"params": enc})))
    with torch.no_grad():
        out, order = model(torch.from_numpy(px), torch.from_numpy(mask), nm)
    np.testing.assert_array_equal(order.numpy(), np.asarray(ref_order))
    assert out.shape == (2, 64 - nm, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_pretraining_tree_round_trip():
    """params_to_flax is the inverse of params_from_flax on the whole
    pretraining tree, names and values."""
    _, params, *_ = _jax_setup()
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    state = convert.params_from_flax(flat, pretraining=True)
    back = convert.params_to_flax(state)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert "mask_token" in state and state["mask_token"].shape == (1, 1, 64)
    assert not any(k.startswith("videomae.") for k in
                   convert.params_from_flax(flat))
