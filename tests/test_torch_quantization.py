"""The PyTorch port's uint8 pixel shipping against the JAX package's on the
CPU: the numpy quantisation bit for bit, and the bfloat16 decode bit for
bit against the JAX decode compiled by XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.data import quantization as jq
from smb_vision_tpu_torch.data import quantization as tq

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["uniform", "float16", "constant", "wide"])
def test_quantize_volume_matches_jax_bit_for_bit(case):
    rng = np.random.default_rng(0)
    vol = rng.uniform(-3.0, 2.0, (37, 1, 17, 19)).astype(np.float32)
    if case == "float16":
        vol = vol.astype(np.float16)
    elif case == "constant":
        vol = np.full((20, 6, 5), 3.25, np.float32)
    elif case == "wide":
        vol = rng.normal(-200, 400, (33, 9, 8)).astype(np.float32)
    q, s, o = tq.quantize_volume(vol)
    jq_, js, jo = jq.quantize_volume(vol)
    assert q.dtype == np.uint8 and s.dtype == o.dtype == np.float32
    np.testing.assert_array_equal(q, jq_)
    assert s.tobytes() == js.tobytes() and o.tobytes() == jo.tobytes()
    back = tq.dequantize_volume(q, s, o)
    np.testing.assert_array_equal(back, jq.dequantize_volume(q, s, o))
    assert np.abs(back - vol.astype(np.float32)).max() <= float(s) / 2 + 2e-3
    if case == "constant":
        assert not q.any() and (back == 3.25).all()
    for dt in (np.float16, np.float32):
        np.testing.assert_array_equal(tq.dequantize_volume(q, s, o, dt),
                                      jq.dequantize_volume(q, s, o, dt))


def test_bf16_decode_matches_jax_jit_bit_for_bit():
    """The JAX decode under jit on the CPU rounds after the product and
    after the sum, as eager PyTorch does in bfloat16; a fused single
    rounding would differ here in about a third of the voxels."""
    rng = np.random.default_rng(2)
    q = rng.integers(0, 256, (4, 20000)).astype(np.uint8)
    s = rng.uniform(1e-4, 1e-2, (4,)).astype(np.float32)
    o = rng.uniform(-1.0, 1.0, (4,)).astype(np.float32)
    ref = jax.jit(lambda q, s, o: jq.dequantize_pixels(
        q, s, o, jnp.bfloat16))(q, s, o)
    ref = np.asarray(ref).view(np.uint16)
    out = tq.dequantize_pixels(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(o), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy().view(
        np.uint16), ref)
    one = (torch.from_numpy(q).float() * torch.from_numpy(s)[:, None].to(
        torch.bfloat16).float() + torch.from_numpy(o)[:, None].to(
        torch.bfloat16).float()).to(torch.bfloat16)
    assert (one.view(torch.int16).numpy().view(np.uint16) != ref).mean() > 0.1


def test_dequantize_pixels_broadcasts_prefix_scales():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, (2, 3, 4, 5)).astype(np.uint8)
    s = rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32)
    o = rng.uniform(-1.0, 1.0, (2, 3)).astype(np.float32)
    out = tq.dequantize_pixels(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(o))
    ref = np.asarray(jq.dequantize_pixels(jnp.asarray(q), jnp.asarray(s),
                                          jnp.asarray(o)))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_allclose(
        out.numpy(), q * s[..., None, None] + o[..., None, None], atol=1e-5)


def test_f32_decode_matches_jax_jit():
    """In float32 XLA contracts q * s + o into one fused multiply-add under
    jit, so the two sides may differ by one rounding of float32."""
    rng = np.random.default_rng(5)
    vol = rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    q, s, o = zip(*(tq.quantize_volume(v) for v in vol))
    q, s, o = np.stack(q), np.asarray(s), np.asarray(o)
    out = tq.dequantize_pixels(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(o))
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - vol).max() <= s.max() / 2 + 1e-6
    ref = jax.jit(lambda q, s, o: jq.dequantize_pixels(q, s, o,
                                                       jnp.float32))(q, s, o)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2 ** -23,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_model_program_sees_the_port_decode(dtype):
    """Inside the JAX package's jitted forward (the runner's uint8 route,
    decode and model in one program) XLA could drop the decode's last
    rounding where a float32 consumer follows. It does not: the model's
    output equals, bit for bit, its output on the port's decoded pixels."""
    from smb_vision_tpu.models.configs import VideoMAEConfig
    from smb_vision_tpu.models.videomae import VideoMAEModel

    cfg = VideoMAEConfig(image_size=32, num_frames=32, patch_size=16,
                         tubelet_size=16, num_channels=1, hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, dtype=dtype, attn_impl="xla")
    model = VideoMAEModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 np.zeros((1, 32, 1, 32, 32), np.float32))
    rng = np.random.default_rng(4)
    q = rng.integers(0, 256, (2, 32, 1, 32, 32)).astype(np.uint8)
    s = rng.uniform(1e-3, 1e-2, (2,)).astype(np.float32)
    o = rng.uniform(-1.0, 1.0, (2,)).astype(np.float32)
    in_program = jax.jit(lambda p, q, s, o: model.apply(
        p, jq.dequantize_pixels(q, s, o, jnp.bfloat16))[0])(params, q, s, o)
    px = tq.dequantize_pixels(torch.from_numpy(q), torch.from_numpy(s),
                              torch.from_numpy(o), torch.bfloat16)
    px = jnp.asarray(px.float().numpy()).astype(jnp.bfloat16)
    on_port = jax.jit(lambda p, x: model.apply(p, x)[0])(params, px)
    np.testing.assert_array_equal(np.asarray(in_program, np.float32),
                                  np.asarray(on_port, np.float32))
