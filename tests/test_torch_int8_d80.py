"""The int8 codes of K3's and K7's tiles of 80 columns (heads of 72 and
80: rows of 96 bytes, a 64-byte panel and a 32-byte one) on the CPU: their
first d columns and their scales bit for bit the JAX package's
quantisation (`_quant_per_head` under jit, as `_fwd_i8` and `_bwd`
quantise), zeros past d; and K3's and K7's plain versions on codes of 96
bytes bit for bit the same on codes of 128 bytes (the d-128 tiles') and of
d bytes. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)


def _bf16(seed, b, n, h, d, count, s=0.7):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((b, n, h, d)) * s)
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(count)]


def _jax_quant(x, mult):
    """The JAX package's quantisation of a (B, N, H, D) array as `_fwd_i8`
    and `_bwd` (i8) run it: (B*H, N, D), x.astype(f32) * mult through
    `_quant_per_head`, under jit. Returns x8 (B, N, H, D) and s (B, H)."""
    b, n, h, d = x.shape

    @jax.jit
    def quant(xj):
        xh = jnp.transpose(xj, (0, 2, 1, 3)).reshape(b * h, n, d)
        return jattn._quant_per_head(xh.astype(jnp.float32) * mult)

    x8, s = quant(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    x8 = np.asarray(x8).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    return x8, np.asarray(s).reshape(b, h)


@pytest.mark.parametrize("d", [72, 80])
def test_codes_of_96_bytes_match_jax(d):
    """q8 and k8 as K3 reads them (`quantize_qk`) and q8, k8, v8, do8 as
    K7 reads them (`_i8_operands` at `_code_width(d, "K7")`), for heads of
    72 and 80: rows of 96 codes whose first d are bit for bit the JAX
    package's, zeros after, and the scales (and K7's scale products sq*sk,
    sdo*sv) bit for bit."""
    q, k, v, do = _bf16(d, 2, 75, 3, d, 4)
    scale = d ** -0.5
    mult = np.float32(scale * tattn.LOG2E)
    want = {name: _jax_quant(x, m) for name, x, m in (
        ("q", q, mult), ("k", k, 1.0), ("v", v, 1.0), ("do", do, 1.0))}
    q8, k8, sq, sk = tattn.quantize_qk(q, k, scale)
    ops = tattn._i8_operands(q, k, v, do, scale, tattn.quantize_per_head,
                             tattn._code_width(d, "K7"))
    codes = {"q": (q8, ops[0]), "k": (k8, ops[1]), "v": (ops[2],),
             "do": (ops[3],)}
    for name, got in codes.items():
        for x8 in got:
            assert x8.shape == (2, 75, 3, 96) and x8.dtype == torch.int8
            np.testing.assert_array_equal(x8[..., :d].numpy(),
                                          want[name][0])
            assert not bool(x8[..., d:].any())
    np.testing.assert_array_equal(sq.numpy(), want["q"][1])
    np.testing.assert_array_equal(sk.numpy(), want["k"][1])
    np.testing.assert_array_equal(ops[4].numpy(),
                                  want["q"][1] * want["k"][1])
    np.testing.assert_array_equal(ops[5].numpy(),
                                  want["do"][1] * want["v"][1])


@pytest.mark.parametrize("d", [72, 80])
def test_plain_int8_kernels_take_zero_columns_exactly(d):
    """K3's and K7's plain versions (K7 with an lse2 cotangent) on codes
    of 96 bytes, the d-80 tiles' and their default, equal the same on
    codes of 128 bytes (the d-128 tiles') and of d bytes bit for bit: a
    zero column adds nothing to an integer score, and every sum of the
    int8 products (|sum| < 127^2 * 128 < 2^24) is exact in f32."""
    q, k, v, do = _bf16(100 + d, 1, 129, 2, d, 4, s=0.4)
    lse_cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 2, 129)).astype(np.float32) * 0.1)
    scale = d ** -0.5
    mult = scale * tattn.LOG2E
    outs = [tattn.int8_attention_plain(*tattn.quantize_qk(q, k, scale), v)]
    for w in (96, 128, d):
        q8, sq = tattn.quantize_per_head(q, mult, width=w)
        k8, sk = tattn.quantize_per_head(k, width=w)
        outs.append(tattn.int8_attention_plain(q8, k8, sq, sk, v))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    out, lse = tattn.xla_attention(q, k, v, with_lse=True)
    grads = [tattn.attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale,
                                          g_lse=lse_cot, width=w)
             for w in (None, 96, 128, d)]
    for got in grads[1:]:
        for a, b in zip(got, grads[0]):
            assert torch.equal(a, b)
