"""The int8 quantisation of the port's int8 attention (K3, K7, K8) against
the JAX package on the CPU, bit for bit: `quantize_per_head` and
`quantize_qk` (the plain versions beside the quantisation kernel,
`csrc/quant.cu`) against `_quant_per_head` and the expressions of `_fwd_i8`,
compiled as the JAX package runs them (under jit). Then the layout in which
K8 reads v8, and K8's plain version fed from it. Inputs come from numpy
seeds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)


def _jax_quant(x, mult):
    """The JAX package's quantisation of a (B, N, H, D) array: `_fwd_i8`
    and `_bwd` (i8) take x in (B*H, N, D) and quantise x.astype(f32) * mult
    with `_quant_per_head`'s expressions, inside their jit. Returns x8 in
    (B, N, H, D) and s (B, H) as numpy."""
    b, n, h, d = x.shape

    @jax.jit
    def quant(xj):
        xh = jnp.transpose(xj, (0, 2, 1, 3)).reshape(b * h, n, d)
        return jattn._quant_per_head(xh.astype(jnp.float32) * mult)

    x8, s = quant(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    x8 = np.asarray(x8).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    return x8, np.asarray(s).reshape(b, h)


def _ties(b, n, h, d, scale_max):
    """Values that land exactly on k + .5 after the division: one head's
    max is scale_max * 127, so s = scale_max exactly (127 * f32(1/127) is
    1), and the rest are (k + .5) * scale_max."""
    rng = np.random.default_rng(3)
    k = rng.integers(-126, 126, size=(b, n, h, d))
    x = (k + 0.5) * scale_max
    x[:, 0, :, 0] = 127 * scale_max
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _case(name):
    """(x bf16 (B, N, H, D), mult) of a named case."""
    rng = np.random.default_rng(len(name))
    if name == "ties":
        return _ties(2, 40, 3, 64, 1.0), 1.0
    if name == "ties_scaled":
        return _ties(1, 33, 2, 32, 2.0), 1.0
    shape = {"ragged": (2, 97, 3, 64), "d128": (1, 65, 2, 128),
             "d32": (2, 129, 4, 32), "zero_head": (2, 50, 3, 64),
             "q_scale": (1, 200, 2, 64), "wide_range": (1, 70, 2, 64)}[name]
    x = rng.standard_normal(shape) * 0.4
    if name == "zero_head":
        x[1, :, 2] = 0.0
    if name == "wide_range":
        x = x * np.exp(rng.uniform(-8, 8, shape))
    mult = 0.125 * tattn.LOG2E if name == "q_scale" else 1.0
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), mult


CASES = ("ragged", "d128", "d32", "zero_head", "q_scale", "wide_range",
         "ties", "ties_scaled")


@pytest.mark.parametrize("name", CASES)
def test_quantize_per_head_matches_jax_bit_for_bit(name):
    """The same int8 bytes and the same f32 scales as the JAX package's
    quantisation: ragged N, head widths 32 to 128, an all-zero head (s =
    1), q's multiplier scale*log2(e), values over 16 binades, and values
    that land exactly on .5 after the division (ties to even)."""
    x, mult = _case(name)
    x8, s = tattn.quantize_per_head(x, mult)
    want8, want_s = _jax_quant(x, mult)
    assert x8.dtype == torch.int8 and x8.shape == x.shape
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(x8.numpy(), want8)
    if name == "zero_head":
        assert float(s[1, 2]) == 1.0 and not bool(x8[1, :, 2].any())
    if name.startswith("ties"):
        # rint: k + .5 goes to the even neighbour
        xf = x.float() / s[:, None, :, None]
        halves = xf - xf.floor() == 0.5
        assert bool(halves.any())
        assert not bool((x8[halves].long() % 2).any())


def test_quantize_qk_matches_jax_fwd_i8():
    """quantize_qk as `_fwd_i8` quantises q (times scale*log2(e)) and k,
    bit for bit, at a ragged Nq != Nk."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy((rng.standard_normal((2, 75, 3, 64)) * 0.4)
                         .astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy((rng.standard_normal((2, 130, 3, 64)) * 0.4)
                         .astype(np.float32)).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(64)
    before = tattn.quantize_per_head_kernel.launches
    q8, k8, sq, sk = tattn.quantize_qk(q, k, scale)
    assert tattn.quantize_per_head_kernel.launches == before  # cpu: plain
    for got8, got_s, x, mult in ((q8, sq, q, scale * jattn.LOG2E),
                                 (k8, sk, k, 1.0)):
        want8, want_s = _jax_quant(x, mult)
        np.testing.assert_array_equal(got_s.numpy(), want_s)
        np.testing.assert_array_equal(got8.numpy(), want8)


def test_quantize_kernel_refuses_cpu_tensors():
    """The kernel's wrapper runs on CUDA only: the plain version is
    `quantize_per_head`."""
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="runs on cuda"):
        tattn.quantize_per_head_kernel(x)


def _from_v_layout(vt, n):
    """v8 (B, N, H, D) back from K8's layout (B, H, D, N_pad): the inverse
    of `quantize_v_kernel_layout`'s key order, written out independently
    (position half*16 + 4t + 2hi + lo holds key half*16 + hi*8 + 2t + lo)."""
    b, h, d, npad = vt.shape
    keys = np.empty(npad, np.int64)
    for pos in range(npad):
        half, t, hi, lo = pos // 16 % 2, pos % 16 // 4, pos % 4 // 2, pos % 2
        keys[pos] = pos // 32 * 32 + half * 16 + hi * 8 + 2 * t + lo
    out = torch.zeros((b, h, d, npad), dtype=vt.dtype)
    out[..., torch.from_numpy(keys)] = vt
    return out[..., :n].permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("n,d", [(100, 64), (64, 128), (193, 64), (1, 32)])
def test_v_layout_round_trip_and_padding(n, d):
    """K8's v layout holds every byte of v8 once, zeros past N, at N_pad a
    multiple of 64 (the requantisation sub-block)."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy((rng.standard_normal((2, n, 3, d)) * 0.4)
                         .astype(np.float32)).to(torch.bfloat16)
    v8, _ = tattn.quantize_per_head(v)
    vt = tattn.quantize_v_kernel_layout(v8)
    npad = -(-n // tattn.PV_SUB) * tattn.PV_SUB
    assert vt.shape == (2, 3, d, npad) and vt.is_contiguous()
    assert torch.equal(_from_v_layout(vt, n), v8)
    assert not bool(_from_v_layout(vt, npad)[:, n:].any())  # keys past N
    assert torch.equal(torch.sort(vt[..., :npad].flatten())[0],
                       torch.sort(torch.cat([
                           v8.permute(0, 2, 3, 1).flatten(),
                           torch.zeros(2 * 3 * d * (npad - n),
                                       dtype=torch.int8)]))[0])


def _kernel_order_pv(p8, vt):
    """The int8 p v as K8 contracts it: thread (g, t)'s s32 score
    accumulator holds keys 2t, 2t+1 of each 8-key group, and its A fragment
    of a k32 step is the bytes it packs from them in that order (positions
    4t..4t+3 and 16+4t..16+4t+3 hold keys 2t, 2t+1, 8+2t, 9+2t and the
    same + 16); the B operand is the v layout read along its keys. p8 (B,
    H, Nq, N_pad) in key order; vt (B, H, D, N_pad)."""
    b, h, nq, npad = p8.shape
    t = torch.arange(4)
    # position -> key within a 32-key step: the packing of pa[cs][0..3]
    pos_key = torch.empty(32, dtype=torch.long)
    for half in range(2):
        for e in range(4):
            pos_key[half * 16 + 4 * t + e] = (half * 16 + 2 * t + (e & 1)
                                              + 8 * (e >> 1))
    keys = (torch.arange(npad // 32)[:, None] * 32 + pos_key).flatten()
    a = p8[..., keys]                                   # A in k order
    return torch.einsum("bhqk,bhdk->bhqd", a.double(), vt.double())


@pytest.mark.parametrize("nq,nk,d", [(64, 130, 64), (70, 64, 128),
                                     (33, 65, 64)])
def test_v_layout_meets_k8_p_fragments(nq, nk, d):
    """The integer sums n = p8 v8 in the order K8 forms them (its p8 A
    fragments against the v layout) equal p8 v8 in key order, bit for bit,
    with keys past N counting 0."""
    rng = np.random.default_rng(nq + nk)
    p8 = torch.from_numpy(rng.integers(0, 128, (1, 2, nq, nk))).to(
        torch.int64)
    v = torch.from_numpy((rng.standard_normal((1, nk, 2, d)) * 0.4)
                         .astype(np.float32)).to(torch.bfloat16)
    v8, _ = tattn.quantize_per_head(v)
    vt = tattn.quantize_v_kernel_layout(v8)
    npad = vt.shape[-1]
    p8_pad = torch.nn.functional.pad(p8, (0, npad - nk), value=99)
    got = _kernel_order_pv(p8_pad, vt)
    want = torch.einsum("bhqk,bkhd->bhqd", p8.double(), v8.double())
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq,nk", [(100, 100), (64, 193), (130, 65)])
def test_int8pv_plain_fed_from_v_layout_matches_jax(nq, nk):
    """K8's plain version fed with v8 read back from K8's layout gives its
    result on v8 bit for bit, and holds to the JAX `pallas_int8pv`
    (interpret, block_k 64) within 1e-2 of max as before; Nq != Nk both
    ways."""
    rng = np.random.default_rng(nq * nk)

    def r(n):
        return torch.from_numpy((rng.standard_normal((1, n, 2, 64)) * 0.4)
                                .astype(np.float32)).to(torch.bfloat16)

    q, k, v = r(nq), r(nk), r(nk)
    q8, k8, sq, sk = tattn.quantize_qk(q, k, 1.0 / math.sqrt(64))
    v8, sv = tattn.quantize_per_head(v)
    vt = tattn.quantize_v_kernel_layout(v8)
    out = tattn.int8pv_attention_plain(q8, k8, sq, sk, _from_v_layout(vt, nk),
                                       sv)
    assert torch.equal(out, tattn.int8pv_attention_plain(q8, k8, sq, sk, v8,
                                                         sv))

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    ref = jattn.attention(jx(q), jx(k), jx(v), impl="pallas_int8pv",
                          interpret=True, block_q=64, block_k=64)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-2
