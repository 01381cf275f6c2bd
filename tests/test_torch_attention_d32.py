"""Head width 32 (the reference-head V-JEPA2 predictor: 384 wide, 12 heads)
in the port's flash attention against the JAX package on the CPU: K1's
plain version (out, lse2 and the gradients of its autograd Function, the
plain version of K4) and the "pallas_i8bwd" route (the plain version of
K7) against the JAX flash kernels in interpret mode at block 32, the int8
forwards' plain versions (K3, K8) against the JAX `_fwd_i8` in interpret
mode at block_k 64, and the routing of "auto" at d 32. Inputs come from
numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

D = 32
_BLOCKS = dict(interpret=True, block_q=32, block_k=32)


def _qkvw(seed, n):
    """q, k, v ~ N(0, 0.4^2) (the JAX attention tests' distribution) and a
    cotangent w, f32 (1, n, 2, 32)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, n, 2, D)) * s).astype(np.float32)
            for s in (0.4, 0.4, 0.4, 1.0)]


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [100, 129])
def test_flash_d32_out_lse_and_grads_match_jax_pallas(n):
    """out and lse2 of `attention_with_lse`, and dq, dk, dv of a loss on
    both (the lse2 cotangent folds into delta), against the JAX flash
    kernels (interpret, block 32) at a ragged N: f32, within 5e-4, the
    bound of the d-64 test_flash_grads_match_jax_pallas. Nothing launches
    on the CPU."""
    q, k, v, w = _qkvw(n, n)

    def jloss(q, k, v):
        out, lse = jattn.attention_with_lse(q, k, v, impl="pallas",
                                            **_BLOCKS)
        return jnp.sum(out * w) + jnp.sum(jnp.sin(lse))

    jout, jlse = jattn.attention_with_lse(q, k, v, impl="pallas", **_BLOCKS)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _leaves(q, k, v)
    before = (tattn.flash_attention.launches,
              tattn.flash_attention_bwd.launches)
    out, lse = tattn.attention_with_lse(tq, tk, tv, impl="pallas")
    assert out.shape == (1, n, 2, D) and lse.shape == (1, 2, n)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               atol=5e-4, rtol=5e-4)
    ((out * torch.from_numpy(w)).sum() + torch.sin(lse).sum()).backward()
    for t, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=5e-4, rtol=5e-4)
    assert (tattn.flash_attention.launches,
            tattn.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("n", [100, 129])
def test_i8bwd_d32_grads_match_jax_pallas(n):
    """`attention(impl="pallas_i8bwd")` at d 32: the forward as K1's, the
    int8-score gradients (the plain version of K7, quantisation unchanged)
    against the JAX package's (interpret, block 32), within 1e-2 of max,
    the bound of the d-64 test_int8_and_i8bwd_refuse_autograd."""
    q, k, v, w = _qkvw(50 + n, n)

    def jloss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, impl="pallas_i8bwd",
                                       **_BLOCKS) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    jout = jattn.attention(q, k, v, impl="pallas_i8bwd", **_BLOCKS)
    leaves = _leaves(q, k, v)
    out = tattn.attention(*leaves, impl="pallas_i8bwd")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=5e-4, rtol=5e-4)
    (out * torch.from_numpy(w)).sum().backward()
    for t, ref in zip(leaves, want):
        assert _rel(t.grad, ref) < 1e-2


@pytest.mark.parametrize("dtype,bias,want", [
    (torch.bfloat16, False, "pallas"),
    (torch.float32, False, "xla"),
    (torch.bfloat16, True, "xla"),
])
def test_auto_routes_head_width_32(dtype, bias, want):
    """"auto" takes K1 (K4 under autograd) at d 32 for bf16 inputs without
    a bias, as the JAX package's "auto" does on its chip, and the plain
    attention for float32 or a bias."""
    q = torch.zeros(1, 16, 2, D, dtype=dtype)
    b = torch.zeros(1, 2, 16, 16) if bias else None
    assert tattn._auto_impl(q, b) == want


def _bf16(seed, n):
    """q, k, v (1, n, 2, 32) ~ N(0, 0.4^2) rounded to bf16: (jax f32 of the
    bf16 values, torch bf16)."""
    out = []
    for a in _qkvw(seed, n)[:3]:
        t = torch.from_numpy(a).to(torch.bfloat16)
        out.append((jnp.asarray(t.float().numpy()), t))
    return out


@pytest.mark.parametrize("impl,f32_bound", [("pallas_int8", 2e-2),
                                            ("pallas_int8pv", 3e-2)])
@pytest.mark.parametrize("n", [100, 129])
def test_int8_forwards_d32_match_jax_pallas(impl, f32_bound, n):
    """K3's and K8's plain versions at d 32 (their quantisation, exact
    integer scores; K8's p requantised per 64-key sub-block) against the
    JAX `_fwd_i8` (pv False / True) in interpret mode at block_k 64, so
    its sub-block is K8's: within 1e-2 of max, the d-64 tests' bound
    (tests/test_torch_ops.py), and within the JAX package's bounds of
    float32 attention. Nothing launches on the CPU."""
    (jq, q), (jk, k), (jv, v) = _bf16(70 + n, n)
    ref = jattn.attention(jq, jk, jv, impl=impl, interpret=True,
                          block_q=64, block_k=64)
    before = (tattn.flash_attention_int8.launches,
              tattn.flash_attention_int8pv.launches)
    out = tattn.attention(q, k, v, impl=impl)
    assert out.dtype == torch.bfloat16 and out.shape == (1, n, 2, D)
    assert _rel(out, ref) < 1e-2
    f32 = jattn.xla_attention(jq, jk, jv)
    assert _rel(out, f32) < f32_bound
    assert (tattn.flash_attention_int8.launches,
            tattn.flash_attention_int8pv.launches) == before
