"""The weight gradients of mlp_impl "pallas_bwd" (K5a + K5b under
autograd, `ops/mlp.py::_MlpTrain`) against the JAX package's
`_mlp_fused_tb` on the CPU: dw1 = x^T dh and dw2 = a^T g are kept in
float32, as `_mlp_fused_tb_bwd` keeps them (`preferred_element_type=
jnp.float32`), and db1, db2 are f32 sums. The JAX side runs its Pallas
kernels in interpret mode; inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.ops import mlp as jmlp
from smb_vision_tpu_torch.ops import mlp as tmlp

torch.set_num_threads(1)

# f32 rounding of sums of ~200 products in another order; a bf16 rounding
# of the products' result reads ~2e-3 of max
TOL_WGRAD = 1e-5


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,act", [(200, "gelu"), (256, "gelu_new")])
def test_pallas_bwd_weight_grads_are_f32(monkeypatch, m, act):
    """dw1, db1, dw2 and db2 of the "pallas_bwd" route at float32 weights
    (K 128, F 256, seed 0; M 200 is ragged against the kernels' 128-row
    tiles) against jax.grad through `_mlp_fused_tb`, within TOL_WGRAD of
    max. The port's two kernel wrappers hand back the JAX kernels' own y,
    h and dx, dh, a here, so both sides take the weight gradients of the
    same bf16 operands, bit for bit: the plain K5a and K5b compute gelu in
    torch, whose erf and tanh differ from XLA's by an ulp now and then,
    and one bf16 ulp of dh moves dw1 by ~3e-4 of max (their own bound,
    3e-2, is tests/test_torch_train_ops.py's). What is left is the order
    of the f32 sums."""
    k, f = 128, 256
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w1 = (rng.normal(size=(k, f)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(f, k)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(k,)) * 0.1).astype(np.float32)
    wy = rng.normal(size=(m, k)).astype(np.float32)
    static = (act, True)
    bx = (jnp.asarray(x).astype(jnp.bfloat16), w1, b1, w2, b2)

    def loss(*a):
        return jnp.sum(jmlp._mlp_fused_tb(*a, static).astype(jnp.float32)
                       * wy)

    want = jax.grad(loss, argnums=(1, 2, 3, 4))(*bx)
    y, (_, h) = jmlp._mlp_tb_fwd_impl(*bx, static)
    bwd = jmlp._mlp_bwd_partitioned(*static)(
        h, jnp.asarray(wy).astype(jnp.bfloat16),
        jnp.asarray(w1).astype(jnp.bfloat16),
        jnp.asarray(w2).astype(jnp.bfloat16))

    def torch_bf16(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    monkeypatch.setattr(tmlp, "mlp_train_fused", lambda *a, **kw: (
        torch_bf16(y), torch_bf16(h)))
    monkeypatch.setattr(tmlp, "mlp_bwd_fused", lambda *a, **kw: tuple(
        torch_bf16(t) for t in bwd))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2,
                                                            b2)]
    out = tmlp.mlp_forward(leaves[0].to(torch.bfloat16), *leaves[1:],
                           act=act, impl="pallas_bwd")
    (out.float() * torch.from_numpy(wy)).sum().backward()
    for name, leaf, ref in zip(("dw1", "db1", "dw2", "db2"), leaves[1:],
                               want):
        assert leaf.grad.dtype == torch.float32, name
        assert _rel(leaf.grad, ref) <= TOL_WGRAD, name


def test_weight_grad_keeps_f32_on_the_cpu():
    """`_weight_grad` of bf16 operands returns float32, the exact f32
    product of the bf16 values (bf16 x bf16 products are exact in f32;
    only the order of the sum differs from float64)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32)).to(
        torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(96, 24)).astype(np.float32)).to(
        torch.bfloat16)
    got = tmlp._weight_grad(a, b)
    want = a.double().t() @ b.double()
    assert got.dtype == torch.float32 and got.shape == (40, 24)
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-6
