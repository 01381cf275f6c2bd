"""The port's training ops against the JAX package on the CPU: the
gradients of the kernels' autograd Functions (K1 with the plain version of
K4, K6 and K2 with their recompute backward, the "pallas_bwd" pair K5a +
K5b), the pixel targets and the MIM mask. The JAX side runs its Pallas
kernels in interpret mode, as its own tests do. Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu.ops import masking as jmasking
from smb_vision_tpu.ops import mlp as jmlp
from smb_vision_tpu.ops import patches as jpatches
from smb_vision_tpu_torch.ops import attention as tattn
from smb_vision_tpu_torch.ops import masking as tmasking
from smb_vision_tpu_torch.ops import mlp as tmlp
from smb_vision_tpu_torch.ops import patches as tpatches

torch.set_num_threads(1)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("n", [128, 100])
def test_flash_grads_match_jax_pallas(n):
    """The K1 Function's backward (the plain version of K4 on the CPU)
    against jax.grad through the JAX flash kernels, f32, aligned and
    ragged; the bound of the JAX package's own test_grads_match_xla."""
    q, k, v = (_rand(30 + i, (1, n, 2, 64), 0.4) for i in range(3))

    def jloss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, impl="pallas",
                                       interpret=True, block_q=64,
                                       block_k=64) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _leaves(q, k, v)
    before = tattn.flash_attention_bwd.launches
    (tattn.attention(tq, tk, tv, impl="pallas") ** 2).sum().backward()
    assert tattn.flash_attention_bwd.launches == before   # cpu: plain
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=5e-4, rtol=5e-4)


def test_attention_with_lse_grads_through_both_outputs():
    """A loss on out and on lse2: the lse2 cotangent folds into delta, as
    the JAX package's _flash_lse VJP does (its bound, 2e-5)."""
    q, k, v = (_rand(40 + i, (1, 128, 2, 64), 0.4) for i in range(3))

    def jloss(q, k, v):
        out, lse = jattn.attention_with_lse(q, k, v, impl="pallas",
                                            interpret=True, block_q=64,
                                            block_k=32)
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(lse) * lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _leaves(q, k, v)
    out, lse = tattn.attention_with_lse(tq, tk, tv, impl="pallas")
    ((out ** 2).sum() + (torch.sin(lse) * lse).sum()).backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=2e-5)


def test_plain_flash_backward_chunks_queries(monkeypatch):
    """The plain backward walks the queries in chunks; the chunking must
    not change dq, dk or dv."""
    q, k, v, do = (torch.from_numpy(_rand(50 + i, (1, 100, 2, 64), 0.4))
                   for i in range(4))
    out, lse = tattn.xla_attention(q, k, v, with_lse=True)
    whole = tattn.attention_bwd_plain(q, k, v, out, lse, do, scale=0.125)
    monkeypatch.setattr(tattn, "_PLAIN_SCORE_ELEMS", 2 * 100 * 7)
    chunked = tattn.attention_bwd_plain(q, k, v, out, lse, do, scale=0.125)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _mlp_args(m, k=128, f=256):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w1 = (rng.normal(size=(k, f)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(f, k)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(k,)) * 0.1).astype(np.float32)
    wy = rng.normal(size=(m, k)).astype(np.float32)
    return (x, w1, b1, w2, b2), wy


def _jax_grads(fn, args, wy):
    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * wy)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)


def _port_grads(fn, args, wy):
    leaves = _leaves(*args)
    xb = leaves[0].to(torch.bfloat16)
    y = fn(xb, *leaves[1:])
    (y.float() * torch.from_numpy(wy)).sum().backward()
    return y, [t.grad for t in leaves]


@pytest.mark.parametrize("m", [256, 100])
@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_pallas_bwd_pair_matches_jax(m, act):
    """mlp_impl "pallas_bwd" (K5a + K5b through their plain versions)
    against the JAX package's _mlp_fused_tb: the forward and all five
    gradients within 3e-2 of max, db1/db2 against the f32 truth, as
    tests/test_mlp_bwd.py holds the JAX kernels."""
    args, wy = _mlp_args(m)
    bx = (jnp.asarray(args[0]).astype(jnp.bfloat16),) + args[1:]
    ref = jmlp._mlp_fused_tb(*bx, (act, True))
    ref_g = _jax_grads(lambda *a: jmlp._mlp_fused_tb(*a, (act, True)), bx,
                       wy)
    f32_g = _jax_grads(lambda *a: jmlp._mlp_xla(*a, act=act), args, wy)
    before = (tmlp.mlp_train_fused.launches, tmlp.mlp_bwd_fused.launches)
    y, got = _port_grads(
        lambda *a: tmlp.mlp_forward(*a, act=act, impl="pallas_bwd"), args,
        wy)
    assert y.dtype == torch.bfloat16
    assert _rel(y.float(), ref) < 3e-2
    for g, r, f, name in zip(got, ref_g, f32_g,
                             ["dx", "dw1", "db1", "dw2", "db2"]):
        want = f if name in ("db1", "db2") else r
        assert _rel(g.float(), want) < 3e-2, name
    assert got[1].dtype == torch.float32 and got[0].dtype == torch.float32
    assert (tmlp.mlp_train_fused.launches,
            tmlp.mlp_bwd_fused.launches) == before


def test_pallas_bwd_primal_takes_the_no_spill_forward(monkeypatch):
    """Nothing differentiated (no_grad, or no input that needs a
    gradient): "pallas_bwd" runs K6's path, never K5a's."""
    args, _ = _mlp_args(64)
    leaves = _leaves(*args)
    calls = []
    monkeypatch.setattr(tmlp, "mlp_train_fused",
                        lambda *a, **k: calls.append(1))
    with torch.no_grad():
        y = tmlp.mlp_forward(leaves[0].to(torch.bfloat16), *leaves[1:],
                             impl="pallas_bwd")
    assert y.shape == (64, 128) and not calls
    plain = [torch.from_numpy(a) for a in args]
    tmlp.mlp_forward(plain[0].to(torch.bfloat16), *plain[1:],
                     impl="pallas_bwd")
    assert not calls


@pytest.mark.parametrize("block", [False, True])
def test_recompute_backward_matches_jax(block):
    """K6 ("pallas") and K2 (the fused half-block) under autograd: the
    recompute backward against the JAX package's recompute VJPs."""
    args, wy = _mlp_args(128)
    lnw = 1.0 + _rand(60, (128,), 0.1)
    lnb = _rand(61, (128,), 0.1)
    bx = (jnp.asarray(args[0]).astype(jnp.bfloat16),) + args[1:]
    if block:
        def jfn(x, w1, b1, w2, b2):
            return jmlp.mlp_block_forward(x, lnw, lnb, w1, b1, w2, b2,
                                          eps=1e-6, impl="pallas",
                                          interpret=True)

        def tfn(x, w1, b1, w2, b2):
            return tmlp.mlp_block_forward(x, torch.from_numpy(lnw),
                                          torch.from_numpy(lnb), w1, b1, w2,
                                          b2, eps=1e-6, impl="pallas")
    else:
        def jfn(*a):
            return jmlp.mlp_forward(*a, impl="pallas", interpret=True)

        def tfn(*a):
            return tmlp.mlp_forward(*a, impl="pallas")
    want = _jax_grads(jfn, bx, wy)
    _, got = _port_grads(tfn, args, wy)
    for g, w, name in zip(got, want, ["dx", "dw1", "db1", "dw2", "db2"]):
        assert _rel(g.float(), w) < 2e-2, name


def test_int8_and_i8bwd_refuse_autograd():
    """K3 is forward-only and raises under autograd. "pallas_i8bwd" trains
    through K7 (its plain version on the CPU) with the JAX package's
    int8-score gradients, on `attention` and `attention_with_lse`; without
    autograd it runs K1's forward."""
    q, k, v, w = (_rand(70 + i, (1, 64, 2, 64), 0.4) for i in range(4))
    qg = torch.from_numpy(q).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        tattn.attention(qg, qg, qg, impl="pallas_int8")

    def jloss(q, k, v):
        out = jattn.attention(q, k, v, impl="pallas_i8bwd", interpret=True,
                              block_q=64, block_k=64)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for route in ("attention", "attention_with_lse"):
        leaves = _leaves(q, k, v)
        out = getattr(tattn, route)(*leaves, impl="pallas_i8bwd")
        out = out[0] if route == "attention_with_lse" else out
        (out * torch.from_numpy(w)).sum().backward()
        for t, ref in zip(leaves, want):
            assert _rel(t.grad, ref) < 1e-2, route
    with torch.no_grad():
        assert torch.equal(tattn.attention(qg, qg, qg, impl="pallas_i8bwd"),
                           tattn.attention(qg, qg, qg, impl="pallas"))


def test_act_and_grad_match_autograd():
    h = torch.linspace(-6, 6, 301, dtype=torch.float64)
    for act in ("gelu", "gelu_new"):
        hh = h.clone().requires_grad_()
        y = tmlp.act_fn(act)(hh)
        y.sum().backward()
        a, d = tmlp.act_and_grad(h, act)
        np.testing.assert_allclose(a.numpy(), y.detach().float().numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(d.numpy(), hh.grad.float().numpy(),
                                   atol=1e-6)


def test_normalize_pixel_targets_matches_jax():
    x = _rand(80, (2, 7, 48), 3.0) + 1.0
    want = jpatches.normalize_pixel_targets(x)
    got = tpatches.normalize_pixel_targets(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpatches.normalize_pixel_targets(
            np.asarray(torch.from_numpy(x).to(torch.bfloat16).float()))),
        atol=1e-5)
    np.testing.assert_allclose(
        tpatches.normalize_pixel_targets(torch.from_numpy(x)).numpy(),
        np.asarray(want), atol=1e-5)


def test_mim_mask_counts_and_blocks():
    assert tmasking.num_masked_tokens(512, 320, 32, 16, 0.65) == 13312
    assert tmasking.num_masked_tokens(512, 320, 32, 16, 0.65) == \
        jmasking.num_masked_tokens(512, 320, 32, 16, 0.65)
    for args in [(224, 160, 32, 16, 0.65), (64, 64, 16, 16, 0.4),
                 (96, 48, 48, 16, 1.0)]:
        assert tmasking.mim_mask_counts(*args) == \
            jmasking.mim_mask_counts(*args)
    gen = torch.Generator().manual_seed(0)
    m = tmasking.mim_mask(gen, 3, input_size=128, depth=64,
                          mask_patch_size=32, model_patch_size=16,
                          mask_ratio=0.65)
    assert m.shape == (3, 4 * 8 * 8) and m.dtype == torch.bool
    assert (m.sum(1) == tmasking.num_masked_tokens(128, 64, 32, 16,
                                                   0.65)).all()
    # every 2x2x2 block of model patches is masked as a whole
    blocks = m.reshape(3, 2, 2, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4, 6)
    blocks = blocks.reshape(3, 2 * 4 * 4, 8)
    assert bool((blocks.all(-1) | ~blocks.any(-1)).all())
    again = tmasking.mim_mask(torch.Generator().manual_seed(0), 3,
                              input_size=128, depth=64, mask_patch_size=32,
                              model_patch_size=16, mask_ratio=0.65)
    assert torch.equal(m, again)
    for bad, match in [((100, 64, 32, 16, 0.5), "divisible"),
                       ((128, 64, 24, 16, 0.5), "divisible"),
                       ((128, 64, 32, 16, 1.5), r"\(0, 1\]")]:
        with pytest.raises(ValueError, match=match):
            tmasking.mim_mask_counts(*bad)
