"""Context parallelism on the port: `context_parallel_attention` (k and v
gathered) and `ring_attention` (k and v rotating, merged by their lse2)
on 4 gloo ranks as the model axis, against the JAX package's dense
attention and its gradients on the same inputs: every case of
tests/test_context_parallel.py, and a token count the axis does not
divide (uneven shards)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.ops.attention import xla_attention

torch.set_num_threads(1)

B, N, H, D = 2, 64, 4, 32
N_UNEVEN = 61        # 16, 15, 15, 15 tokens over 4 ranks
RUNS = [("gather", "context_parallel_attention", "xla", N),
        ("ring", "ring_attention", "auto", N),
        ("ring_pallas", "ring_attention", "pallas", N),
        ("gather_uneven", "context_parallel_attention", "xla", N_UNEVEN),
        ("ring_uneven", "ring_attention", "pallas", N_UNEVEN)]


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal((B, N, H, D)) * 0.5).astype(np.float32)
            for k in "qkv"}


@pytest.fixture(scope="module")
def port(qkv, tmp_path_factory):
    return W.run_ranks("context", 4, dict(qkv, runs=RUNS),
                       tmp_path_factory.mktemp("context"))


def _dense(qkv, n):
    """The JAX package's dense attention on the first n tokens, and the
    gradients of sum(out ** 2)."""
    q, k, v = (jnp.asarray(qkv[x][:, :n]) for x in "qkv")
    out = xla_attention(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(xla_attention(q, k, v) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_context_parallel_matches_dense(port, qkv):
    out, _ = _dense(qkv, N)
    np.testing.assert_allclose(port["gather"]["out"], out, atol=2e-5,
                               rtol=2e-5)


def test_ring_attention_matches_dense(port, qkv):
    out, _ = _dense(qkv, N)
    np.testing.assert_allclose(port["ring"]["out"], out, atol=3e-5,
                               rtol=3e-5)


def test_ring_attention_grad_flows(port, qkv):
    """The gather variant's gradient of q (the JAX test's case)."""
    _, grads = _dense(qkv, N)
    np.testing.assert_allclose(port["gather"]["q"], grads[0], atol=5e-5,
                               rtol=5e-5)


def test_ring_attention_grads_match_dense(port, qkv):
    _, grads = _dense(qkv, N)
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(port["ring"][name], g, atol=1e-4,
                                   rtol=1e-4)


def test_ring_attention_pallas_path_matches_dense(port, qkv):
    """The ring on the kernel route (K1 with its lse2; the plain version
    on the CPU) merges exactly to dense attention."""
    out, _ = _dense(qkv, N)
    np.testing.assert_allclose(port["ring_pallas"]["out"], out, atol=3e-5,
                               rtol=3e-5)


def test_ring_attention_pallas_grads_match_dense(port, qkv):
    """Training through the kernel route: the backward (K4's plain
    version) takes each block's lse2 cotangent."""
    _, grads = _dense(qkv, N)
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(port["ring_pallas"][name], g, atol=1e-4,
                                   rtol=1e-4)


def test_ring_attention_uses_flash_wrapper(port):
    """Every ring block goes through attention_with_lse (the kernel entry
    point): one a ring position on every rank, no other route."""
    assert port["ring"]["calls"] == [4, 4, 4, 4]
    assert port["ring_pallas"]["calls"] == [4, 4, 4, 4]
    assert port["gather"]["calls"] == [0, 0, 0, 0]


@pytest.mark.parametrize("name", ["gather_uneven", "ring_uneven"])
def test_uneven_token_shards_match_dense(port, qkv, name):
    """61 tokens over 4 ranks (16, 15, 15, 15): the kernels take ragged
    shards, no key is padded; output and gradients as dense attention's.
    A split that leaves a rank no token is refused."""
    out, grads = _dense(qkv, N_UNEVEN)
    np.testing.assert_allclose(port[name]["out"], out, atol=3e-5, rtol=3e-5)
    for x, g in zip("qkv", grads):
        np.testing.assert_allclose(port[name][x], g, atol=1e-4, rtol=1e-4)
    assert "no token" in port["refusal"]
