"""W8A8 (quant8) on the port against the JAX package on the CPU: the row
quantisation and the product bit for bit against the jitted JAX
`w8a8_dot` (the CLI's route; eager JAX rounds some scales differently),
QuantLinear, Attention, Mlp and Block with quant8 against the JAX modules
on the same weights, a tiny quant8 VideoMAE against the JAX one, and the
routes' refusals under autograd. The kernels' own tests are the card
tests of tests/test_torch_kernels.py. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.layers import Attention as JAttention
from smb_vision_tpu.models.layers import Block as JBlock
from smb_vision_tpu.models.layers import Mlp as JMlp
from smb_vision_tpu.models.layers import QuantDense
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.ops.quant import w8a8_dot as jw8a8_dot
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models import layers as L
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.videomae import VideoMAEModel
from smb_vision_tpu_torch.ops import quant as Q
from smb_vision_tpu_torch.ops.attention import INV127

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@jax.jit
def _jax_quantize_rows(x):
    """The activation quantisation of the JAX `w8a8_dot`
    (smb_vision_tpu/ops/quant.py, its three lines for x) under jit: the
    codes and scales that `w8a8_dot` itself does not return."""
    x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    sx = jnp.max(jnp.abs(x2), axis=1, keepdims=True) / 127.0
    sx = jnp.where(sx == 0, 1.0, sx)
    return jnp.clip(jnp.round(x2 / sx), -127, 127).astype(jnp.int8), sx[:, 0]


def _rows(seed, m, k):
    """(m, k) f32 rows ~ N(0, 1) with an all-zero row (3) and a row (7)
    whose max is 127, so that its scale is exactly 1 and 0.5, 1.5, -2.5
    sit on exact ties of the rounding."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)
    x[3] = 0.0
    x[7] = 0.0
    x[7, :4] = [127.0, 0.5, 1.5, -2.5]
    return x


def _on(x, name):
    """x on the grid of dtype `name`: (jax array, torch tensor), the same
    values."""
    jdt, tdt = DTYPES[name]
    jx = jnp.asarray(x).astype(jdt)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k", [(257, 96), (129, 768)])
def test_quantize_rows_plain_matches_jax_jit(m, k, dtype):
    """Codes and scales bit for bit at ragged rows, K 96 and 768, bf16 and
    f32 inputs, an all-zero row (scale 1, codes 0) and exact ties (to
    even); with kpad, zeros past K."""
    jx, tx = _on(_rows(m + k, m, k), dtype)
    want8, want_s = map(np.asarray, _jax_quantize_rows(jx))
    x8, s = Q.quantize_rows_plain(tx)
    assert x8.dtype == torch.int8 and x8.shape == (m, k)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(x8.numpy(), want8)
    assert float(s[3]) == 1.0 and not x8[3].any()
    assert float(s[7]) == float(np.float32(127.0) * np.float32(INV127)) == 1.0
    assert x8[7, :4].tolist() == [127, 0, 2, -2]
    padded, s2 = Q.quantize_rows_plain(tx, Q.padded_k(k + 1))
    assert padded.shape == (m, Q.padded_k(k + 1)) and torch.equal(s2, s)
    assert torch.equal(padded[:, :k], x8) and not padded[:, k:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(257, 96, 40), (129, 768, 64)])
def test_w8a8_dot_plain_matches_jax_jit(m, k, n, dtype):
    """`w8a8_dot` on the CPU (the plain versions) against jax.jit of the
    JAX `w8a8_dot`, bit for bit: the same rows, an all-zero weight column
    (scale 1) and a weight column with exact ties."""
    jx, tx = _on(_rows(m * k, m, k), dtype)
    w = (np.random.default_rng(n).standard_normal((k, n)) * 0.05).astype(
        np.float32)
    w[:, 5] = 0.0
    w[:, 6] = 0.0
    w[:4, 6] = [127.0, 0.5, 1.5, -2.5]
    want = np.asarray(jax.jit(jw8a8_dot)(jx, jnp.asarray(w)).astype(
        jnp.float32))
    before = (Q.quantize_rows_kernel.launches, Q.w8a8_gemm_kernel.launches)
    got = Q.w8a8_dot(tx, torch.from_numpy(np.ascontiguousarray(w.T)))
    assert got.dtype == tx.dtype and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[:, 5].any() and not got[3].any()
    assert (Q.quantize_rows_kernel.launches,
            Q.w8a8_gemm_kernel.launches) == before   # cpu: plain versions
    # the same product from the codes, through the GEMM's plain version
    x8, sx = Q.quantize_rows_plain(tx)
    w8, sw = Q.quantize_rows_plain(torch.from_numpy(np.ascontiguousarray(
        w.T)))
    assert torch.equal(Q.w8a8_linear_plain(x8, sx, w8, sw, dtype=tx.dtype),
                       got)


def _flax_to_module(jparams, prefix=""):
    """The port's state_dict names of a JAX module's parameters (Dense
    kernels transposed into Linear weights, `scale` -> `weight`)."""
    state = convert.params_from_flax(
        {"params.encoder.layer_0." + prefix + k[len("params."):]: v
         for k, v in flatten_params(jparams).items()})
    cut = len("encoder.layer_0." + prefix)
    return {k[cut:]: v for k, v in state.items()}


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [True, False])
def test_quant_linear_matches_quant_dense(dtype, bias):
    """QuantLinear against the jitted JAX QuantDense on the same weights
    and a (2, 33, 96) input: bit for bit, the bias added in the compute
    dtype after the product's rounding; but in float32 with a bias, where
    XLA contracts the dequantisation and the bias add into one FMA: there
    the two differ by that one rounding, an ulp of the product (2^-23 of
    max). Its parameters are Linear's (the checkpoint names do not change)
    and its weight codes are quantised once and again after the weight
    changes."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal((2, 33, 96)).astype(
        np.float32)
    jmod = QuantDense(40, use_bias=bias, dtype=jdt)
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(jmod.apply)(params, x).astype(jnp.float32))
    lin = L.QuantLinear(96, 40, bias, tdt)
    assert set(lin.state_dict()) == set(
        L.Linear(96, 40, bias, tdt).state_dict())
    flat = flatten_params(params)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(np.asarray(flat["params.kernel"]).T)))
        if bias:
            lin.bias.copy_(torch.from_numpy(np.array(flat["params.bias"])))
        got = lin(torch.from_numpy(x))
        assert got.dtype == tdt and got.shape == (2, 33, 40)
        if bias and dtype == "float32":
            assert np.abs(got.numpy() - want).max() <= \
                2.0 ** -23 * np.abs(want).max()
        else:
            np.testing.assert_array_equal(got.float().numpy(), want)
        codes = lin.codes.get((lin.weight,))
        assert lin.codes.get((lin.weight,)) is codes       # kept
        lin.weight.mul_(2.0)                                # bumps _version
        assert lin.codes.get((lin.weight,)) is not codes    # requantised
        again = lin(torch.from_numpy(x))
    assert not torch.equal(again, got)
    # built under inference_mode, its weight counts no versions: quantised
    # at every call, the same result
    with torch.inference_mode():
        inf = L.QuantLinear(96, 40, bias, tdt)
        inf.load_state_dict(lin.state_dict())
        assert inf.weight.is_inference()
        assert torch.equal(inf(torch.from_numpy(x)), again)
        assert inf.codes.get((inf.weight,)) is not \
            inf.codes.get((inf.weight,))


def _attn_pair(x, bias_mode, dtype):
    jdt, tdt = DTYPES[dtype]
    kw = dict(bias_mode=bias_mode, dtype=jdt, attn_impl="xla")
    jparams = _perturbed(jax.jit(JAttention(128, 2, **kw).init)(
        jax.random.PRNGKey(0), x))
    jmod = JAttention(128, 2, quant8=True, **kw)
    mod = L.Attention(128, 2, bias_mode, dtype=tdt, attn_impl="xla",
                      quant8=True)
    mod.load_state_dict(_flax_to_module(jparams, "attention."))
    return jmod, jparams, mod


@pytest.mark.parametrize("bias_mode", ["qv", "qkv", "none"])
def test_attention_quant8_matches_jax(bias_mode):
    """Attention(quant8=True) in float32 against the JAX Attention with
    QuantDense projections on the same weights: q, k and v from one
    quantisation of x and one product on their stacked codes (bit for bit
    the three apart), the output projection on its own. Within 1e-5 of max:
    the two packages differ only where XLA contracts the dequantisation
    and the bias into one FMA, by an ulp that can move a code of the next
    quantisation by one step."""
    x = np.random.default_rng(2).standard_normal((2, 50, 128)).astype(
        np.float32)
    jmod, jparams, mod = _attn_pair(x, bias_mode, "float32")
    want = jax.jit(jmod.apply)(jparams, x)
    before = Q.quantize_rows_kernel.launches
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert _rel(got, want) <= 1e-5
    assert isinstance(mod.query, L.QuantLinear) and \
        isinstance(mod.proj, L.QuantLinear)
    assert Q.quantize_rows_kernel.launches == before


def test_attention_quant8_bf16_and_fused_ignored():
    """In bf16 the JAX Attention's quant8 output within 1e-2 of max (bf16
    rounding of q, k, v and the softmax path); fused_qkv is ignored under
    quant8 in both packages (the same output bit for bit on the port)."""
    x = np.random.default_rng(3).standard_normal((2, 50, 128)).astype(
        np.float32)
    jmod, jparams, mod = _attn_pair(x, "qv", "bfloat16")
    want = jax.jit(jmod.apply)(jparams, x)
    fused = L.Attention(128, 2, "qv", dtype=torch.bfloat16, attn_impl="xla",
                        quant8=True, fused_qkv=True)
    fused.load_state_dict(mod.state_dict())
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
        assert torch.equal(fused(torch.from_numpy(x)), got)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= 1e-2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_quant8_matches_jax(dtype):
    """Mlp(quant8=True) against the JAX Mlp with QuantDense fc1 and fc2:
    the unfused route even under mlp_impl "pallas_bwd" (fc1, gelu, fc2).
    float32 within 1e-5 of max (see the attention test); bf16 within 1e-2
    (the gelu of each package in bf16)."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(4).standard_normal((2, 40, 128)).astype(
        np.float32)
    jparams = _perturbed(jax.jit(JMlp(128, 256, dtype=jdt).init)(
        jax.random.PRNGKey(1), x))
    want = jax.jit(JMlp(128, 256, dtype=jdt, quant8=True,
                        mlp_impl="pallas_bwd").apply)(jparams, x)
    mlp = L.Mlp(128, 256, dtype=tdt, mlp_impl="pallas_bwd", quant8=True)
    mlp.load_state_dict(_flax_to_module(jparams, "mlp."))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    assert got.dtype == tdt
    assert _rel(got.float(), want) <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype,glue", [("float32", "auto"),
                                        ("bfloat16", "pallas")])
def test_block_quant8_matches_jax(dtype, glue):
    """Block(quant8=True) against the JAX Block(quant8=True): neither
    half-block fuses (not the glue, not the MLP block, whatever the impls
    say), the projections on W8A8. float32 within 1e-5 of max, bf16 within
    1e-2."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(5).standard_normal((2, 64, 128)).astype(
        np.float32)
    kw = dict(bias_mode="qv", layerscale_value=0.5)
    jparams = _perturbed(jax.jit(JBlock(128, 2, 256, dtype=jdt,
                                        attn_impl="xla", mlp_impl="xla",
                                        **kw).init)(
        jax.random.PRNGKey(2), x))
    want = jax.jit(JBlock(128, 2, 256, dtype=jdt, attn_impl="xla",
                          mlp_impl="pallas", glue_impl=glue, quant8=True,
                          **kw).apply)(jparams, x)
    block = L.Block(128, 2, 256, dtype=tdt, attn_impl="xla",
                    mlp_impl="pallas", glue_impl=glue, quant8=True, **kw)
    block.load_state_dict(_flax_to_module(jparams))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert _rel(got.float(), want) <= (1e-5 if dtype == "float32" else 1e-2)


def _videomae_pair(**kw):
    base = dict(image_size=32, num_frames=32, patch_size=16,
                tubelet_size=16, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128,
                dtype="float32", attn_impl="xla", **kw)
    jcfg = JConfig(**base)
    params = _perturbed(jax.jit(JModel(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), np.zeros((1, 32, 1, 32, 32), np.float32)))
    model = VideoMAEModel(VideoMAEConfig(**base))
    model.load_state_dict(convert.params_from_flax(flatten_params(params)))
    return JModel(jcfg), params, model.eval()


def test_videomae_quant8_matches_jax():
    """A tiny VideoMAE (2 layers, 64 wide) with quant8 in float32 against
    the JAX one on the same weights: within 1e-4 of max, far inside the
    5e-2 the JAX package allows between quant8 and the unquantised model
    (tests/test_models.py), which the port's quant8 model also keeps from
    its own unquantised one."""
    jmodel, params, model = _videomae_pair(quant8=True)
    px = np.random.default_rng(6).uniform(0, 1, (2, 32, 1, 32, 32)).astype(
        np.float32)
    want, _ = jax.jit(jmodel.apply)(params, px)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(px))
        _, _, plain = _videomae_pair()
        ref, _ = plain(torch.from_numpy(px))
    assert got.shape == (2, 8, 64)
    assert _rel(got, want) <= 1e-4
    assert 0 < _rel(got, ref) < 5e-2


def test_quant8_is_inference_only():
    """Every W8A8 route raises under autograd (the rounding has zero
    gradient almost everywhere), and runs under no_grad."""
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.randn(16, 32)
    lin = L.QuantLinear(32, 16, True, torch.float32)
    attn = L.Attention(32, 2, dtype=torch.float32, attn_impl="xla",
                       quant8=True)
    for call in (lambda: Q.w8a8_dot(x, w), lambda: lin(x.detach()),
                 lambda: attn(x.detach()[None])):
        with pytest.raises(RuntimeError, match="inference-only"):
            call()
    with torch.no_grad():
        assert lin(x).shape == (4, 16)
        assert attn(x[None]).shape == (1, 4, 32)
