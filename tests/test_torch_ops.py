"""The PyTorch port's ops against the JAX package on the CPU: attention and
MLP (the plain versions that stand beside kernels K1, K2, K3, K6 and K8),
patches and the sincos table. The JAX side runs its Pallas kernels in
interpret mode, as its own tests do. Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu.ops import mlp as jmlp
from smb_vision_tpu.ops import patches as jpatches
from smb_vision_tpu_torch.ops import attention as tattn
from smb_vision_tpu_torch.ops import attn_glue as tglue
from smb_vision_tpu_torch.ops import mlp as tmlp
from smb_vision_tpu_torch.ops import patches as tpatches

torch.set_num_threads(1)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qkv(seed, b=1, n=128, h=2, d=64):
    """q, k, v ~ N(0, 0.4^2), the JAX attention tests' distribution."""
    return [_rand(seed + i, (b, n, h, d), 0.4) for i in range(3)]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _from_bf16(x):
    """numpy f32 values of a bf16 torch tensor, for JAX (same values)."""
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_attention_f32_matches_xla(with_bias):
    q, k, v = _qkv(0, b=2, n=96, h=3, d=32)
    bias = _rand(7, (1, 3, 96, 96)) if with_bias else None
    ref = jattn.xla_attention(q, k, v, bias=bias)
    out = tattn.xla_attention(
        *map(torch.from_numpy, (q, k, v)),
        bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_plain_attention_chunks_queries(monkeypatch):
    """The plain version processes queries in chunks; the chunking must not
    change the result."""
    q, k, v = map(torch.from_numpy, _qkv(1, n=100))
    whole = tattn.xla_attention(q, k, v, with_lse=True)
    monkeypatch.setattr(tattn, "_PLAIN_SCORE_ELEMS", 2 * 100 * 7)
    assert tattn._plain_chunk(1, 2, 100) == 7
    chunked = tattn.xla_attention(q, k, v, with_lse=True)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("n", [256, 100])
def test_attention_bf16_matches_pallas_kernel(n):
    """K1's plain version in bf16 against the JAX flash kernel (interpret),
    at an aligned and a ragged length."""
    q, k, v = (_bf16(x) for x in _qkv(2, n=n))
    ref = jattn.attention(*map(_from_bf16, (q, k, v)), impl="pallas",
                          interpret=True, block_q=64, block_k=64)
    before = tattn.flash_attention.launches
    out = tattn.attention(q, k, v, impl="pallas")
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out.float(), ref) < 1e-2
    assert tattn.flash_attention.launches == before   # cpu: plain version


@pytest.mark.parametrize("n", [256, 100])
def test_attention_with_lse_matches_pallas_kernel(n):
    q, k, v = (_bf16(x) for x in _qkv(3, n=n))
    ref, ref_lse = jattn.attention_with_lse(
        *map(_from_bf16, (q, k, v)), impl="pallas", interpret=True,
        block_q=64, block_k=64)
    out, lse = tattn.attention_with_lse(q, k, v, impl="pallas")
    assert lse.shape == (1, 2, n) and lse.dtype == torch.float32
    assert _rel(out.float(), ref) < 1e-2
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-2)


def test_attention_with_lse_xla_f32():
    q, k, v = _qkv(4, n=64)
    ref, ref_lse = jattn.attention_with_lse(q, k, v, impl="xla")
    out, lse = tattn.attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                        impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5)


@pytest.mark.parametrize("n", [256, 100])
def test_int8_attention_matches_pallas_int8_kernel(n):
    """K3's plain version (same quantisation, exact integer scores)
    against the JAX int8-score kernel (interpret)."""
    q, k, v = (_bf16(x) for x in _qkv(5, n=n))
    ref = jattn.attention(*map(_from_bf16, (q, k, v)), impl="pallas_int8",
                          interpret=True, block_q=64, block_k=64)
    out = tattn.attention(q, k, v, impl="pallas_int8")
    assert _rel(out.float(), ref) < 1e-2
    f32 = jattn.xla_attention(*(x.float().numpy() for x in (q, k, v)))
    assert _rel(out.float(), f32) < 2e-2


@pytest.mark.parametrize("n", [256, 100])
def test_int8pv_attention_matches_pallas_int8pv_kernel(n):
    """K8's plain version (int8 scores and int8 p v, p requantised per
    64-key sub-block) against the JAX kernel (interpret, block_k 64, so its
    sub-block is 64 too): within 1e-2 of max, and within 3e-2 of float32
    attention, the JAX package's own bound for this impl."""
    q, k, v = (_bf16(x) for x in _qkv(7, n=n))
    ref = jattn.attention(*map(_from_bf16, (q, k, v)), impl="pallas_int8pv",
                          interpret=True, block_q=64, block_k=64)
    before = tattn.flash_attention_int8pv.launches
    out = tattn.attention(q, k, v, impl="pallas_int8pv")
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert tattn.flash_attention_int8pv.launches == before  # cpu: plain
    assert _rel(out.float(), ref) < 1e-2
    f32 = jattn.xla_attention(*(x.float().numpy() for x in (q, k, v)))
    assert _rel(out.float(), f32) < 3e-2


def test_int8pv_kernel_layout_of_v():
    """The v8 layout K8 reads: (B, H, D, N_pad), zeros past N, and within
    each 32 keys key half*16 + hi*8 + 2t + lo at half*16 + 4t + 2hi + lo."""
    n = 100
    v8 = torch.arange(n, dtype=torch.int64).reshape(1, n, 1, 1) \
        .expand(1, n, 2, 3) % 127
    vt = tattn.quantize_v_kernel_layout(v8.to(torch.int8))
    assert vt.shape == (1, 2, 3, 128) and vt.is_contiguous()
    for pos in range(128):
        half, t, hi, lo = pos // 16 % 2, pos % 16 // 4, pos % 4 // 2, pos % 2
        key = pos // 32 * 32 + half * 16 + hi * 8 + 2 * t + lo
        want = key % 127 if key < n else 0
        assert int(vt[0, 1, 2, pos]) == want, pos


def _tma_case(name):
    """A bf16 (B, N, H, D) tensor as K1 and K4 receive it, or an int8 one
    as K3 and K7 receive their quantised operands."""
    if name == "contiguous":
        return torch.zeros(2, 100, 3, 64, dtype=torch.bfloat16)
    if name == "ragged_d128":
        return torch.zeros(1, 1961, 8, 128, dtype=torch.bfloat16)
    if name.startswith("fused_"):   # q, k or v of one (B, N, 3, H, D)
        qkv = torch.zeros(2, 96, 3, 4, 64, dtype=torch.bfloat16)
        return qkv.unbind(2)["qkv".index(name[-1])]
    if name == "int8_d64":          # leg B's q8 and k8
        return torch.zeros(1, 20480, 12, 64, dtype=torch.int8)
    if name == "int8_d128":         # the V-JEPA encoder's
        return torch.zeros(1, 9216, 8, 128, dtype=torch.int8)
    if name == "int8_ragged":
        return torch.zeros(2, 1961, 3, 64, dtype=torch.int8)
    if name == "d32":               # the reference-head predictor's q
        return torch.zeros(1, 9216, 12, 32, dtype=torch.bfloat16)
    if name == "d32_fused":
        return torch.zeros(2, 96, 3, 4, 32, dtype=torch.bfloat16)[:, :, 1]
    if name == "int8_d32":          # its q8, k8, v8 and do8 in K7
        return torch.zeros(1, 9216, 12, 32, dtype=torch.int8)
    raise KeyError(name)


# the box's columns and swizzle bytes: 64 bf16 columns in the 128-byte
# swizzle (a whole row of 32 in the 64-byte one at d 32); a whole int8 row
# of 32, 64 or 128 bytes in the swizzle of its width
_TMA_BOX = {"int8_d64": (64, 64), "int8_d128": (128, 128),
            "int8_ragged": (64, 64), "d32": (32, 64), "d32_fused": (32, 64),
            "int8_d32": (32, 32)}


@pytest.mark.parametrize("name,rows,dims,strides", [
    ("contiguous", 128, (64, 3, 100, 2), (128, 384, 38400)),
    ("ragged_d128", 64, (128, 8, 1961, 1), (256, 2048, 16)),
    ("fused_q", 128, (64, 4, 96, 2), (128, 1536, 147456)),
    ("fused_k", 64, (64, 4, 96, 2), (128, 1536, 147456)),
    ("fused_v", 32, (64, 4, 96, 2), (128, 1536, 147456)),
    ("int8_d64", 128, (64, 12, 20480, 1), (64, 768, 16)),
    ("int8_d128", 32, (128, 8, 9216, 1), (128, 1024, 16)),
    ("int8_ragged", 64, (64, 3, 1961, 2), (64, 192, 376512)),
    ("d32", 128, (32, 12, 9216, 1), (64, 768, 16)),
    ("d32_fused", 64, (32, 4, 96, 2), (64, 768, 73728)),
    ("int8_d32", 64, (32, 12, 9216, 1), (32, 384, 16)),
])
def test_tma_geometry(name, rows, dims, strides):
    """The tensor map the wgmma kernels encode: dims (D, H, N, B), the byte
    strides of H, N and B (16 for a dim of size 1), box (cols, 1, rows, 1)
    and the swizzle. The fused-qkv slices keep their strides: no copy is
    made for TMA."""
    t = _tma_case(name)
    cols, swizzle = _TMA_BOX.get(name, (64, 128))
    geo = tattn._tma_geometry(t, rows)
    assert geo == {"dims": dims, "strides": strides,
                   "box": (cols, 1, rows, 1), "swizzle": swizzle}
    if "fused" in name:
        assert not t.is_contiguous()


def test_tma_geometry_refuses_misaligned_views():
    x = torch.zeros(1, 64, 3, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tattn._tma_geometry(x[..., :64], 64)      # 136-byte head stride
    y = torch.zeros(1, 65, 2, 64, dtype=torch.bfloat16).flatten()
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        tattn._tma_geometry(y[1:1 + 64 * 2 * 64].view(1, 64, 2, 64), 64)
    # a bf16 head width K1 does not read in place: no multiple of 8 (the
    # wrappers pad it first), or past 128
    for d in (100, 136):
        with pytest.raises(ValueError, match="multiple of 8 up to 128"):
            tattn._tma_geometry(torch.zeros(1, 8, 2, d,
                                            dtype=torch.bfloat16), 64)
    with pytest.raises(ValueError, match="multiples of 16"):
        tattn._tma_geometry(x[..., :32], 64)      # d 32, the same stride
    with pytest.raises(ValueError, match="box rows"):
        tattn._tma_geometry(torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16),
                            512)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tma_geometry_refuses_misaligned_int8_views(d):
    """What the int8 maps of K3 and K7 cannot take raises before a launch:
    a head stride that is no multiple of 16 bytes, a base off 16 bytes, a
    row of another width than 32, 64 or 128 bytes, more than 256 box
    rows."""
    x = torch.zeros(1, 64, 3, d + 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 16"):
        tattn._tma_geometry(x[..., :d], 64)       # (d + 8)-byte head stride
    y = torch.zeros(1, 65, 2, d, dtype=torch.int8).flatten()
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        tattn._tma_geometry(y[4:4 + 64 * 2 * d].view(1, 64, 2, d), 64)
    with pytest.raises(ValueError, match="D in"):
        tattn._tma_geometry(torch.zeros(1, 8, 2, d - 16, dtype=torch.int8),
                            64)
    with pytest.raises(ValueError, match="D in"):
        tattn._tma_geometry(torch.zeros(2, 8, 2, 2 * d, 2,
                                        dtype=torch.int8)[..., 0], 64)
    with pytest.raises(ValueError, match="box rows"):
        tattn._tma_geometry(torch.zeros(1, 8, 2, d, dtype=torch.int8), 257)
    with pytest.raises(TypeError, match="bfloat16 or int8"):
        tattn._tma_geometry(torch.zeros(1, 8, 2, d), 64)


def test_attention_impl_names():
    q, k, v = (_bf16(x) for x in _qkv(6, n=16))
    # K8 runs (its plain version on the CPU) and, like K3, has no backward
    out = tattn.attention(q, k, v, impl="pallas_int8pv")
    assert out.shape == q.shape and bool(out.float().isfinite().all())
    with pytest.raises(RuntimeError, match="forward-only"):
        tattn.attention(q.requires_grad_(), k, v, impl="pallas_int8pv")
    q = q.detach()
    # the int8-forward spellings coerce to K1 where lse2 is wanted
    a, la = tattn.attention_with_lse(q, k, v, impl="pallas_int8pv")
    b, lb = tattn.attention_with_lse(q, k, v, impl="pallas")
    assert torch.equal(a, b) and torch.equal(la, lb)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="pallas_int8_pv")
    with pytest.raises(NotImplementedError, match="bias"):
        tattn.attention(q, k, v, impl="pallas",
                        bias=torch.zeros(1, 2, 16, 16))
    a = tattn.attention(q, k, v, impl="pallas_i8bwd")
    b = tattn.attention(q, k, v, impl="auto")
    assert torch.equal(a, b)
    # auto takes K1 (and K4 under autograd) only where it maps: bf16, no
    # bias, any head width up to 128
    assert tattn._auto_impl(q, None) == "pallas"
    assert tattn._auto_impl(q, torch.zeros(1, 2, 16, 16)) == "xla"
    assert tattn._auto_impl(q.float(), None) == "xla"
    assert tattn._auto_impl(q[..., :32], None) == "pallas"
    assert tattn._auto_impl(q[..., :16], None) == "pallas"
    wide = torch.zeros(1, 16, 2, 136, dtype=torch.bfloat16)
    assert tattn._auto_impl(wide, None) == "xla"


def _mlp_params(k=128, f=512):
    w1, b1 = _rand(11, (k, f), k ** -0.5), _rand(12, (f,), 0.1)
    w2, b2 = _rand(13, (f, k), f ** -0.5), _rand(14, (k,), 0.1)
    lnw, lnb = 1.0 + _rand(15, (k,), 0.1), _rand(16, (k,), 0.1)
    return lnw, lnb, w1, b1, w2, b2


def test_mlp_block_matches_pallas_kernel():
    """K2's plain version against the JAX half-block kernel (interpret) at
    K = 128, F = 512 and 256 rows (the kernel's 128-row rule)."""
    x = _bf16(_rand(10, (2, 128, 128)))
    lnw, lnb, w1, b1, w2, b2 = _mlp_params()
    ref = jmlp.mlp_block_forward(_from_bf16(x), lnw, lnb, w1, b1, w2, b2,
                                 eps=1e-12, impl="pallas", interpret=True)
    out = tmlp.mlp_block_forward(x, *map(torch.from_numpy,
                                         (lnw, lnb, w1, b1, w2, b2)),
                                 eps=1e-12, impl="pallas")
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert _rel(out.float(), ref) < 8e-3


@pytest.mark.parametrize("impl", ["pallas", "pallas_bwd"])
def test_mlp_matches_pallas_kernel(impl):
    """K6's plain version against the JAX MLP kernel (interpret);
    'pallas_bwd' runs the same no-spill forward when not differentiated."""
    x = _bf16(_rand(20, (256, 128)))
    _, _, w1, b1, w2, b2 = _mlp_params()
    ref = jmlp.mlp_forward(_from_bf16(x), w1, b1, w2, b2, impl=impl,
                           interpret=True)
    before = tmlp.mlp_fused.launches
    out = tmlp.mlp_forward(x, *map(torch.from_numpy, (w1, b1, w2, b2)),
                           impl=impl)
    assert _rel(out.float(), ref) < 8e-3
    assert tmlp.mlp_fused.launches == before


def test_mlp_xla_f32_matches():
    x = _rand(21, (2, 24, 128))
    lnw, lnb, w1, b1, w2, b2 = _mlp_params()
    ref = jmlp.mlp_block_forward(x, lnw, lnb, w1, b1, w2, b2, eps=1e-6,
                                 impl="xla")
    out = tmlp.mlp_block_forward(*map(torch.from_numpy,
                                      (x, lnw, lnb, w1, b1, w2, b2)),
                                 eps=1e-6, impl="auto")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    ref = jmlp.mlp_forward(x, w1, b1, w2, b2, act="gelu_new", impl="xla")
    out = tmlp.mlp_forward(*map(torch.from_numpy, (x, w1, b1, w2, b2)),
                           act="gelu_new", impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_mlp_impl_routing():
    x = torch.zeros(4, 96, dtype=torch.bfloat16)
    w1, b1 = torch.zeros(96, 64), torch.zeros(64)
    w2, b2 = torch.zeros(64, 96), torch.zeros(96)
    with pytest.raises(ValueError, match="cannot map"):
        tmlp.mlp_forward(x, w1, b1, w2, b2, impl="pallas")
    with pytest.raises(ValueError, match="unknown mlp impl"):
        tmlp.mlp_block_forward(x, torch.ones(96), b2, w1, b1, w2, b2,
                               impl="pallas_bwd")
    assert tmlp.mlp_forward(x, w1, b1, w2, b2).shape == x.shape   # auto
    assert tmlp.kernel_maps(768, 3072, "gelu")
    assert not tmlp.kernel_maps(768, 3000, "gelu")
    assert not tmlp.kernel_maps(768, 3072, "relu")


@pytest.mark.parametrize("m", [1, 63, 129, 20480, 32768, 32769, 33792,
                               81920, 100000])
def test_mlp_chunk_rows(m):
    """The MLP forward's row chunks: one chunk up to the cap; past it the
    fewest chunks that fit under the cap, all of near-equal size and whole
    128-row tiles but the last, so the workspace stays bounded."""
    cap = tmlp._CHUNK_ROWS
    rows = tmlp.mlp_chunk_rows(m)
    chunks = -(-m // rows)
    assert 1 <= rows <= min(m, cap)
    assert chunks == -(-m // cap)
    if chunks == 1:
        assert rows == m
    else:
        assert rows % 128 == 0 and m - (chunks - 1) * rows > 0
        assert rows - (m - (chunks - 1) * rows) < 128 * chunks


@pytest.mark.parametrize("m,k,f,ln", [(3922, 1536, 4096, True),
                                      (1961, 1536, 4096, True),
                                      (33792, 256, 160, True),
                                      (81920, 768, 3072, False)])
def test_mlp_workspace(m, k, f, ln):
    """The workspaces the MLP wrappers hand K2, K6, K5a and K9: a bf16
    (chunk, F) one for the activation (K9: the gate) and, with the
    LayerNorm prologue, a bf16 (chunk, K) one for LN(x), where chunk is
    mlp_chunk_rows(M), so neither grows past the cap."""
    chunk, ws, xn = tmlp._mlp_workspace(m, k, f, ln, "cpu")
    assert chunk == tmlp.mlp_chunk_rows(m) <= tmlp._CHUNK_ROWS
    assert ws.shape == (chunk, f) and ws.dtype == torch.bfloat16
    if ln:
        assert xn.shape == (chunk, k) and xn.dtype == torch.bfloat16
    else:
        assert xn is None


@pytest.mark.parametrize("m,k,chunks", [(20480, 768, 1), (40960, 384, 1),
                                        (6000, 2816, 2), (81920, 768, 4)])
def test_glue_workspace(m, k, chunks):
    """The workspace the glue wrapper hands K10a for LN(x): bf16 (chunk, K)
    with chunk = glue_chunk_rows(M, K), never past the byte cap: one chunk
    at the embed shape and the MIM decoder at batch 2, two at K 2,816,
    four for leg G's batch 4; past one chunk, whole 128-row tiles."""
    chunk, xn = tglue._glue_workspace(m, k, "cpu")
    assert chunk == tglue.glue_chunk_rows(m, k)
    assert xn.shape == (chunk, k) and xn.dtype == torch.bfloat16
    assert -(-m // chunk) == chunks
    assert xn.numel() * 2 <= tglue._WS_BYTES
    if chunks > 1:
        assert chunk % 128 == 0


@pytest.mark.parametrize("channel_major", [True, False])
def test_extract_patches_exact(channel_major):
    px = _rand(30, (2, 8, 3, 8, 12))
    ref = jpatches.extract_patches(px, 4, 4, channel_major=channel_major)
    out = tpatches.extract_patches(torch.from_numpy(px), 4, 4,
                                   channel_major=channel_major)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_patch_embed_matches():
    px = _rand(31, (2, 16, 1, 32, 32))
    kern, bias = _rand(32, (24, 1, 16, 16, 16), 0.02), _rand(33, (24,))
    ref = jpatches.patch_embed(px, kern, bias, dtype=jnp.float32)
    out = tpatches.patch_embed(*map(torch.from_numpy, (px, kern, bias)),
                               dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n,d", [(20480, 768), (64, 32)])
def test_sincos_table_exact(n, d):
    ref = np.asarray(jpatches.sincos_position_table(n, d))
    out = tpatches.sincos_position_table(n, d)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
