"""The forward kernels at every width the JAX kernels take, on the CPU
against the JAX package: K1's plain version (out and lse2) at head widths
past 32 / 64 / 128 (16, 40, 72, 80, and 100, which no kernel reads in
place) against the JAX flash kernel in interpret mode, K3's and K8's
against the JAX `_fwd_i8` in interpret mode at block_k 64 (D1), the plain
version of R6's padded codes against `quantize_per_head` and the JAX
quantisation, K2's, K6's and K9's plain versions at K 1,280 and 2,048
against the JAX kernels in interpret mode, a 2-layer SigLIP at so400m
widths and a 2-layer VideoMAE at ViT-H widths against the JAX models
through the converters, and the routing: "auto" and a forced kernel impl
with and without autograd, `kernel_maps`, the TMA maps. Inputs come from
numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models import convert as jconvert
from smb_vision_tpu.models.configs import SiglipVisionConfig as JSigConfig
from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.siglip import SiglipVisionModel as JSiglip
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu.ops import mlp as jmlp
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import (
    SiglipVisionConfig,
    VideoMAEConfig,
)
from smb_vision_tpu_torch.models.siglip import SiglipVisionModel
from smb_vision_tpu_torch.models.videomae import VideoMAEModel
from smb_vision_tpu_torch.ops import attention as tattn
from smb_vision_tpu_torch.ops import mlp as tmlp

torch.set_num_threads(1)

_BLOCKS = dict(interpret=True, block_q=32, block_k=32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _qkv(seed, n, d, h=2):
    """q, k, v ~ N(0, 0.4^2) f32 (1, n, h, d)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, n, h, d)) * 0.4).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("d", [16, 40, 72, 80, 100])
def test_flash_widths_out_lse_match_jax_pallas(d):
    """K1's route at a head width past the instantiations (its plain
    version on the CPU) against the JAX flash kernel (interpret, block 32;
    d 100 padded to 104 there) at a ragged N: out and lse2 within 5e-4, the
    bound of the d-32 test. Nothing launches on the CPU."""
    q, k, v = _qkv(d, 100, d)
    jout, jlse = jattn.attention_with_lse(q, k, v, impl="pallas", **_BLOCKS)
    before = tattn.flash_attention.launches
    out, lse = tattn.attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                        impl="pallas")
    assert out.shape == (1, 100, 2, d) and lse.shape == (1, 2, 100)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=5e-4,
                               rtol=5e-4)
    assert tattn.flash_attention.launches == before


def _bf16(seed, n, d):
    """q, k, v (1, n, 2, d) ~ N(0, 0.4^2) rounded to bf16: (jax f32 of the
    bf16 values, torch bf16)."""
    out = []
    for a in _qkv(seed, n, d):
        t = torch.from_numpy(a).to(torch.bfloat16)
        out.append((jnp.asarray(t.float().numpy()), t))
    return out


@pytest.mark.parametrize("impl,f32_bound", [("pallas_int8", 2e-2),
                                            ("pallas_int8pv", 3e-2)])
@pytest.mark.parametrize("d", [72, 80])
def test_int8_forwards_widths_match_jax_pallas(impl, f32_bound, d):
    """K3's and K8's plain versions at d 72 and 80 (q8 and k8 in rows of
    the code width each kernel reads, zeros past d: 96 on K3's d-80 tiles,
    128 on K8's d-128 ones) against the JAX `_fwd_i8` (pv False / True) in
    interpret mode at block_k 64, so its sub-block is K8's: within 1e-2 of
    max, the d-32 tests' bound, and within the JAX package's bounds of
    float32 attention."""
    (jq, q), (jk, k), (jv, v) = _bf16(90 + d, 129, d)
    ref = jattn.attention(jq, jk, jv, impl=impl, interpret=True,
                          block_q=64, block_k=64)
    out = tattn.attention(q, k, v, impl=impl)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 129, 2, d)
    assert _rel(out, ref) < 1e-2
    assert _rel(out, jattn.xla_attention(jq, jk, jv)) < f32_bound
    kernel, width = ("K3", 96) if impl == "pallas_int8" else ("K8", 128)
    q8, k8, _, _ = tattn.quantize_qk(q, k, d ** -0.5, kernel=kernel)
    assert q8.shape[-1] == k8.shape[-1] == width


@pytest.mark.parametrize("d", [8, 40, 72, 80, 120])
def test_padded_codes_match_quantize_per_head(d):
    """The plain version of what R6 writes at a head width below its
    instantiation's: the first d columns and the scales bit for bit
    `quantize_per_head`'s and the JAX `_quant_per_head`'s under jit, zeros
    past d; in K8's v layout the first d rows bit for bit the unpadded
    layout's, zero rows past them."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy((rng.standard_normal((2, 75, 3, d)) * 0.7)
                         .astype(np.float32)).to(torch.bfloat16)
    w = tattn._tile_width(d)
    mult = d ** -0.5 * tattn.LOG2E
    x8, s = tattn.quantize_per_head(x, mult)
    p8, ps = tattn.quantize_per_head(x, mult, width=w)
    assert p8.shape == (2, 75, 3, w) and p8.is_contiguous()
    assert torch.equal(ps, s) and torch.equal(p8[..., :d], x8)
    assert not bool(p8[..., d:].any())
    xj = jnp.swapaxes(jnp.asarray(x.float().numpy() * np.float32(mult)),
                      1, 2).reshape(6, 75, d)
    j8, js = jax.jit(jattn._quant_per_head)(xj)
    np.testing.assert_array_equal(
        p8[..., :d].permute(0, 2, 1, 3).reshape(6, 75, d).numpy(),
        np.asarray(j8))
    np.testing.assert_array_equal(s.reshape(6).numpy(),
                                  np.asarray(js).reshape(6))
    vt = tattn.quantize_v_kernel_layout(x8, w)
    assert vt.shape == (2, 3, w, 128)
    assert torch.equal(vt[:, :, :d], tattn.quantize_v_kernel_layout(x8))
    assert not bool(vt[:, :, d:].any())


def _mlp_args(seed, m, k, f):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = np.asarray(r(m, k).astype(jnp.bfloat16)).astype(np.float32)
    return (x, 1.0 + r(k, s=0.1), r(k, s=0.1), r(k, f, s=k ** -0.5),
            r(f, s=0.1), r(f, k, s=f ** -0.5), r(k, s=0.1))


@pytest.mark.parametrize("k,f", [(1280, 512), (2048, 256)])
def test_mlp_widths_match_jax_pallas(k, f):
    """K2's, K6's and K9's routes at K past 1,024 (their plain versions on
    the CPU, bf16) against the JAX kernels in interpret mode at 256 rows:
    within 8e-3 of max (K2, K6), the bound of the K-768 tests, and 5e-3
    (K9, the DINOv2 test's)."""
    x, lnw, lnb, w1, b1, w2, b2 = _mlp_args(k, 256, k, f)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    t = [torch.from_numpy(a) for a in (lnw, lnb, w1, b1, w2, b2)]
    assert tmlp.kernel_maps(k, f, "gelu")
    ref = jmlp.mlp_block_forward(xj, lnw, lnb, w1, b1, w2, b2, eps=1e-6,
                                 impl="pallas", interpret=True)
    out = tmlp.mlp_block_forward(xb, *t, eps=1e-6, impl="pallas")
    assert out.dtype == torch.bfloat16 and _rel(out, ref) < 8e-3
    ref = jmlp.mlp_forward(xj, w1, b1, w2, b2, act="gelu_new",
                           impl="pallas", interpret=True)
    out = tmlp.mlp_forward(xb, t[2], t[3], t[4], t[5], act="gelu_new",
                           impl="pallas")
    assert _rel(out, ref) < 8e-3
    ref = jmlp.mlp_forward(xj, w1, b1, w2, b2, impl="pallas_bwd",
                           interpret=True)
    out = tmlp.mlp_forward(xb, t[2], t[3], t[4], t[5], impl="pallas_bwd")
    assert _rel(out, ref) < 8e-3
    rng = np.random.default_rng(k + 1)
    w_in = (rng.standard_normal((k, 2 * f)) * k ** -0.5).astype(np.float32)
    b_in = (rng.standard_normal(2 * f) * 0.1).astype(np.float32)
    ref = jmlp.swiglu_block_forward(xj, lnw, lnb, w_in, b_in, w2, b2,
                                    eps=1e-6, impl="pallas", interpret=True)
    out = tmlp.swiglu_block_forward(xb, t[0], t[1], torch.from_numpy(w_in),
                                    torch.from_numpy(b_in), t[4], t[5],
                                    eps=1e-6, impl="pallas")
    assert _rel(out, ref) < 5e-3


def test_routing_of_the_new_widths(monkeypatch):
    """"auto" takes K1 at d 72, 80 and 100 with and without a gradient
    (K4's route under autograd) and the plain attention past 128; a forced
    kernel impl trains at those widths (K4's or K7's route); the MLP
    kernels take K 1,280 under autograd too ("pallas", "pallas_bwd", K9's
    "pallas"); `kernel_maps` and the TMA maps of d 72 and 80 (bf16 read in
    place, the box past d reading zeros) and of the padded int8 codes."""
    calls = []

    def counted(name, fn):
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

    for name, label in (("_flash_fwd", "K1"), ("xla_attention", "plain"),
                        ("attention_bwd_plain", "K4"),
                        ("attention_bwd_i8_plain", "K7")):
        monkeypatch.setattr(tattn, name, counted(label,
                                                 getattr(tattn, name)))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 16, 72))
    tattn.attention(q, k, v)
    assert calls == ["K1", "plain"]      # K1's plain version on the CPU
    for d in (72, 80, 100):
        assert tattn._auto_impl(torch.zeros(1, 16, 2, d,
                                            dtype=torch.bfloat16),
                                None) == "pallas"
        calls.clear()
        leaf = torch.zeros(1, 16, 2, d, dtype=torch.bfloat16,
                           requires_grad=True)
        kv = torch.zeros(1, 16, 2, d, dtype=torch.bfloat16)
        tattn.attention(leaf, kv, kv).float().sum().backward()
        assert calls == ["K1", "plain", "K4"] and leaf.grad is not None
    wide = torch.zeros(1, 16, 2, 136, dtype=torch.bfloat16,
                       requires_grad=True)
    assert tattn._auto_impl(wide, None) == "xla"
    calls.clear()
    tattn.attention(wide, wide.detach(), wide.detach()).float().sum() \
        .backward()
    assert calls == ["plain"]
    leaf = q.clone().requires_grad_()
    for impl, bwd in (("pallas", "K4"), ("pallas_i8bwd", "K7")):
        for fn in (tattn.attention, tattn.attention_with_lse):
            calls.clear()
            leaf.grad = None
            out = fn(leaf, k, v, impl=impl)
            (out[0] if isinstance(out, tuple) else out).float().sum() \
                .backward()
            assert calls == ["K1", "plain", bwd] and leaf.grad is not None

    assert tmlp.kernel_maps(1280, 5120, "gelu")
    assert tmlp.auto_routes(1280, 5120, "gelu", torch.bfloat16)
    assert not tmlp.auto_routes(1280, 5120, "gelu", torch.float32)
    assert not tmlp.kernel_maps(1152, 4304, "gelu_new")
    assert not tmlp.kernel_maps(1216, 5120, "gelu")
    assert tmlp.swiglu_kernel_maps(1280, 1024)
    assert tmlp.swiglu_kernel_maps(2048, 5504)
    x = torch.zeros(4, 1280, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(1280, 64), torch.zeros(64, 1280)
    b1, b2 = torch.zeros(64), torch.zeros(1280)
    xg = x.float().requires_grad_()
    y = tmlp.mlp_forward(xg, w1, b1, w2, b2)       # "auto": plain in f32
    assert torch.equal(y, tmlp._mlp_xla(xg, w1, b1, w2, b2, "gelu"))
    for impl in ("pallas", "pallas_bwd"):
        xg.grad = None
        tmlp.mlp_forward(xg, w1, b1, w2, b2, impl=impl).sum().backward()
        assert xg.grad is not None and xg.grad.shape == xg.shape
    xg.grad = None
    tmlp.swiglu_block_forward(xg, torch.ones(1280), torch.zeros(1280),
                              torch.zeros(1280, 128), torch.zeros(128),
                              w2, b2, impl="pallas").sum().backward()
    assert xg.grad is not None

    for d, cols, swz in ((72, 64, 128), (80, 64, 128), (16, 32, 64)):
        t = torch.zeros(1, 729, 16, d, dtype=torch.bfloat16)
        assert tattn._tma_geometry(t, 128) == {
            "dims": (d, 16, 729, 1), "strides": (2 * d, 32 * d, 16),
            "box": (cols, 1, 128, 1), "swizzle": swz}
        # K1 and K4 read heads of 72 and 80 into their tiles of 80
        # columns: a second map of the last 16, in the 32-byte swizzle
        for kernel in ("K1", "K4"):
            tail = {"tail": {"col": 64, "box": (16, 1, 128, 1),
                             "swizzle": 32}} if d > 64 else {}
            assert tattn._tma_geometry(t, 128, kernel) == {
                "dims": (d, 16, 729, 1), "strides": (2 * d, 32 * d, 16),
                "box": (cols, 1, 128, 1), "swizzle": swz, **tail}
            assert tattn._tile_width(d, kernel) == (80 if d > 64 else 32)
        for kernel in ("K3", "K7"):     # their d-80 tiles too
            assert tattn._tile_width(d, kernel) == (80 if d > 64 else 32)
    # K3's codes of a head of 80: rows of 96 bytes, two maps
    q8, k8, _, _ = tattn.quantize_qk(torch.zeros(2, 65, 3, 80),
                                     torch.zeros(2, 65, 3, 80), 0.1)
    assert tattn._tma_geometry(q8, 64) == {
        "dims": (96, 3, 65, 2), "strides": (96, 288, 18720),
        "box": (64, 1, 64, 1), "swizzle": 64,
        "tail": {"col": 64, "box": (32, 1, 64, 1), "swizzle": 32}}


def _so400m_pair():
    """transformers' SiglipVisionModel at so400m-patch14-384's widths
    (hidden 1,152, 16 heads of 72, MLP 4,304, gelu_pytorch_tanh), 2
    layers at image 42 (9 patches of 14), seeded; the port's tower with
    its weights (bf16, "auto") and the JAX tower's params."""
    from transformers import SiglipVisionConfig as HFConfig
    from transformers import SiglipVisionModel as HFModel

    kw = dict(image_size=42, patch_size=14, num_channels=3,
              hidden_size=1152, num_hidden_layers=2, num_attention_heads=16,
              intermediate_size=4304)
    torch.manual_seed(0)
    hf = HFModel(HFConfig(**kw)).eval()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    model = SiglipVisionModel(SiglipVisionConfig(
        dtype="bfloat16", attn_impl="auto", **kw)).eval()
    model.load_state_dict(convert.params_from_flax(
        convert.convert_hf_siglip(state), whole=True))
    return kw, model, jconvert.convert_hf_siglip(state, 2)


def test_siglip_so400m_widths_match_jax():
    """A 2-layer SigLIP at so400m widths in bf16 under "auto": the
    attention on K1's route at d 72, the MLP (F 4,304) and the MAP head
    plain, as in the JAX package; tokens and pooled output within 3e-2 of
    max of the float32 JAX tower running its flash kernel at d 72
    (interpret)."""
    kw, model, params = _so400m_pair()
    x = np.random.default_rng(5).normal(size=(2, 3, 42, 42)).astype(
        np.float32)
    before = tattn.flash_attention.launches
    with torch.no_grad():
        tokens, pooled = model(torch.from_numpy(x))
    assert tattn.flash_attention.launches == before
    assert tokens.shape == (2, 9, 1152) and pooled.shape == (2, 1152)
    jt, jp = JSiglip(JSigConfig(dtype="float32", attn_impl="pallas", **kw)
                     ).apply(params, jnp.asarray(x))
    for got, want in ((tokens, jt), (pooled, jp)):
        assert _rel(got, want) <= 3e-2


@pytest.mark.parametrize("attn_impl,mlp_impl", [
    ("auto", "auto"),                # K1 + K2 routes at d 80, K 1,280
    ("pallas_int8", "pallas_bwd"),   # K3 + K6 routes
    ("pallas_int8pv", "auto"),       # K8 + K2 routes
])
def test_videomae_vit_h_widths_match_jax(attn_impl, mlp_impl):
    """A 2-layer VideoMAE at ViT-H widths (hidden 1,280, 16 heads of 80,
    MLP 5,120) in bf16 on the kernels' routes (their plain versions on the
    CPU) against the JAX model on its kernels in interpret mode ("auto":
    the JAX model forced onto "pallas"), 64^3 volumes of 64 tokens at
    batch 2: within 2e-2 of max, the bound of the ViT-Base test."""
    base = dict(image_size=64, num_frames=64, patch_size=16,
                tubelet_size=16, hidden_size=1280, num_hidden_layers=2,
                num_attention_heads=16, intermediate_size=5120,
                dtype="bfloat16")
    jimpl = dict(attn_impl="pallas" if attn_impl == "auto" else attn_impl,
                 mlp_impl="pallas" if mlp_impl == "auto" else mlp_impl)
    jcfg = JConfig(**base, **jimpl)
    px0 = np.zeros((1, 64, 1, 64, 64), np.float32)
    params = jax.jit(JModel(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), px0)
    model = VideoMAEModel(VideoMAEConfig(**base, attn_impl=attn_impl,
                                         mlp_impl=mlp_impl)).eval()
    model.load_state_dict(convert.params_from_flax(flatten_params(params)))
    px = np.random.default_rng(1).uniform(0, 1, (2, 64, 1, 64, 64)).astype(
        np.float32)
    ref, _ = JModel(jcfg).apply(params, px)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(px))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 1280)
    assert _rel(out, ref) < 2e-2
