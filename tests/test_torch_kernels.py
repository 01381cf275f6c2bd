"""The port's hand-written kernels: import hygiene on any machine, and
parity with their plain PyTorch versions on an NVIDIA Hopper GPU.

This file imports torch only (no JAX), so the card tests run where JAX is
absent; tests/conftest.py imports JAX, hence --noconftest there:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
Without CUDA they skip."""

import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from smb_vision_tpu_torch.ops import _build
from smb_vision_tpu_torch.ops import attention as A
from smb_vision_tpu_torch.ops import mlp as M
from smb_vision_tpu_torch.ops import quant as Q

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _listing(path: Path):
    """The kernel builds under path. The native CT loader's library
    (`ctloader-<hash>/`, data/build_native.py) shares the directory and
    is left out, and a directory not made yet lists as empty: other test
    processes build the loader at their first use while this one runs;
    the import's own loader state is checked instead."""
    return sorted(str(p) for p in path.rglob("*")
                  if not p.relative_to(path).parts[0].startswith(
                      "ctloader-")) if path.exists() else []


def test_port_imports_neither_jax_nor_the_jax_package_nor_builds():
    """Every module of smb_vision_tpu_torch imports in a process where
    `import jax` fails; afterwards neither jax nor smb_vision_tpu is
    loaded, and no kernel and no native loader was built or loaded."""
    code = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        for name in [k for k in sys.modules if k.split(".")[0] == "jax"]:
            del sys.modules[name]
        sys.modules["jax"] = None
        import smb_vision_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from smb_vision_tpu_torch.ops import _build
        from smb_vision_tpu_torch.data import native
        print(json.dumps({
            "native": [native._lib is not None, native._error is not None],
            "names": names,
            "jax": sorted(k for k, v in sys.modules.items()
                          if k.split(".")[0] == "jax" and v is not None),
            "jax_package": sorted(k for k in sys.modules
                                  if k.split(".")[0] == "smb_vision_tpu"),
            "lib_loaded": _build._lib is not None}))
    """)
    before = _listing(_build.BUILD_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("cli.run_inference", "cli.run_mim", "cli.run_vjepa",
                 "cli.run_classification", "models.dinov2", "models.vjepa",
                 "ops._build", "ops.masking", "ops.rope3d",
                 "train.classification", "train.losses", "train.metrics",
                 "train.mim", "train.optim", "train.trainer", "train.vjepa",
                 "utils.profiling", "train.lora", "train.quantized",
                 "models.siglip", "models.resnet3d", "data.image2d",
                 "inference.encoders", "cli.run_encoders", "ops.quant"):
        assert f"smb_vision_tpu_torch.{name}" in seen["names"]
    assert seen["jax"] == [] and seen["jax_package"] == []
    assert not seen["lib_loaded"]
    assert seen["native"] == [False, False]
    assert _listing(_build.BUILD_ROOT) == before


def test_build_key_tracks_sources():
    key = _build.build_key()
    assert len(key) == 16 and key == _build.build_key()
    assert _build.build_dir().parent == _build.BUILD_ROOT
    for name in _build.SOURCES:
        assert (_build.CSRC / name).is_file()


def test_wrappers_reject_unsupported_devices():
    x = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        A.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        M.mlp_fused(torch.zeros(4, 128, device="meta"), None, None, None,
                    None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    assert bool(out.isfinite().all())
    return float((out - ref).abs().max() / ref.abs().max())


# the wgmma kernels' tile edges (64-row warpgroups, 64- and 128-key tiles,
# 128-row blocks) and DINOv2-giant's ragged N 1,961, at every head width
_EDGES = [(256, 64), (100, 64), (130, 128)] + [
    (n, 64) for n in (1, 63, 64, 65, 127, 128, 129, 193, 1961)] + [
    (n, 128) for n in (1, 63, 65, 127, 129, 193, 1961)] + [
    (n, 32) for n in (1, 63, 65, 127, 129, 193, 1961)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", _EDGES)
def test_flash_kernels_match_plain(cuda, n, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = [(torch.randn((2, n, 3, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16) for _ in range(3)]
    before = A.flash_attention.launches
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    assert A.flash_attention.launches == before + 1
    ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
    assert _rel(out, ref) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    q8, k8, sq, sk = A.quantize_qk(q, k, 1.0 / math.sqrt(d))
    out8 = A.flash_attention_int8(q, k, v)
    assert _rel(out8, A.int8_attention_plain(q8, k8, sq, sk, v)) <= 1e-2
    assert _rel(out8, A.xla_attention(q.float(), k.float(), v.float())) \
        <= 2e-2


# head widths past the instantiations of 32, 64 and 128: d 72 and 80
# (SigLIP so400m, a VideoMAE at ViT-H widths) and others under and between
# them, at ragged N; 100 and 20 are no multiple of 8 (padded by a copy)
_WIDTHS = [(65, 8), (193, 16), (65, 20), (129, 40), (193, 72), (729, 72),
           (65, 80), (1961, 80), (129, 100), (65, 120)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", _WIDTHS)
def test_forward_kernels_take_every_head_width(cuda, n, d):
    """K1 (out and lse2), K3 and K8 at a head width past 32 / 64 / 128
    against their plain versions, one launch each, the output of width d;
    R6 writes the codes at the instantiation's width, bit for bit
    `quantize_per_head`'s on the first d columns and zeros past them, in
    both layouts; under autograd "auto" runs K1 and K4 at the width."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    q, k, v = [(torch.randn((2, n, 3, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16) for _ in range(3)]
    scale = 1.0 / math.sqrt(d)
    before = (A.flash_attention.launches, A.flash_attention_int8.launches,
              A.flash_attention_int8pv.launches)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
    assert out.shape == q.shape and _rel(out, ref) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    q8, k8, sq, sk = A.quantize_qk(q, k, scale, A.quantize_per_head)
    out8 = A.flash_attention_int8(q, k, v)
    assert out8.shape == q.shape
    assert _rel(out8, A.int8_attention_plain(q8, k8, sq, sk, v)) <= 1e-2
    v8, sv = A.quantize_per_head(v)
    outpv = A.flash_attention_int8pv(q, k, v)
    assert outpv.shape == q.shape
    assert _rel(outpv, A.int8pv_attention_plain(q8, k8, sq, sk, v8,
                                                sv)) <= 1e-2
    assert (A.flash_attention.launches, A.flash_attention_int8.launches,
            A.flash_attention_int8pv.launches) == tuple(
                c + 1 for c in before)
    if d % 8 == 0:
        w = A._tile_width(d)
        want8, want_s = A.quantize_per_head(q, scale * A.LOG2E, width=w)
        x8, s = A.quantize_per_head_kernel(q, scale * A.LOG2E, width=w)
        assert x8.shape == (2, n, 3, w) and not bool(x8[..., d:].any())
        assert torch.equal(s, want_s) and torch.equal(x8, want8)
        vt, s = A.quantize_per_head_kernel(v, v_layout=True, width=w)
        assert torch.equal(s, sv)
        assert torch.equal(vt, A.quantize_v_kernel_layout(v8, w))
    leaf = q.detach().requires_grad_()
    before = (A.flash_attention.launches, A.flash_attention_bwd.launches)
    got = A.attention(leaf, k, v, impl="auto")
    assert torch.equal(got, out)
    got.float().sum().backward()
    assert (A.flash_attention.launches,
            A.flash_attention_bwd.launches) == tuple(c + 1 for c in before)
    assert leaf.grad.shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", _WIDTHS)
def test_backward_kernels_take_every_head_width(cuda, n, d):
    """K4 and K7 at a head width past 32 / 64 / 128 (on the next
    instantiation up; 20 and 100 padded by a copy) against their plain
    versions, with an lse2 cotangent, one launch each at the instantiation
    of the padded width, dq, dk and dv of width d; K7 on R6's codes at the
    instantiation's width."""
    gen = torch.Generator(device=cuda).manual_seed(37)
    q, k, v, do = [(torch.randn((2, n, 3, d), generator=gen, device=cuda)
                    * 0.4).to(torch.bfloat16) for _ in range(4)]
    g_lse = torch.randn((2, 3, n), generator=gen, device=cuda) * 0.1
    scale = 1.0 / math.sqrt(d)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    d8 = d + (-d % 8)
    for kernel, plain in ((A.flash_attention_bwd, A.attention_bwd_plain),
                          (A.flash_attention_bwd_i8,
                           A.attention_bwd_i8_plain)):
        before = kernel.launches_by_width.get(d8, 0)
        got = kernel(q, k, v, out, lse, do, g_lse=g_lse)
        assert kernel.launches_by_width[d8] == before + 1
        want = plain(q, k, v, out, lse, do, scale=scale, g_lse=g_lse)
        for a, b in zip(got, want):
            assert a.shape == b.shape == q.shape
            assert _rel(a, b) <= 2e-2


# K past 1,024 in the MLP forward kernels (ViT-H's 1,280, 2,048, SigLIP
# so400m's 1,152 and 640, which the earlier list skipped), ragged M and F
_MLP_WIDE = [(129, 1280, 5120), (100, 2048, 1024), (33, 1152, 4608),
             (65, 640, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,f", _MLP_WIDE)
def test_mlp_kernels_take_wide_k(cuda, m, k, f):
    """K2, K6 and K9 at a K outside the earlier list (the runtime-K
    LayerNorm pass for K2 and K9) against their plain versions, one launch
    each; a training path takes those K too: autograd through mlp_impl
    "pallas_bwd" launches K5a and K5b."""
    gen = torch.Generator(device=cuda).manual_seed(31)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * s

    x = r(m, k).to(torch.bfloat16)
    lnw, lnb = 1.0 + r(k, s=0.1), r(k, s=0.1)
    w1, w2 = r(k, f, s=k ** -0.5), r(f, k, s=f ** -0.5)
    b1, b2 = r(f, s=0.1), r(k, s=0.1)
    before = (M.mlp_block_fused.launches, M.mlp_fused.launches,
              M.swiglu_block_fused.launches)
    yb = M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, act="gelu",
                           eps=1e-6)
    ref = M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, "gelu", 1e-6)
    assert yb.shape == (m, k) and _rel(yb, ref) <= 8e-3
    y = M.mlp_fused(x, w1, b1, w2, b2, act="gelu_new")
    assert _rel(y, M._mlp_xla(x, w1, b1, w2, b2, "gelu_new")) <= 8e-3
    w_in, b_in = r(k, 2 * f, s=k ** -0.5), r(2 * f, s=0.1)
    ys = M.swiglu_block_fused(x, lnw, lnb, w_in, b_in, w2, b2, eps=1e-6)
    want = M._swiglu_block_plain(x, lnw, lnb, w_in, b_in, w2, b2, 1e-6)
    assert _rel(ys, want) <= 8e-3
    assert (M.mlp_block_fused.launches, M.mlp_fused.launches,
            M.swiglu_block_fused.launches) == tuple(c + 1 for c in before)
    before = (M.mlp_train_fused.launches, M.mlp_bwd_fused.launches)
    xg = x.detach().float().requires_grad_()
    M.mlp_forward(xg, w1, b1, w2, b2, impl="pallas_bwd").sum().backward()
    assert (M.mlp_train_fused.launches,
            M.mlp_bwd_fused.launches) == tuple(c + 1 for c in before)
    assert xg.grad.shape == x.shape and bool(xg.grad.isfinite().all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,f", _MLP_WIDE)
@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
def test_mlp_train_kernels_take_wide_k(cuda, m, k, f, act):
    """K5a (y and the spilled h) and K5b (dx, dh, a) at K past 1,024 and
    between the earlier list's widths against their plain versions, within
    3e-2 of max (the JAX package's bound for its pair), one launch
    each."""
    gen = torch.Generator(device=cuda).manual_seed(41)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * s

    x, g = r(m, k).to(torch.bfloat16), r(m, k).to(torch.bfloat16)
    w1 = r(f, k, s=k ** -0.5).to(torch.bfloat16).t()
    w2 = r(k, f, s=f ** -0.5).to(torch.bfloat16).t()
    b1, b2 = r(f, s=0.1), r(k, s=0.1)
    before = (M.mlp_train_fused.launches, M.mlp_bwd_fused.launches)
    y, h = M.mlp_train_fused(x, w1, b1, w2, b2, act=act)
    y_ref, h_ref = M._mlp_train_plain(x, w1, b1, w2, b2, act)
    assert _rel(y, y_ref) <= 3e-2 and _rel(h, h_ref) <= 3e-2
    got = M.mlp_bwd_fused(h, g, w1, w2, act=act)
    want = M._mlp_bwd_plain(h, g, w1, w2, act)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 3e-2
    assert (M.mlp_train_fused.launches,
            M.mlp_bwd_fused.launches) == tuple(c + 1 for c in before)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(70, 200, 64), (200, 70, 64),
                                     (1, 129, 64), (193, 64, 128),
                                     (65, 1961, 128), (70, 200, 32),
                                     (200, 70, 32), (65, 1961, 32)])
def test_flash_kernels_cross_lengths_and_refusals(cuda, nq, nk, d):
    """Nq != Nk both ways with ragged tails, K1 and K3; inputs the
    kernels do not take raise instead of falling back to the plain version,
    and launch nothing."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = (torch.randn((1, nq, 2, d), generator=gen, device=cuda)
         * 0.4).to(torch.bfloat16)
    k, v = [(torch.randn((1, nk, 2, d), generator=gen, device=cuda)
             * 0.4).to(torch.bfloat16) for _ in range(2)]
    assert _rel(A.flash_attention(q, k, v), A.xla_attention(q, k, v)) \
        <= 1e-2
    q8, k8, sq, sk = A.quantize_qk(q, k, 1.0 / math.sqrt(d))
    before8 = A.flash_attention_int8.launches
    out8 = A.flash_attention_int8(q, k, v)
    assert A.flash_attention_int8.launches == before8 + 1
    assert _rel(out8, A.int8_attention_plain(q8, k8, sq, sk, v)) <= 1e-2
    assert _rel(out8, A.xla_attention(q.float(), k.float(),
                                      v.float())) <= 2e-2
    before = (A.flash_attention.launches, A.flash_attention_int8.launches)
    wide = torch.zeros((1, nk, 2, d + 4), dtype=torch.bfloat16, device=cuda)
    # a head width past 128 (ROADMAP G4): no kernel takes it
    past = torch.zeros((1, nk, 2, 136), dtype=torch.bfloat16, device=cuda)
    for fn in (A.flash_attention, A.flash_attention_int8):
        with pytest.raises(ValueError, match="head width"):
            fn(past, past, past)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q, k, wide[..., :d])
    with pytest.raises(TypeError, match="bfloat16"):
        A.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(TypeError, match="bfloat16"):
        A.flash_attention_int8(q, k, v.float())
    assert (A.flash_attention.launches,
            A.flash_attention_int8.launches) == before
    x = torch.zeros(8, 96, dtype=torch.bfloat16, device=cuda)
    w1, b1 = torch.zeros(96, 64, device=cuda), torch.zeros(64, device=cuda)
    w2, b2 = torch.zeros(64, 96, device=cuda), torch.zeros(96, device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        M.mlp_fused(x, w1, b1, w2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(96, 64), (129, 64), (193, 128),
                                 (129, 32)])
def test_flash_kernel_reads_strided_heads(cuda, n, d):
    """q, k, v as views of one fused (B, N, 3, H, D) projection, read by
    TMA through their strides: K1 and K4, K3 (v and the fused q, k it
    quantises) and K7 (its bf16 q and k)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = (torch.randn((2, n, 3, 4, d), generator=gen, device=cuda)
           * 0.4).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    scale = 1.0 / math.sqrt(d)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    assert _rel(out, A.xla_attention(q, k, v)) <= 1e-2
    do = torch.randn_like(q)
    got = A.flash_attention_bwd(q, k, v, out, lse, do)
    want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=scale)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-2
    q8, k8, sq, sk = A.quantize_qk(q, k, scale)
    assert _rel(A.flash_attention_int8(q, k, v),
                A.int8_attention_plain(q8, k8, sq, sk, v)) <= 1e-2
    got = A.flash_attention_bwd_i8(q, k, v, out, lse, do)
    want = A.attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-2


# the MLP forward's edges: every K it takes, M of 1, under a 64-row
# warpgroup, past a 128-row tile and over two chunks of the workspace
# (33,792 = 2 x 132 x 128 rows), F a multiple of 32 but not of the 128-column
# tile or the 64-column contraction step
_MLP_EDGES = [(100, 128, 512), (256, 768, 3072), (33, 384, 1536),
              (1, 128, 96), (63, 256, 160), (129, 512, 1056),
              (1, 768, 3072), (129, 1024, 4096), (33792, 384, 1568)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,f", _MLP_EDGES)
def test_mlp_kernels_match_plain(cuda, m, k, f):
    """K2 and K6 against their plain versions, both activations, one
    launch counted a call."""
    gen = torch.Generator(device=cuda).manual_seed(2)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * s

    x = r(m, k).to(torch.bfloat16)
    lnw, lnb = 1.0 + r(k, s=0.1), r(k, s=0.1)
    w1 = r(k, f, s=k ** -0.5)
    w2 = r(f, k, s=f ** -0.5)
    b1, b2 = r(f, s=0.1), r(k, s=0.1)
    for act in ("gelu", "gelu_new"):
        before = (M.mlp_block_fused.launches, M.mlp_fused.launches)
        yb = M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, act=act,
                               eps=1e-6)
        ref = M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, act, 1e-6)
        assert yb.shape == (m, k) and _rel(yb, ref) <= 8e-3
        y = M.mlp_fused(x, w1, b1, w2, b2, act=act)
        assert y.shape == (m, k)
        assert _rel(y, M._mlp_xla(x, w1, b1, w2, b2, act)) <= 8e-3
        assert (M.mlp_block_fused.launches, M.mlp_fused.launches) == (
            before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(n, n, d) for n, d in _EDGES] + [
    (70, 200, 64), (200, 70, 64), (1, 129, 128), (193, 64, 128),
    (70, 200, 32), (200, 70, 32), (1, 129, 32), (193, 1961, 32)])
def test_flash_bwd_kernel_matches_plain(cuda, nq, nk, d):
    """K4 against its plain backward, with and without an lse2 cotangent,
    on the lse2 of K1, at the tile edges and with Nq != Nk both ways."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def r(n):
        return (torch.randn((2, n, 3, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16)

    q, k, v, do = r(nq), r(nk), r(nk), r(nq)
    g_lse = torch.randn((2, 3, nq), generator=gen, device=cuda)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    scale = 1.0 / math.sqrt(d)
    for gl in (None, g_lse):
        before = A.flash_attention_bwd.launches
        got = A.flash_attention_bwd(q, k, v, out, lse, do, g_lse=gl)
        assert A.flash_attention_bwd.launches == before + 1
        want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=scale,
                                     g_lse=gl)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
            if nk == 1 and gl is None and i < 2:
                # one key and no lse2 cotangent: ds = dp - delta is 0 up
                # to rounding, so dq and dk are rounding noise on both
                # sides; held against dv's scale
                assert float(a.abs().max()) <= 2e-2 * float(
                    want[2].abs().max())
            else:
                assert _rel(a, b) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,f", [(100, 128, 512), (256, 768, 3072),
                                   (1, 1024, 4096), (129, 1024, 4096),
                                   (63, 256, 160), (33792, 384, 1568),
                                   (7168, 768, 3072), (20480, 384, 1536),
                                   (9216, 1024, 4096), (1, 128, 96),
                                   (129, 512, 96), (63, 768, 160)])
def test_mlp_train_and_bwd_kernels_match_plain(cuda, m, k, f):
    """K5a (y and the spilled h) and K5b (dx, dh, a) against their plain
    versions, on the same inputs, both activations: at the MIM encoder's
    and decoder's and the V-JEPA encoder's shapes and at the GEMM tiles'
    edges (M 1, 63, 129 and 33,792; F 96 and 160, not multiples of the
    64-column step, and 1,568); bound 3e-2 of max as the JAX package's
    tests/test_mlp_bwd.py. One launch counted a call."""
    gen = torch.Generator(device=cuda).manual_seed(5)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * s

    x = r(m, k).to(torch.bfloat16)
    w1 = r(f, k, s=k ** -0.5).to(torch.bfloat16).t()
    w2 = r(k, f, s=f ** -0.5).to(torch.bfloat16).t()
    b1, b2 = r(f, s=0.1), r(k, s=0.1)
    g = r(m, k).to(torch.bfloat16)
    for act in ("gelu", "gelu_new"):
        before = (M.mlp_train_fused.launches, M.mlp_bwd_fused.launches)
        y, h = M.mlp_train_fused(x, w1, b1, w2, b2, act=act)
        y_ref, h_ref = M._mlp_train_plain(x, w1, b1, w2, b2, act)
        assert _rel(y, y_ref) <= 3e-2 and _rel(h, h_ref) <= 3e-2
        got = M.mlp_bwd_fused(h, g, w1, w2, act=act)
        want = M._mlp_bwd_plain(h, g, w1, w2, act)
        for a, b in zip(got, want):
            assert a.shape == b.shape and _rel(a, b) <= 3e-2
        assert (M.mlp_train_fused.launches, M.mlp_bwd_fused.launches) == (
            before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_pallas_bwd_weight_grads_are_f32_on_the_card(cuda):
    """The "pallas_bwd" route's weight-gradient product on the card: bf16
    operands, an f32 result equal to the f32 product of the same bf16
    values up to the order of the f32 sums (1e-5 of max), where a bf16
    result reads ~2e-3 (tests/test_torch_mlp_wgrad.py holds the route
    against the JAX package on the CPU)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a, b = (torch.randn((7168, n), generator=gen, device=cuda).to(
        torch.bfloat16) for n in (1280, 640))
    got = M._weight_grad(a, b)
    assert got.dtype == torch.float32 and got.shape == (1280, 640)
    assert _rel(got, a.double().t() @ b.double()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_impl", ["auto", "pallas_bwd"])
def test_block_backward_runs_through_the_kernels(cuda, mlp_impl):
    """loss.backward() through one bf16 Block on the kernels: every
    parameter gets a finite, non-zero gradient, within 3e-2 of max of a
    float32 Block's, as the plain bf16 path's are."""
    from smb_vision_tpu_torch.models.layers import Block

    torch.manual_seed(0)

    def block(**kw):
        b = Block(128, 2, 512, bias_mode="qv", layer_norm_eps=1e-12, **kw)
        b.load_state_dict(ref_state)
        return b.to(cuda)

    ref_state = Block(128, 2, 512, bias_mode="qv").state_dict()
    for name, p in ref_state.items():
        p.add_(torch.randn(p.shape) * 0.05)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 200, 128), generator=gen, device=cuda)
    w = torch.randn((2, 200, 128), generator=gen, device=cuda)

    def grads(b):
        (b(x.to(b.dtype)).float() * w).sum().backward()
        return {n: p.grad for n, p in b.named_parameters()}

    launches = (A.flash_attention_bwd.launches, M.mlp_bwd_fused.launches)
    kern = grads(block(dtype=torch.bfloat16, mlp_impl=mlp_impl))
    assert A.flash_attention_bwd.launches == launches[0] + 1
    if mlp_impl == "pallas_bwd":
        assert M.mlp_bwd_fused.launches == launches[1] + 1
    plain = grads(block(dtype=torch.bfloat16, attn_impl="xla",
                        mlp_impl="xla"))
    f32 = grads(block(dtype=torch.float32, attn_impl="xla", mlp_impl="xla"))
    for name, g in kern.items():
        assert g is not None and bool(g.isfinite().all()), name
        assert float(g.abs().max()) > 0, name
        assert _rel(plain[name], f32[name]) <= 3e-2, name
        assert _rel(g, f32[name]) <= 3e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(n, n, d) for n, d in _EDGES] + [
    (256, 256, 128), (70, 200, 64), (200, 70, 64), (1, 129, 128),
    (193, 64, 128), (70, 200, 32), (200, 70, 32), (1, 129, 32),
    (1961, 193, 32)])
def test_flash_bwd_i8_kernel_matches_plain(cuda, nq, nk, d):
    """K7 against its plain version, with and without an lse2 cotangent,
    on the lse2 of K1, at the wgmma tile edges and with Nq != Nk both
    ways."""
    gen = torch.Generator(device=cuda).manual_seed(7)

    def r(n):
        return (torch.randn((2, n, 3, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16)

    q, k, v, do = r(nq), r(nk), r(nk), r(nq)
    g_lse = torch.randn((2, 3, nq), generator=gen, device=cuda)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    scale = 1.0 / math.sqrt(d)
    for gl in (None, g_lse):
        before = A.flash_attention_bwd_i8.launches
        got = A.flash_attention_bwd_i8(q, k, v, out, lse, do, g_lse=gl)
        assert A.flash_attention_bwd_i8.launches == before + 1
        want = A.attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale,
                                        g_lse=gl)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
            assert _rel(a, b) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", [(9216, 9216), (1961, 1961), (193, 193),
                                   (129, 1), (70, 200), (200, 70),
                                   (1961, 65)])
def test_int8_forwards_run_head_width_32(cuda, nq, nk):
    """K3 and K8 at head width 32 (the reference-head V-JEPA2 predictor,
    12 heads of 32): one launch each, on their wrappers and through
    `attention`, within their d-64 bounds of their plain versions (1e-2
    of max) and of float32 attention (2e-2, 3e-2): the predictor's shape,
    ragged N, Nq != Nk both ways and a 64-key sub-block wholly past Nk."""
    gen = torch.Generator(device=cuda).manual_seed(13)

    def r(n):
        return (torch.randn((1, n, 12, 32), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16)

    q, k, v = r(nq), r(nk), r(nk)
    q8, k8, sq, sk = A.quantize_qk(q, k, 1.0 / math.sqrt(32),
                                   A.quantize_per_head)
    v8, sv = A.quantize_per_head(v)
    f32 = A.xla_attention(q.float(), k.float(), v.float())
    for impl, fn, plain, bound in (
            ("pallas_int8", A.flash_attention_int8,
             A.int8_attention_plain(q8, k8, sq, sk, v), 2e-2),
            ("pallas_int8pv", A.flash_attention_int8pv,
             A.int8pv_attention_plain(q8, k8, sq, sk, v8, sv), 3e-2)):
        before = fn.launches
        out = fn(q, k, v)
        assert fn.launches == before + 1
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert _rel(out, plain) <= 1e-2 and _rel(out, f32) <= bound
        assert torch.equal(A.attention(q, k, v, impl=impl), out)
        assert fn.launches == before + 2


@pytest.mark.cuda
def test_int8_forward_and_i8bwd_refuse_autograd(cuda):
    """K3 is forward-only and raises under autograd; "pallas_i8bwd" trains
    through K7, whose gradients are its plain version's; without autograd
    it runs K1's forward."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, w = [(torch.randn((1, 64, 2, 64), generator=gen, device=cuda)
                   * 0.4).to(torch.bfloat16) for _ in range(4)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with pytest.raises(RuntimeError, match="forward-only"):
        A.attention(*leaves, impl="pallas_int8")
    before = A.flash_attention_bwd_i8.launches
    (A.attention(*leaves, impl="pallas_i8bwd").float()
     * w.float()).sum().backward()
    assert A.flash_attention_bwd_i8.launches == before + 1
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    want = A.attention_bwd_i8_plain(q, k, v, out, lse, w, scale=0.125)
    for t, ref in zip(leaves, want):
        assert _rel(t.grad, ref) <= 2e-2
    with torch.no_grad():
        assert torch.equal(A.attention(*leaves, impl="pallas_i8bwd"),
                           A.attention(*leaves, impl="pallas"))


def _rope_block_grads(device):
    """Gradients of one Block(256, 2 heads of 128, 1024) with a RoPE
    table, as the V-JEPA preset pins it (bf16, attn "pallas_i8bwd", mlp
    "pallas_bwd"), of the plain bf16 path and of a float32 Block."""
    from smb_vision_tpu_torch.models.layers import Block
    from smb_vision_tpu_torch.ops.rope3d import rope3d_cos_sin

    torch.manual_seed(0)
    ref_state = Block(256, 2, 1024).state_dict()
    for p in ref_state.values():
        p.add_(torch.randn(p.shape) * 0.05)
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn((2, 200, 256), generator=gen, device=device)
    w = torch.randn((2, 200, 256), generator=gen, device=device)
    ids = torch.arange(200, device=device)

    def grads(**kw):
        b = Block(256, 2, 1024, **kw)
        b.load_state_dict(ref_state)
        b.to(device)
        rope = rope3d_cos_sin(ids, 5, 128, dtype=b.dtype)
        (b(x.to(b.dtype), rope=rope).float() * w).sum().backward()
        return {n: p.grad for n, p in b.named_parameters()}

    kern = grads(dtype=torch.bfloat16, attn_impl="pallas_i8bwd",
                 mlp_impl="pallas_bwd")
    plain = grads(dtype=torch.bfloat16, attn_impl="xla", mlp_impl="xla")
    f32 = grads(dtype=torch.float32, attn_impl="xla", mlp_impl="xla")
    return kern, plain, f32


@pytest.mark.cuda
def test_rope_block_trains_through_k7(cuda):
    """loss.backward() through the V-JEPA preset's Block on the card: K7
    and K5b launch, and every parameter gets a finite, non-zero gradient,
    within 5e-2 of max of a float32 Block's (the JAX package's bound for
    the int8-score backward, tests/test_attention.py), as the plain bf16
    path's are within 3e-2. The key bias is held to 1e-1: its gradient,
    sum_j dk_j, would vanish without RoPE (a shift of every key leaves the
    softmax unchanged), so its max is small against the int8 noise (the
    plain version of K7 lands 3.9e-2 from float32 on the CPU)."""
    launches = (A.flash_attention_bwd_i8.launches, M.mlp_bwd_fused.launches)
    kern, plain, f32 = _rope_block_grads(cuda)
    assert A.flash_attention_bwd_i8.launches == launches[0] + 1
    assert M.mlp_bwd_fused.launches == launches[1] + 1
    for name, g in kern.items():
        assert g is not None and bool(g.isfinite().all()), name
        assert float(g.abs().max()) > 0, name
        assert _rel(plain[name], f32[name]) <= 3e-2, name
        bound = 1e-1 if name == "attention.key.bias" else 5e-2
        assert _rel(g, f32[name]) <= bound, name


def _swiglu_inputs(m, k, f, gen, dev):
    """x, LN params and Linear-layout bf16 weights, passed as the Block
    passes them: w_in (K, 2F) and w_out (F, K) as transposed views."""
    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    x = r(m, k).to(torch.bfloat16)
    lnw, lnb = 1.0 + r(k, s=0.1), r(k, s=0.1)
    w_in = r(2 * f, k, s=k ** -0.5).to(torch.bfloat16).t()
    w_out = r(k, f, s=f ** -0.5).to(torch.bfloat16).t()
    b_in, b_out = r(2 * f, s=0.1), r(k, s=0.1)
    return x, lnw, lnb, w_in, b_in, w_out, b_out


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,f", [(3922, 1536, 4096), (20480, 768, 2048),
                                   (1961, 1536, 4096), (100, 128, 256),
                                   (1, 1536, 4096), (1, 128, 96),
                                   (77, 384, 160), (130, 1536, 96),
                                   (33792, 256, 160)])
def test_swiglu_kernel_matches_plain(cuda, m, k, f):
    """K9 against its plain version (the kernel's numerics), against the
    JAX package's bf16 chain `_swiglu_block_xla` and against the same math
    in float32, within 8e-3 of max: DINOv2-giant at batch 2 and at its
    ragged batch 1, the DINOv2-base shape the JAX package benchmarked, a
    small ragged one, and the gated tile's edges (M 1, F 96 and 160, which
    end each half of w_in inside a 64-row box, and two workspace chunks).
    One launch counted a call."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    args = _swiglu_inputs(m, k, f, gen, cuda)
    before = M.swiglu_block_fused.launches
    y = M.swiglu_block_fused(*args, eps=1e-6)
    assert M.swiglu_block_fused.launches == before + 1
    assert y.shape == (m, k) and y.dtype == torch.bfloat16
    assert _rel(y, M._swiglu_block_plain(*args, 1e-6)) <= 8e-3
    assert _rel(y, M._swiglu_block_xla(*args, 1e-6)) <= 8e-3
    x, *w = args
    assert _rel(y, M._swiglu_block_xla(x.float(), *[t.float() for t in w],
                                       1e-6)) <= 8e-3


@pytest.mark.cuda
def test_swiglu_gradients_and_refusals(cuda):
    """Under autograd K9 runs the forward and the backward recomputes the
    plain half-block: all seven gradients within 3e-2 of max of the plain
    version's. A shape K9 does not take raises instead of falling back."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    args = _swiglu_inputs(300, 768, 512, gen, cuda)
    g = torch.randn((300, 768), generator=gen, device=cuda)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        (fn(*leaves).float() * g).sum().backward()
        return [t.grad for t in leaves]

    before = M.swiglu_block_fused.launches
    got = grads(lambda *a: M.swiglu_block_forward(*a, eps=1e-6,
                                                  impl="pallas"))
    assert M.swiglu_block_fused.launches == before + 1
    want = grads(lambda *a: M.swiglu_block_forward(*a, eps=1e-6, impl="xla"))
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 3e-2
    x, lnw, lnb, w_in, b_in, w_out, b_out = _swiglu_inputs(8, 96, 64, gen,
                                                           cuda)
    with pytest.raises(ValueError, match="cannot map"):
        M.swiglu_block_forward(x, lnw, lnb, w_in, b_in, w_out, b_out,
                               impl="pallas")
    with pytest.raises(ValueError, match="no kernel"):
        M.swiglu_block_fused(x, lnw, lnb, w_in, b_in, w_out, b_out)
    assert M.swiglu_block_fused.launches == before + 1


@pytest.mark.cuda
def test_swiglu_block_trains_through_k9(cuda):
    """loss.backward() through one bf16 DINOv2 SwiGLU Block (LayerScale,
    q, k and v biases, mlp_impl "pallas"): K4 and K9 launch, and every
    parameter gets a finite, non-zero gradient within 3e-2 of max of a
    float32 Block's, as the plain bf16 path's are. The key bias's exact
    gradient is zero (a shift of every key leaves the softmax unchanged),
    so its bf16 gradient is held to 3e-2 of the query bias's max
    instead."""
    from smb_vision_tpu_torch.models.layers import Block

    torch.manual_seed(0)
    kw = dict(layerscale_value=0.9, use_swiglu=True)
    ref_state = Block(256, 4, 512, **kw).state_dict()
    for p in ref_state.values():
        p.add_(torch.randn(p.shape) * 0.05)
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, 197, 256), generator=gen, device=cuda)
    w = torch.randn((2, 197, 256), generator=gen, device=cuda)

    def grads(**impl):
        b = Block(256, 4, 512, **kw, **impl)
        b.load_state_dict(ref_state)
        b.to(cuda)
        (b(x.to(b.dtype)).float() * w).sum().backward()
        return {n: p.grad for n, p in b.named_parameters()}

    launches = (A.flash_attention_bwd.launches, M.swiglu_block_fused.launches)
    kern = grads(dtype=torch.bfloat16, mlp_impl="pallas")
    assert A.flash_attention_bwd.launches == launches[0] + 1
    assert M.swiglu_block_fused.launches == launches[1] + 1
    plain = grads(dtype=torch.bfloat16, attn_impl="xla", mlp_impl="xla")
    f32 = grads(dtype=torch.float32, attn_impl="xla", mlp_impl="xla")
    q_max = float(f32["attention.query.bias"].abs().max())
    for name, g in kern.items():
        assert g is not None and bool(g.isfinite().all()), name
        assert float(g.abs().max()) > 0, name
        if name == "attention.key.bias":
            for got in (g, plain[name]):
                assert float((got - f32[name]).abs().max()) <= 3e-2 * q_max
            continue
        assert _rel(plain[name], f32[name]) <= 3e-2, name
        assert _rel(g, f32[name]) <= 3e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", [(1, 20480, 12, 64), (1, 1961, 12, 64),
                                     (2, 100, 3, 64), (2, 130, 3, 128)])
def test_int8pv_kernel_matches_plain(cuda, b, n, h, d):
    """K8 against its plain version (the same quantised operands and 64-key
    sub-blocks) within 1e-2 of max, and against float32 attention within
    3e-2 (the JAX package's bound for this impl): the embed shape, a ragged
    one and two small ones."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = [(torch.randn((b, n, h, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16) for _ in range(3)]
    before = A.flash_attention_int8pv.launches
    out = A.flash_attention_int8pv(q, k, v)
    assert A.flash_attention_int8pv.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    q8, k8, sq, sk = A.quantize_qk(q, k, 1.0 / math.sqrt(d))
    v8, sv = A.quantize_per_head(v)
    assert _rel(out, A.int8pv_attention_plain(q8, k8, sq, sk, v8, sv)) <= 1e-2
    assert _rel(out, A.xla_attention(q.float(), k.float(), v.float())) \
        <= 3e-2


@pytest.mark.cuda
def test_int8pv_refuses_autograd(cuda):
    """K8 is forward-only, as K3: under autograd it raises."""
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        A.attention(q, q, q, impl="pallas_int8pv")


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(129, 129, 64), (257, 257, 128),
                                     (70, 200, 64), (200, 70, 128),
                                     (1961, 65, 64)])
def test_int8pv_kernel_masked_sub_block_and_cross_lengths(cuda, nq, nk, d):
    """K8 where a 64-key sub-block lies wholly past Nk (Nk = 1 mod 64: at
    d 64 its 128-key tile holds one key) and with Nq != Nk both ways, at
    the bounds of `test_int8pv_kernel_matches_plain`."""
    gen = torch.Generator(device=cuda).manual_seed(17)

    def r(n):
        return (torch.randn((2, n, 3, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16)

    q, k, v = r(nq), r(nk), r(nk)
    out = A.flash_attention_int8pv(q, k, v)
    assert out.shape == q.shape
    q8, k8, sq, sk = A.quantize_qk(q, k, 1.0 / math.sqrt(d),
                                   A.quantize_per_head)
    v8, sv = A.quantize_per_head(v)
    assert _rel(out, A.int8pv_attention_plain(q8, k8, sq, sk, v8, sv)) <= 1e-2
    assert _rel(out, A.xla_attention(q.float(), k.float(), v.float())) \
        <= 3e-2


def _quant_input(case, gen, dev):
    """(x, mult) of a named quantisation case on the card."""
    def r(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.4).to(
            torch.bfloat16)

    scale_q = 0.125 * A.LOG2E
    if case == "embed":           # leg B's q at batch 4, 12 heads of 64
        return r(4, 20480, 12, 64), scale_q
    if case == "vjepa_encoder":   # N 9,216, 8 heads of 128
        return r(1, 9216, 8, 128), 1.0
    if case == "predictor":       # the reference-head predictor, 12 x 32
        return r(1, 9216, 12, 32), 1.0 / math.sqrt(32) * A.LOG2E
    if case == "ragged":
        return r(2, 1961, 3, 64), 1.0
    if case == "one_token":
        return r(2, 1, 3, 128), 1.0
    if case == "zero_head":
        x = r(2, 193, 4, 64)
        x[1, :, 2] = 0
        return x, 1.0
    if case.startswith("fused_"):  # q, k or v of one (B, N, 3, H, D)
        qkv = r(2, 1961, 3, 12, 64)
        return qkv.unbind(2)["qkv".index(case[-1])], 1.0
    raise KeyError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["embed", "vjepa_encoder", "predictor",
                                  "ragged", "one_token", "zero_head",
                                  "fused_q", "fused_k", "fused_v"])
def test_quantize_kernel_matches_plain_bit_for_bit(cuda, case):
    """The quantisation kernel (R6) gives `quantize_per_head`'s int8 bytes
    and f32 scales bit for bit, in the input's layout and in K8's v layout
    (`quantize_v_kernel_layout` of the plain bytes), at the model's shapes,
    head widths 32 to 128, a ragged N, an all-zero head (s = 1, or 0 with
    zero_scale) and the strided views of a fused projection."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    x, mult = _quant_input(case, gen, cuda)
    want8, want_s = A.quantize_per_head(x, mult)
    before = A.quantize_per_head_kernel.launches
    x8, s = A.quantize_per_head_kernel(x, mult)
    assert A.quantize_per_head_kernel.launches == before + 1
    assert x8.is_contiguous() and x8.shape == x.shape
    assert torch.equal(s, want_s) and torch.equal(x8, want8)
    vt, sv = A.quantize_per_head_kernel(x, mult, v_layout=True)
    assert torch.equal(sv, want_s)
    assert torch.equal(vt, A.quantize_v_kernel_layout(want8))
    if case == "zero_head":
        assert float(s[1, 2]) == 1.0
    # zero_scale, as K7 quantises do: an all-zero head reports 0
    want8, want_s = A.quantize_per_head(x, mult, zero_scale=True)
    x8, s = A.quantize_per_head_kernel(x, mult, zero_scale=True)
    assert torch.equal(s, want_s) and torch.equal(x8, want8)
    assert (case == "zero_head") == bool((s == 0).any())


@pytest.mark.cuda
def test_quantize_kernel_refusals(cuda):
    """The kernel takes bf16 with a contiguous head dim and a head width
    that is a multiple of 8 up to 128 (the wrappers pad any other);
    anything else raises before a launch."""
    before = A.quantize_per_head_kernel.launches
    for x in (torch.zeros((1, 8, 2, 64), device=cuda),
              torch.zeros((1, 8, 2, 44), dtype=torch.bfloat16, device=cuda),
              torch.zeros((1, 8, 2, 136), dtype=torch.bfloat16, device=cuda),
              torch.zeros((1, 8, 64, 2), dtype=torch.bfloat16,
                          device=cuda).transpose(2, 3)):
        with pytest.raises(ValueError):
            A.quantize_per_head_kernel(x)
    assert A.quantize_per_head_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(20480, 20480, 64), (9216, 9216, 128),
                                     (1961, 193, 64), (9216, 9216, 32)])
def test_int8_wrappers_equal_kernels_on_plain_operands(cuda, nq, nk, d):
    """K3 and K7 through their wrappers (operands from the quantisation
    kernel) equal their kernels fed with plain-quantised operands, bit for
    bit: the kernel changes no byte downstream."""
    gen = torch.Generator(device=cuda).manual_seed(23)

    def r(n):
        return (torch.randn((1, n, 4, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16)

    q, k, v, do = r(nq), r(nk), r(nk), r(nq)
    scale = 1.0 / math.sqrt(d)
    plain = A.quantize_per_head
    assert torch.equal(A.flash_attention_int8(q, k, v),
                       A._launch_int8(*A.quantize_qk(q, k, scale, plain), v))
    vt8, sv = plain(v)
    assert torch.equal(
        A.flash_attention_int8pv(q, k, v),
        A._launch_int8pv(*A.quantize_qk(q, k, scale, plain),
                         A.quantize_v_kernel_layout(vt8), sv))
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    got = A.flash_attention_bwd_i8(q, k, v, out, lse, do)
    want = A._launch_bwd_i8(q, k, do, out, lse,
                            A._i8_operands(q, k, v, do, scale, plain), scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _glue_inputs(m, k, gen, dev):
    """x, LN params, Linear-layout bf16 weights passed as (in, out)
    transposed views, as the Block passes them, and f32 biases."""
    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    x = r(m, k).to(torch.bfloat16)
    ws = [r(k, k, s=k ** -0.5).to(torch.bfloat16).t() for _ in range(4)]
    bs = [r(k, s=0.1) for _ in range(4)]
    return x, 1.0 + r(k, s=0.1), r(k, s=0.1), ws, bs


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(20480, 768), (7168, 768), (20480, 384),
                                 (3922, 1024), (300, 1536), (1, 768),
                                 (127, 384), (129, 128), (200, 2688),
                                 (6000, 2816), (21761, 768)])
def test_glue_kernels_match_plain(cuda, m, k):
    """K10a and K10b against their plain versions (the kernels' numerics)
    within 1e-2 of max, and against the same math in float32, one launch
    a call: the embed, MIM encoder and MIM decoder shapes, a ragged one,
    the DINOv2-giant width, the edges of the 128 x 128 tiles (M 1, 127,
    129; K 128), K 2,688 and K 2,816 (K10a's former limit and the first
    width past it), and M past one chunk of K10a's LN(x) workspace (K
    2,816, and M 21,761 at K 768)."""
    from smb_vision_tpu_torch.ops import attn_glue as G

    gen = torch.Generator(device=cuda).manual_seed(14)
    x, lnw, lnb, (wq, wk, wv, wo), (bq, bk, bv, bo) = _glue_inputs(
        m, k, gen, cuda)
    before = (G.qkv_ln_fused.launches, G.out_res_fused.launches)
    got = G.qkv_ln_fused(x, lnw, lnb, wq, wk, wv, bq, bk, bv, eps=1e-6)
    want = G._qkv_ln_plain(x, lnw, lnb, wq, wk, wv, bq, bk, bv, 1e-6)
    f32 = G._qkv_xla(x.float(), lnw, lnb, wq.float(), wk.float(),
                     wv.float(), bq, bk, bv, 1e-6)
    for a, b, c in zip(got, want, f32):
        assert a.shape == (m, k) and a.dtype == torch.bfloat16
        assert _rel(a, b) <= 1e-2 and _rel(a, c) <= 1e-2
    y = got[2]
    o = G.out_res_fused(x, y, wo, bo)
    assert o.shape == (m, k) and o.dtype == torch.bfloat16
    assert _rel(o, G._out_res_plain(x, y, wo, bo)) <= 1e-2
    assert _rel(o, G._out_xla(x.float(), y.float(), wo.float(), bo)) <= 1e-2
    assert (G.qkv_ln_fused.launches, G.out_res_fused.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_glue_kernels_take_misaligned_views(cuda):
    """K10a and K10b on views that start 2 (bf16) or 4 (f32) bytes past a
    16-byte boundary, which TMA and the LayerNorm pass's vector loads
    cannot read in place: the wrapper copies them, and the results match
    the plain versions within 1e-2 of max."""
    from smb_vision_tpu_torch.ops import attn_glue as G

    m, k = 300, 256
    gen = torch.Generator(device=cuda).manual_seed(17)
    x, lnw, lnb, (wq, wk, wv, wo), (bq, bk, bv, bo) = _glue_inputs(
        m, k, gen, cuda)
    xs = torch.empty(m * k + 1, dtype=x.dtype, device=cuda)
    xs[1:].copy_(x.reshape(-1))
    x = xs[1:].view(m, k)
    ps = torch.empty(2 * k + 1, device=cuda)
    ps[1:k + 1], ps[k + 1:] = lnw, lnb
    lnw, lnb = ps[1:k + 1], ps[k + 1:]
    assert x.data_ptr() % 16 and lnw.data_ptr() % 16
    got = G.qkv_ln_fused(x, lnw, lnb, wq, wk, wv, bq, bk, bv, eps=1e-6)
    want = G._qkv_ln_plain(x, lnw, lnb, wq, wk, wv, bq, bk, bv, 1e-6)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-2
    o = G.out_res_fused(x, x, wo, bo)
    assert _rel(o, G._out_res_plain(x, x, wo, bo)) <= 1e-2


@pytest.mark.cuda
def test_glue_refuses_unmappable_on_cuda(cuda):
    """A feature dim the glue kernels do not take raises instead of falling
    back to the plain version: "pallas" refuses K % 128 != 0 ("cannot
    map"), and the kernels themselves refuse it with an invalid-value
    error."""
    from smb_vision_tpu_torch.ops import attn_glue as G

    gen = torch.Generator(device=cuda).manual_seed(15)
    x, lnw, lnb, (wq, wk, wv, wo), (bq, bk, bv, bo) = _glue_inputs(
        64, 96, gen, cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        G.qkv_ln_fused(x, lnw, lnb, wq, wk, wv, bq, bk, bv)
    with pytest.raises(RuntimeError, match="invalid argument"):
        G.out_res_fused(x, x, wo, bo)
    with pytest.raises(ValueError, match="cannot map"):
        G.attn_out_residual(x, x, wo, bo, impl="pallas")
    with pytest.raises(ValueError, match="cannot map"):
        G.qkv_ln_forward(x, lnw, lnb, wq, bq, wk, bk, wv, bv, impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("layerscale", [None, 0.9])
def test_glue_block_trains_through_k10(cuda, layerscale):
    """loss.backward() through one bf16 Block with glue_impl "pallas"
    (bias_mode "qv", so a zeros k bias): K10a and K10b launch once each,
    and every parameter gets a finite, non-zero gradient within 3e-2 of
    max of a float32 Block's, as the plain bf16 path's are."""
    from smb_vision_tpu_torch.models.layers import Block
    from smb_vision_tpu_torch.ops import attn_glue as G

    torch.manual_seed(0)
    kw = dict(bias_mode="qv", layerscale_value=layerscale)
    ref_state = Block(256, 4, 512, **kw).state_dict()
    for p in ref_state.values():
        p.add_(torch.randn(p.shape) * 0.05)
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((2, 200, 256), generator=gen, device=cuda)
    w = torch.randn((2, 200, 256), generator=gen, device=cuda)

    def grads(**impl):
        b = Block(256, 4, 512, **kw, **impl)
        b.load_state_dict(ref_state)
        b.to(cuda)
        (b(x.to(b.dtype)).float() * w).sum().backward()
        return {n: p.grad for n, p in b.named_parameters()}

    before = (G.qkv_ln_fused.launches, G.out_res_fused.launches)
    kern = grads(dtype=torch.bfloat16, glue_impl="pallas")
    assert (G.qkv_ln_fused.launches, G.out_res_fused.launches) == (
        before[0] + 1, before[1] + 1)
    plain = grads(dtype=torch.bfloat16, attn_impl="xla", mlp_impl="xla")
    f32 = grads(dtype=torch.float32, attn_impl="xla", mlp_impl="xla")
    for name, g in kern.items():
        assert g is not None and bool(g.isfinite().all()), name
        assert float(g.abs().max()) > 0, name
        assert _rel(plain[name], f32[name]) <= 3e-2, name
        assert _rel(g, f32[name]) <= 3e-2, name


# W8A8 at ViT-Base's projections on the embed rows (fc1, fc2, q/k/v
# stacked, o) and ragged ones: rows under a 64-row warpgroup and past a
# 128-row tile, K under one 128-column k-step and no multiple of 16 (the
# codes zero-padded), N no multiple of 8 (a bf16 result in a wider
# allocation)
_W8A8_SHAPES = [(20480, 768, 3072), (20480, 3072, 768), (20480, 768, 2304),
                (1961, 768, 768), (129, 96, 40), (1, 100, 33), (300, 13, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", _W8A8_SHAPES)
def test_w8a8_kernels_match_plain_bit_for_bit(cuda, m, k, n, dtype):
    """The row quantisation gives `quantize_rows_plain`'s codes (zeros past
    K) and scales bit for bit, for the activations (bf16 or f32, an
    all-zero row, a row of exact ties) and the f32 weight; the GEMM on
    those codes gives `w8a8_linear_plain`'s result bit for bit, with and
    without a bias, in bf16 and f32. One launch each."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    x[min(3, m - 1)] = 0
    if m > 7 and k >= 4:   # a row of scale 1: 0.5, 1.5, -2.5 exact ties
        x[7] = 0
        x[7, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])
    w = torch.randn((n, k), generator=gen, device=cuda) * k ** -0.5
    b = torch.randn((n,), generator=gen, device=cuda) * 0.1
    kp = Q.padded_k(k)
    for t in (x, w):
        before = Q.quantize_rows_kernel.launches
        got8, got_s = Q.quantize_rows_kernel(t)
        assert Q.quantize_rows_kernel.launches == before + 1
        want8, want_s = Q.quantize_rows_plain(t, kp)
        assert got8.shape == (t.shape[0], kp)
        assert torch.equal(got8, want8) and torch.equal(got_s, want_s)
    x8, sx = Q.quantize_rows_plain(x, kp)
    w8, sw = Q.quantize_rows_plain(w, kp)
    for bias in (None, b):
        before = Q.w8a8_gemm_kernel.launches
        got = Q.w8a8_gemm_kernel(x8, sx, w8, sw, bias, dtype)
        assert Q.w8a8_gemm_kernel.launches == before + 1
        want = Q.w8a8_linear_plain(x8, sx, w8, sw, bias, dtype)
        assert got.shape == (m, n) and got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_w8a8_quantisation_reads_any_rows(cuda):
    """Rows the kernel cannot read 16 bytes at a time (a view 2 bytes past
    an aligned start, an odd row stride) and a (B, N, K) input, bit for
    bit; `w8a8_dot` on the card equals the plain versions' result."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    big = torch.randn((257, 801), generator=gen, device=cuda)
    for x in (big.to(torch.bfloat16)[:, 1:769], big[:, :797],
              big.to(torch.bfloat16)[:256].reshape(2, 128, 801)):
        got8, got_s = Q.quantize_rows_kernel(x)
        want8, want_s = Q.quantize_rows_plain(x, Q.padded_k(x.shape[-1]))
        assert torch.equal(got8, want8) and torch.equal(got_s, want_s)
    x = big[:, :768].to(torch.bfloat16)
    w = torch.randn((300, 768), generator=gen, device=cuda) * 0.03
    x8, sx = Q.quantize_rows_plain(x)
    w8, sw = Q.quantize_rows_plain(w)
    assert torch.equal(Q.w8a8_dot(x, w),
                       Q.w8a8_linear_plain(x8, sx, w8, sw))


@pytest.mark.cuda
def test_w8a8_refusals(cuda):
    """The kernels refuse what they do not take before a launch, and every
    W8A8 route refuses autograd."""
    before = (Q.quantize_rows_kernel.launches, Q.w8a8_gemm_kernel.launches)
    x8 = torch.zeros((8, 32), dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        Q.quantize_rows_kernel(torch.zeros((4, 8), dtype=torch.float16,
                                           device=cuda))
    with pytest.raises(ValueError):
        Q.quantize_rows_kernel(torch.zeros((4, 8), device=cuda), kpad=8)
    with pytest.raises(ValueError):
        Q.w8a8_gemm_kernel(x8[:, :24], s, x8[:, :24], s)     # K 24
    with pytest.raises(ValueError):
        Q.w8a8_gemm_kernel(x8.float(), s, x8, s)
    with pytest.raises(ValueError):
        Q.w8a8_gemm_kernel(x8, s, x8, s, dtype=torch.float16)
    assert (Q.quantize_rows_kernel.launches,
            Q.w8a8_gemm_kernel.launches) == before
    w = torch.zeros((8, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        Q.w8a8_dot(torch.zeros((4, 32), device=cuda), w)
