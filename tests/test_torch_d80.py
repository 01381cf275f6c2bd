"""The tiles of 80 columns of K1, K4, K3 and K7 (heads of 66 to 80,
multiples of 8; K3's and K7's int8 codes in rows of 96 bytes): which
instantiation each flash kernel runs a head width on and the TMA maps of
its operands, on any machine, and on an NVIDIA Hopper GPU the d-80
kernels against their plain versions, the kernel each launch runs, and
the launches by width.

This file imports torch only (no JAX), so the card tests run where JAX is
absent; tests/conftest.py imports JAX, hence --noconftest there:
    python -m pytest --noconftest -m cuda tests/test_torch_d80.py -q
Without CUDA they skip."""

import math
import re

import pytest
import torch

from smb_vision_tpu_torch.ops import attention as A

torch.set_num_threads(1)

_D80_TILES = ("K1", "K4", "K3", "K7")   # 32, 64, 80 and 128
_INT8_D80 = ("K3", "K7")                 # codes of 96 bytes on the d-80 tiles


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_instantiation_of_each_head_width(d):
    """K1, K4, K3 and K7 run heads of 66 to 80 on the d-80 tiles and of 88
    to 128 on the d-128 ones; K8 keeps 32, 64 and 128 (the default), so
    heads of 72 and 80 stay on 128 there. The codes R6 writes for K3 and
    K7 are rows of 96 bytes on the d-80 tiles, for K8 rows of its
    instantiation's width."""
    want = 32 if d <= 32 else 64 if d <= 64 else 128
    assert A._tile_width(d, "K8") == A._tile_width(d) == want
    assert A._code_width(d, "K8") == A._code_width(d) == want
    for kernel in _D80_TILES:
        assert A._tile_width(d, kernel) == (80 if 64 < d <= 80 else want)
    for kernel in _INT8_D80:
        assert A._code_width(d, kernel) == (96 if 64 < d <= 80 else want)


@pytest.mark.parametrize("d", [64, 72, 80, 88, 128])
def test_tail_maps_of_the_d80_tiles(d):
    """K1, K4, K3 and K7 read a bf16 head of 72 or 80 (K3's v; K7's k, q
    and do) by two maps, the 64-column panel in the 128-byte swizzle and
    the last 16 columns (box 16 at column 64) in the 32-byte one, both at
    the real width; every other width, and K8's operands at any width, by
    one."""
    t = torch.zeros(2, 129, 3, d, dtype=torch.bfloat16)
    base = A._tma_geometry(t, 128)
    for kernel in _D80_TILES:
        geo = A._tma_geometry(t, 64, kernel)
        assert geo["dims"] == base["dims"] == (d, 3, 129, 2)
        assert geo["box"] == (64, 1, 64, 1) and geo["swizzle"] == 128
        if d in (72, 80):
            assert geo["tail"] == {"col": 64, "box": (16, 1, 64, 1),
                                   "swizzle": 32}
        else:
            assert "tail" not in geo
    assert "tail" not in A._tma_geometry(t, 128, "K8")


@pytest.mark.parametrize("d", [72, 80])
def test_int8_code_maps_of_the_d80_tiles(d):
    """The codes K3 and K7 read for heads of 72 and 80 are rows of 96
    bytes, read by two maps of the same dims and strides: the first 64
    bytes (box 64) in the 64-byte swizzle, and the last 32 (box 32 at byte
    64) in the 32-byte one; K8's stay rows of 128, one map in the 128-byte
    swizzle. A code tensor of another width, or a view off 16 bytes,
    raises before a launch."""
    x = torch.zeros(2, 129, 3, d, dtype=torch.bfloat16)
    q8, k8, _, _ = A.quantize_qk(x, x, 0.1)
    ops = A._i8_operands(x, x, x, x, 0.1, A.quantize_per_head,
                         A._code_width(d, "K7"))
    for t in (q8, k8, *ops[:4]):
        assert t.shape == (2, 129, 3, 96) and t.dtype == torch.int8
        for rows in (128, 64):
            assert A._tma_geometry(t, rows) == {
                "dims": (96, 3, 129, 2), "strides": (96, 288, 37152),
                "box": (64, 1, rows, 1), "swizzle": 64,
                "tail": {"col": 64, "box": (32, 1, rows, 1),
                         "swizzle": 32}}
    q8, _, _, _ = A.quantize_qk(x, x, 0.1, kernel="K8")
    assert A._tma_geometry(q8, 64) == {
        "dims": (128, 3, 129, 2), "strides": (128, 384, 49536),
        "box": (128, 1, 64, 1), "swizzle": 128}
    with pytest.raises(ValueError, match="D in"):
        A._tma_geometry(torch.zeros(1, 8, 2, 80, dtype=torch.int8), 64)
    with pytest.raises(ValueError, match="multiples of 16"):  # 104-byte rows
        A._tma_geometry(torch.zeros(1, 8, 2, 104, dtype=torch.int8)[..., :96],
                        64)
    flat = torch.zeros(1 + 64 * 2 * 96, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        A._tma_geometry(flat[1:].view(1, 64, 2, 96), 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    assert bool(out.isfinite().all())
    return float((out - ref).abs().max() / ref.abs().max())


def _inputs(dev, seed, b, n, h, d, count):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((b, n, h, d), generator=gen, device=dev) * 0.4).to(
        torch.bfloat16) for _ in range(count)]


# the d-80 tiles' edges (64-row warpgroups, 128-key tiles in K1, 64-query
# tiles in K4's dk/dv pass, 128-row blocks), ragged N, SigLIP so400m's 729
# tokens and DINOv2-giant's ragged 1,961
_D80_SHAPES = [(1, 80), (63, 72), (64, 80), (65, 80), (127, 72), (128, 80),
               (129, 80), (193, 72), (729, 72), (1961, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", _D80_SHAPES)
def test_d80_kernels_match_plain(cuda, n, d):
    """K1 (out and lse2) and K4 (dq, dk, dv, with an lse2 cotangent) at
    heads of 72 and 80 against their plain versions, within the bounds of
    tests/test_torch_kernels.py (1e-2 of max, lse2 1e-3, the backward 2e-2
    of max), one launch each counted at the real width."""
    q, k, v, do = _inputs(cuda, 41, 2, n, 3, d, 4)
    gen = torch.Generator(device=cuda).manual_seed(43)
    g_lse = torch.randn((2, 3, n), generator=gen, device=cuda) * 0.1
    scale = 1.0 / math.sqrt(d)
    before = (A.flash_attention.launches_by_width.get(d, 0),
              A.flash_attention_bwd.launches_by_width.get(d, 0))
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
    assert out.shape == q.shape and _rel(out, ref) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    got = A.flash_attention_bwd(q, k, v, out, lse, do, g_lse=g_lse)
    want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=scale,
                                 g_lse=g_lse)
    for a, b in zip(got, want):
        assert a.shape == q.shape and _rel(a, b) <= 2e-2
    assert (A.flash_attention.launches_by_width[d],
            A.flash_attention_bwd.launches_by_width[d]) == tuple(
                c + 1 for c in before)


# K3 and K7 at the same edges (K3 streams 128-key tiles, K7's dq pass
# 64-key ones and its dk/dv pass 64-query ones) and with Nq != Nk both ways
_I8_D80_SHAPES = [(n, n, d) for n, d in _D80_SHAPES] + [
    (70, 200, 80), (200, 70, 72), (729, 193, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", _I8_D80_SHAPES)
def test_int8_d80_kernels_match_plain(cuda, nq, nk, d):
    """K3 and K7 at heads of 72 and 80 on their d-80 tiles (codes of 96
    bytes) against their plain versions on the same codes, within the
    bounds of tests/test_torch_kernels.py (K3 1e-2 of max; K7's dq, dk and
    dv, with an lse2 cotangent, 2e-2), one launch each counted at the real
    width; each wrapper (codes by R6) equals its kernel fed the plain
    codes bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(59)

    def r(n):
        return (torch.randn((2, n, 3, d), generator=gen, device=cuda)
                * 0.4).to(torch.bfloat16)

    q, k, v, do = r(nq), r(nk), r(nk), r(nq)
    g_lse = torch.randn((2, 3, nq), generator=gen, device=cuda) * 0.1
    scale = 1.0 / math.sqrt(d)
    before = (A.flash_attention_int8.launches_by_width.get(d, 0),
              A.flash_attention_bwd_i8.launches_by_width.get(d, 0))
    q8, k8, sq, sk = A.quantize_qk(q, k, scale, A.quantize_per_head)
    assert q8.shape[-1] == k8.shape[-1] == 96
    out8 = A.flash_attention_int8(q, k, v)
    assert out8.shape == q.shape
    assert _rel(out8, A.int8_attention_plain(q8, k8, sq, sk, v)) <= 1e-2
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    got = A.flash_attention_bwd_i8(q, k, v, out, lse, do, g_lse=g_lse)
    want = A.attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale,
                                    g_lse=g_lse)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.shape == t.shape and _rel(a, b) <= 2e-2
    assert (A.flash_attention_int8.launches_by_width[d],
            A.flash_attention_bwd_i8.launches_by_width[d]) == tuple(
                c + 1 for c in before)
    assert torch.equal(out8, A._launch_int8(q8, k8, sq, sk, v))
    ops = A._i8_operands(q, k, v, do, scale, A.quantize_per_head, 96)
    for a, b in zip(got, A._launch_bwd_i8(q, k, do, out, lse, ops, scale,
                                          g_lse)):
        assert torch.equal(a, b)


def _launched(fn) -> list:
    """The names of the events of three calls of fn under the profiler,
    the CUDA kernels among them. A session now and then delivers the
    runtime's calls without the kernels' records (the CUPTI buffer not yet
    handed over); then a new session is taken, up to three."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()]
        if any("sm90_kernel" in name for name in names):
            break
    return names


def _instantiation(names: list, template: str) -> str:
    """The template arguments of the one launched kernel of `template`
    (demangled, "80, false, true", or mangled, "ILi80ELb0ELb1E")."""
    found = {re.sub(r"\s", "", m.group(1) or m.group(2))
             for name in names for m in [re.search(
                 template + r"(?:<([^>]*)>|(I(?:L[ib]\d+E)+E))", name)]
             if m}
    assert len(found) == 1, (template, names)
    return found.pop()


@pytest.mark.cuda
@pytest.mark.parametrize("d,tiles,narrow", [(72, 80, True), (80, 80, False),
                                            (88, 128, True),
                                            (64, 64, False)])
def test_launch_runs_the_d80_instantiation(cuda, d, tiles, narrow):
    """A head of 72 or 80 launches flash_fwd_sm90_kernel<80, false, NARROW>
    (K1), flash_bwd_sm90_kernel<80, NARROW> (K4), flash_fwd_sm90_kernel<80,
    true, NARROW> (K3) and flash_bwd_i8_sm90_kernel<80, NARROW> (K7)
    (NARROW for 72: 72 columns stored), one of 88 the d-128 ones, one of 64
    the d-64 ones."""
    q, k, v, do = _inputs(cuda, 47, 1, 300, 2, d, 4)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    word, bit = ("true", 1) if narrow else ("false", 0)
    fwd = _instantiation(_launched(lambda: A.flash_attention(
        q, k, v, with_lse=True)), "flash_fwd_sm90_kernel")
    bwd = _instantiation(_launched(lambda: A.flash_attention_bwd(
        q, k, v, out, lse, do)), "flash_bwd_sm90_kernel")
    k3 = _instantiation(_launched(lambda: A.flash_attention_int8(
        q, k, v)), "flash_fwd_sm90_kernel")
    k7 = _instantiation(_launched(lambda: A.flash_attention_bwd_i8(
        q, k, v, out, lse, do)), "flash_bwd_i8_sm90_kernel")
    assert fwd in (f"{tiles},false,{word}", f"ILi{tiles}ELb0ELb{bit}E")
    assert bwd in (f"{tiles},{word}", f"ILi{tiles}ELb{bit}E")
    assert k3 in (f"{tiles},true,{word}", f"ILi{tiles}ELb1ELb{bit}E")
    assert k7 in (f"{tiles},{word}", f"ILi{tiles}ELb{bit}E")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [193, 729])
def test_k7_reads_the_d80_forward_lse(cuda, n):
    """Under "pallas_i8bwd" K1 and K7 run on the d-80 tiles: the lse2 K1
    writes has the layout K7 reads, (B, H, Nq) f32, so
    K7 on K1's out and lse2 meets its plain version on the same within
    2e-2 of max, and the route trains through both kernels."""
    d = 80
    q, k, v, do = _inputs(cuda, 53, 2, n, 3, d, 4)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    _, ref_lse = A.xla_attention(q, k, v, with_lse=True)
    assert lse.shape == (2, 3, n) and lse.dtype == torch.float32
    assert lse.is_contiguous()
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    got = A.flash_attention_bwd_i8(q, k, v, out, lse, do)
    want = A.attention_bwd_i8_plain(q, k, v, out, lse, do,
                                    scale=1.0 / math.sqrt(d))
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-2
    leaf = q.detach().requires_grad_()
    before = (A.flash_attention.launches_by_width.get(d, 0),
              A.flash_attention_bwd_i8.launches_by_width.get(d, 0))
    A.attention(leaf, k, v, impl="pallas_i8bwd").float().sum().backward()
    assert (A.flash_attention.launches_by_width[d],
            A.flash_attention_bwd_i8.launches_by_width[d]) == tuple(
                c + 1 for c in before)
    assert leaf.grad is not None and bool(leaf.grad.isfinite().all())
