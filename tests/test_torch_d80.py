"""K1's and K4's tiles of 80 columns (heads of 66 to 80, multiples of 8):
which instantiation each flash kernel runs a head width on, on any
machine, and on an NVIDIA Hopper GPU the d-80 kernels against their plain
versions, the kernel each launch runs, and the launches by width.

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

_BF16_TILES = ("K1", "K4")              # 32, 64, 80 and 128
_INT8_TILES = ("K3", "K8", "K7", "R6")  # 32, 64 and 128


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_instantiation_of_each_head_width(d):
    """K1 and K4 run heads of 66 to 80 on the d-80 tiles and of 88 to 128
    on the d-128 ones; K3, K8, K7 and R6 (the codes the int8 kernels read)
    keep 32, 64 and 128, so heads of 72 and 80 stay on 128 there."""
    want = 32 if d <= 32 else 64 if d <= 64 else 128
    for kernel in _INT8_TILES:
        assert A._tile_width(d, kernel) == want
    assert A._tile_width(d) == want
    for kernel in _BF16_TILES:
        assert A._tile_width(d, kernel) == (80 if 64 < d <= 80 else want)


@pytest.mark.parametrize("d", [64, 72, 80, 88, 128])
def test_tail_maps_of_the_d80_tiles(d):
    """K1 and K4 read a head of 72 or 80 by two maps, the 64-column panel
    in the 128-byte swizzle and the last 16 columns (box 16 at column 64)
    in the 32-byte one, both at the real width; every other width, and
    K3's and K7's bf16 operands at any width, by one."""
    t = torch.zeros(2, 129, 3, d, dtype=torch.bfloat16)
    base = A._tma_geometry(t, 128)
    for kernel in _BF16_TILES:
        geo = A._tma_geometry(t, 64, kernel)
        assert geo["dims"] == base["dims"] == (d, 3, 129, 2)
        assert geo["box"] == (64, 1, 64, 1) and geo["swizzle"] == 128
        if d in (72, 80):
            assert geo["tail"] == {"col": 64, "box": (16, 1, 64, 1),
                                   "swizzle": 32}
        else:
            assert "tail" not in geo
    for kernel in ("K3", "K7"):
        assert "tail" not in A._tma_geometry(t, 128, kernel)


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
    and flash_bwd_sm90_kernel<80, NARROW> (NARROW for 72: 72 columns
    stored), one of 88 the d-128 ones, one of 64 the d-64 ones; K7 at 80
    stays on the d-128 tiles."""
    q, k, v, do = _inputs(cuda, 47, 1, 300, 2, d, 4)
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    word, bit = ("true", 1) if narrow else ("false", 0)
    fwd = _instantiation(_launched(lambda: A.flash_attention(
        q, k, v, with_lse=True)), "flash_fwd_sm90_kernel")
    bwd = _instantiation(_launched(lambda: A.flash_attention_bwd(
        q, k, v, out, lse, do)), "flash_bwd_sm90_kernel")
    assert fwd in (f"{tiles},false,{word}", f"ILi{tiles}ELb0ELb{bit}E")
    assert bwd in (f"{tiles},{word}", f"ILi{tiles}ELb{bit}E")
    if d == 80:
        i8 = _instantiation(_launched(lambda: A.flash_attention_bwd_i8(
            q, k, v, out, lse, do)), "flash_bwd_i8_sm90_kernel")
        assert i8 in ("128,true", "ILi128ELb1E")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [193, 729])
def test_k7_reads_the_d80_forward_lse(cuda, n):
    """Under "pallas_i8bwd" K1 runs on the d-80 tiles and K7 on the d-128
    ones: the lse2 K1 writes has the layout K7 reads, (B, H, Nq) f32, so
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
