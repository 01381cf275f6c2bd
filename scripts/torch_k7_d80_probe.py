#!/usr/bin/env python3
"""Where the time of K7, the int8-score flash-attention backward of the
PyTorch port (`smb_vision_tpu_torch/csrc/flash_bwd.cu`), goes on its tiles
of 80 columns (int8 codes of 96 bytes): the kernel as built beside
variants of it, each built from a patched copy of the package under
`output/` and timed alone (`_launch_bwd_i8` on the operands the
quantisation kernel gives its wrapper) in turns with the others, in one
process, on the same inputs, at the V-JEPA2 ViT-H encoder's shape (N
9,216, 16 heads of 80) and SigLIP so400m's (B 32, N 729, 16 heads of 72),
with the wrapper, the quantisation of q, k, v and do, and K4 on the same
inputs beside them:

  - "no ping-pong": the two consumer warpgroups issue their wgmma when
    their operands are in, without taking turns (the output is the
    kernel's, bit for bit);
  - "dq pass alone" / "dk/dv pass alone": the other pass's blocks of the
    one grid return at once (the output is wrong; each pass's time);
  - "dq key tile 128": the dq pass streams 128 keys a tile at d 80, where
    the kernel streams 64;
  - "6 stages": a ring of 6 stages in both passes, where the kernel has 4.

The variants patch the kernel's source by exact lines, and the script stops
with an error naming the line once that source changes: it records one
measurement of one version of K7 and is not kept in step with the kernel.

Needs a Hopper GPU and nvcc; run from the root of a checkout:
    python3 scripts/torch_k7_d80_probe.py
"""

import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the lines of K7 that the variants replace
DISPATCH = """  if ((int)blockIdx.x < gq)
    dq_pass_i8<D, NARROW>(mq8, mdo8, mk8, mv8, mkb, tails, p, blockIdx.x,
                          smem_raw);
  else
    dkv_pass_i8<D, NARROW>(nk8, nv8, nq8, ndo8, nqb, ndob, tails, p,
                           blockIdx.x - gq, smem_raw);
"""
DQ_TILE = "  static constexpr int BN = 64;   // keys of a tile\n"
STAGES = "constexpr int kStages = 4;\n"
PING_PONG = "constexpr bool kI8PingPong = Codes<D>::TAIL;\n"
PATCHES = {
    "base": [],
    "no ping-pong": [(PING_PONG, "constexpr bool kI8PingPong = false;\n")],
    "dq pass alone": [(DISPATCH, """  if ((int)blockIdx.x < gq)
    dq_pass_i8<D, NARROW>(mq8, mdo8, mk8, mv8, mkb, tails, p, blockIdx.x,
                          smem_raw);
""")],
    "dk/dv pass alone": [(DISPATCH, """  if ((int)blockIdx.x >= gq)
    dkv_pass_i8<D, NARROW>(nk8, nv8, nq8, ndo8, nqb, ndob, tails, p,
                           blockIdx.x - gq, smem_raw);
""")],
    "dq key tile 128": [(DQ_TILE, "  static constexpr int BN = D == 80 ? "
                         "128 : 64;   // keys of a tile\n")],
    "6 stages": [(STAGES, "constexpr int kStages = 6;\n")],
}
# the variants whose output is K7's, held to its plain version; the one
# whose output is the kernel's bit for bit
CORRECT = ("base", "no ping-pong", "dq key tile 128", "6 stages")
SAME = "no ping-pong"
SHAPES = ((1, 9216, 16, 80), (32, 729, 16, 72))
ROUNDS = 3


def variant(name: str, patches: list) -> Path:
    """A copy of the package under output/ with K7's source patched."""
    dst = ROOT / "output" / ("k7_" + name.replace(" ", "_").replace("/", ""))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "smb_vision_tpu_torch",
                    dst / "smb_vision_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "smb_vision_tpu_torch" / "csrc" / "flash_bwd.cu"
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"K7's source changed; no single line {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def main() -> int:
    import torch

    import chip_smoke as C
    from smb_vision_tpu_torch.ops import _build
    from smb_vision_tpu_torch.ops import attention as A

    card = C.phase_device()
    roots = {name: variant(name, patches)
             for name, patches in PATCHES.items() if patches}
    with ThreadPoolExecutor(len(roots)) as pool:
        paths = dict(zip(roots, pool.map(C.build_library, roots.values())))
    libs = {"base": _build.lib()}
    libs.update({name: _build.bind(path) for name, path in paths.items()})
    for name, path in paths.items():
        for line in C.ptxas_report("flash_bwd_i8_sm90_kernelILi80E",
                                   path.parent):
            C.log(f"ptxas {name}: {line}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, n, h, d in SHAPES:
        q, k, v, do = [(torch.randn((b, n, h, d), generator=gen, device=dev)
                        * 0.4).to(torch.bfloat16) for _ in range(4)]
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        shape = f"B={b} N={n} H={h} d={d}"
        scale = d ** -0.5
        w = A._code_width(d, "K7")
        ops = A._i8_operands(q, k, v, do, scale, width=w)
        want = A.attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale)
        times = {}
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                _build._lib = lib
                times.setdefault(name, []).append(C.cuda_ms(
                    lambda: A._launch_bwd_i8(q, k, do, out, lse, ops, scale),
                    repeats=C.KERNEL_REPEATS))
        got = {}
        for name in CORRECT:
            _build._lib = libs[name]
            got[name] = A._launch_bwd_i8(q, k, do, out, lse, ops, scale)
            err = max(C.errors(a, c)[1] for a, c in zip(got[name], want))
            if err > C.TOL_FLASH_BWD:
                raise AssertionError(f"{name} {shape}: rel error {err}")
        same = all(torch.equal(a, c) for a, c in zip(got["base"], got[SAME]))
        C.log(f"K7 {shape} {SAME}: outputs bit for bit the kernel's: {same}")
        if not same:
            raise AssertionError(f"{SAME} {shape}: outputs differ")
        _build._lib = libs["base"]
        extra = {
            "wrapper": lambda: A.flash_attention_bwd_i8(q, k, v, out, lse,
                                                        do),
            "R6 on q, k, v, do": lambda: A._i8_operands(q, k, v, do, scale,
                                                        width=w),
            "K4": lambda: A.flash_attention_bwd(q, k, v, out, lse, do)}
        for name, fn in extra.items():
            times[name] = [C.cuda_ms(fn, repeats=C.KERNEL_REPEATS)]
        for name, runs in times.items():
            C.log(f"K7 {shape} {name:<17} {sum(runs) / len(runs):.3f} ms "
                  f"(runs {[round(x, 3) for x in runs]}) on {card}")
        del q, k, v, do, out, lse, want, ops, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
