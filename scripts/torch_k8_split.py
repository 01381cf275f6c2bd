#!/usr/bin/env python3
"""Where the time of K8, the int8 p v flash forward of the PyTorch port
(`smb_vision_tpu_torch/csrc/flash_fwd.cu`), goes: the kernel as built
beside variants of it, each built from a patched copy of the package
under `output/` and timed alone (`_launch_int8pv`) in turns with the
others, in one process, on the same inputs, at the embed shape (N 20,480,
12 heads of 64) and the V-JEPA encoder's (N 9,216, 8 heads of 128), with
K3's kernel alone on the same inputs and the exp2 floor beside them:

  - "small-int fold": the fold converts n_u by K3's integer-add trick;
  - "floor(y + .5)": p8 rounded by two adds, as the JAX kernel rounds,
    for the shipped round-to-nearest by one;
  - "skip unit rescale": the fold's o a skipped where no row of the warp
    moved its max (a warp vote and a branch);
  - "no fold": the fold of n_u and l_u into o and l skipped (the output is
    wrong; the time without the rescale);
  - "no exp2": the requantisation's exp2 and rounding replaced by a move
    (wrong output; the time without them).

The variants patch the kernel's source by exact lines, and the script stops
with an error naming the line once that source changes: it records one
measurement of one version of K8 and is not kept in step with the kernel.

Needs a Hopper GPU and nvcc; run from the root of a checkout:
    python3 scripts/torch_k8_split.py
"""

import math
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the lines of K8's requantisation and fold that the variants replace
ROUND = ("          const float y = ex2(fmaf(x - sm[j / 8][e >> 1], c, "
         "kLog127));\n"
         "          si[4 * j + e] = rint_bits(y);")
FOLD = "          acc = fmaf(fw[u][r], __int2float_rn((int)n[u][i]), acc);"
RESCALE = """#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int r = (i >> 1) & 1;
        float acc = o[i] * (r ? fa1 : fa0);
"""
PATCHES = {
    "base": [],
    "small-int fold": [(FOLD, "          acc = fmaf(fw[u][r], __int_as_float("
                        "(int)n[u][i] + 0x4B400000) - 12582912.f, acc);")],
    "floor(y + .5)": [(ROUND, "          si[4 * j + e] = __float_as_uint("
                       "__fadd_rz(ex2(fmaf(x - sm[j / 8][e >> 1], c, "
                       "kLog127)) + 0.5f, 8388608.f));")],
    "skip unit rescale": [(RESCALE, """      if (__any_sync(0xffffffffu,
                     fa0 != 1.f || fa1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? fa1 : fa0;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int r = (i >> 1) & 1;
        float acc = o[i];
""")],
    "no fold": [("    auto fold = [&]() {\n",
                 "    auto fold = [&]() {\n      if (p.Nk > 0) return;\n")],
    "no exp2": [(ROUND, "          si[4 * j + e] = "
                 "__float_as_uint(x - sm[j / 8][e >> 1]);")],
}
SHAPES = ((20480, 12, 64), (9216, 8, 128))


def variant(name: str) -> Path:
    """The kernel library of the named variant, built in its own process."""
    import chip_smoke as S
    from smb_vision_tpu_torch.ops import _build

    if not PATCHES[name]:
        return _build.build()
    dst = ROOT / "output" / ("k8_" + "".join(
        ch if ch.isalnum() else "_" for ch in name))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "smb_vision_tpu_torch",
                    dst / "smb_vision_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "smb_vision_tpu_torch" / "csrc" / "flash_fwd.cu"
    text = src.read_text()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the line to patch is not "
                               f"in flash_fwd.cu once: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return S.build_library(dst)


def main() -> int:
    import torch

    import chip_smoke as S
    from smb_vision_tpu_torch.ops import _build
    from smb_vision_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("torch_k8_split: no CUDA device")
    card = S.phase_device()
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        paths = dict(zip(PATCHES, pool.map(variant, PATCHES)))
    libs = {name: _build.bind(path) for name, path in paths.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, h, d in SHAPES:
        q, k, v = [(torch.randn((1, n, h, d), generator=gen, device=dev)
                    * 0.4).to(torch.bfloat16) for _ in range(3)]
        ops = A.quantize_qk(q, k, 1 / math.sqrt(d))
        vt8, sv = A.quantize_per_head_kernel(v, v_layout=True)
        times = {name: [] for name in libs}
        for _ in range(3):
            for name in list(libs) + list(libs)[::-1]:
                _build._lib = libs[name]
                times[name].append(S.cuda_ms(
                    lambda: A._launch_int8pv(*ops, vt8, sv), iters=10))
        _build._lib = libs["base"]
        k3 = S.cuda_ms(lambda: A._launch_int8(*ops, v), iters=10)
        for name, ts in times.items():
            S.log(f"K8 split N={n} H={h} d={d}: {name} "
                  f"{sum(ts) / len(ts):.4f} ms (runs "
                  f"{[round(t, 4) for t in ts]}); K3 kernel alone {k3:.4f} "
                  f"ms; exp2 floor {S.exp2_floor_ms(n, h):.4f} ms on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
