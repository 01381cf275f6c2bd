#!/usr/bin/env python3
"""Where the time of K4, the flash-attention backward of the PyTorch port
(`smb_vision_tpu_torch/csrc/flash_bwd.cu`), goes on its tiles of 80
columns: the kernel as built beside variants of it, each built from a
patched copy of the package under `output/` and timed through its wrapper
in turns with the others, in one process, on the same inputs, at the
ViT-H MIM encoder's shape (N 7,168, 16 heads of 80), SigLIP so400m's (B 32,
N 729, 16 heads of 72) and the MIM encoder's at d 64 (N 7,168, 12 heads),
with the backward of `F.scaled_dot_product_attention` beside them:

  - "dq pass alone" / "dk/dv pass alone": the other pass's blocks of the
    one grid return at once (the output is wrong; each pass's time);
  - "dq key tile 128": the dq pass streams 128 keys a tile at d 80, where
    the kernel streams 64;
  - "6 stages": a ring of 6 stages in both passes, where the kernel has 4
    (this variant runs only at d 80 and below: at d 128 six stages do not
    fit in shared memory).

Last, the weight-gradient product of the "pallas_bwd" MLP route at the
ViT-H MIM encoder's shapes (M 7,168, K 1,280, F 5,120), its f32 result
(`ops/mlp.py::_weight_grad`) beside the bf16 product it replaced.

The variants patch the kernel's source by exact lines, and the script stops
with an error naming the line once that source changes: it records one
measurement of one version of K4 and is not kept in step with the kernel.

Needs a Hopper GPU and nvcc; run from the root of a checkout:
    python3 scripts/torch_k4_d80_probe.py
"""

import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the lines of K4 that the variants replace
DISPATCH = """  if ((int)blockIdx.x < gq)
    dq_pass<D, NARROW>(mq, mdo, mk, mv, tails, p, blockIdx.x, smem_raw);
  else
    dkv_pass<D, NARROW>(nk, nv, nq, ndo, tails, p, blockIdx.x - gq,
                        smem_raw);
"""
DQ_TILE = "  static constexpr int BN = 64;   // keys of a tile\n"
STAGES = "constexpr int kStages = 4;\n"
PATCHES = {
    "base": [],
    "dq pass alone": [(DISPATCH, """  if ((int)blockIdx.x < gq)
    dq_pass<D, NARROW>(mq, mdo, mk, mv, tails, p, blockIdx.x, smem_raw);
""")],
    "dk/dv pass alone": [(DISPATCH, """  if ((int)blockIdx.x >= gq)
    dkv_pass<D, NARROW>(nk, nv, nq, ndo, tails, p, blockIdx.x - gq,
                        smem_raw);
""")],
    "dq key tile 128": [(DQ_TILE, "  static constexpr int BN = D == 80 ? "
                         "128 : 64;   // keys of a tile\n")],
    "6 stages": [(STAGES, "constexpr int kStages = 6;\n")],
}
# the variants whose output is K4's, held to its plain version
CORRECT = ("base", "dq key tile 128", "6 stages")
SHAPES = ((1, 7168, 16, 80), (32, 729, 16, 72), (1, 7168, 12, 64))
ROUNDS = 3


def variant(name: str, patches: list) -> Path:
    """A copy of the package under output/ with K4's source patched."""
    dst = ROOT / "output" / ("k4_" + name.replace(" ", "_").replace("/", ""))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "smb_vision_tpu_torch",
                    dst / "smb_vision_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dst / "smb_vision_tpu_torch" / "csrc" / "flash_bwd.cu"
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"K4's source changed; no single line {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def main() -> int:
    import torch

    import chip_smoke as C
    from smb_vision_tpu_torch.ops import _build
    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    card = C.phase_device()
    roots = {name: variant(name, patches)
             for name, patches in PATCHES.items() if patches}
    with ThreadPoolExecutor(len(roots)) as pool:
        paths = dict(zip(roots, pool.map(C.build_library, roots.values())))
    libs = {"base": _build.lib()}
    libs.update({name: _build.bind(path) for name, path in paths.items()})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, n, h, d in SHAPES:
        q, k, v, do = [(torch.randn((b, n, h, d), generator=gen, device=dev)
                        * 0.4).to(torch.bfloat16) for _ in range(4)]
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        shape = f"B={b} N={n} H={h} d={d}"
        want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=d ** -0.5)
        times = {}
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                if name == "6 stages" and d > 80:
                    continue
                _build._lib = lib
                times.setdefault(name, []).append(C.cuda_ms(
                    lambda: A.flash_attention_bwd(q, k, v, out, lse, do),
                    repeats=C.KERNEL_REPEATS))
        for name in CORRECT:
            if name not in times:
                continue
            _build._lib = libs[name]
            got = A.flash_attention_bwd(q, k, v, out, lse, do)
            err = max(C.errors(a, c)[1] for a, c in zip(got, want))
            if err > C.TOL_FLASH_BWD:
                raise AssertionError(f"{name} {shape}: rel error {err}")
        _build._lib = libs["base"]
        sdpa = C.sdpa_ms(q, k, v, do)
        for name, runs in times.items():
            C.log(f"K4 {shape} {name:<17} {sum(runs) / len(runs):.3f} ms "
                  f"(runs {[round(x, 3) for x in runs]}) on {card}")
        C.log(f"K4 {shape} SDPA backward {sdpa:.3f} ms on {card}")
        del q, k, v, do, out, lse, want
        torch.cuda.empty_cache()
    m, kd, f = 7168, 1280, 5120
    x, dh = (torch.randn((m, c), generator=gen, device=dev).to(
        torch.bfloat16) for c in (kd, f))
    for label, fn in (("f32 result", lambda: M._weight_grad(x, dh)),
                      ("bf16 result", lambda: torch.matmul(x.t(), dh))):
        C.log(f"weight gradient x^T dh M={m} K={kd} F={f}, {label}: "
              f"{C.cuda_ms(fn, iters=20, repeats=C.KERNEL_REPEATS):.3f} ms "
              f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
