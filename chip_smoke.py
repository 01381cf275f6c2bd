#!/usr/bin/env python3
"""Drive the PyTorch port's batch-embedding and MIM-pretraining paths once
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on any
error:
  1. device: a CUDA device is present; print its name and power limit;
  2. build: compile the hand-written kernels from `smb_vision_tpu_torch/csrc`;
  3. kernels: every kernel of the embedding path against its plain PyTorch
     version at the main-path and a ragged shape, with its time beside the
     plain one; then the training kernels (K4, K5a, K5b) at the MIM
     encoder's and decoder's shapes and a ragged one;
  4. leg A: `run_inference` on 4 synthetic 512x512x320 CT volumes, bf16,
     attention and MLP impls at "auto" (kernels K1 and K2);
  5. leg B: the same with --attn_impl pallas_int8 and a config that pins
     mlp_impl "pallas_bwd" (kernels K3 and K6);
  6. whole model: kernels against the plain path on one volume;
  7. throughput: encoder volumes/s at batch 4 for both legs;
  8. training parity: one MIM step of the configs/mim_base_512.json model
     at full width on one volume, kernels against the plain path in bf16
     and a float32 plain run;
  9. leg C: `run_mim` with a copy of configs/mim_base_512.json on the 4
     volumes, 4 steps with checkpoints, then a resume to 6 (kernels K1, K4,
     K5a and K5b in training, K6 in eval);
 10. training throughput: MIM steps/s, MFU and peak memory at batch 1 and 2.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# parity bounds: max|kernel - plain| / max|plain|, from the JAX package's own
# kernel tests (tests/test_attention.py, tests/test_mlp.py)
TOL_FLASH = 1e-2
TOL_INT8 = 1e-2
TOL_INT8_F32 = 2e-2
TOL_MLP = 8e-3
# whole-model bounds, one volume through 12 bf16 layers. Measured on the
# H100: the plain bf16 path and the kernel path each land 1.7-1.8e-2 (of
# max) from a float32 run of the same model, at different elements, so
# the two bf16 paths differ by up to about twice that; 2e-2 between them
# was exceeded by bf16 rounding alone. Hence 3e-2 between the two bf16
# paths, and the kernel path held against float32 directly: no more than
# 1.25x the plain bf16 path's own distance from it.
TOL_MODEL = 3e-2
TOL_MODEL_VS_F32 = 1.25

# training kernels: K4 is held to 2e-2 of max (as K1), K5a/K5b to 3e-2 of
# max, the JAX package's bound for its own pair (tests/test_mlp_bwd.py)
TOL_FLASH_BWD = 2e-2
TOL_MLP_TRAIN = 3e-2
# one MIM step at full width: the kernel path's loss within 1e-2 relative
# of the plain bf16 path's, and its global gradient error against a
# float32 run, ||g - g32|| / ||g32|| over all parameters, at most 1.25x the
# plain bf16 path's (the rule of the whole-model forward above)
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD_VS_F32 = 1.25

MAIN_N = 20480          # 512/16 * 512/16 * 320/16 tokens
RAGGED_N = 1960         # 224/16 * 224/16 * 160/16 tokens
HEADS, HEAD_DIM, HIDDEN, FFN = 12, 64, 768, 3072
# MIM at mask 0.65 (configs/mim_base_512.json): the encoder sees 7,168 of
# the 20,480 tokens; the decoder is 384 wide with 6 heads of 64
ENC_N = 7168
DEC_HIDDEN, DEC_HEADS, DEC_FFN = 384, 6, 1536
MIM_PRESET = ROOT / "configs" / "mim_base_512.json"

SOURCES = {
    "flash_fwd": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                  "smb_vision_tpu/ops/attention.py:106"),
    "flash_fwd_i8": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                     "smb_vision_tpu/ops/attention.py:244"),
    "mlp_block_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                      "smb_vision_tpu/ops/mlp.py:214"),
    "mlp_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                "smb_vision_tpu/ops/mlp.py:109"),
    "flash_bwd": ("smb_vision_tpu_torch/csrc/flash_bwd.cu",
                  "smb_vision_tpu/ops/attention.py:436"),
    "mlp_train_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                      "smb_vision_tpu/ops/mlp.py:137"),
    "mlp_bwd": ("smb_vision_tpu_torch/csrc/mlp_bwd.cu",
                "smb_vision_tpu/ops/mlp.py:171"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers():
    from smb_vision_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_int8,
    )
    from smb_vision_tpu_torch.ops.mlp import (
        mlp_block_fused,
        mlp_bwd_fused,
        mlp_fused,
        mlp_train_fused,
    )

    return {"flash_fwd": flash_attention,
            "flash_fwd_i8": flash_attention_int8,
            "mlp_block_fwd": mlp_block_fused, "mlp_fwd": mlp_fused,
            "flash_bwd": flash_attention_bwd,
            "mlp_train_fwd": mlp_train_fused, "mlp_bwd": mlp_bwd_fused}


def reset_launches() -> dict:
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    return ws


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean time of fn() on the device, by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def errors(out, ref):
    """(max|out - ref|, max|out - ref| / max|ref|); inf if out is not
    finite."""
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        return math.inf, math.inf
    err = float((out - ref).abs().max())
    return err, err / float(ref.abs().max())


def phase_device() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from smb_vision_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path.parent.name}")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")


def _attn_inputs(n: int, gen, dev):
    """q, k, v ~ N(0, 0.4^2), the distribution of the JAX package's own
    attention tests (tests/test_attention.py::_qkv), whose bounds these
    are."""
    import torch

    shape = (1, n, HEADS, HEAD_DIM)
    return [(torch.randn(shape, generator=gen, device=dev) * 0.4).to(
        torch.bfloat16) for _ in range(3)]


def _mlp_inputs(m: int, gen, dev):
    """x and Linear-layout bf16 weights (passed as transposed views, as
    the model passes them)."""
    import torch

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    x = r(m, HIDDEN).to(torch.bfloat16)
    lnw, lnb = 1.0 + r(HIDDEN, s=0.1), r(HIDDEN, s=0.1)
    w1 = r(FFN, HIDDEN, s=HIDDEN ** -0.5).to(torch.bfloat16)
    w2 = r(HIDDEN, FFN, s=FFN ** -0.5).to(torch.bfloat16)
    b1, b2 = r(FFN, s=0.1), r(HIDDEN, s=0.1)
    return x, lnw, lnb, w1.t(), b1, w2.t(), b2


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main-path shape and a
    ragged one, and its time beside the plain version's at the main-path
    shape. Returns {name: record} for the JSON kernel table."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = {name: {"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": 0, "max_abs_err": 0.0,
                    "ms": None, "plain_ms": None}
             for name, (src, rep) in SOURCES.items()}

    def check(name, n, out, ref, tol, what="plain"):
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        log(f"{name:<14} N={n:<6} vs {what:<11} max|d| {err:.3e}  "
            f"rel {rel:.3e} (bound {tol})")
        if not rel <= tol:
            raise AssertionError(f"{name} at N={n}: rel {rel} > {tol}")
        if what == "plain":
            table[name]["max_abs_err"] = max(table[name]["max_abs_err"], err)

    def timed(name, kernel, plain, iters):
        table[name]["ms"] = cuda_ms(kernel, iters=iters)
        table[name]["plain_ms"] = cuda_ms(plain, iters=max(2, iters // 4))

    scale = 1.0 / math.sqrt(HEAD_DIM)
    for n in (MAIN_N, RAGGED_N):
        q, k, v = _attn_inputs(n, gen, dev)
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
        check("flash_fwd", n, out, ref, TOL_FLASH)
        check("flash_fwd", n, lse, ref_lse, TOL_FLASH, "plain lse2")
        q8, k8, sq, sk = A.quantize_qk(q, k, scale)
        out8 = A.flash_attention_int8(q, k, v)
        check("flash_fwd_i8", n, out8,
              A.int8_attention_plain(q8, k8, sq, sk, v), TOL_INT8)
        check("flash_fwd_i8", n, out8,
              A.xla_attention(q.float(), k.float(), v.float()),
              TOL_INT8_F32, "f32 softmax")
        if n == MAIN_N:
            timed("flash_fwd", lambda: A.flash_attention(q, k, v),
                  lambda: A.xla_attention(q, k, v), 8)
            timed("flash_fwd_i8", lambda: A.flash_attention_int8(q, k, v),
                  lambda: A.int8_attention_plain(
                      *A.quantize_qk(q, k, scale), v), 8)
        del q, k, v, out, ref, out8

        x, lnw, lnb, w1, b1, w2, b2 = _mlp_inputs(n, gen, dev)
        eps = 1e-12
        check("mlp_block_fwd", n,
              M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, eps=eps),
              M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, "gelu", eps),
              TOL_MLP)
        check("mlp_fwd", n, M.mlp_fused(x, w1, b1, w2, b2),
              M._mlp_xla(x, w1, b1, w2, b2, "gelu"), TOL_MLP)
        if n == MAIN_N:
            timed("mlp_block_fwd",
                  lambda: M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2,
                                            eps=eps),
                  lambda: M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2,
                                           "gelu", eps), 20)
            timed("mlp_fwd", lambda: M.mlp_fused(x, w1, b1, w2, b2),
                  lambda: M._mlp_xla(x, w1, b1, w2, b2, "gelu"), 20)
    for rec in table.values():
        if rec["ms"] is not None:
            log(f"time {rec['name']:<14} kernel {rec['ms']:.3f} ms, plain "
                f"{rec['plain_ms']:.3f} ms (main-path shape, CUDA events)")
    phase_train_kernels(table, gen, dev)
    return table


def phase_train_kernels(table: dict, gen, dev) -> None:
    """K4 against its plain backward, K5a and K5b against theirs, at the
    MIM encoder's and decoder's shapes and a ragged one, on the same
    inputs; times at both MIM shapes (the table keeps the encoder's)."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    def check(name, what, out, ref, tol):
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        log(f"{name:<14} {what:<26} max|d| {err:.3e}  rel {rel:.3e} "
            f"(bound {tol})")
        if not rel <= tol:
            raise AssertionError(f"{name} {what}: rel {rel} > {tol}")
        table[name]["max_abs_err"] = max(table[name]["max_abs_err"], err)

    def timed(name, shape, kernel, plain, iters, keep):
        ms, plain_ms = cuda_ms(kernel, iters=iters), cuda_ms(plain, iters=2)
        log(f"time {name:<14} {shape:<22} kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (CUDA events)")
        if keep:
            table[name]["ms"], table[name]["plain_ms"] = ms, plain_ms

    scale = 1.0 / math.sqrt(HEAD_DIM)
    for n, h, label in ((ENC_N, HEADS, "encoder"), (MAIN_N, DEC_HEADS,
                                                    "decoder"),
                        (RAGGED_N, HEADS, "ragged")):
        q, k, v, do = [(torch.randn((1, n, h, HEAD_DIM), generator=gen,
                                    device=dev) * 0.4).to(torch.bfloat16)
                       for _ in range(4)]
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        got = A.flash_attention_bwd(q, k, v, out, lse, do)
        want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=scale)
        for what, a, b in zip(("dq", "dk", "dv"), got, want):
            check("flash_bwd", f"N={n} H={h} {what}", a, b, TOL_FLASH_BWD)
        del got, want
        if label != "ragged":
            timed("flash_bwd", f"{label} N={n} H={h}",
                  lambda: A.flash_attention_bwd(q, k, v, out, lse, do),
                  lambda: A.attention_bwd_plain(q, k, v, out, lse, do,
                                                scale=scale),
                  5, label == "encoder")
        del q, k, v, do, out, lse

    for m, kd, f, label in ((ENC_N, HIDDEN, FFN, "encoder"),
                            (MAIN_N, DEC_HIDDEN, DEC_FFN, "decoder"),
                            (RAGGED_N, HIDDEN, FFN, "ragged")):
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s

        x = r(m, kd).to(torch.bfloat16)
        w1 = r(f, kd, s=kd ** -0.5).to(torch.bfloat16).t()
        w2 = r(kd, f, s=f ** -0.5).to(torch.bfloat16).t()
        b1, b2 = r(f, s=0.1), r(kd, s=0.1)
        g = r(m, kd).to(torch.bfloat16)
        y, hh = M.mlp_train_fused(x, w1, b1, w2, b2)
        y_ref, h_ref = M._mlp_train_plain(x, w1, b1, w2, b2, "gelu")
        what = f"M={m} K={kd} F={f}"
        check("mlp_train_fwd", what + " y", y, y_ref, TOL_MLP_TRAIN)
        check("mlp_train_fwd", what + " h", hh, h_ref, TOL_MLP_TRAIN)
        got = M.mlp_bwd_fused(hh, g, w1, w2)
        want = M._mlp_bwd_plain(hh, g, w1, w2, "gelu")
        for name, a, b in zip(("dx", "dh", "a"), got, want):
            check("mlp_bwd", f"{what} {name}", a, b, TOL_MLP_TRAIN)
        if label != "ragged":
            keep = label == "encoder"
            timed("mlp_train_fwd", f"{label} {what}",
                  lambda: M.mlp_train_fused(x, w1, b1, w2, b2),
                  lambda: M._mlp_train_plain(x, w1, b1, w2, b2, "gelu"),
                  20, keep)
            timed("mlp_bwd", f"{label} {what}",
                  lambda: M.mlp_bwd_fused(hh, g, w1, w2),
                  lambda: M._mlp_bwd_plain(hh, g, w1, w2, "gelu"), 20, keep)


VOL_SHAPE = (256, 256, 160)    # int16 HU at spacing (3, 3, 6) mm: the
VOL_SPACING = (3.0, 3.0, 6.0)  # smb-vision spacing (1.5, 1.5, 3) makes it
N_VOLUMES = 4                  # exactly 512 x 512 x 320


def write_volumes(root: Path) -> Path:
    """N_VOLUMES seeded synthetic CT volumes as uncompressed NIfTI."""
    import numpy as np

    from smb_vision_tpu_torch.data.nifti import save_nifti

    vols = root / "volumes"
    vols.mkdir(parents=True)
    rng = np.random.default_rng(0)
    affine = np.diag([*VOL_SPACING, 1.0])
    for i in range(N_VOLUMES):
        hu = rng.normal(-200.0, 400.0, VOL_SHAPE).clip(-1024, 3000)
        save_nifti(vols / f"ct_{i}.nii", hu.astype(np.int16), affine)
    return vols


def vit_base_config(root: Path, name: str, mlp_impl: str) -> Path:
    """ViT-Base VideoMAE at 512^2 x 320, bf16 (the bench.py encoder)."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    cfg = VideoMAEConfig(image_size=512, num_frames=320, patch_size=16,
                         tubelet_size=16, hidden_size=HIDDEN,
                         num_hidden_layers=12, num_attention_heads=HEADS,
                         intermediate_size=FFN, dtype="bfloat16",
                         mlp_impl=mlp_impl)
    path = root / f"{name}.json"
    cfg.save_json(str(path))
    return path


def run_leg(root: Path, vols: Path, leg: str, cfg: Path, extra: list,
            kernels: tuple, table: dict) -> Path:
    """One run_inference over the volumes; asserts the outputs and that
    the leg's kernels launched. Returns the output directory."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_inference import main as run_inference

    out = root / f"emb_{leg}"
    ws = reset_launches()
    t0 = time.perf_counter()
    stats = run_inference([
        "--data_dir", str(vols), "--output_dir", str(out),
        "--config_path", str(cfg), "--batch_size", "2", "--device", "cuda",
        "--num_workers", "2", *extra])
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    log(f"leg {leg}: {stats} in {wall:.1f} s (decode + preprocess + "
        f"encode + write); launches {counts}")
    if stats != {"embedded": N_VOLUMES, "failed": 0, "skipped": 0}:
        raise AssertionError(f"leg {leg}: {stats}")
    npys = sorted(out.glob("*.npy"))
    if len(npys) != N_VOLUMES or not (out / "metadata.json").exists():
        raise AssertionError(f"leg {leg}: {len(npys)} npy files, "
                             f"metadata.json present: "
                             f"{(out / 'metadata.json').exists()}")
    for f in npys:
        emb = np.load(f)
        if emb.shape != (MAIN_N, HIDDEN) or not np.isfinite(emb).all():
            raise AssertionError(f"{f.name}: shape {emb.shape}, finite "
                                 f"{bool(np.isfinite(emb).all())}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"leg {leg}: kernel {name} never launched")
        table[name]["launches"] = counts[name]
    return out


def phase_whole_model(vols: Path, emb_a: Path) -> None:
    """One volume through the model with the kernels and with the plain
    path (attn_impl = mlp_impl = "xla"), same weights."""
    import numpy as np
    import torch

    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import CT_PIPELINES
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    dev = torch.device("cuda")
    pipe = CT_PIPELINES["smb-vision"]
    pipe = type(pipe)(pipe.target_spacing, (512, 512, 320))
    ds = CTDataset(items=[{"image": str(sorted(vols.glob("*.nii"))[0])}],
                   pipeline=pipe, device=dev)
    px = torch.from_numpy(ds[0]["image"][None]).to(dev)

    def model(**kw):
        kw.setdefault("dtype", "bfloat16")
        cfg = VideoMAEConfig(image_size=512, num_frames=320,
                             hidden_size=HIDDEN, num_hidden_layers=12,
                             num_attention_heads=HEADS,
                             intermediate_size=FFN, **kw)
        m = VideoMAEModel(cfg).init_weights(torch.Generator().manual_seed(0))
        return m.to(dev).eval()

    with torch.inference_mode():
        ref = model(attn_impl="xla", mlp_impl="xla")(px)[0].float()
        out = model()(px)[0].float()
        out8 = model(attn_impl="pallas_int8", mlp_impl="pallas_bwd")(
            px)[0].float()
        # float32 model: how far each bf16 path is from the f32 result
        ref32 = model(dtype="float32")(px)[0]
    torch.cuda.synchronize()
    err, rel = errors(out, ref)
    err8, rel8 = errors(out8, ref)
    plain32, kern32 = errors(ref, ref32)[1], errors(out, ref32)[1]
    log(f"whole model vs float32 plain: bf16 plain rel {plain32:.3e}, bf16 "
        f"kernels rel {kern32:.3e} (bound {TOL_MODEL_VS_F32} x plain), int8 "
        f"kernels rel {errors(out8, ref32)[1]:.3e}")
    if not kern32 <= TOL_MODEL_VS_F32 * plain32:
        raise AssertionError(f"kernels are {kern32} from float32, the plain "
                             f"bf16 path {plain32}")
    cli = torch.from_numpy(np.load(emb_a / "ct_0.npy")).to(dev)
    _, cli_rel = errors(cli, out)
    log(f"whole model, 12 layers bf16, kernels (K1+K2) vs plain: max|d| "
        f"{err:.3e} rel {rel:.3e} (bound {TOL_MODEL}); int8 leg (K3+K6) "
        f"vs plain: max|d| {err8:.3e} rel {rel8:.3e}; CLI leg A (batch 2) "
        f"vs this model call (batch 1): rel {cli_rel:.3e}")
    if not rel <= TOL_MODEL:
        raise AssertionError(f"whole model rel {rel} > {TOL_MODEL}")
    if not cli_rel <= TOL_MODEL:
        raise AssertionError(f"CLI embedding differs from the model's: "
                             f"rel {cli_rel}")


def phase_throughput(card: str, batch: int = 4, iters: int = 3) -> dict:
    """Encoder-only volumes/s at 512^2 x 320, batch 4, for both legs:
    CUDA events over `iters` distinct seeded batches after one warm-up."""
    import torch

    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batches = [torch.rand((batch, 320, 1, 512, 512), generator=gen,
                          device=dev).to(torch.bfloat16)
               for _ in range(iters + 1)]
    legs = {"bf16": dict(), "int8": dict(attn_impl="pallas_int8",
                                         mlp_impl="pallas_bwd")}
    rates = {}
    for leg, impls in legs.items():
        cfg = VideoMAEConfig(image_size=512, num_frames=320,
                             hidden_size=HIDDEN, num_hidden_layers=12,
                             num_attention_heads=HEADS,
                             intermediate_size=FFN, dtype="bfloat16",
                             **impls)
        m = VideoMAEModel(cfg).init_weights(
            torch.Generator().manual_seed(0)).to(dev).eval()
        with torch.inference_mode():
            m(batches[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for px in batches[1:]:
                m(px)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / iters
        rates[leg] = batch * 1000.0 / ms
        log(f"throughput {leg}: {rates[leg]:.3f} volumes/s ({ms:.1f} ms per "
            f"batch of {batch}, 512x512x320 ViT-Base d64, encoder only, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB) "
            f"on {card}")
        with torch.inference_mode():
            profile_call(lambda: m(batches[0]),
                         f"{leg}: one batch-{batch} forward")
        del m
    return rates


def profile_call(fn, label: str, top: int = 8) -> None:
    """fn() once under torch.profiler: device busy and idle share of the
    wall time, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"profile {label}: the profiler saw no device time")
        return
    log(f"profile {label}: {wall:.1f} ms wall (profiler on), device busy "
        f"{busy:.1f} ms = {100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% of busy  x{count:<4} "
            f"{key[:100]}")


def mim_config(**kw):
    """The configs/mim_base_512.json model (ViT-Base VideoMAE at 512^2 x
    320, decoder 384 wide and 4 deep, bf16, mlp_impl pallas_bwd, remat)
    built as run_mim builds it, at full width; kw overrides config keys.
    Returns (config, the preset's keys)."""
    from smb_vision_tpu_torch.cli.run_mim import ModelArguments, build_config

    preset = json.loads(MIM_PRESET.read_text())
    names = {f.name for f in dataclasses.fields(ModelArguments)}
    cfg = build_config(ModelArguments(
        **{k: v for k, v in preset.items() if k in names}))
    cfg.update(kw)
    return cfg, preset


def phase_train_parity() -> None:
    """One MIM step (forward + backward, no update) on one volume, the
    same seeded weights and mask, through the kernels (attn auto, mlp
    pallas_bwd, remat), through the plain path in bf16 and through the
    plain path in float32 (TF32 off)."""
    import torch

    from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
    from smb_vision_tpu_torch.ops.masking import mim_mask, num_masked_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg0, preset = mim_config()
    geo = dict(input_size=cfg0.image_size, depth=cfg0.num_frames,
               mask_patch_size=preset["mask_patch_size"],
               model_patch_size=cfg0.patch_size,
               mask_ratio=preset["mask_ratio"])
    nm = num_masked_tokens(**geo)
    if cfg0.seq_len - nm != ENC_N:
        raise AssertionError(f"the preset encodes {cfg0.seq_len - nm} "
                             f"tokens, not {ENC_N}")
    gen = torch.Generator(device=dev).manual_seed(2)
    px = torch.rand((1, cfg0.num_frames, 1, cfg0.image_size,
                     cfg0.image_size), generator=gen, device=dev)
    mask = mim_mask(torch.Generator().manual_seed(0), 1, **geo).to(dev)

    def step(**kw):
        cfg, _ = mim_config(**kw)
        model = VideoMAEForPreTraining(cfg).init_weights(
            torch.Generator().manual_seed(0)).to(dev).train()
        loss = model(px, mask, nm)["loss"]
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        if any(g is None for g in grads):
            raise AssertionError(f"{kw or 'kernel path'}: a parameter got "
                                 "no gradient")
        flat = torch.cat([g.float().flatten() for g in grads])
        del model, grads
        torch.cuda.empty_cache()
        return float(loss.detach()), flat

    ws = reset_launches()
    t0 = time.perf_counter()
    k_loss, k_grad = step()
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    for name in ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"training step: {name} never launched")
    p_loss, p_grad = step(attn_impl="xla", mlp_impl="xla")
    f_loss, f_grad = step(attn_impl="xla", mlp_impl="xla", dtype="float32")
    norm = float(f_grad.norm())
    k_err = float((k_grad - f_grad).norm()) / norm
    p_err = float((p_grad - f_grad).norm()) / norm
    rel_loss = abs(k_loss - p_loss) / abs(p_loss)
    finite = bool(k_grad.isfinite().all())
    log(f"training parity, one MIM step at full width: loss kernels "
        f"{k_loss:.6f}, plain bf16 {p_loss:.6f}, f32 {f_loss:.6f}; rel "
        f"{rel_loss:.3e} (bound {TOL_TRAIN_LOSS}); gradient error vs f32: "
        f"kernels {k_err:.3e}, plain bf16 {p_err:.3e} (bound "
        f"{TOL_TRAIN_GRAD_VS_F32} x plain); kernel step {wall:.1f} s with "
        f"the first calls; launches {counts}")
    if not (finite and math.isfinite(k_loss)):
        raise AssertionError("the kernel path's loss or gradient is not "
                             "finite")
    if not rel_loss <= TOL_TRAIN_LOSS:
        raise AssertionError(f"training loss rel {rel_loss}")
    if not k_err <= TOL_TRAIN_GRAD_VS_F32 * p_err:
        raise AssertionError(f"kernel gradients are {k_err} from float32, "
                             f"the plain bf16 path's {p_err}")


def run_leg_c(work: Path, vols: Path, table: dict) -> None:
    """run_mim on the volumes with a copy of configs/mim_base_512.json:
    4 steps, a checkpoint every 2, eval; then the same to 6 steps, which
    resumes at 4. Asserts the logs, the checkpoints, the export and that
    the training kernels and K6 (eval) launched."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_mim import main as run_mim
    from smb_vision_tpu_torch.train.trainer import Trainer

    spec = work / "mim_data.json"
    spec.write_text(json.dumps({"train": [
        {"image": str(p)} for p in sorted(vols.glob("*.nii"))]}))
    out = work / "mim_out"
    preset = json.loads(MIM_PRESET.read_text())

    def run(steps):
        path = work / f"mim_{steps}.json"
        path.write_text(json.dumps(dict(
            preset, json_path=str(spec), output_dir=str(out),
            num_train_steps=steps, save_steps=2, logging_steps=1,
            do_eval=True)))
        t0 = time.perf_counter()
        res = run_mim([str(path)])
        return res, time.perf_counter() - t0

    ws = reset_launches()
    res4, wall4 = run(4)
    counts = {name: w.launches for name, w in ws.items()}
    res6, wall6 = run(6)
    log(f"leg C: {res4} in {wall4:.1f} s, resumed {res6} in {wall6:.1f} s "
        f"(preprocess + train + eval + save); launches of the first run "
        f"{counts}")
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    for r in train:
        log(f"  step {r['step']}: loss {r['loss']:.6f}, "
            f"{r['step_time_ms']:.1f} ms, mfu {r.get('mfu')}")
    if [r["step"] for r in train] != [1, 2, 3, 4, 5, 6]:
        raise AssertionError(f"leg C logged steps "
                             f"{[r['step'] for r in train]}")
    for r in train:
        if not (math.isfinite(r["loss"]) and r.get("mfu", 0) > 0):
            raise AssertionError(f"leg C step record {r}")
    for res in (res4, res6):
        if not math.isfinite(res.get("eval_loss", math.nan)):
            raise AssertionError(f"leg C eval: {res}")
    ckpts = Trainer.checkpoint_steps(out / "checkpoints")
    if ckpts != [2, 4, 6] or res6["train_steps"] != 6:
        raise AssertionError(f"leg C checkpoints {ckpts}, result {res6}")
    from smb_vision_tpu_torch.models.convert import read_safetensors

    export = read_safetensors(out / "model.safetensors")
    if not (out / "config.json").exists() or not all(
            np.isfinite(v).all() for v in export.values()):
        raise AssertionError("leg C: config.json or a finite "
                             "model.safetensors is missing")
    log(f"leg C: checkpoints {ckpts}, model.safetensors "
        f"{len(export)} tensors, config.json")
    for name in ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd",
                 "mlp_fwd"):
        if counts[name] <= 0:
            raise AssertionError(f"leg C: kernel {name} never launched")
    for name in ("flash_bwd", "mlp_train_fwd", "mlp_bwd"):
        table[name]["launches"] = counts[name]


def phase_train_throughput(card: str, iters: int = 3) -> None:
    """MIM steps of the preset at batch 1 and 2: CUDA events over `iters`
    seeded steps after one warm-up, MFU against the card's dense bf16
    peak, peak memory, and one step under the profiler."""
    import torch

    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import (
        device_peak_flops,
        mim_flops_per_sample,
    )

    dev = torch.device("cuda")
    cfg, preset = mim_config()
    flops = mim_flops_per_sample(cfg, preset["mask_ratio"])
    peak = device_peak_flops(dev)
    for bs in (1, 2):
        model, init_fn, step_fn, _ = make_mim_workload(
            cfg, mask_patch_size=preset["mask_patch_size"],
            mask_ratio=preset["mask_ratio"], tx=functools.partial(
                make_optimizer, learning_rate=preset["learning_rate"],
                total_steps=100, warmup_ratio=preset["warmup_ratio"],
                weight_decay=preset["weight_decay"]), device=dev)
        state = init_fn(0)
        gen = torch.Generator(device=dev).manual_seed(3)
        pxs = [torch.rand((bs, cfg.num_frames, 1, cfg.image_size,
                           cfg.image_size), generator=gen, device=dev)
               for _ in range(iters + 1)]

        def step(i):
            return step_fn(state, {"pixel_values": pxs[i]},
                           step_generator(0, i))

        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = [step(i)["loss"] for i in range(1, iters + 1)]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(float(x)) for x in losses):
            raise AssertionError(f"MIM batch {bs}: losses {losses}")
        mfu = flops * bs / (ms / 1e3) / peak if peak else None
        log(f"MIM train step batch {bs}: {ms:.1f} ms = {1e3 / ms:.3f} "
            f"steps/s, {bs * 1e3 / ms:.3f} volumes/s, MFU {mfu} "
            f"({flops / 1e12:.2f} TFLOP/sample analytic, no remat "
            f"recompute), peak {mem:.1f} GiB, on {card}")
        profile_call(lambda: step(0), f"MIM train step batch {bs}")
        del model, state, pxs
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import smb_vision_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = phase_device()
    phase_build()
    table = phase_kernels()
    work = ROOT / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        vols = write_volumes(work)
        emb_a = run_leg(work, vols, "A", vit_base_config(work, "leg_a",
                                                         "auto"),
                        [], ("flash_fwd", "mlp_block_fwd"), table)
        run_leg(work, vols, "B", vit_base_config(work, "leg_b",
                                                 "pallas_bwd"),
                ["--attn_impl", "pallas_int8"],
                ("flash_fwd_i8", "mlp_fwd"), table)
        phase_whole_model(vols, emb_a)
        run_leg_c(work, vols, table)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_throughput(card)
    phase_train_parity()
    phase_train_throughput(card)
    log(card)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
