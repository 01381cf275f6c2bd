"""Where FSDP2's cost goes at one rank: the full-width MIM step of
configs/mim_base_512.json on one card, without a mesh, under "dp" and
under "fsdp" (FSDP2 over a data axis of 1) in a one-process NCCL group.
For each: the median step, the median optimizer update (the gradient
sync, the clip and AdamW) and the rest (forward and backward with their
hooks and gathers), each synchronised on the card.

    python scripts/torch_fsdp_overhead_probe.py
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import socket
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = 8          # the first two are warm-up


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(policy: str) -> dict:
    import torch

    from smb_vision_tpu_torch.cli import run_mim
    from smb_vision_tpu_torch.ops.masking import mim_mask
    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
    )

    preset = json.loads((ROOT / "configs" / "mim_base_512.json").read_text())
    names = {f.name for f in dataclasses.fields(run_mim.ModelArguments)}
    cfg = run_mim.build_config(run_mim.ModelArguments(
        **{k: v for k, v in preset.items() if k in names}))
    dev = torch.device("cuda", 0)
    _, init_fn, step_fn, _ = make_mim_workload(
        cfg, mask_patch_size=preset["mask_patch_size"],
        mask_ratio=preset["mask_ratio"], device=dev,
        tx=functools.partial(make_optimizer, learning_rate=1e-4,
                             total_steps=STEPS))
    state = init_fn(0)
    mesh = None
    if policy != "none":
        from smb_vision_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(device_type="cuda")
    Trainer(args=TrainingArguments(
        output_dir=str(ROOT / "output" / "fsdp_probe" / policy),
        device="cuda", sharding_policy="dp" if policy == "none" else policy),
        state=state, step_fn=step_fn, train_loader=None, mesh=mesh)
    opt = state["optimizer"]
    inner, opt_ms = opt.step, []

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)

    opt.step = timed_step
    gen = torch.Generator(device=dev).manual_seed(0)
    px = torch.rand((1, cfg.num_frames, 1, cfg.image_size, cfg.image_size),
                    generator=gen, device=dev)
    mask = mim_mask(torch.Generator().manual_seed(0), 1,
                    input_size=cfg.image_size, depth=cfg.num_frames,
                    mask_patch_size=preset["mask_patch_size"],
                    model_patch_size=cfg.patch_size,
                    mask_ratio=preset["mask_ratio"]).to(dev)
    step_ms = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, {"pixel_values": px}, mask=mask)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step = statistics.median(step_ms[2:])
    upd = statistics.median(opt_ms[2:])
    return {"step_ms": step, "update_ms": upd, "rest_ms": step - upd}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import subprocess

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for policy in ("none", "dp", "fsdp"):
        if policy == "dp":
            # the process group of one rank, after the run without one
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="localhost",
                              MASTER_PORT=str(free_port()))
            from smb_vision_tpu_torch.parallel.mesh import (
                maybe_initialize_distributed,
            )

            maybe_initialize_distributed(None, device="cuda")
        res = run(policy)
        print(f"MIM step at one rank, {policy}: step {res['step_ms']:.1f} "
              f"ms, optimizer update {res['update_ms']:.1f} ms, forward + "
              f"backward {res['rest_ms']:.1f} ms (medians of "
              f"{STEPS - 2} steps)", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
