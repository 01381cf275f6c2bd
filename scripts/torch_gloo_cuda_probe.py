"""Which collectives a gloo process group runs on CUDA tensors: two ranks
on one card (cuda:0), as chip_smoke.py's 2-rank phase puts them.

Each collective runs in a fresh pair of processes, so one that crashes
(a segfault kills the process) is reported and the others still run.
Prints one line a collective: "ok", the exception, or the exit code of
a crash.

    python scripts/torch_gloo_cuda_probe.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

CASES = ("all_reduce", "all_gather", "all_gather_into_tensor",
         "reduce_scatter", "reduce_scatter_tensor", "broadcast",
         "all_to_all_single", "dtensor_full_tensor",
         "dtensor_redistribute_replicate")


def run_case(case: str, rank: int, init: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    if case == "all_reduce":
        dist.all_reduce(x)
    elif case == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif case == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(16, device=dev), x)
    elif case == "reduce_scatter":
        dist.reduce_scatter(torch.empty_like(x), [x, x.clone()])
    elif case == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(4, device=dev), x)
    elif case == "broadcast":
        dist.broadcast(x, 0)
    elif case == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (
            Replicate,
            Shard,
            distribute_tensor,
        )

        mesh = init_device_mesh("cuda", (2,))
        t = distribute_tensor(torch.arange(8.0, device=dev), mesh,
                              [Shard(0)])
        if case == "dtensor_full_tensor":
            t.full_tensor()
        else:
            t.redistribute(mesh, [Replicate()]).to_local()
    torch.cuda.synchronize()
    dist.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--case"]:
        run_case(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        return 0
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for case in CASES:
            init = os.path.join(tmp, f"rdv_{case}")
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--case", case, str(r), init],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=120)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0])
            codes = [p.returncode for p in procs]
            if codes == [0, 0]:
                verdict = "ok"
            else:
                last = [o.strip().splitlines()[-1] if o.strip() else ""
                        for o in outs]
                verdict = f"exit codes {codes}: {last}"
            print(f"gloo on CUDA, {case}: {verdict}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
