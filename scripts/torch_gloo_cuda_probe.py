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
         "dtensor_redistribute_replicate",
         # point to point and the one-split all_to_all_single of the ring
         # shift (parallel/collectives.py), each way: rank 0 -> 1 and 1 -> 0
         "send_recv_up", "send_recv_down", "isend_irecv_up",
         "isend_irecv_down", "batch_isend_irecv", "all_to_all_one_split",
         "all_to_all_one_split_uneven_bf16")


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
    elif case.startswith(("send_recv", "isend_irecv")):
        src = 0 if case.endswith("_up") else 1
        if rank == src:
            op = dist.isend if case.startswith("i") else dist.send
            work = op(x, 1 - rank)
        else:
            op = dist.irecv if case.startswith("i") else dist.recv
            work = op(x, 1 - rank)
        if case.startswith("i"):
            work.wait()
        if rank != src and float(x[0]) != float(src + 1):
            raise AssertionError(f"received {x.tolist()}")
    elif case == "batch_isend_irecv":
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, got, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if float(got[0]) != float(2 - rank):
            raise AssertionError(f"received {got.tolist()}")
    elif case.startswith("all_to_all_one_split"):
        # what ring_shift does: all of x to the other rank, nothing to
        # itself; the uneven case sends 8 + rank bf16 values
        dt = torch.bfloat16 if case.endswith("bf16") else x.dtype
        n_me = 8 + rank if case.endswith("bf16") else 8
        n_other = 8 + (1 - rank) if case.endswith("bf16") else 8
        send = torch.full((n_me,), float(rank + 1), device=dev, dtype=dt)
        got = torch.empty(n_other, device=dev, dtype=dt)
        ins, outs = [0, 0], [0, 0]
        ins[1 - rank], outs[1 - rank] = n_me, n_other
        dist.all_to_all_single(got, send, output_split_sizes=outs,
                               input_split_sizes=ins)
        if float(got[0]) != float(2 - rank):
            raise AssertionError(f"received {got.tolist()}")
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
