"""Where the host time of a mode of `chip_smoke.py`'s 2-rank phase goes:
two gloo ranks on cuda:0, as `chip_smoke.phase_two_ranks` starts them,
each runs the named modes of `chip_smoke.TWO_RANK_MODES` once to warm up
and once under cProfile; rank 0 prints each mode's seconds, its step
times and its functions by cumulative and by own time (the collectives
show as `all_gather_into_tensor` and `all_reduce`).

    python scripts/torch_two_rank_profile.py ["vjepa fsdp+tp gather" ...]

The kernels are built first (`chip_smoke.phase_build`); rank 0's report is
`chiprun_out/two_rank_profile_0.log`. Needs one card.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402

DEFAULT = ["vjepa fsdp+tp gather", "vjepa ring"]


def worker(rank: int, init: str, names: list) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2)
    modes = {m[0]: m for m in C.TWO_RANK_MODES}
    try:
        for name in names:
            t0 = time.perf_counter()
            C.two_rank_steps(modes[name])
            warm = time.perf_counter() - t0
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.enable()
            res = C.two_rank_steps(modes[name])
            prof.disable()
            again = time.perf_counter() - t0
            if rank == 0:
                text = io.StringIO()
                stats = pstats.Stats(prof, stream=text)
                stats.sort_stats("cumulative").print_stats(40)
                stats.sort_stats("tottime").print_stats(20)
                print(f"=== {name}: warm {warm:.1f} s, again {again:.1f} s, "
                      f"step ms {res['step_ms']}\n{text.getvalue()}",
                      flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4:])
        return 0
    names = sys.argv[1:] or DEFAULT
    C.phase_device()
    C.phase_build()
    work = ROOT / "chip_smoke_work" / "two_rank_profile"
    work.mkdir(parents=True, exist_ok=True)
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(work / "rdv"),
         *names], env=env, stderr=subprocess.STDOUT,
        stdout=open(logs / f"two_rank_profile_{r}.log", "w"))
        for r in range(2)]
    try:
        rcs = [p.wait(timeout=1200) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print("ranks' exit codes", rcs)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
