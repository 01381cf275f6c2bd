"""One rank of the port's multi-rank CPU tests, and the steps they run.

`run_ranks(case, world, spec, work)` starts `world` processes of this
file, each `python tests/torch_dist_worker.py CASE RANK WORLD INIT WORK`:
a gloo process group through a `file://` rendezvous under WORK (no fixed
port), one thread a rank, then `CASES[CASE](spec)` on the spec pickled
in WORK. Rank 0's result comes back through WORK. The same `run_steps`
runs in the test's own process without a process group for the
single-process reference.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_ranks(case: str, world: int, spec, work: Path,
              timeout: float = 300.0, env: dict = None):
    """Run CASE on `world` gloo ranks; rank 0's result."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    (work / "spec.pkl").write_bytes(pickle.dumps(spec))
    init = work / "rendezvous"
    if init.exists():
        init.unlink()
    penv = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **(env or {}))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        penv.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(init),
         str(work)], env=penv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"{case}: ranks {bad} failed:\n"
                             + "\n".join(logs[r][-4000:] for r in bad))
    return pickle.loads((work / "out_0.pkl").read_bytes())


# -- the tiny models ---------------------------------------------------------

GEOM = dict(image_size=32, num_frames=32, patch_size=16, tubelet_size=16)
MIM_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=128, decoder_hidden_size=64,
                decoder_num_hidden_layers=1, decoder_num_attention_heads=2,
                decoder_intermediate_size=128, dtype="float32",
                attn_impl="xla", mlp_impl="xla")
MIM_MASK = dict(mask_patch_size=16, mask_ratio=0.5)
VJ_TINY = dict(crop_size=32, frames_per_clip=32, patch_size=16,
               tubelet_size=16, in_chans=1, hidden_size=64,
               num_hidden_layers=2, num_attention_heads=2, mlp_ratio=2.0,
               pred_hidden_size=64, pred_num_hidden_layers=1,
               pred_num_attention_heads=2, pred_mlp_ratio=2.0,
               dtype="float32", attn_impl="xla", mlp_impl="xla")
CLS_TINY = dict(image_size=32, num_frames=32, patch_size=16,
                tubelet_size=16, num_channels=1, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=128, num_labels=1,
                additional_features_size=1, dtype="float32",
                attn_impl="xla", mlp_impl="xla")
# min_fsdp_size of the tiny models: every (64, 64) matrix and larger
MIN_FSDP = 4096


def make_workload(kind: str, cfg: dict, opt: dict, accum: int,
                  device="cpu"):
    """(model, init_fn, step_fn, eval_fn) of the port's workload."""
    from smb_vision_tpu_torch.train import optim as toptim

    tx = functools.partial(toptim.make_optimizer, **opt)
    if kind == "mim":
        from smb_vision_tpu_torch.models.configs import VideoMAEConfig
        from smb_vision_tpu_torch.train.mim import make_mim_workload

        return make_mim_workload(VideoMAEConfig(**cfg), tx=tx,
                                 grad_accum=accum, device=device,
                                 **MIM_MASK)
    if kind == "vjepa":
        from smb_vision_tpu_torch.models.configs import VJEPA2Config
        from smb_vision_tpu_torch.train.vjepa import make_vjepa_workload

        return make_vjepa_workload(VJEPA2Config(**cfg), tx=tx,
                                   grad_accum=accum, device=device)
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.train.classification import (
        make_classification_workload,
    )

    return make_classification_workload(
        VideoMAEConfig(**cfg), task_type="survival", tx=tx,
        grad_accum=accum, device=device)


def _full(t):
    if t is None:
        return None
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy().copy()


def run_steps(spec: dict, policy: str = "dp", model_parallel: int = 1,
              out_dir=None) -> dict:
    """spec["steps"] optimizer steps of spec["kind"] from spec["weights"]
    (the port's state_dict) on the global batches and masks of the spec,
    under `policy` on the world's mesh (one device without a process
    group). Returns the loss of each step, the first step's gradients
    (after the sync and the clip) and the parameters (and the teacher's)
    after the steps, whole, by name."""
    from smb_vision_tpu_torch.parallel.collectives import share_rows
    from smb_vision_tpu_torch.parallel.mesh import use_mesh
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
    )

    accum = spec.get("accum", 1)
    device = spec.get("device", "cpu")
    model, init_fn, step_fn, _ = make_workload(
        spec["kind"], spec["config"], spec["opt"], accum, device)
    state = init_fn(0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["weights"].items()})
    if "teacher" in state:
        state["teacher"].load_state_dict(model.state_dict())
    args = TrainingArguments(
        output_dir=str(out_dir or Path(spec["work"]) / f"o_{policy}"),
        device=device, sharding_policy=policy,
        model_parallel=model_parallel)
    trainer = Trainer(args=args, state=state, step_fn=step_fn,
                      train_loader=None, min_fsdp_size=MIN_FSDP)
    losses, grads = [], None
    with use_mesh(trainer.mesh):
        for i, batch in enumerate(spec["batches"]):
            local = {k: share_rows(torch.from_numpy(np.asarray(v)),
                                   accum).to(device)
                     for k, v in batch.items()}
            kw = {}
            if spec.get("masks") is not None:
                kw["mask"] = share_rows(
                    torch.from_numpy(np.asarray(spec["masks"][i])),
                    accum).to(device)
            m = step_fn(state, local, **kw)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = {n: _full(p.grad)
                         for n, p in model.named_parameters()}
    params = {n: _full(p) for n, p in model.named_parameters()}
    out = {"losses": losses, "grads": grads, "params": params,
           "trainer": trainer}
    if "teacher" in state:
        out["teacher"] = {n: _full(p)
                          for n, p in state["teacher"].named_parameters()}
    return out


# -- the cases ---------------------------------------------------------------

def case_steps(spec):
    """run_steps under each (policy, model_parallel) of each job of
    spec["jobs"] ({name: a run_steps spec with its "runs"})."""
    res = {}
    for name, job in spec["jobs"].items():
        job = dict(job, work=spec["work"])
        for policy, mp in job["runs"]:
            r = run_steps(job, policy, mp,
                          out_dir=Path(spec["work"]) / f"o_{name}_{policy}")
            r.pop("trainer")
            res[(name, policy, mp)] = r
    return res


# the split dim of each parameter of `eight_bit_steps`
EIGHT_BIT_DIMS = {"whole": 0, "partial": 0, "tiny": 0, "rowsplit": 1}


def eight_bit_steps(spec, mesh) -> dict:
    """AdamW8bit updates of spec["params"] with spec["grads"], each
    parameter split over `mesh` on its EIGHT_BIT_DIMS dim (whole
    without a mesh). Returns the parameters, the state (whole) and each
    parameter's layout."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from smb_vision_tpu_torch.train.quantized import AdamW8bit, _layout

    def place(name, a):
        t = torch.from_numpy(np.array(a))
        if mesh is None:
            return t
        return distribute_tensor(t, mesh, [Shard(EIGHT_BIT_DIMS[name])])

    names = list(spec["params"])
    params = {k: torch.nn.Parameter(place(k, spec["params"][k]))
              for k in names}
    opt = AdamW8bit([params[k] for k in names], lr=1e-2,
                    weight_decay=0.1)
    for grads in spec["grads"]:
        for k in names:
            params[k].grad = place(k, grads[k])
        opt.step()
    sd = opt.state_dict()["state"]

    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().cpu().numpy().copy()

    return {"params": {k: _full(params[k]) for k in names},
            "state": {k: {key: whole(v) for key, v in sd[i].items()
                          if key != "step"}
                      for i, k in enumerate(names)},
            "modes": {k: _layout(params[k])[0] for k in names}}


def case_eight_bit(spec):
    from smb_vision_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(device_type="cpu")["data"]
    return eight_bit_steps(spec, mesh)


class GlobalBatches:
    """A train loader over fixed global batches: each epoch yields them in
    order, each rank its rows (`share_rows` of the data axis); one
    process takes them whole."""

    def __init__(self, batches, n_data: int = 1, rank: int = 0):
        self.batches, self.n, self.r = batches, n_data, rank
        self.ds = self.batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        for b in self.batches:
            per = len(b["pixel_values"]) // self.n
            yield {k: np.asarray(v)[self.r * per:(self.r + 1) * per]
                   for k, v in b.items()}


def train_run(spec, out_dir, steps: int, stop_after=None) -> dict:
    """Trainer.train() of the tiny MIM on spec["batches"] to `steps`,
    saving every 2, then save_model; with stop_after, rank 1 (or the one
    process) sends itself SIGTERM after that step. Returns the logged
    losses and the parameters, whole."""
    import signal

    from smb_vision_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_rank,
        axis_size,
        create_mesh,
        rank,
        world_size,
    )
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
    )

    model, init_fn, step_fn, _ = make_workload(
        "mim", spec["config"], spec["opt"], spec.get("accum", 1))
    state = init_fn(0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["weights"].items()})
    mesh = create_mesh(device_type="cpu")
    loader = GlobalBatches(spec["batches"], axis_size(mesh, DATA_AXIS),
                           axis_rank(mesh, DATA_AXIS))
    args = TrainingArguments(
        output_dir=str(out_dir), num_train_steps=steps, save_steps=2,
        logging_steps=1, save_total_limit=None, device="cpu",
        sharding_policy=spec["policy"], seed=3)
    trainer = Trainer(args=args, state=state, step_fn=step_fn,
                      train_loader=loader, mesh=mesh,
                      min_fsdp_size=MIN_FSDP)
    if stop_after is not None:
        inner = trainer.step_fn

        def stepping(st, batch, gen):
            out = inner(st, batch, gen)
            if st["step"] == stop_after and rank() == min(
                    1, world_size() - 1):
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        trainer.step_fn = stepping
    res = trainer.train()
    trainer.save_model()
    return {"train_steps": res["train_steps"],
            "params": {n: _full(p) for n, p in model.named_parameters()}}


def case_ckpt(spec):
    """4 straight steps in work/a; 2 steps stopped by a SIGTERM on rank 1
    and a resume to 4 in work/b."""
    work = Path(spec["work"])
    a = train_run(spec, work / "a", 4)
    b1 = train_run(spec, work / "b", 4, stop_after=2)
    b2 = train_run(spec, work / "b", 4)
    return {"a": a, "b_stopped": b1["train_steps"], "b": b2}


def case_ckpt_losses(spec):
    """The logged losses of train_run over spec["batches"]."""
    import json

    work = Path(spec["work"])
    train_run(spec, work / "run", len(spec["batches"]))
    if dist.get_rank():
        return None
    return {r["step"]: r["loss"] for r in map(
        json.loads, (work / "run" / "metrics.jsonl").read_text()
        .splitlines()) if "loss" in r}


def cox_and_eval(spec, mesh=None) -> dict:
    """The Cox loss of spec["risk"] (its gradient on the risks) over the
    global batch, with and without padding rows, and Trainer.evaluate of
    the tiny survival model over spec["eval"] (two batches, the second
    short)."""
    from smb_vision_tpu_torch.parallel.collectives import share_rows
    from smb_vision_tpu_torch.parallel.mesh import use_mesh
    from smb_vision_tpu_torch.train.losses import cox_loss
    from smb_vision_tpu_torch.train.metrics import compute_metrics
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
    )

    out = {}
    with use_mesh(mesh):
        for valid in (None, spec["valid"]):
            risk = share_rows(torch.from_numpy(spec["risk"])).clone()
            risk.requires_grad_(True)
            loss = cox_loss(
                risk, share_rows(torch.from_numpy(spec["duration"])),
                share_rows(torch.from_numpy(spec["event"])),
                valid=None if valid is None
                else share_rows(torch.from_numpy(valid)))
            loss.backward()
            key = "plain" if valid is None else "valid"
            out[key] = (float(loss), _full_rows(risk.grad))
    model, init_fn, step_fn, eval_fn = make_workload(
        "cls", CLS_TINY, dict(learning_rate=1e-3, total_steps=1), 1)
    state = init_fn(0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["weights"].items()})
    args = TrainingArguments(output_dir=str(Path(spec["work"]) / "eval"),
                             device="cpu", per_device_eval_batch_size=2)
    trainer = Trainer(args=args, state=state, step_fn=step_fn,
                      train_loader=None, eval_loader=spec["eval"],
                      eval_fn=eval_fn, mesh=mesh, compute_metrics=(
                          functools.partial(compute_metrics, "survival")))
    out["eval"] = trainer.evaluate()
    return out


def _full_rows(t):
    """The rows of every data rank, in order."""
    from smb_vision_tpu_torch.parallel.collectives import gather_rows

    with torch.no_grad():
        return gather_rows(t).numpy().copy()


def case_basics(spec):
    """The mesh functions at world 2 and the global Cox loss and eval."""
    from smb_vision_tpu_torch.parallel import mesh as pm

    out = {"shapes": {}, "errors": {}}
    for kw in ({}, {"model": 2}, {"data": 2, "dcn": 2}):
        m = pm.create_mesh(device_type="cpu", **kw)
        out["shapes"][str(sorted(kw.items()))] = (
            tuple(m.shape), pm.local_batch_slice(8, m))
        with pm.use_mesh(m):
            out["shapes"][str(sorted(kw.items())) + " init"] = \
                pm.init_batch_size()
    for kw in ({"model": 3}, {"data": 3}, {"data": 1, "dcn": 2}):
        try:
            pm.create_mesh(device_type="cpu", **kw)
        except ValueError as e:
            out["errors"][str(sorted(kw.items()))] = str(e)
    out["again"] = pm.maybe_initialize_distributed(None, device="cpu")
    out.update(cox_and_eval(spec, pm.create_mesh(device_type="cpu")))
    return out


def case_suffix(spec):
    """AdamW's state of two parameters whose names share a suffix
    ("lora_a.weight", "a.weight"), one sharded by fsdp and one not: the
    placement of each parameter and of its moments."""
    from smb_vision_tpu_torch.parallel.mesh import create_mesh
    from smb_vision_tpu_torch.parallel.sharding import apply_policy
    from smb_vision_tpu_torch.train.optim import make_optimizer

    torch.manual_seed(0)
    model = torch.nn.Module()
    model.lora_a = torch.nn.Linear(16, 8, bias=False)
    model.a = torch.nn.Linear(4, 4, bias=False)
    mesh = create_mesh(device_type="cpu")
    opt = make_optimizer(model.named_parameters(), learning_rate=1e-3,
                         total_steps=1)
    fsdp_ids = apply_policy(model, mesh, "fsdp", min_fsdp_size=64)
    opt.place(mesh, fsdp_ids, model.named_parameters())
    model.lora_a.weight.grad = torch.ones_like(model.lora_a.weight)
    model.a.weight.grad = torch.ones_like(model.a.weight)
    opt.step()

    def where(t):
        return str(getattr(t, "placements", "plain"))

    return {n: (where(p), {k: where(v) for k, v in opt.opt.state[p].items()
                           if k != "step"})
            for n, p in model.named_parameters()}


CASES = {"steps": case_steps, "eight_bit": case_eight_bit,
         "suffix": case_suffix,
         "ckpt": case_ckpt, "ckpt_losses": case_ckpt_losses,
         "basics": case_basics}


def main():
    case, rank, world, init, work = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        spec = pickle.loads((Path(work) / "spec.pkl").read_bytes())
        spec["work"] = work
        out = CASES[case](spec)
        if rank == 0:
            (Path(work) / "out_0.pkl").write_bytes(pickle.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
