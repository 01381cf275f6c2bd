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
                  device="cpu", pipeline: int = 0, mesh=None):
    """(model, init_fn, step_fn, eval_fn) of the port's workload; with
    pipeline M, the pipelined one over mesh's model axis, M microbatches
    (its remat as the config's gradient_checkpointing)."""
    from smb_vision_tpu_torch.train import optim as toptim

    tx = functools.partial(toptim.make_optimizer, **opt)
    if kind == "mim":
        from smb_vision_tpu_torch.models.configs import VideoMAEConfig
        from smb_vision_tpu_torch.train.mim import (
            make_mim_workload,
            make_pipelined_mim_workload,
        )

        if pipeline:
            return make_pipelined_mim_workload(
                VideoMAEConfig(**cfg), tx=tx, mesh=mesh,
                num_microbatches=pipeline, device=device,
                remat=cfg.get("gradient_checkpointing", False), **MIM_MASK)
        return make_mim_workload(VideoMAEConfig(**cfg), tx=tx,
                                 grad_accum=accum, device=device,
                                 **MIM_MASK)
    if kind == "vjepa":
        from smb_vision_tpu_torch.models.configs import VJEPA2Config
        from smb_vision_tpu_torch.train.vjepa import (
            make_pipelined_vjepa_workload,
            make_vjepa_workload,
        )

        if pipeline:
            return make_pipelined_vjepa_workload(
                VJEPA2Config(**cfg), tx=tx, mesh=mesh,
                num_microbatches=pipeline, device=device,
                remat=cfg.get("gradient_checkpointing", False))
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
    group); spec["pipeline"] = M: the pipelined workload over the model
    axis. Returns the loss of each step, the first step's gradients
    (after the sync and the clip) and the parameters (and the teacher's)
    after the steps, whole, by name (every stage's)."""
    from smb_vision_tpu_torch.models.pipelined import stage_state
    from smb_vision_tpu_torch.parallel.collectives import share_rows
    from smb_vision_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
    )

    accum = spec.get("accum", 1)
    device = spec.get("device", "cpu")
    mesh = create_mesh(model=model_parallel, device_type="cpu")
    model, init_fn, step_fn, _ = make_workload(
        spec["kind"], spec["config"], spec["opt"], accum, device,
        pipeline=spec.get("pipeline", 0), mesh=mesh)
    state = init_fn(0)
    model.load_state_dict(stage_state(model, {
        k: torch.from_numpy(v) for k, v in spec["weights"].items()}))
    if "teacher" in state:
        state["teacher"].load_state_dict(model.state_dict())
    args = TrainingArguments(
        output_dir=str(out_dir or Path(spec["work"]) / f"o_{policy}"),
        device=device, sharding_policy=policy,
        model_parallel=model_parallel)
    trainer = Trainer(args=args, state=state, step_fn=step_fn,
                      train_loader=None, min_fsdp_size=MIN_FSDP, mesh=mesh)
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
                grads = _stages({n: _full(p.grad)
                                 for n, p in model.named_parameters()})
    params = _stages({n: _full(p) for n, p in model.named_parameters()})
    out = {"losses": losses, "grads": grads, "params": params,
           "trainer": trainer}
    if "teacher" in state:
        out["teacher"] = _stages({
            n: _full(p) for n, p in state["teacher"].named_parameters()})
    return out


def _stages(named: dict) -> dict:
    """The union over the ranks of {name: array} (a pipeline's stages hold
    different layers); the dict itself without a process group."""
    if not dist.is_initialized():
        return named
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, named)
    out = {}
    for part in parts:
        out.update(part)
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


# -- context parallelism, sequence-parallel models, the pipeline -------------

def case_context(spec):
    """`context_parallel_attention` and `ring_attention` over the world
    as the model axis, on each (name, fn, impl, N) of spec["runs"]: this
    rank's token shard of the spec's q, k, v (torch.tensor_split's cut),
    the output, and the gradients of sum(out ** 2) w.r.t. q, k, v; with
    the calls of attention_with_lse counted. Returns the shards
    concatenated, by run name."""
    from smb_vision_tpu_torch.parallel import context as ctx
    from smb_vision_tpu_torch.parallel.collectives import token_split_sizes
    from smb_vision_tpu_torch.parallel.mesh import create_mesh, use_mesh

    mesh = create_mesh(model=dist.get_world_size(), device_type="cpu")
    r = dist.get_rank()
    real = ctx.attention_with_lse
    calls = {"n": 0}

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    ctx.attention_with_lse = spy
    out = {}
    try:
        for name, fn, impl, n in spec["runs"]:
            sizes = token_split_sizes(n, dist.get_world_size())
            lo = sum(sizes[:r])
            qkv = [torch.from_numpy(spec[k][:, :n][:, lo:lo + sizes[r]])
                   .clone().requires_grad_() for k in "qkv"]
            calls["n"] = 0
            with use_mesh(mesh):
                o = getattr(ctx, fn)(*qkv, impl=impl, token_sizes=sizes)
                (o.float() ** 2).sum().backward()
            out[name] = {(r, "out"): o.detach().numpy(),
                         (r, "calls"): calls["n"]}
            out[name].update({(r, k): t.grad.numpy()
                              for k, t in zip("qkv", qkv)})
    finally:
        ctx.attention_with_lse = real
    merged = {name: _stages(d) for name, d in out.items()}
    world = dist.get_world_size()
    res = {}
    for name, d in merged.items():
        res[name] = {k: np.concatenate([d[(i, k)] for i in range(world)],
                                       axis=1)
                     for k in ("out", "q", "k", "v")}
        res[name]["calls"] = [d[(i, "calls")] for i in range(world)]
    try:
        token_split_sizes(3, 4)
    except ValueError as e:
        res["refusal"] = str(e)
    return res


def sp_model(kind: str, cfg: dict, variant=None):
    """The port's pretraining model of `kind` ("mim" or "vjepa") from a
    config dict, sequence parallel with `variant` unless None."""
    if kind == "mim":
        from smb_vision_tpu_torch.models.configs import VideoMAEConfig
        from smb_vision_tpu_torch.models.videomae import (
            VideoMAEForPreTraining,
        )

        c = VideoMAEConfig(**cfg)
        model = VideoMAEForPreTraining
    else:
        from smb_vision_tpu_torch.models.configs import VJEPA2Config
        from smb_vision_tpu_torch.models.vjepa import VJEPA2Model

        c = VJEPA2Config(**cfg)
        model = VJEPA2Model
    if variant is not None:
        c.sequence_parallel, c.sp_variant = True, variant
    return model(c)


def sp_loss(kind, model, batch, teacher=None):
    """The pretraining loss of `model` on a batch of numpy arrays (MIM:
    pixels, mask, num_masked; V-JEPA: pixels, target mask, the teacher's
    weights)."""
    px = torch.from_numpy(batch["pixel_values"])
    mask = torch.from_numpy(batch["mask"])
    if kind == "mim":
        return model(px, mask, int(batch["num_masked"]))["loss"]
    from smb_vision_tpu_torch.models.vjepa import vjepa_loss

    out = model(px, target_bool=mask)
    with torch.no_grad():
        tgt = teacher(px, target_bool=mask,
                      skip_predictor=True)["last_hidden_state"]
    return vjepa_loss(out["predictor_output"], tgt, mask)


def case_sp_models(spec):
    """Each job of spec["jobs"] ({name: kind, config, weights, batch,
    variant, model (axis size), teacher}): the loss and, after
    `sync_gradients` (data mean, the model-axis sum of the
    sequence-parallel stacks), every parameter's gradient, on a (world /
    model, model) mesh; and the calls of context_parallel_attention."""
    from smb_vision_tpu_torch.parallel import context as ctx
    from smb_vision_tpu_torch.parallel.collectives import share_rows
    from smb_vision_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from smb_vision_tpu_torch.parallel.sharding import (
        model_sum_ids,
        sync_gradients,
    )

    real = {k: getattr(ctx, k) for k in ("context_parallel_attention",
                                         "ring_attention")}
    calls = {"n": 0}

    def spying(fn):
        def spy(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return spy

    for k, fn in real.items():
        setattr(ctx, k, spying(fn))
    res = {}
    try:
        for name, job in spec["jobs"].items():
            mesh = create_mesh(model=job["model"], device_type="cpu")
            model = sp_model(job["kind"], job["config"], job["variant"])
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in job["weights"].items()})
            teacher = None
            if job["kind"] == "vjepa":
                teacher = sp_model("vjepa", job["config"], job["variant"])
                teacher.load_state_dict({
                    k: torch.from_numpy(v)
                    for k, v in job["teacher"].items()})
            calls["n"] = 0
            with use_mesh(mesh):
                batch = {k: share_rows(torch.from_numpy(np.asarray(v)))
                         .numpy() if k != "num_masked" else v
                         for k, v in job["batch"].items()}
                loss = sp_loss(job["kind"], model, batch, teacher)
                loss.backward()
            params = [p for p in model.parameters()]
            sync_gradients(params, mesh, set(),
                           model_sum_ids(model, mesh))
            res[name] = {"loss": float(loss), "calls": calls["n"],
                         "grads": {n: p.grad.numpy().copy()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}}
    finally:
        for k, fn in real.items():
            setattr(ctx, k, fn)
    return res


def _pipe_mesh(model: int):
    """A (world / model, model) mesh and this rank's PipeStages."""
    from smb_vision_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
        axis_rank,
        create_mesh,
    )
    from smb_vision_tpu_torch.parallel.pipeline import PipeStages

    mesh = create_mesh(model=model, device_type="cpu")
    return mesh, lambda m: PipeStages(model, axis_rank(mesh, MODEL_AXIS), m)


def _rows_back(t: torch.Tensor) -> np.ndarray:
    """Every data rank's rows of t, in order, as numpy (f32)."""
    from smb_vision_tpu_torch.parallel.collectives import gather_rows

    with torch.no_grad():
        return gather_rows(t.detach().float()).numpy().copy()


def _stage_weights(model, weights: dict) -> None:
    from smb_vision_tpu_torch.models.pipelined import stage_state

    model.load_state_dict(stage_state(model, {
        k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()}))


def _synced_grads(model, mesh) -> dict:
    """The gradients after the data-axis mean, every stage's, by name."""
    from smb_vision_tpu_torch.parallel.sharding import sync_gradients

    sync_gradients(list(model.parameters()), mesh, set())
    return _stages({n: p.grad.numpy().copy()
                    for n, p in model.named_parameters()
                    if p.grad is not None})


def pipe_job(job) -> dict:
    """One pipeline job of case_pipeline (see there)."""
    from smb_vision_tpu_torch.models import pipelined as P
    from smb_vision_tpu_torch.parallel.collectives import (
        data_mean,
        share_rows,
    )
    from smb_vision_tpu_torch.parallel.mesh import use_mesh

    mesh, stages = _pipe_mesh(job["model"])
    kind, m = job["kind"], job["microbatches"]
    out = {}
    with use_mesh(mesh):
        if kind == "encoder":
            from smb_vision_tpu_torch.models.layers import Encoder

            enc = Encoder(**job["config"], dtype=torch.float32,
                          attn_impl="xla", mlp_impl="xla",
                          pipe=stages(m))
            _stage_weights(enc, job["weights"])
            x = share_rows(torch.from_numpy(job["x"])).clone()
            x.requires_grad_(True)
            gen = (torch.Generator().manual_seed(job["seed"])
                   if "seed" in job else None)
            y = P.pipelined_encoder(enc, x, num_microbatches=m,
                                    remat=job.get("remat", False),
                                    deterministic=gen is None,
                                    generator=gen)
            out["out"] = _rows_back(y)
            if "tgt" in job:
                sq = (y - share_rows(torch.from_numpy(job["tgt"]))) ** 2
                data_mean(sq.sum(), sq.new_tensor(float(sq.numel())),
                          local=sq.mean()).backward()
                out["grads"] = _synced_grads(enc, mesh)
                # the input's cotangent: every stage holds it whole (the
                # data mean's n x share convention, undone)
                from smb_vision_tpu_torch.parallel.collectives import (
                    global_rows,
                )

                n = global_rows(1)
                out["x_grad"] = _rows_back(x.grad) / n
            if gen is not None:
                gen2 = torch.Generator().manual_seed(job["seed"])
                with torch.no_grad():
                    out["again"] = _rows_back(P.pipelined_encoder(
                        enc, x, num_microbatches=m, deterministic=False,
                        generator=gen2))
                    out["eval"] = _rows_back(P.pipelined_encoder(
                        enc, x, num_microbatches=m))
            return out
        px = share_rows(torch.from_numpy(job["pixel_values"]))
        if kind in ("videomae_encode", "vjepa_encode", "dinov2_encode"):
            from smb_vision_tpu_torch.models import configs

            if kind == "videomae_encode":
                from smb_vision_tpu_torch.models.videomae import (
                    VideoMAEModel as cls,
                )

                cfg, fn = configs.VideoMAEConfig(**job["config"]), \
                    P.videomae_pipeline_encode
            elif kind == "vjepa_encode":
                from smb_vision_tpu_torch.models.vjepa import (
                    VJEPA2Encoder as cls,
                )

                cfg, fn = configs.VJEPA2Config(**job["config"]), \
                    P.vjepa2_pipeline_encode
            else:
                from smb_vision_tpu_torch.models.dinov2 import (
                    Dinov2Model as cls,
                )

                cfg, fn = configs.Dinov2Config(**job["config"]), \
                    P.dinov2_pipeline_encode
            model = cls(cfg, stages(m))
            _stage_weights(model, job["weights"])
            with torch.no_grad():
                out["out"] = _rows_back(fn(cfg, model, px,
                                           num_microbatches=m))
            return out
        mask = share_rows(torch.from_numpy(job["mask"]))
        model = sp_model(kind, job["config"])
        cls = type(model)
        model = cls(model.config, pipe=stages(m))
        _stage_weights(model, job["weights"])
        if kind == "mim":
            loss = P.videomae_pipeline_pretrain(
                model.config, model, px, mask, int(job["num_masked"]))[
                    "loss"]
        else:
            teacher = cls(model.config, pipe=stages(m))
            _stage_weights(teacher, job["teacher"])
            loss = P.vjepa2_pipeline_pretrain(model.config, model, teacher,
                                              px, mask)
        loss.backward()
        out["loss"] = float(loss.detach())
        out["grads"] = _synced_grads(model, mesh)
        return out


def case_pipeline(spec):
    """Each job of spec["jobs"] on a (world / model, model) mesh, the
    stages on the model axis, this rank on its rows of the global inputs.
    kinds: "encoder" (an Encoder stage through `pipelined_encoder`: the
    output; with "tgt", the gradients of the global mean squared error,
    the layers' (every stage's) and the input's; with "seed", DropPath in
    train mode, again from the same seed, and in eval); the
    "*_encode" functions of `models/pipelined.py` (the output); "mim" and
    "vjepa" (`videomae_pipeline_pretrain`, `vjepa2_pipeline_pretrain`:
    the loss and every gradient after the data-axis mean)."""
    return {name: pipe_job(job) for name, job in spec["jobs"].items()}


def case_pipe_train(spec):
    """The pipelined workload of spec["kind"] under spec["policy"] on a
    (world / 2, 2) mesh: spec["steps"] Trainer steps on the global batch
    (a fixed step generator), the eval loss twice, the names of the
    parameters this rank holds, and (V-JEPA) the largest gap between the
    teacher's and the student's parameters; then the export of the model
    gathered from the stages (`save_model`) and of its HF layout, as
    bytes, beside a one-process dense Trainer's of the same weights."""
    from smb_vision_tpu_torch.models.convert import (
        export_hf_videomae,
        params_to_flax,
        write_safetensors,
    )
    from smb_vision_tpu_torch.parallel.collectives import share_rows
    from smb_vision_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
        step_generator,
    )

    mesh = create_mesh(model=2, device_type="cpu")
    model, init_fn, step_fn, eval_fn = make_workload(
        spec["kind"], spec["config"], spec["opt"], 1,
        pipeline=spec["microbatches"], mesh=mesh)
    state = init_fn(0)
    work = Path(spec["work"])
    args = TrainingArguments(output_dir=str(work / "pipe"), device="cpu",
                             sharding_policy=spec["policy"],
                             model_parallel=2)
    trainer = Trainer(args=args, state=state, step_fn=step_fn,
                      train_loader=None, min_fsdp_size=MIN_FSDP, mesh=mesh)
    px = share_rows(torch.from_numpy(spec["pixel_values"]))
    losses = []
    with use_mesh(mesh):
        for i in range(spec["steps"]):
            m = step_fn(state, {"pixel_values": px}, step_generator(5, 0))
            losses.append(float(m["loss"]))
        evals = [float(eval_fn(state, {"pixel_values": px})["loss"])
                 for _ in range(2)]
    out = {"losses": losses, "evals": evals,
           "names": _stages({dist.get_rank(): sorted(
               n for n, _ in model.named_parameters())})}
    if "teacher" in state:
        out["ema_gap"] = max(
            float((t - s).abs().max()) for t, s in zip(
                state["teacher"].parameters(), model.parameters()))
    trainer.save_model()
    full = trainer.full_model_state()
    if dist.get_rank() == 0 and spec["kind"] == "mim":
        out["export"] = (work / "pipe" / "model.safetensors").read_bytes()
        cfg = model.config
        out["hf"] = export_hf_videomae(
            full, num_layers=cfg.num_hidden_layers,
            decoder_layers=cfg.decoder_num_hidden_layers)
        out["full"] = {k: v.numpy() for k, v in full.items()}
        # the dense model of the same weights, written as one process's
        # Trainer.save_model writes it
        dense, *_ = make_workload(spec["kind"], spec["config"],
                                  spec["opt"], 1)
        dense.load_state_dict(full)
        (work / "dense").mkdir(exist_ok=True)
        write_safetensors(work / "dense" / "model.safetensors",
                          params_to_flax(dense.state_dict()))
        out["dense_export"] = (work / "dense" /
                               "model.safetensors").read_bytes()
        out["dense_hf"] = export_hf_videomae(
            dense.state_dict(), num_layers=cfg.num_hidden_layers,
            decoder_layers=cfg.decoder_num_hidden_layers)
        out["flax"] = sorted(params_to_flax(full))
    return out


def case_many(spec):
    """Several cases in one spawn: {name: CASES[case](its spec)} over
    spec["cases"] ({name: (case, spec)})."""
    return {name: CASES[case](dict(sub, work=spec["work"]))
            for name, (case, sub) in spec["cases"].items()}


CASES = {"steps": case_steps, "eight_bit": case_eight_bit,
         "suffix": case_suffix,
         "ckpt": case_ckpt, "ckpt_losses": case_ckpt_losses,
         "basics": case_basics, "context": case_context,
         "sp_models": case_sp_models, "many": case_many,
         "pipeline": case_pipeline, "pipe_train": case_pipe_train}


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
