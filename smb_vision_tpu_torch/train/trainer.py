"""Training loop on PyTorch: one device, gradient accumulation, checkpoints
with auto-resume, periodic eval and metric logging.

Counterpart of `smb_vision_tpu/train/trainer.py` (`TrainingArguments`,
`accumulate_gradients`, `Trainer`) for one device. Host batches reach the
device through pinned buffers on a side stream (`prefetch_to_device`);
a `DeviceCachedBatchLoader`'s batches are on the device already. With
input_dtype "uint8" the pixels travel as codes with a per-volume affine
and are decoded to bfloat16 on the device, in the step. profile_steps
"A-B" writes a `torch.profiler` trace of global steps A to B under
`output_dir/profile`. A checkpoint is one
`torch.save` of the model, the optimizer (moments, update count), the EMA
teacher where the workload has one (V-JEPA), a LoRA run's merge
hyperparameters and initial head, and the step and epoch, under
`output_dir/checkpoints/<step>/state.pt`. Each step
seeds its own mask generator from (seed, step), and a resumed run skips
the batches its epoch already consumed, so it replays no batch and no
mask: 2 steps + resume + 2 steps equals 4 steps bitwise.

On N ranks (`python -m torch.distributed.run`, `parallel/mesh.py`) the
Trainer takes a (data, model) mesh and a sharding policy ("dp", "fsdp",
"tp", "fsdp+tp"; `parallel/sharding.py`), places the model, the EMA
teacher and the optimizer state, and runs every step inside the mesh
(`use_mesh`): the masks and the DropPath draws are drawn for the global
batch and sliced by rank, and the losses are the global batch's
(`parallel/collectives.py`). Each rank's train loader yields its share of
the global batch, laid out (accumulation, data rank, micro-batch rows).
Rank 0 writes the metrics and the exports; a stop request on any rank
stops every rank after the same step; checkpoints go through
`torch.distributed.checkpoint` (a directory of shards and `meta.pt`
under `checkpoints/<step>/`), which reshards on load, so a run resumes at
another world size, or as one process.
"""

from __future__ import annotations

import contextlib
import itertools
import shutil
import signal
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from smb_vision_tpu_torch.data import quantization
from smb_vision_tpu_torch.data.dataset import prefetch_to_device, to_tensor
from smb_vision_tpu_torch.parallel import mesh as pmesh
from smb_vision_tpu_torch.parallel.collectives import gather_rows
from smb_vision_tpu_torch.parallel.sharding import (
    apply_policy,
    check_policy,
    model_sum_ids,
    stage_param_ids,
)
from smb_vision_tpu_torch.utils.logging import MetricLogger, get_logger
from smb_vision_tpu_torch.utils.profiling import device_peak_flops, trace

logger = get_logger(__name__)

# only these columns are cast to input_dtype: labels, survival durations
# and tabular features keep their dtype (bf16 spacing at a duration of
# ~2048 days is 16: a cast would tie distinct survival times)
_PIXEL_KEYS = ("pixel_values", "pixel_values_videos")
# state entries beside the model and the optimizer that a checkpoint
# carries: the LoRA merge hyperparameters and the head as initialised
_STATE_EXTRAS = ("lora_meta", "base_head")
# threads that write each rank's file of a sharded checkpoint (a ViT-Base
# MIM state with its AdamW moments is ~1.3 GB)
_SAVE_THREADS = 4
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "uint8": torch.uint8}


@dataclass
class TrainingArguments:
    """The HF TrainingArguments subset the reference recipes use, and the
    JAX package's knobs, under the same names (its config files parse
    here); `device` is the port's own."""

    output_dir: str = "output"
    do_train: bool = True
    do_eval: bool = False
    num_train_steps: Optional[int] = None
    num_train_epochs: float = 1.0
    per_device_train_batch_size: int = 1
    per_device_eval_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    grad_accum_dtype: str = "float32"   # float32 | bfloat16 accumulator
    # dtype pixels are shipped in: float32 | bfloat16 | float16 | uint8
    # (per-volume affine codes, decoded to bfloat16 on the device in the
    # step; max abs err (max - min) / 510 a voxel)
    input_dtype: str = "float32"
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.0
    warmup_steps: int = 0
    lr_scheduler_type: str = "cosine"
    optim: str = "adamw"
    min_lr: float = 0.0
    max_grad_norm: float = 1.0
    seed: int = 42
    logging_steps: int = 10
    save_steps: int = 500
    save_total_limit: Optional[int] = 3
    eval_steps: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    overwrite_output_dir: bool = False
    report_to: str = "none"
    run_name: Optional[str] = None      # written into every metrics record
    vision_lr: Optional[float] = None
    merger_lr: Optional[float] = None
    sharding_policy: str = "dp"
    model_parallel: int = 1
    dcn_slices: int = 1
    multihost: Optional[bool] = None
    model_flops_per_sample: Optional[float] = None
    # "A-B" (or "A"): a torch.profiler trace of global steps A..B
    # inclusive under output_dir/profile
    profile_steps: Optional[str] = None
    device: str = "cuda"                # cuda | cuda:N | cpu


def profile_range(spec: Optional[str]):
    """(first, last) global step of a profile_steps "A-B" or "A"; None."""
    if not spec:
        return None
    a, _, b = str(spec).partition("-")
    try:
        lo, hi = int(a), int(b or a)
    except ValueError:
        raise ValueError(f"profile_steps {spec!r}: expected 'A-B' or "
                         "'A'") from None
    if not 1 <= lo <= hi:
        raise ValueError(f"profile_steps {spec!r}: expected 1 <= A <= B")
    return lo, hi


def step_generator(seed: int, step: int) -> torch.Generator:
    """The random generator of one global step, seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def accumulate_gradients(loss_fn: Callable, params: List[torch.Tensor],
                         batch: Dict[str, torch.Tensor], n_accum: int = 1,
                         accum_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Backward of loss_fn over n_accum microbatches (the batch's leading
    axis split in order), leaving the mean gradient in each p.grad (f32)
    and returning the mean loss. The running sum is kept in accum_dtype
    (f32 by default; bf16 halves it)."""
    if n_accum == 1:
        loss = loss_fn(batch)
        loss.backward()
        return loss.detach()
    rows = next(iter(batch.values())).shape[0]
    if rows % n_accum:
        raise ValueError(f"batch of {rows} does not split into {n_accum} "
                         "microbatches")
    micro = rows // n_accum
    acc_dt = accum_dtype or torch.float32
    acc = [torch.zeros_like(p, dtype=acc_dt) for p in params]
    total = 0.0
    for i in range(n_accum):
        mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
        for p in params:
            p.grad = None
        loss = loss_fn(mb)
        loss.backward()
        for a, p in zip(acc, params):
            if p.grad is not None:
                a += p.grad.to(acc_dt)
        total = total + loss.detach()
    for a, p in zip(acc, params):
        p.grad = (a.float() / n_accum).to(p.dtype)
    return total / n_accum


class Trainer:
    """Drives step_fn(state, batch, generator) -> metrics over a
    BatchLoader. state: {"model", "optimizer", "step"} and, for V-JEPA, a
    "teacher" module, built by the workload (train/mim.py,
    train/vjepa.py)."""

    def __init__(self, *, args: TrainingArguments, state: dict,
                 step_fn: Callable, train_loader, eval_loader=None,
                 eval_fn: Optional[Callable] = None,
                 compute_metrics: Optional[Callable] = None,
                 mesh=None, min_fsdp_size: int = 2 ** 16,
                 eval_batch_multiple: int = 1):
        """mesh: the (data, model) DeviceMesh; by default
        `create_mesh(model=args.model_parallel, dcn=args.dcn_slices)`,
        None without a process group (one device). The model (and the
        teacher) must be on this rank's device. eval_batch_multiple: an
        eval batch is padded to a multiple of it times the data axis (a
        pipelined eval_fn splits each rank's rows into that many
        microbatches)."""
        self.args = args
        self.state = state
        self.step_fn = step_fn
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.eval_fn = eval_fn
        self.compute_metrics = compute_metrics
        self.eval_batch_multiple = max(int(eval_batch_multiple), 1)
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and self.device.index is None \
                and torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        check_policy(args.sharding_policy)
        self.mesh = mesh if mesh is not None else pmesh.create_mesh(
            model=args.model_parallel, dcn=args.dcn_slices,
            device_type=self.device.type)
        self.n_data = pmesh.axis_size(self.mesh, pmesh.DATA_AXIS)
        self.main = pmesh.is_main_process()
        # host-side agreement (stop requests, checkpoint discovery) on a
        # CPU group, so it never waits on the device
        self._ctl = None
        if self.mesh is not None and dist.get_world_size() > 1:
            self._ctl = (dist.new_group(backend="gloo")
                         if dist.get_backend() != "gloo" else
                         dist.group.WORLD)
        if self.mesh is not None:
            # "dp" keeps the parameters; the other policies replace them,
            # but a LoRA run's trainable ones, which stay replicated
            # (`sharding.lora_trainable`)
            placed = (args.sharding_policy != "dp"
                      and "lora_meta" not in state)
            fsdp_ids = apply_policy(state["model"], self.mesh,
                                    args.sharding_policy, min_fsdp_size)
            if "teacher" in state:
                apply_policy(state["teacher"], self.mesh,
                             args.sharding_policy, min_fsdp_size)
            state["optimizer"].place(
                self.mesh, fsdp_ids,
                state["model"].named_parameters() if placed else None,
                model_sums=model_sum_ids(state["model"], self.mesh),
                stage_ids=stage_param_ids(state["model"]))
        # a pipelined model's ranks hold different layers: its checkpoint
        # keys the optimizer state by parameter name, entry by entry
        self.staged = bool(stage_param_ids(state["model"]))
        if args.input_dtype not in _DTYPES:
            raise ValueError(f"input_dtype {args.input_dtype!r}: expected "
                             f"one of {sorted(_DTYPES)}")
        self.in_dtype = _DTYPES[args.input_dtype]
        self.profile_range = profile_range(args.profile_steps)
        self.out_dir = Path(args.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.out_dir / "checkpoints"
        self.mlog = MetricLogger(self.out_dir, report_to=args.report_to,
                                 run_name=args.run_name, enabled=self.main)
        if args.input_dtype == "uint8":
            # decode on the device, in the step, to bfloat16; the eval_fn
            # (host code for the classification metrics) gets decoded
            # tensors the same way
            inner_step, inner_eval = self.step_fn, self.eval_fn
            self.step_fn = lambda state, batch, gen: inner_step(
                state, quantization.dequantize_batch(batch, torch.bfloat16),
                gen)
            if inner_eval is not None:
                self.eval_fn = lambda state, batch: inner_eval(
                    state, quantization.dequantize_batch(batch,
                                                         torch.bfloat16))
        self.device_cached = hasattr(train_loader, "attach_device")
        if self.device_cached:
            train_loader.attach_device(self.device)

    # -- batches -----------------------------------------------------------
    def host_cast(self, batch: Dict) -> Dict:
        """The host-side cast before the copy, so the copy moves the
        narrower type: only the pixel columns are cast; uint8 quantises a
        float batch (`quantize_batch`; a uint8 one passes); float32 passes
        everything."""
        if self.args.input_dtype == "float32":
            return batch
        if self.args.input_dtype == "uint8":
            return quantization.quantize_batch(batch)
        out = dict(batch)
        for k in _PIXEL_KEYS:
            if k in out:
                t = to_tensor(out[k])
                if t.is_floating_point() and t.dtype != self.in_dtype:
                    out[k] = t.to(self.in_dtype)
        return out

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A host batch -> tensors on the device, after `host_cast`."""
        return {k: to_tensor(v).to(self.device)
                for k, v in self.host_cast(batch).items()}

    # -- ranks -------------------------------------------------------------
    def _agree(self, value):
        """Rank 0's value of a host object, on every rank."""
        if self._ctl is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self._ctl)
        return box[0]

    def _any(self, flag: bool) -> bool:
        """True on every rank when flag is True on any."""
        if self._ctl is None:
            return flag
        t = torch.tensor([1.0 if flag else 0.0])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._ctl)
        return bool(t.item())

    def _barrier(self) -> None:
        if self._ctl is not None:
            dist.barrier(group=self._ctl)

    # -- checkpoints -------------------------------------------------------
    @staticmethod
    def checkpoint_steps(ckpt_dir: Path) -> List[int]:
        """The complete checkpoints under ckpt_dir: `state.pt` (one
        process) or a sharded one (`meta.pt`, written last)."""
        if not ckpt_dir.is_dir():
            return []
        return sorted(int(d.name) for d in ckpt_dir.iterdir()
                      if d.name.isdigit() and ((d / "state.pt").exists()
                                               or (d / "meta.pt").exists()))

    def _meta(self, step: int, epoch: int) -> dict:
        meta = {"step": step, "epoch": epoch,
                "updates": self.state["optimizer"].updates,
                "flat_optimizer": self.staged}
        for key in _STATE_EXTRAS:
            if key in self.state:
                meta[key] = self.state[key]
        return meta

    def _sharded_state(self, flat: bool = False) -> dict:
        """The model, optimizer and teacher state, keyed by parameter
        name, in `torch.distributed.checkpoint`'s form (DTensors where
        sharded); flat: the optimizer's entries one a key (a pipeline's
        stages hold different parameters)."""
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
            get_state_dict,
        )

        msd, osd = get_state_dict(
            self.state["model"], self.state["optimizer"].opt,
            options=StateDictOptions(flatten_optimizer_state_dict=flat))
        out = {"model": msd, "optimizer": osd}
        if "teacher" in self.state:
            out["teacher"] = get_model_state_dict(self.state["teacher"])
        return out

    def save_checkpoint(self, step: int, epoch: int) -> None:
        final = self.ckpt_dir / str(step)
        tmp = self.ckpt_dir / f".{step}.tmp"
        if self.main:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
        if self.mesh is None:
            blob = {"model": self.state["model"].state_dict(),
                    "optimizer": self.state["optimizer"].state_dict(),
                    "step": step, "epoch": epoch}
            for key in _STATE_EXTRAS:
                if key in self.state:
                    blob[key] = self.state[key]
            if "teacher" in self.state:
                blob["teacher"] = self.state["teacher"].state_dict()
            torch.save(blob, tmp / "state.pt")
        else:
            import torch.distributed.checkpoint as dcp

            self._barrier()
            dcp.save(self._sharded_state(self.staged),
                     storage_writer=dcp.FileSystemWriter(
                         str(tmp), thread_count=_SAVE_THREADS))
            if self.main:
                torch.save(self._meta(step, epoch), tmp / "meta.pt")
        if self.main:
            shutil.rmtree(final, ignore_errors=True)
            tmp.rename(final)
            limit = self.args.save_total_limit
            if limit:
                for old in self.checkpoint_steps(self.ckpt_dir)[:-limit]:
                    shutil.rmtree(self.ckpt_dir / str(old),
                                  ignore_errors=True)
        self._barrier()

    def _restore(self, path: Path) -> int:
        """Restore from a checkpoint directory: `state.pt`, or a sharded
        one, which loads at any world size (or as one process)."""
        if not (path / "meta.pt").exists():
            if self.mesh is not None:
                raise ValueError(
                    f"{path} holds a one-process checkpoint (state.pt); a "
                    "sharded run resumes from a sharded one (meta.pt)")
            return self._restore_blob(path / "state.pt")
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
            set_state_dict,
        )

        meta = torch.load(path / "meta.pt", weights_only=True)
        flat = bool(meta.get("flat_optimizer", False))
        sd = self._sharded_state(flat)
        dcp.load(sd, checkpoint_id=str(path))
        opt = self.state["optimizer"].opt
        # the groups are this run's (another world size groups the
        # parameters otherwise); the state is matched by parameter name
        groups = [{k: v for k, v in g.items() if k != "params"}
                  for g in opt.param_groups]
        set_state_dict(self.state["model"], opt,
                       model_state_dict=sd["model"],
                       optim_state_dict=sd["optimizer"],
                       options=StateDictOptions(
                           flatten_optimizer_state_dict=flat))
        for g, own in zip(opt.param_groups, groups):
            g.update(own)
        if "teacher" in self.state:
            set_model_state_dict(self.state["teacher"], sd["teacher"])
        self.state["optimizer"].updates = int(meta["updates"])
        for key in _STATE_EXTRAS:
            if key in self.state:
                self.state[key] = meta[key]
        self.state["step"] = int(meta["step"])
        return self.state["step"]

    def _restore_blob(self, path: Path) -> int:
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.state["model"].load_state_dict(blob["model"])
        self.state["optimizer"].load_state_dict(blob["optimizer"])
        if "teacher" in self.state:
            if "teacher" not in blob:
                raise ValueError(f"{path} holds no EMA teacher: a checkpoint "
                                 "of another workload?")
            self.state["teacher"].load_state_dict(blob["teacher"])
        for key in _STATE_EXTRAS:
            if key in self.state:
                self.state[key] = blob[key]
        self.state["step"] = int(blob["step"])
        return self.state["step"]

    def maybe_restore(self) -> int:
        """HF-style resume: an explicit resume_from_checkpoint (a
        checkpoints directory or one step's directory) > the latest step
        in output_dir, unless overwrite_output_dir deletes them."""
        if self.args.resume_from_checkpoint:
            path = Path(self.args.resume_from_checkpoint)
            if not ((path / "state.pt").exists()
                    or (path / "meta.pt").exists()):
                steps = self._agree(self.checkpoint_steps(path))
                if not steps:
                    raise FileNotFoundError(f"no checkpoint under {path}")
                path = path / str(steps[-1])
            return self._restore(path)
        steps = self._agree(self.checkpoint_steps(self.ckpt_dir))
        if self.args.overwrite_output_dir:
            if steps:
                logger.info("overwrite_output_dir: deleting checkpoints up "
                            "to step %d, training from scratch", steps[-1])
            self._barrier()
            if self.main:
                shutil.rmtree(self.ckpt_dir, ignore_errors=True)
            self._barrier()
            return 0
        if steps:
            logger.info("checkpoint detected, resuming at step %d",
                        steps[-1])
            return self._restore(self.ckpt_dir / str(steps[-1]))
        return 0

    def full_model_state(self) -> Dict[str, torch.Tensor]:
        """The whole state_dict of the model, gathered from its shards
        (and, pipelined, from every stage: dense names, the dense model's
        state); on a mesh every rank must call it, and ranks other than 0
        get an empty dict."""
        module = self.state["model"]
        if self.staged:
            from smb_vision_tpu_torch.parallel.pipeline import (
                stage_ranks_state,
            )

            # the tables FSDP2 shards under "pipeline+fsdp" whole on every
            # rank (the same keys in the same order on each), then the
            # stages' layers merged on rank 0
            full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                    for k, v in module.state_dict().items()}
            data_rank = pmesh.axis_rank(self.mesh, pmesh.DATA_AXIS)
            return stage_ranks_state(full, self._ctl, data_rank == 0)
        if not any(hasattr(p, "placements") for p in module.parameters()):
            return module.state_dict() if self.main else {}
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
        )

        return get_model_state_dict(module, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))

    def save_model(self) -> None:
        """Final weights as one flat safetensors file in the JAX package's
        names (`params.videomae.encoder.layer_0...kernel`). A LoRA run
        writes three, as the JAX package does: model.safetensors (the
        frozen base, its head as initialised), lora.safetensors (adapters,
        head, meta) and model_merged.safetensors (adapters merged, the
        trained head)."""
        from smb_vision_tpu_torch.models.convert import (
            params_to_flax,
            write_safetensors,
        )

        model = self.state["model"]
        # gathered whole from its shards on a mesh (every rank calls it)
        full = self.full_model_state()
        if not self.main:
            self._barrier()
            return
        if "lora_meta" not in self.state:
            write_safetensors(self.out_dir / "model.safetensors",
                              params_to_flax(full))
            self._barrier()
            return
        from smb_vision_tpu_torch.train import lora

        # the adapters and the head are replicated: this rank's are whole
        head0 = self.state["base_head"]
        base = {k: head0.get(lora.jax_path(k, v.ndim), v)
                for k, v in lora.base_state_dict(model, state=full).items()}
        write_safetensors(self.out_dir / "model.safetensors",
                          params_to_flax(base))
        write_safetensors(self.out_dir / "lora.safetensors",
                          lora.lora_tensors(model, self.state["lora_meta"]))
        write_safetensors(self.out_dir / "model_merged.safetensors",
                          params_to_flax(lora.base_state_dict(
                              model, merged=True, state=full)))
        self._barrier()

    # -- loops -------------------------------------------------------------
    def train(self) -> Dict[str, int]:
        with pmesh.use_mesh(self.mesh):
            return self._train()

    def _train(self) -> Dict[str, int]:
        args = self.args
        loader = self.train_loader
        steps_per_epoch = len(loader)
        if steps_per_epoch == 0:
            raise ValueError(
                f"the batch size exceeds the dataset ({len(loader.ds)} "
                "items): no full batch can be formed; reduce "
                "per_device_train_batch_size or grad-accum, or add data")
        total = args.num_train_steps or int(steps_per_epoch
                                            * args.num_train_epochs)
        start = self.maybe_restore()

        # a SIGTERM or SIGINT asks for a checkpoint at the next step
        # boundary instead of dying mid-update
        stop = {"flag": False}

        def request_stop(signum, frame):
            logger.warning("signal %s received: checkpointing and stopping "
                           "at the next step boundary", signum)
            stop["flag"] = True

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, request_stop)
            except ValueError:   # not the main thread
                pass

        samples_per_step = (args.per_device_train_batch_size * self.n_data
                            * args.gradient_accumulation_steps)
        flops = args.model_flops_per_sample
        peak = device_peak_flops(self.device)
        if peak:
            peak *= pmesh.world_size()
        epoch, skip = divmod(start, steps_per_epoch)
        if skip:
            logger.info("resume: skipping %d consumed batches of epoch %d",
                        skip, epoch)
        logger.info("training: %d -> %d steps, %d samples/step on %s%s",
                    start, total, samples_per_step, self.device,
                    "" if self.mesh is None else
                    f", mesh {tuple(self.mesh.shape)} "
                    f"{args.sharding_policy}")
        step = start
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        window: List[torch.Tensor] = []
        prof_range = self.profile_range
        profiling = contextlib.ExitStack()
        profiled = False
        t_last = time.perf_counter()
        try:
            while step < total and not stop["flag"]:
                loader.set_epoch(epoch)
                source = iter(loader)
                batches = source
                if skip:
                    batches = itertools.islice(batches, skip, None)
                    skip = 0
                if not self.device_cached:
                    batches = prefetch_to_device(
                        map(self.host_cast, batches), self.device)
                for batch in batches:
                    if step >= total:
                        break
                    if (prof_range and not profiled
                            and prof_range[0] <= step + 1 <= prof_range[1]):
                        profiling.enter_context(
                            trace(self.out_dir / "profile"))
                        profiled = True
                    metrics = self.step_fn(self.state, batch,
                                           step_generator(args.seed, step))
                    step += 1
                    if prof_range and step == prof_range[1]:
                        profiling.close()
                        prof_range = None
                    window.append(metrics["loss"].detach())
                    if step % args.logging_steps == 0:
                        losses = self._mean_over_ranks(window)  # syncs
                        dt = time.perf_counter() - t_last
                        sps = len(losses) * samples_per_step / dt
                        rec = {"step": step,
                               "loss": float(np.mean(losses)),
                               "samples_per_sec": sps,
                               "step_time_ms": dt / len(losses) * 1e3}
                        if flops and peak:
                            rec["mfu"] = flops * sps / peak
                        if self.device.type == "cuda":
                            rec["peak_memory_mib"] = \
                                torch.cuda.max_memory_allocated(
                                    self.device) / 2 ** 20
                        self.mlog.log(rec)
                        window.clear()
                        t_last = time.perf_counter()
                    if step % args.save_steps == 0:
                        self.save_checkpoint(step, epoch)
                    if (args.eval_steps and self.eval_loader is not None
                            and step % args.eval_steps == 0):
                        self.evaluate(step=step)
                    # a stop asked of any rank stops all after this step
                    stop["flag"] = self._any(stop["flag"])
                    if stop["flag"]:
                        break
                else:
                    epoch += 1
                if hasattr(source, "close"):
                    source.close()          # stops a loader's producer
        finally:
            profiling.close()               # a window past the last step
            for sig, handler in prev.items():
                signal.signal(sig, handler)
        steps = self._agree(self.checkpoint_steps(self.ckpt_dir))
        if not steps or steps[-1] != step:
            self.save_checkpoint(step, epoch)
        if stop["flag"]:
            logger.warning("stopped early at step %d (checkpoint saved); "
                           "run again to resume", step)
        return {"train_steps": step}

    def _mean_over_ranks(self, values: List[torch.Tensor]) -> List[float]:
        """Each logged value's mean over the ranks (the losses are the
        global batch's on every rank already: the mean keeps them)."""
        t = torch.stack([v.float().reshape(()) for v in values])
        if self.mesh is not None and dist.get_world_size() > 1:
            t = t.cpu()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._ctl)
            t = t / dist.get_world_size()
        return [float(x) for x in t.cpu()]

    def evaluate(self, step: Optional[int] = None) -> Dict[str, float]:
        """eval_fn over the eval loader. A short final batch is padded to
        the first batch's size by repeating its last row, with a
        `valid_mask` of 0 on the padding, and weighted by its true count.
        When eval_fn also returns "logits" and "labels" (an array, or a
        dict of arrays: the survival durations and events), the padded
        rows are dropped and compute_metrics(logits, labels) over the whole
        eval set adds `eval_<name>` entries."""
        if self.eval_loader is None or self.eval_fn is None:
            return {}
        with pmesh.use_mesh(self.mesh):
            return self._evaluate(step)

    def _evaluate(self, step: Optional[int]) -> Dict[str, float]:
        losses, preds, labels, size = [], [], [], None
        m, r = pmesh.data_share()
        for raw in self.eval_loader:
            if "valid_mask" in raw:
                raise ValueError("eval batches must not carry a "
                                 "'valid_mask' column: the Trainer injects "
                                 "its own padding mask under that name")
            n = len(raw["pixel_values"])
            # every rank reads the global eval batch, padded to a multiple
            # of the data axis as the JAX Trainer pads it, and evaluates
            # its rows; the loss is the global batch's, the logits and
            # labels are gathered back in row order
            mult = m * self.eval_batch_multiple
            size = size or -(-n // mult) * mult
            batch = {k: np.concatenate([np.asarray(v)]
                                       + [np.asarray(v)[-1:]] * (size - n))
                     for k, v in raw.items()}
            batch["valid_mask"] = np.concatenate(
                [np.ones(n, np.float32), np.zeros(size - n, np.float32)])
            per = size // m
            batch = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            out = self.eval_fn(self.state, self.to_device(batch))
            losses.append((float(out["loss"]), n))
            if "logits" in out:
                preds.append(_host(gather_rows(out["logits"]))[:n])
            if "labels" in out:
                lab = out["labels"]
                labels.append({k: _host(gather_rows(v))[:n]
                               for k, v in lab.items()}
                              if isinstance(lab, dict)
                              else _host(gather_rows(lab))[:n])
        rec: Dict[str, float] = {}
        if losses:
            tot = sum(w for _, w in losses)
            rec["eval_loss"] = sum(v * w for v, w in losses) / max(tot, 1)
        if preds and labels and self.compute_metrics is not None:
            if isinstance(labels[0], dict):
                lab_all = {k: np.concatenate([d[k] for d in labels])
                           for k in labels[0]}
            else:
                lab_all = np.concatenate(labels)
            rec.update({f"eval_{k}": v for k, v in self.compute_metrics(
                np.concatenate(preds), lab_all).items()})
        if step is not None:
            rec["step"] = step
        if rec:
            self.mlog.log(rec)
        return rec


def _host(t) -> np.ndarray:
    """A tensor or array as a numpy array on the host (f32 for a float
    tensor)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return np.asarray(t)
