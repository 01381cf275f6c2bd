"""MIM pretraining CLI on PyTorch / CUDA.

Counterpart of `smb_vision_tpu/cli/run_mim.py`, with the same flags, the
same single-JSON mode (`run_mim config.json`) and the same outputs
(`metrics.jsonl`, `checkpoints/<step>/`, `model.safetensors` in the JAX
package's names, `config.json`, and with --export_hf
`hf_model.safetensors` in the HF VideoMAEForPreTraining layout).
`--device` (default cuda) picks the device; the CLI refuses to run if CUDA
is absent, and a CPU run must ask for it with --device cpu. Under
`python -m torch.distributed.run --nproc_per_node N` it trains on N ranks
(NCCL on CUDA, gloo with --device cpu): --sharding_policy dp | fsdp | tp |
fsdp+tp over a (data, model) mesh of --model_parallel model ranks
(`parallel/`), each data rank reading its share of the items
(`partition_items`) and feeding its share of the global batch of
per_device_train_batch_size x data ranks x accumulation.
--sequence_parallel splits the tokens over the model ranks (under every
policy but the pipeline's: with tp or fsdp+tp the stacks' split weights
share the model axis with the tokens; `sp_variant` "gather" or "ring"
through --config_overrides), and
--pipeline_stages S streams --pipeline_microbatches through S stages of
both stacks on the model axis (policy "pipeline" or "pipeline+fsdp"). The volumes go
through the native CT loader when
its library builds (else decode on the host and resample on the device),
--cache_data_dir keeps them preprocessed on disk, --device_cache keeps
them on the device after their first load, and --input_dtype uint8 ships
them as one byte a voxel, decoded on the device in the step.

Example:
    python -m smb_vision_tpu_torch.cli.run_mim \\
        --json_path data.json --output_dir out/mim --image_size 512 \\
        --depth 320 --mask_patch_size 32 --mask_ratio 0.65 \\
        --mlp_impl pallas_bwd --gradient_checkpointing true \\
        --per_device_train_batch_size 1 --num_train_steps 1000
"""

from __future__ import annotations

import functools
import random
from dataclasses import dataclass, field
from dataclasses import fields as dc_fields
from typing import Optional

from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger("run_mim")


@dataclass
class DataTrainingArguments:
    json_path: Optional[str] = field(
        default=None, metadata={"help": "The local json data path."})
    train_split: str = "train"
    validation_split: str = "validation"
    train_val_split: float = 0.15
    mask_patch_size: int = field(
        default=16, metadata={"help": "size of square mask patches"})
    mask_ratio: float = field(
        default=0.5, metadata={"help": "fraction of patches to mask"})
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "preprocessed-volume cache dir"})
    cache_dtype: str = field(
        default="float32",
        metadata={"help": "on-disk dtype for cached volumes; float16 halves "
                          "disk/IO bytes (~1e-4 rounding on [0,1] values)"})
    num_workers: int = 8
    device_cache: bool = field(
        default=False,
        metadata={"help": "keep volumes in DEVICE memory after their first "
                          "load; later epochs put batches together on the "
                          "device (no host pixel bytes a step). For "
                          "datasets that fit beside the model state"})


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None,
        metadata={"help": "checkpoint to initialise from: the JAX "
                          "package's or this CLI's export, an HF VideoMAE "
                          "file or directory, or a hub id"})
    config_name_or_path: Optional[str] = None
    config_overrides: Optional[str] = field(
        default=None,
        metadata={"help": "comma list key=value applied to the config"})
    image_size: int = 224
    depth: int = 160
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    decoder_num_attention_heads: int = 6
    intermediate_size: int = 3072
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    mlp_impl: str = field(
        default="auto",
        metadata={"help": "MLP kernel: auto|pallas|pallas_bwd|xla "
                          "('pallas_bwd': kernels K5a + K5b in training)"})
    gradient_checkpointing: bool = False
    sequence_parallel: bool = False
    export_hf: bool = field(
        default=False,
        metadata={"help": "also write hf_model.safetensors, the HF "
                          "VideoMAEForPreTraining layout"})
    pipeline_stages: int = field(
        default=1,
        metadata={"help": "GPipe-pipeline the encoder and decoder stacks "
                          "over this many stages (the mesh's model axis): "
                          "each rank holds layers/S of both stacks. Both "
                          "layer counts must divide by it; microbatching "
                          "replaces gradient accumulation"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches per step through the pipeline (0 = "
                          "per_device_train_batch_size). Bubble is "
                          "(stages-1)/(microbatches+stages-1)"})


def build_config(model_args: ModelArguments):
    """VideoMAEConfig from a config file or the flags. A config file's
    geometry, impls, dtype and remat stand unless a flag is given a value
    other than its default (passing the default value is the same as not
    passing it; --config_overrides forces any key)."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    from_file = bool(model_args.config_name_or_path)
    if from_file:
        config = VideoMAEConfig.from_json(model_args.config_name_or_path)
    else:
        config = VideoMAEConfig(
            hidden_size=model_args.hidden_size,
            num_hidden_layers=model_args.num_hidden_layers,
            num_attention_heads=model_args.num_attention_heads,
            intermediate_size=model_args.intermediate_size)
    defaults = {f.name: f.default for f in dc_fields(type(model_args))}
    flags = {
        "image_size": ("image_size", model_args.image_size),
        "num_frames": ("depth", model_args.depth),
        "tubelet_size": ("patch_size", model_args.patch_size),
        "patch_size": ("patch_size", model_args.patch_size),
        "decoder_num_attention_heads": (
            "decoder_num_attention_heads",
            model_args.decoder_num_attention_heads),
        "attn_impl": ("attn_impl", model_args.attn_impl),
        "mlp_impl": ("mlp_impl", model_args.mlp_impl),
        "dtype": ("dtype", model_args.dtype),
        "gradient_checkpointing": ("gradient_checkpointing",
                                   model_args.gradient_checkpointing),
        "sequence_parallel": ("sequence_parallel",
                              model_args.sequence_parallel),
    }
    upd = {k: v for k, (arg, v) in flags.items()
           if not from_file or v != defaults[arg]}
    if not from_file:
        upd["num_channels"] = 1
    config.update(upd)
    return config.apply_overrides(model_args.config_overrides)


def check_parallel_flags(model_args, training_args) -> bool:
    """The model-parallel flags, before any process group: sequence
    parallelism runs under every policy but the pipeline's ("tp" and
    "fsdp+tp" store the stacks' split weights over the model axis, which
    also holds the tokens); --pipeline_stages S > 1 refuses gradient
    accumulation and sequence parallelism, as the JAX CLI does, and puts
    the stages on the model axis under the "pipeline" policy (a
    "pipeline+..." policy stands). Returns whether the run is pipelined.
    A flag the calling CLI does not have counts as unset."""
    sp = getattr(model_args, "sequence_parallel", False)
    stages = getattr(model_args, "pipeline_stages", 1)
    if stages <= 1:
        return False
    if training_args.gradient_accumulation_steps > 1:
        raise SystemExit(
            "--pipeline_stages replaces gradient accumulation with "
            "microbatching (--pipeline_microbatches); set "
            "--gradient_accumulation_steps 1")
    if sp:
        raise ValueError("pipeline parallelism composes with the data "
                         "axis, not sequence parallelism; drop "
                         "--sequence_parallel")
    training_args.model_parallel = stages
    if "pipeline" not in training_args.sharding_policy:
        logger.info("pipeline_stages=%d: sharding_policy -> 'pipeline'",
                    stages)
        training_args.sharding_policy = "pipeline"
    return True


def pipeline_microbatches(model_args, training_args):
    """(train, eval) microbatches of a pipelined run: --pipeline_
    microbatches or the per-device batch, and its gcd with the eval
    batch."""
    import math

    m = (model_args.pipeline_microbatches
         or training_args.per_device_train_batch_size)
    return m, math.gcd(m, training_args.per_device_eval_batch_size)


def start_distributed(training_args):
    """Bring up torch.distributed when a launcher started this process
    (or --multihost true), then the device and the (data, model) mesh of
    --model_parallel and --dcn_slices. Returns (device, accumulation
    dtype, mesh or None, whether this call made the process group)."""
    import torch.distributed as dist

    from smb_vision_tpu_torch.parallel.mesh import (
        create_mesh,
        maybe_initialize_distributed,
    )

    before = dist.is_initialized()
    maybe_initialize_distributed(training_args.multihost,
                                 device=training_args.device)
    made = dist.is_initialized() and not before
    device, accum_dt = _device_and_accum(training_args)
    mesh = create_mesh(model=training_args.model_parallel,
                       dcn=training_args.dcn_slices,
                       device_type=device.type)
    return device, accum_dt, mesh, made


def stop_distributed(made: bool) -> None:
    import torch.distributed as dist

    if made and dist.is_initialized():
        dist.destroy_process_group()


def data_partition(train_ds, mesh) -> None:
    """Each data rank keeps its share of the training items, in place
    (the ranks of one model group read the same ones)."""
    from smb_vision_tpu_torch.data.dataset import partition_items
    from smb_vision_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_rank,
        axis_size,
    )

    n = axis_size(mesh, DATA_AXIS)
    if n > 1:
        train_ds.items = partition_items(train_ds.items, n,
                                         axis_rank(mesh, DATA_AXIS))


def make_datasets(data_args, training_args, pipe, device, data_path,
                  train_split, validation_split, max_eval_samples=None):
    """(train, eval or None) CTDatasets of a spec, with the cache flags
    and out_dtype = input_dtype, so a half-precision or uint8 cache goes
    to the device without a float32 round trip on the host."""
    from smb_vision_tpu_torch.data.dataset import CTDataset

    kw = dict(pipeline=pipe, device=device,
              cache_dir=data_args.cache_data_dir,
              cache_dtype=data_args.cache_dtype,
              out_dtype=training_args.input_dtype)
    train_ds = CTDataset(data_path, split=train_split,
                         max_samples=data_args.max_train_samples, **kw)
    try:
        eval_ds = CTDataset(data_path, split=validation_split,
                            max_samples=max_eval_samples, **kw)
    except (ValueError, FileNotFoundError):
        eval_ds = None
    return train_ds, eval_ds, kw


def make_train_loader(train_ds, data_args, training_args):
    """The host BatchLoader, or with --device_cache the
    DeviceCachedBatchLoader (which the Trainer attaches to its device)."""
    from smb_vision_tpu_torch.data.dataset import (
        BatchLoader,
        DeviceCachedBatchLoader,
    )

    batch = (training_args.per_device_train_batch_size
             * training_args.gradient_accumulation_steps)
    if data_args.device_cache:
        return DeviceCachedBatchLoader(
            train_ds, batch, shuffle=True, seed=training_args.seed,
            input_dtype=training_args.input_dtype)
    return BatchLoader(train_ds, batch, shuffle=True,
                       seed=training_args.seed,
                       num_workers=data_args.num_workers)


def _device_and_accum(training_args):
    """The torch device of --device (cuda refuses to run without CUDA;
    there is no fallback to the CPU; under a process group "cuda" is this
    rank's card) and the dtype of --grad_accum_dtype."""
    import torch

    device = torch.device(training_args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but CUDA is not available; pass --device cpu to "
            "run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {training_args.device}: expected cuda "
                         "or cpu")
    accum_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        training_args.grad_accum_dtype)
    if accum_dt is None:
        raise ValueError(f"--grad_accum_dtype "
                         f"{training_args.grad_accum_dtype!r}: expected "
                         "float32 or bfloat16")
    return device, accum_dt


def main(argv=None) -> dict:
    from smb_vision_tpu_torch.train.trainer import TrainingArguments

    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataTrainingArguments, TrainingArguments), argv)
    pipelined = check_parallel_flags(model_args, training_args)
    device, accum_dt, mesh, made = start_distributed(training_args)
    try:
        return _main(model_args, data_args, training_args, device, accum_dt,
                     mesh, pipelined)
    finally:
        stop_distributed(made)


def _main(model_args, data_args, training_args, device, accum_dt,
          mesh, pipelined: bool = False) -> dict:
    from smb_vision_tpu_torch.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.models.convert import (
        export_hf_videomae,
        load_params_into,
        write_safetensors,
    )
    from smb_vision_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
    from smb_vision_tpu_torch.train.mim import (
        make_mim_workload,
        make_pipelined_mim_workload,
    )
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import Trainer
    from smb_vision_tpu_torch.utils.profiling import mim_flops_per_sample

    config = build_config(model_args)
    logger.info("MIM config: %s tokens, grid %s, on %s", config.seq_len,
                config.grid, device)

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["mim"].target_spacing,
        target_size=(config.image_size, config.image_size,
                     config.num_frames))
    train_ds, eval_ds, ds_kw = make_datasets(
        data_args, training_args, pipe, device, data_args.json_path,
        data_args.train_split, data_args.validation_split,
        data_args.max_eval_samples)
    if eval_ds is None and data_args.train_val_split and len(train_ds) > 1:
        # no validation split in the spec: split train, seeded
        items = list(train_ds.items)
        random.Random(training_args.seed).shuffle(items)
        n_val = min(max(1, round(len(items) * data_args.train_val_split)),
                    len(items) - 1)
        val_items = items[:n_val]
        if data_args.max_eval_samples:
            val_items = val_items[:data_args.max_eval_samples]
        eval_ds = CTDataset(items=val_items, **ds_kw)
        train_ds.items = items[n_val:]
        logger.info("no '%s' split: auto-split %d/%d train/val "
                    "(train_val_split=%.2f)", data_args.validation_split,
                    len(train_ds), len(eval_ds), data_args.train_val_split)

    data_partition(train_ds, mesh)
    train_loader = make_train_loader(train_ds, data_args, training_args)
    # every rank reads the global eval batch; the Trainer splits it
    n_data = axis_size(mesh, DATA_AXIS)
    eval_loader = (BatchLoader(eval_ds,
                               training_args.per_device_eval_batch_size
                               * n_data, shuffle=False,
                               num_workers=data_args.num_workers,
                               drop_last=False)
                   if eval_ds and len(eval_ds) else None)
    total_steps = training_args.num_train_steps or int(
        len(train_loader) * training_args.num_train_epochs)

    tx = functools.partial(
        make_optimizer, learning_rate=training_args.learning_rate,
        total_steps=total_steps, weight_decay=training_args.weight_decay,
        warmup_ratio=training_args.warmup_ratio,
        warmup_steps=training_args.warmup_steps,
        schedule=training_args.lr_scheduler_type,
        min_lr=training_args.min_lr, grad_clip=training_args.max_grad_norm,
        vision_lr=training_args.vision_lr,
        merger_lr=training_args.merger_lr, optim=training_args.optim)
    eval_mb = 1
    if pipelined:
        n_mb, eval_mb = pipeline_microbatches(model_args, training_args)
        model, init_fn, step_fn, eval_fn = make_pipelined_mim_workload(
            config, mask_patch_size=data_args.mask_patch_size,
            mask_ratio=data_args.mask_ratio, tx=tx, mesh=mesh,
            num_microbatches=n_mb, eval_microbatches=eval_mb,
            device=device)
        stages = model_args.pipeline_stages
        logger.info("pipelined pretraining: %d stages x %d microbatches "
                    "(bubble %.0f%%)", stages, n_mb,
                    100 * (stages - 1) / (n_mb + stages - 1))
    else:
        model, init_fn, step_fn, eval_fn = make_mim_workload(
            config, mask_patch_size=data_args.mask_patch_size,
            mask_ratio=data_args.mask_ratio, tx=tx,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=accum_dt, device=device)
    if training_args.model_flops_per_sample is None:
        training_args.model_flops_per_sample = mim_flops_per_sample(
            config, data_args.mask_ratio)

    state = init_fn(training_args.seed)
    if model_args.model_name_or_path:
        # graft what matches (name and shape) into the fresh init: a
        # checkpoint of another architecture fails here, not at a step
        load_params_into(model, model_args.model_name_or_path,
                         tree="pretraining")

    trainer = Trainer(args=training_args, state=state, step_fn=step_fn,
                      train_loader=train_loader, eval_loader=eval_loader,
                      eval_fn=eval_fn, mesh=mesh,
                      eval_batch_multiple=eval_mb)
    result = {}
    if training_args.do_train:
        result.update(trainer.train())
        trainer.save_model()
        if model_args.export_hf:
            full = trainer.full_model_state()
        if trainer.main:
            config.save_json(str(trainer.out_dir / "config.json"))
        if model_args.export_hf and trainer.main:
            hf = export_hf_videomae(
                full, num_layers=config.num_hidden_layers,
                decoder_layers=config.decoder_num_hidden_layers)
            write_safetensors(trainer.out_dir / "hf_model.safetensors", hf)
            logger.info("HF export: %d tensors -> hf_model.safetensors",
                        len(hf))
        logger.info("train complete: %s", result)
    if training_args.do_eval:
        metrics = trainer.evaluate()
        logger.info("eval: %s", metrics)
        result.update(metrics)
    return result


if __name__ == "__main__":
    main()
