"""MIM pretraining CLI on PyTorch / CUDA.

Counterpart of `smb_vision_tpu/cli/run_mim.py`, with the same flags, the
same single-JSON mode (`run_mim config.json`) and the same outputs
(`metrics.jsonl`, `checkpoints/<step>/`, `model.safetensors` in the JAX
package's names, `config.json`). `--device` (default cuda) picks the
device; the CLI refuses to run if CUDA is absent, and a CPU run must ask
for it with --device cpu. Training runs on one device: sharding_policy
"dp" or "fsdp" on one device is plain single-device training.

Example:
    python -m smb_vision_tpu_torch.cli.run_mim \\
        --json_path data.json --output_dir out/mim --image_size 512 \\
        --depth 320 --mask_patch_size 32 --mask_ratio 0.65 \\
        --mlp_impl pallas_bwd --gradient_checkpointing true \\
        --per_device_train_batch_size 1 --num_train_steps 1000
"""

from __future__ import annotations

import functools
import os
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
        default=None, metadata={"help": "not ported yet"})
    cache_dtype: str = field(
        default="float32",
        metadata={"help": "on-disk dtype for cached volumes; float16 halves "
                          "disk/IO bytes (~1e-4 rounding on [0,1] values). "
                          "Read only with --cache_data_dir, which is not "
                          "ported yet"})
    num_workers: int = 8
    device_cache: bool = field(
        default=False, metadata={"help": "not ported yet"})


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None,
        metadata={"help": "safetensors checkpoint to initialise from (the "
                          "JAX package's or this CLI's export)"})
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
    export_hf: bool = field(default=False,
                            metadata={"help": "not ported yet"})
    pipeline_stages: int = field(
        default=1, metadata={"help": "values above 1 are not ported yet"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches per step through the pipeline (0 = "
                          "per_device_train_batch_size). Read only with "
                          "--pipeline_stages > 1, which is not ported yet"})


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


def _refuse_unported(model_args, data_args, training_args,
                     cli: str = "run_mim", extra=()) -> None:
    """Raise for a flag whose module is not ported, naming its ROADMAP.md
    item; extra: more (hit, flag, item) triples of the calling CLI. A flag
    the calling CLI does not have counts as unset."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    unported = [*extra,
        (getattr(model_args, "pipeline_stages", 1) > 1,
         "--pipeline_stages > 1", "queue 1, multi-GPU"),
        (bool(data_args.cache_data_dir), "--cache_data_dir",
         "queue 1, native loader and dataset cache"),
        (getattr(data_args, "device_cache", False), "--device_cache",
         "queue 1, native loader and dataset cache"),
        (training_args.input_dtype == "uint8", "--input_dtype uint8",
         "queue 1, uint8 shipping"),
        (bool(training_args.multihost), "--multihost", "queue 1, multi-GPU"),
        (training_args.model_parallel > 1, "--model_parallel > 1",
         "queue 1, multi-GPU"),
        (training_args.dcn_slices > 1 or world > 1,
         "training on more than one device", "queue 1, multi-GPU"),
        (training_args.sharding_policy not in ("dp", "fsdp"),
         f"--sharding_policy {training_args.sharding_policy}",
         "queue 1, multi-GPU"),
        (getattr(model_args, "export_hf", False), "--export_hf",
         "queue 1, checkpoints"),
        (bool(training_args.profile_steps), "--profile_steps",
         "queue 1, MIM training (item 4)"),
        (training_args.report_to not in ("none", ""),
         f"--report_to {training_args.report_to}",
         "queue 1, MIM training (item 4)"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise NotImplementedError(
                f"{flag} is not yet ported to smb_vision_tpu_torch "
                f"(ROADMAP.md {item}); use smb_vision_tpu.cli.{cli}")


def _device_and_accum(training_args):
    """The torch device of --device (cuda refuses to run without CUDA;
    there is no fallback to the CPU) and the dtype of
    --grad_accum_dtype."""
    import torch

    device = torch.device(training_args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but CUDA is not available; pass --device cpu to "
            "run on the CPU")
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


def _load_checkpoint(model, path: str) -> None:
    """Graft every tensor of a safetensors export (the JAX package's names)
    whose name and shape match the model; none matching is an error."""
    import torch

    from smb_vision_tpu_torch.models.convert import (
        params_from_flax,
        read_safetensors,
    )

    src = params_from_flax(read_safetensors(path), pretraining=True)
    target = model.state_dict()
    hits = {k: v for k, v in src.items()
            if k in target and tuple(v.shape) == tuple(target[k].shape)}
    if not hits:
        raise ValueError(f"no tensor in {path} matches the MIM parameter "
                         "tree (names and shapes): wrong checkpoint for this "
                         "architecture?")
    with torch.no_grad():
        for k, v in hits.items():
            target[k].copy_(v)
    logger.info("initialised %d tensors from %s (%d checkpoint tensors "
                "unused)", len(hits), path, len(src) - len(hits))


def main(argv=None) -> dict:
    import torch

    from smb_vision_tpu_torch.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import Trainer, TrainingArguments
    from smb_vision_tpu_torch.utils.profiling import mim_flops_per_sample

    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataTrainingArguments, TrainingArguments), argv)
    _refuse_unported(model_args, data_args, training_args)
    device, accum_dt = _device_and_accum(training_args)
    config = build_config(model_args)
    logger.info("MIM config: %s tokens, grid %s, on %s", config.seq_len,
                config.grid, device)

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["mim"].target_spacing,
        target_size=(config.image_size, config.image_size,
                     config.num_frames))
    train_ds = CTDataset(data_args.json_path, split=data_args.train_split,
                         pipeline=pipe, device=device,
                         max_samples=data_args.max_train_samples)
    try:
        eval_ds = CTDataset(data_args.json_path,
                            split=data_args.validation_split, pipeline=pipe,
                            device=device,
                            max_samples=data_args.max_eval_samples)
    except (ValueError, FileNotFoundError):
        eval_ds = None
    if eval_ds is None and data_args.train_val_split and len(train_ds) > 1:
        # no validation split in the spec: split train, seeded
        items = list(train_ds.items)
        random.Random(training_args.seed).shuffle(items)
        n_val = min(max(1, round(len(items) * data_args.train_val_split)),
                    len(items) - 1)
        val_items = items[:n_val]
        if data_args.max_eval_samples:
            val_items = val_items[:data_args.max_eval_samples]
        eval_ds = CTDataset(items=val_items, pipeline=pipe, device=device)
        train_ds.items = items[n_val:]
        logger.info("no '%s' split: auto-split %d/%d train/val "
                    "(train_val_split=%.2f)", data_args.validation_split,
                    len(train_ds), len(eval_ds), data_args.train_val_split)

    train_loader = BatchLoader(
        train_ds, training_args.per_device_train_batch_size
        * training_args.gradient_accumulation_steps, shuffle=True,
        seed=training_args.seed, num_workers=data_args.num_workers)
    eval_loader = (BatchLoader(eval_ds,
                               training_args.per_device_eval_batch_size,
                               shuffle=False,
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
        _load_checkpoint(model, model_args.model_name_or_path)

    trainer = Trainer(args=training_args, state=state, step_fn=step_fn,
                      train_loader=train_loader, eval_loader=eval_loader,
                      eval_fn=eval_fn)
    result = {}
    if training_args.do_train:
        result.update(trainer.train())
        trainer.save_model()
        config.save_json(str(trainer.out_dir / "config.json"))
        logger.info("train complete: %s", result)
    if training_args.do_eval:
        metrics = trainer.evaluate()
        logger.info("eval: %s", metrics)
        result.update(metrics)
    return result


if __name__ == "__main__":
    main()
