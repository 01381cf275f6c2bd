"""V-JEPA2 pretraining CLI on PyTorch / CUDA.

Counterpart of `smb_vision_tpu/cli/run_vjepa.py`, with the same flags, the
same single-JSON mode (`run_vjepa config.json`, e.g. a copy of
`configs/vjepa_large_384_tpu.json` with `data_path` and `output_dir` set),
the same only-if-explicit config-file guard with `--config_overrides`, and
the same outputs (`metrics.jsonl`, `checkpoints/<step>/` with the EMA
teacher, `model.safetensors` in the JAX package's names, `config.json`,
and with --export_hf `hf_model.safetensors` in the HF VJEPA2Model layout).
The volumes take the V-JEPA pipeline (spacing (1.0, 1.0, 1.5) mm, cropped
to image_size^2 x depth), with the data flags of run_mim
(--cache_data_dir, --device_cache, --input_dtype uint8).
--model_name_or_path continues pretraining from a checkpoint (this CLI's
or the JAX package's export, an HF V-JEPA2 file or a hub id): what
matches is grafted into the student and the EMA teacher starts as its
copy. `--device` (default cuda) picks the device; the CLI refuses to run
if CUDA is absent, and a CPU run must ask for it with --device cpu. Under
`python -m torch.distributed.run` it trains on N ranks as run_mim does
(--sequence_parallel and --pipeline_stages included); the EMA teacher is
placed, split and pipelined like the student.

Example:
    python -m smb_vision_tpu_torch.cli.run_vjepa \\
        --data_path data.json --output_dir out/vjepa \\
        --num_attention_heads 8 --pred_num_attention_heads 3 \\
        --attn_impl pallas_i8bwd --teacher_attn_impl pallas_int8 \\
        --mlp_impl pallas_bwd --gradient_checkpointing true \\
        --per_device_train_batch_size 1 --num_train_steps 1000
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from dataclasses import fields as dc_fields
from typing import Optional

from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger("run_vjepa")


@dataclass
class DataTrainingArguments:
    data_path: Optional[str] = field(
        default=None, metadata={"help": "The local data path."})
    train_split: str = "train"
    validation_split: str = "validation"
    max_train_samples: Optional[int] = None
    cache_data_dir: Optional[str] = None
    cache_dtype: str = "float32"
    num_workers: int = 8
    device_cache: bool = field(
        default=False,
        metadata={"help": "keep volumes in device memory after their first "
                          "load (see run_mim)"})
    num_mask_blocks: int = 3
    inv_block: bool = False


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None,
        metadata={"help": "continued pretraining: graft this checkpoint "
                          "into the student; the EMA teacher starts as "
                          "its copy"})
    config_name_or_path: Optional[str] = None
    config_overrides: Optional[str] = field(
        default=None,
        metadata={"help": "comma list key=value applied to the config "
                          "after the only-if-explicit flag merge"})
    image_size: int = 384
    depth: int = 256
    patch_size: int = 16
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    pred_hidden_size: int = 384
    pred_num_hidden_layers: int = 12
    pred_num_attention_heads: int = 12
    ema_momentum: float = 0.99925
    teacher_attn_impl: Optional[str] = field(
        default=None,
        metadata={"help": "attention impl of the forward-only EMA teacher "
                          "(e.g. 'pallas_int8': kernel K3); None = the "
                          "student's"})
    dtype: str = "bfloat16"
    attn_impl: str = field(
        default="auto",
        metadata={"help": "'pallas_i8bwd': K1 forward, int8-score backward "
                          "K7"})
    mlp_impl: str = field(
        default="auto",
        metadata={"help": "MLP kernel: auto|pallas|pallas_bwd|xla "
                          "('pallas_bwd': kernels K5a + K5b in training)"})
    gradient_checkpointing: bool = False
    sequence_parallel: bool = False
    export_hf: bool = field(
        default=False,
        metadata={"help": "also write hf_model.safetensors, the HF "
                          "VJEPA2Model layout"})
    pipeline_stages: int = field(
        default=1,
        metadata={"help": "GPipe-pipeline the student's, the teacher's and "
                          "the predictor's stacks over this many stages "
                          "(the mesh's model axis); the encoder's and the "
                          "predictor's layer counts must divide by it"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches per step through the pipeline (0 = "
                          "per_device_train_batch_size)"})


def build_config(model_args: ModelArguments):
    """VJEPA2Config from a config file or the flags. A config file's
    geometry, impls, dtype and remat stand unless a flag is given a value
    other than its default (passing the default value is the same as not
    passing it; --config_overrides forces any key)."""
    from smb_vision_tpu_torch.models.configs import VJEPA2Config

    from_file = bool(model_args.config_name_or_path)
    if from_file:
        config = VJEPA2Config.from_json(model_args.config_name_or_path)
    else:
        config = VJEPA2Config(
            hidden_size=model_args.hidden_size,
            num_hidden_layers=model_args.num_hidden_layers,
            num_attention_heads=model_args.num_attention_heads,
            pred_hidden_size=model_args.pred_hidden_size,
            pred_num_hidden_layers=model_args.pred_num_hidden_layers,
            pred_num_attention_heads=model_args.pred_num_attention_heads)
    defaults = {f.name: f.default for f in dc_fields(type(model_args))}
    flags = {
        "crop_size": ("image_size", model_args.image_size),
        "patch_size": ("patch_size", model_args.patch_size),
        "frames_per_clip": ("depth", model_args.depth),
        "tubelet_size": ("patch_size", model_args.patch_size),
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
        upd["in_chans"] = 1
    config.update(upd)
    return config.apply_overrides(model_args.config_overrides)


def main(argv=None) -> dict:
    from smb_vision_tpu_torch.cli.run_mim import (
        check_parallel_flags,
        start_distributed,
        stop_distributed,
    )
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
    from smb_vision_tpu_torch.cli.run_mim import (
        data_partition,
        make_datasets,
        make_train_loader,
        pipeline_microbatches,
    )
    from smb_vision_tpu_torch.data.dataset import BatchLoader
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.models.convert import (
        export_hf_vjepa2,
        load_params_into,
        write_safetensors,
    )
    from smb_vision_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import Trainer
    from smb_vision_tpu_torch.train.vjepa import (
        make_pipelined_vjepa_workload,
        make_vjepa_workload,
    )
    from smb_vision_tpu_torch.utils.profiling import vjepa_flops_per_sample

    config = build_config(model_args)
    logger.info("V-JEPA config: %s tokens, grid %s, on %s", config.seq_len,
                config.grid, device)

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["vjepa"].target_spacing,
        target_size=(config.crop_size, config.crop_size,
                     config.frames_per_clip))
    train_ds, eval_ds, _ = make_datasets(
        data_args, training_args, pipe, device, data_args.data_path,
        data_args.train_split, data_args.validation_split)
    data_partition(train_ds, mesh)
    train_loader = make_train_loader(train_ds, data_args, training_args)
    # every rank reads the global eval batch; the Trainer splits it
    eval_loader = (BatchLoader(eval_ds,
                               training_args.per_device_eval_batch_size
                               * axis_size(mesh, DATA_AXIS), shuffle=False,
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
    kw = dict(ema_momentum=model_args.ema_momentum,
              teacher_attn_impl=model_args.teacher_attn_impl,
              num_blocks=data_args.num_mask_blocks,
              inv_block=data_args.inv_block, device=device)
    eval_mb = 1
    if pipelined:
        n_mb, eval_mb = pipeline_microbatches(model_args, training_args)
        model, init_fn, step_fn, eval_fn = make_pipelined_vjepa_workload(
            config, tx=tx, mesh=mesh, num_microbatches=n_mb,
            eval_microbatches=eval_mb, **kw)
        logger.info("pipelined pretraining: %d stages x %d microbatches",
                    model_args.pipeline_stages, n_mb)
    else:
        model, init_fn, step_fn, eval_fn = make_vjepa_workload(
            config, tx=tx,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=accum_dt, **kw)
    if training_args.model_flops_per_sample is None:
        training_args.model_flops_per_sample = vjepa_flops_per_sample(config)

    state = init_fn(training_args.seed)
    if model_args.model_name_or_path:
        # continued pretraining: graft what matches (the whole V-JEPA
        # tree, or an encoder-only export) into the fresh student; the
        # EMA teacher restarts as a copy of the loaded student
        load_params_into(state["model"], model_args.model_name_or_path,
                         tree="vjepa")
        state["teacher"].load_state_dict(state["model"].state_dict())
    trainer = Trainer(args=training_args, state=state,
                      step_fn=step_fn, train_loader=train_loader,
                      eval_loader=eval_loader, eval_fn=eval_fn, mesh=mesh,
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
            hf = export_hf_vjepa2(
                full, num_layers=config.num_hidden_layers,
                pred_layers=config.pred_num_hidden_layers)
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
