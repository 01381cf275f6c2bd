"""Fine-tuning CLI on PyTorch / CUDA: classification |
multilabel_classification | regression | survival | cox_regression.

Counterpart of `smb_vision_tpu/cli/run_classification.py`, with the same
flags and the same single-JSON mode: task-type dispatch, tabular
additional_features fused at the VideoMAE head, two-tier learning rates
(--vision_lr for the backbone, --merger_lr for the head), the model
dispatch (--model_type, else a config file's model_type, else 'dino' or
'vjepa' in --model_name_or_path, else VideoMAE) and the metric suite
(C-index, micro F1, accuracy and ROC-AUC, MSE) on eval. A config file's
impls, dtype and remat stand unless a flag is given a value other than
its default. Outputs: `metrics.jsonl` (with the eval metrics),
`checkpoints/<step>/`, `model.safetensors` in the JAX package's names and
`config.json`; with --lora_enable only LoRA adapters (--lora_rank,
--lora_alpha) and the head train, and the run also writes
`lora.safetensors` and `model_merged.safetensors` (train/lora.py).
--optim adamw8bit keeps the AdamW moments in int8 blocks. `--device`
(default cuda) picks the device; the CLI refuses to run if CUDA is
absent, and a CPU run must ask for it with --device cpu. Under
`python -m torch.distributed.run` it trains on N ranks as run_mim does:
the Cox risk sets and the eval metrics are the global batch's. LoRA
(--lora_enable) trains under every sharding policy: the frozen base is
placed by it, the adapters and the head stay replicated.

Example:
    python -m smb_vision_tpu_torch.cli.run_classification \\
        --train_data_path train.json --val_data_path val.json \\
        --output_dir out/cls --task_type survival \\
        --additional_feature_columns age --config_name_or_path dinov2.json \\
        --vision_lr 1e-5 --merger_lr 3e-4 --num_train_steps 1000 --do_eval
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass, field
from dataclasses import fields as dc_fields
from typing import List, Optional

from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger("run_classification")


@dataclass
class DataTrainingArguments:
    train_data_path: Optional[str] = None
    val_data_path: Optional[str] = None
    task_type: str = field(default="classification", metadata={"help":
        "classification | multilabel_classification | regression | "
        "survival | cox_regression"})
    num_labels: int = 2
    label_columns: List[str] = field(default_factory=lambda: ["label"])
    additional_feature_columns: List[str] = field(default_factory=list)
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "preprocessed-volume cache dir"})
    cache_dtype: str = "float32"
    num_workers: int = 8


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None, metadata={"help":
            "backbone checkpoint (the JAX package's or this package's "
            "safetensors export, or an HF-layout VideoMAE or DINOv2 file); "
            "'dino'/'vjepa' in the name select those routes when "
            "model_type=auto"})
    model_type: str = field(default="auto", metadata={
        "help": "auto | videomae | dinov2 | vjepa2"})
    config_name_or_path: Optional[str] = None
    config_overrides: Optional[str] = field(
        default=None,
        metadata={"help": "comma list key=value applied to the config "
                          "after the only-if-explicit flag merge"})
    image_size: int = 224
    depth: int = 160
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    mlp_impl: str = field(
        default="auto",
        metadata={"help": "MLP kernel: auto|pallas|pallas_bwd|xla ('pallas' "
                          "with a SwiGLU DINOv2: kernel K9)"})
    gradient_checkpointing: bool = False
    lora_enable: bool = field(
        default=False, metadata={"help": "train LoRA adapters and the head "
                                         "only (train/lora.py)"})
    lora_rank: int = 8
    lora_alpha: float = 16.0


def _explicit_impl_args(model_args: ModelArguments) -> dict:
    """The impl, dtype and remat flags given a value other than their
    default: with --config_name_or_path only these override the file."""
    defaults = {f.name: f.default for f in dc_fields(ModelArguments)}
    return {k: getattr(model_args, k)
            for k in ("dtype", "attn_impl", "mlp_impl",
                      "gradient_checkpointing")
            if getattr(model_args, k) != defaults[k]}


def model_type_of(model_args: ModelArguments, cfg_file: Optional[dict]
                  ) -> str:
    mtype = model_args.model_type
    if mtype != "auto":
        return mtype
    if cfg_file and cfg_file.get("model_type") in ("videomae", "dinov2",
                                                   "vjepa2"):
        return cfg_file["model_type"]
    name = (model_args.model_name_or_path or "").lower()
    return ("dinov2" if "dino" in name
            else "vjepa2" if "vjepa" in name else "videomae")


def build_config(model_args: ModelArguments, data_args):
    """(config, pipeline key) of the route: a config file's (with the
    task's labels and only-if-explicit impl flags), or one built from the
    flags; then --config_overrides."""
    config, pipeline_key = _route_config(model_args, data_args)
    return config.apply_overrides(model_args.config_overrides), pipeline_key


def _route_config(model_args: ModelArguments, data_args):
    from smb_vision_tpu_torch.models.configs import (
        Dinov2Config,
        VideoMAEConfig,
        VJEPA2Config,
    )
    from smb_vision_tpu_torch.train.classification import (
        is_survival,
        problem_type_for,
    )

    cfg_file = None
    if model_args.config_name_or_path:
        with open(model_args.config_name_or_path) as fh:
            cfg_file = json.load(fh)
    mtype = model_type_of(model_args, cfg_file)
    task = data_args.task_type
    num_labels = (1 if is_survival(task) or task == "regression"
                  else len(data_args.label_columns)
                  if task == "multilabel_classification"
                  else data_args.num_labels)
    common = dict(
        image_size=model_args.image_size, patch_size=model_args.patch_size,
        hidden_size=model_args.hidden_size,
        num_hidden_layers=model_args.num_hidden_layers,
        num_attention_heads=model_args.num_attention_heads,
        num_labels=num_labels, dtype=model_args.dtype,
        attn_impl=model_args.attn_impl, mlp_impl=model_args.mlp_impl,
        gradient_checkpointing=model_args.gradient_checkpointing)
    feat = dict(
        additional_features_size=len(data_args.additional_feature_columns),
        problem_type=problem_type_for(task, num_labels))
    if mtype != "videomae" and model_args.intermediate_size != 3072:
        logger.warning("--intermediate_size is read only on the videomae "
                       "route; the %s config sizes its MLP from mlp_ratio",
                       mtype)
    explicit = _explicit_impl_args(model_args)
    if mtype == "dinov2":
        if cfg_file is not None:
            config = Dinov2Config.from_dict(cfg_file)
            config.update({"num_labels": num_labels, **feat, **explicit})
        else:
            config = Dinov2Config(depth=model_args.depth, **common, **feat)
        return config, "dinov2"
    if mtype == "vjepa2":
        if cfg_file is not None:
            config = VJEPA2Config.from_dict(cfg_file)
            config.update({"num_labels": num_labels, **explicit})
        else:
            cm = dict(common)
            cm["crop_size"] = cm.pop("image_size")
            config = VJEPA2Config(frames_per_clip=model_args.depth,
                                  in_chans=1,
                                  tubelet_size=model_args.patch_size, **cm)
        return config, "smb-vision"
    if mtype != "videomae":
        raise ValueError(f"--model_type {mtype!r}: expected auto, videomae, "
                         "dinov2 or vjepa2")
    if cfg_file is not None:
        config = VideoMAEConfig.from_dict(cfg_file)
        config.update({"num_labels": num_labels, **feat, **explicit})
    else:
        config = VideoMAEConfig(
            num_frames=model_args.depth, num_channels=1,
            tubelet_size=model_args.patch_size,
            intermediate_size=model_args.intermediate_size, **common, **feat)
    return config, "smb-vision"


def main(argv=None) -> dict:
    from smb_vision_tpu_torch.cli.run_mim import (
        check_parallel_flags,
        start_distributed,
        stop_distributed,
    )
    from smb_vision_tpu_torch.train.trainer import TrainingArguments

    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataTrainingArguments, TrainingArguments), argv)
    check_parallel_flags(model_args, training_args)
    device, accum_dt, mesh, made = start_distributed(training_args)
    try:
        return _main(model_args, data_args, training_args, device, accum_dt,
                     mesh)
    finally:
        stop_distributed(made)


def _main(model_args, data_args, training_args, device, accum_dt,
          mesh) -> dict:
    from smb_vision_tpu_torch.cli.run_mim import data_partition
    from smb_vision_tpu_torch.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.models.convert import load_backbone_into
    from smb_vision_tpu_torch.train.classification import (
        collate_classification,
        make_classification_workload,
    )
    from smb_vision_tpu_torch.train.metrics import compute_metrics
    from smb_vision_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import Trainer
    from smb_vision_tpu_torch.utils.profiling import (
        classification_flops_per_sample,
    )

    if data_args.additional_feature_columns == [""]:
        data_args.additional_feature_columns = []
    config, pipeline_key = build_config(model_args, data_args)
    if config.model_type != "videomae" and \
            data_args.additional_feature_columns:
        logger.warning("the %s head does not fuse tabular features; "
                       "ignoring additional_feature_columns",
                       config.model_type)
        data_args.additional_feature_columns = []
    if config.model_type == "dinov2":
        size, depth = config.image_size, config.depth
    elif config.model_type == "vjepa2":
        size, depth = config.crop_size, config.frames_per_clip
    else:
        size, depth = config.image_size, config.num_frames
    logger.info("%s fine-tuning (%s): %s tokens at %d^2 x %d on %s",
                config.model_type, data_args.task_type, config.seq_len, size,
                depth, device)
    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES[pipeline_key].target_spacing,
        target_size=(size, size, depth),
        layout=CT_PIPELINES[pipeline_key].layout)

    # out_dtype = input_dtype: a half-precision or uint8 cache goes to the
    # device without a float32 round trip on the host
    ds_kw = dict(pipeline=pipe, device=device,
                 cache_dir=data_args.cache_data_dir,
                 cache_dtype=data_args.cache_dtype,
                 out_dtype=training_args.input_dtype)
    train_ds = None
    if training_args.do_train:
        if not data_args.train_data_path:
            raise SystemExit("--train_data_path is required with --do_train")
        train_ds = CTDataset(data_args.train_data_path, split="train",
                             max_samples=data_args.max_train_samples,
                             **ds_kw)
    eval_ds = (CTDataset(data_args.val_data_path, split="validation",
                         max_samples=data_args.max_eval_samples, **ds_kw)
               if data_args.val_data_path else None)
    if train_ds is None and not (eval_ds and len(eval_ds)):
        raise SystemExit("nothing to do: need --train_data_path with "
                         "--do_train, or --val_data_path with --do_eval")
    collate = functools.partial(
        collate_classification, task_type=data_args.task_type,
        label_columns=data_args.label_columns,
        additional_feature_columns=data_args.additional_feature_columns)
    if train_ds is not None:
        data_partition(train_ds, mesh)
    train_loader = BatchLoader(
        train_ds, training_args.per_device_train_batch_size
        * training_args.gradient_accumulation_steps, shuffle=True,
        seed=training_args.seed, num_workers=data_args.num_workers,
        collate=collate) if train_ds is not None else None
    # every rank reads the global eval batch; the Trainer splits it
    eval_loader = (BatchLoader(eval_ds,
                               training_args.per_device_eval_batch_size
                               * axis_size(mesh, DATA_AXIS),
                               num_workers=data_args.num_workers,
                               drop_last=False, collate=collate)
                   if eval_ds and len(eval_ds) else None)
    total_steps = training_args.num_train_steps or int(
        (len(train_loader) if train_loader is not None else 1)
        * training_args.num_train_epochs) or 1

    tx = functools.partial(
        make_optimizer, learning_rate=training_args.learning_rate,
        total_steps=total_steps, weight_decay=training_args.weight_decay,
        warmup_ratio=training_args.warmup_ratio,
        warmup_steps=training_args.warmup_steps,
        schedule=training_args.lr_scheduler_type,
        min_lr=training_args.min_lr, grad_clip=training_args.max_grad_norm,
        vision_lr=training_args.vision_lr,
        merger_lr=training_args.merger_lr, optim=training_args.optim)
    if training_args.model_flops_per_sample is None:
        training_args.model_flops_per_sample = \
            classification_flops_per_sample(config)
    if model_args.lora_enable:
        # the backbone is loaded into the base before the adapters are
        # registered; only the adapters and the head train
        from smb_vision_tpu_torch.train.lora import (
            lora_size,
            make_lora_classification_workload,
        )

        model, init_fn, step_fn, eval_fn = make_lora_classification_workload(
            config, task_type=data_args.task_type, tx=tx,
            rank=model_args.lora_rank, alpha=model_args.lora_alpha,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=accum_dt, device=device)
        state = init_fn(training_args.seed,
                        backbone=model_args.model_name_or_path)
        logger.info("LoRA rank %d: %d adapter params trainable",
                    model_args.lora_rank, lora_size(model))
    else:
        model, init_fn, step_fn, eval_fn = make_classification_workload(
            config, task_type=data_args.task_type, tx=tx,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=accum_dt, device=device)
        state = init_fn(training_args.seed)
        if model_args.model_name_or_path:
            load_backbone_into(model, model_args.model_name_or_path)
    if model_args.model_name_or_path:
        logger.info("backbone initialised from %s",
                    model_args.model_name_or_path)

    trainer = Trainer(
        args=training_args, state=state, step_fn=step_fn,
        train_loader=train_loader, eval_loader=eval_loader, eval_fn=eval_fn,
        compute_metrics=functools.partial(compute_metrics,
                                          data_args.task_type), mesh=mesh)
    result = {}
    if training_args.do_train:
        result.update(trainer.train())
        trainer.save_model()
        if trainer.main:
            config.save_json(str(trainer.out_dir / "config.json"))
        logger.info("train complete: %s", result)
    if training_args.do_eval:
        metrics = trainer.evaluate()
        logger.info("eval: %s", metrics)
        result.update(metrics)
    return result


if __name__ == "__main__":
    main()
