"""Batch-embedding CLI on PyTorch / CUDA.

Counterpart of `smb_vision_tpu/cli/run_inference.py`, with the same flags
and the same outputs (one {uid}.npy of (tokens, hidden) per volume plus
metadata.json, or parquet rows), and two more flags: --device (default
cuda; the CLI refuses to run if CUDA is absent, and a CPU run must ask for
it with --device cpu) and --seed (the random initialisation used when no
checkpoint is given).

Example:
    python -m smb_vision_tpu_torch.cli.run_inference \\
        --data_dir /data/niftis --output_dir out/embeddings \\
        --model_name_or_path out/mim/model.safetensors \\
        --config_path out/mim/config.json --batch_size 2 --format npy
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger("run_inference")


@dataclass
class InferenceArguments:
    data_dir: Optional[str] = field(
        default=None, metadata={"help": "directory of *.nii[.gz] volumes"})
    data_json: Optional[str] = field(
        default=None, metadata={"help": "or: json list of {image: path}"})
    output_dir: str = "embeddings"
    model_name_or_path: Optional[str] = field(
        default=None, metadata={"help": "safetensors checkpoint (the JAX "
                                        "package's export or HF layout)"})
    config_path: Optional[str] = field(
        default=None, metadata={"help": "model config json"})
    model_id: str = "smb-vision-tpu-base"
    format: str = field(default="npy", metadata={"help": "npy | parquet"})
    batch_size: int = 1
    image_size: int = 224
    depth: int = 160
    patch_size: int = 16
    sliding_window: bool = field(
        default=False, metadata={"help": "not ported yet"})
    sw_overlap: float = 0.25
    resume: bool = True
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "not ported yet"})
    cache_dtype: str = "float32"
    num_workers: int = 8
    max_samples: Optional[int] = None
    dtype: str = "bfloat16"
    input_dtype: str = field(
        default="float32",
        metadata={"help": "dtype pixels are shipped to the device in "
                          "(float32 | bfloat16 | float16); uint8 is not "
                          "ported yet"})
    attn_impl: str = "auto"
    quant8: bool = field(default=False, metadata={"help": "not ported yet"})
    num_shards: int = 1
    shard_index: int = 0
    pipeline_parallel: int = field(
        default=1, metadata={"help": "values above 1 are not ported yet"})
    pipeline_microbatches: int = 0
    device: str = field(
        default="cuda", metadata={"help": "cuda | cuda:N | cpu"})
    seed: int = field(
        default=0, metadata={"help": "seed of the random initialisation "
                                     "used without a checkpoint"})


def _refuse_unported(args) -> None:
    unported = [
        (args.sliding_window, "--sliding_window",
         "queue 1, sliding window and serve"),
        (args.pipeline_parallel > 1, "--pipeline_parallel > 1",
         "queue 1, multi-GPU"),
        (args.quant8, "--quant8", "queue 1, W8A8"),
        (args.input_dtype == "uint8", "--input_dtype uint8",
         "queue 1, uint8 shipping"),
        (bool(args.cache_data_dir), "--cache_data_dir",
         "queue 1, native loader and dataset cache"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise NotImplementedError(
                f"{flag} is not yet ported to smb_vision_tpu_torch "
                f"(ROADMAP.md {item}); use smb_vision_tpu.cli.run_inference")


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.inference.embed import (
        EmbeddingWriter,
        build_json_from_nifti_files,
        run_embedding,
    )
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    (args,) = parse_args_into_dataclasses((InferenceArguments,), argv)
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but CUDA is not available; pass --device cpu to "
            "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {args.device}: expected cuda or cpu")
    in_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}.get(args.input_dtype)
    if in_dt is None:
        raise ValueError(f"--input_dtype {args.input_dtype!r}: expected "
                         "float32, bfloat16 or float16")

    if args.config_path:
        config = VideoMAEConfig.from_json(args.config_path)
        config.update({"attn_impl": args.attn_impl, "dtype": args.dtype,
                       "quant8": args.quant8})
    else:
        config = VideoMAEConfig(
            image_size=args.image_size, num_frames=args.depth,
            num_channels=1, patch_size=args.patch_size,
            tubelet_size=args.patch_size, dtype=args.dtype,
            attn_impl=args.attn_impl, quant8=args.quant8)

    if args.data_json:
        dataset_kwargs = dict(data_path=args.data_json, split=None)
    elif args.data_dir:
        dataset_kwargs = dict(items=build_json_from_nifti_files(args.data_dir))
    else:
        raise SystemExit("one of --data_dir / --data_json is required")

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["smb-vision"].target_spacing,
        target_size=(config.image_size, config.image_size,
                     config.num_frames))
    ds = CTDataset(pipeline=pipe, max_samples=args.max_samples,
                   device=device, **dataset_kwargs)
    if args.num_shards > 1:
        ds.items = ds.items[args.shard_index::args.num_shards]
        logger.info("shard %d/%d", args.shard_index, args.num_shards)
    logger.info("%d volumes to embed on %s", len(ds), device)

    model = VideoMAEModel(config)
    if args.model_name_or_path:
        from smb_vision_tpu_torch.models.convert import load_backbone_into

        load_backbone_into(model, args.model_name_or_path)
    else:
        gen = torch.Generator().manual_seed(args.seed)
        model.init_weights(gen)
        logger.info("no checkpoint: random weights from seed %d", args.seed)
    model.to(device).eval()

    def embed_fn(pixels: np.ndarray) -> np.ndarray:
        # cast on the host before the copy: the copy is what a narrower
        # input dtype saves
        px = torch.from_numpy(pixels).to(in_dt).to(device)
        with torch.inference_mode():
            out, _ = model(px)
        return out.float().cpu().numpy()

    writer = EmbeddingWriter(args.output_dir, fmt=args.format,
                             model_id=args.model_id)
    stats = run_embedding(ds, embed_fn, writer, batch_size=args.batch_size,
                          resume=args.resume, num_workers=args.num_workers)
    logger.info("done: %s", stats)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
