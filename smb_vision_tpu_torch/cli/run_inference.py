"""Batch-embedding CLI on PyTorch / CUDA.

Counterpart of `smb_vision_tpu/cli/run_inference.py`, with the same flags
and the same outputs (one {uid}.npy of (tokens, hidden) per volume plus
metadata.json, or parquet rows; with --sliding_window one
(windows, tokens, hidden) array per volume), and two more flags: --device
(default cuda; the CLI refuses to run if CUDA is absent, and a CPU run
must ask for it with --device cpu) and --seed (the random initialisation
used when no checkpoint is given).

Example:
    python -m smb_vision_tpu_torch.cli.run_inference \\
        --data_dir /data/niftis --output_dir out/embeddings \\
        --model_name_or_path out/mim/model.safetensors \\
        --config_path out/mim/config.json --batch_size 2 --format npy

--sliding_window embeds volumes larger than the model's grid: each volume
is resampled and windowed at its whole extent, and dense windows at the
grid's size (overlap --sw_overlap) go through the model --batch_size at a
time. --input_dtype uint8 ships each volume to the device as one byte a
voxel with its own scale and offset, decoded there to bfloat16.
--cache_data_dir keeps the preprocessed volumes (in --cache_dtype), so a
second run skips decode and resample. Under `python -m
torch.distributed.run --nproc_per_node N`, --pipeline_parallel S splits
the encoder's layers over S stages (each rank builds only its own) and
streams --pipeline_microbatches through them; the N / S data ranks take
their rows of each batch, and rank 0 writes the embeddings.
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
        default=False,
        metadata={"help": "use sliding-window embedding for volumes larger "
                          "than the model grid"})
    sw_overlap: float = 0.25
    resume: bool = True
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "preprocessed-volume cache dir"})
    cache_dtype: str = field(
        default="float32", metadata={"help": "float32 | float16 | uint8"})
    num_workers: int = 8
    max_samples: Optional[int] = None
    dtype: str = "bfloat16"
    input_dtype: str = field(
        default="float32",
        metadata={"help": "dtype pixels are shipped to the device in: "
                          "float32 | bfloat16 | float16 | uint8 (per-volume "
                          "affine codes decoded on the device to bfloat16, "
                          "max abs err (max-min)/510)"})
    attn_impl: str = "auto"
    quant8: bool = field(
        default=False,
        metadata={"help": "run transformer projections as W8A8 on the "
                          "int8 tensor cores (per-token activation scales, "
                          "per-channel weight scales; two hand-written "
                          "kernels, ops/quant.py; inference only). Whether "
                          "it gains on the card: PERF.md"})
    num_shards: int = 1
    shard_index: int = 0
    pipeline_parallel: int = field(
        default=1,
        metadata={"help": "split the encoder's layer stack over this many "
                          "pipeline stages (ranks of "
                          "torch.distributed.run); the other ranks form the "
                          "data axis. num_hidden_layers must divide by it"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches a batch streams through the "
                          "pipeline in (0 = batch_size / data ranks)"})
    device: str = field(
        default="cuda", metadata={"help": "cuda | cuda:N | cpu"})
    seed: int = field(
        default=0, metadata={"help": "seed of the random initialisation "
                                     "used without a checkpoint"})


def _refuse_unported(args) -> None:
    from smb_vision_tpu_torch.utils.args import not_ported

    unported = [
        (args.pipeline_parallel > 1 and args.sliding_window,
         "--pipeline_parallel with --sliding_window", "multi-gpu"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise not_ported(flag, item, "smb_vision_tpu.cli.run_inference")


def pipeline_mesh(args, device, num_layers: int):
    """The (data, stages) mesh of --pipeline_parallel over the launcher's
    ranks (the process group brought up here); raises as the JAX CLI
    does when the ranks or the layers do not divide into the stages, and
    when the data ranks do not divide the batch."""
    from smb_vision_tpu_torch.parallel.mesh import (
        create_mesh,
        maybe_initialize_distributed,
        world_size,
    )

    s = args.pipeline_parallel
    maybe_initialize_distributed(None, device=device.type)
    n = world_size()
    if n % s:
        raise SystemExit(f"{n} devices do not divide into {s} pipeline "
                         "stages")
    if num_layers % s:
        raise SystemExit(f"{num_layers} layers do not divide into {s} "
                         "pipeline stages")
    n_data = n // s
    if args.batch_size % n_data:
        raise SystemExit(f"--batch_size {args.batch_size} does not divide "
                         f"over the {n_data} data ranks")
    return create_mesh(model=s, device_type=device.type)


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.data.quantization import dequantize_pixels
    from smb_vision_tpu_torch.inference.embed import (
        EmbeddingWriter,
        build_json_from_nifti_files,
        run_embedding,
    )
    from smb_vision_tpu_torch.inference.runner import resolve_device
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    (args,) = parse_args_into_dataclasses((InferenceArguments,), argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    mesh = None
    in_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16, "uint8": torch.uint8}.get(
                 args.input_dtype)
    if in_dt is None:
        raise ValueError(f"--input_dtype {args.input_dtype!r}: expected "
                         "float32, bfloat16, float16 or uint8")

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

    stages = None
    made = not torch.distributed.is_initialized()
    if args.pipeline_parallel > 1:
        from smb_vision_tpu_torch.parallel.mesh import (
            MODEL_AXIS,
            axis_rank,
            axis_size,
        )
        from smb_vision_tpu_torch.parallel.pipeline import PipeStages

        mesh = pipeline_mesh(args, device, config.num_hidden_layers)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        n_data = axis_size(mesh, "data")
        m = args.pipeline_microbatches or max(args.batch_size // n_data, 1)
        stages = PipeStages(axis_size(mesh, MODEL_AXIS),
                            axis_rank(mesh, MODEL_AXIS), m)
        logger.info("pipeline: %d stages x data %d, %d microbatches "
                    "(bubble %.0f%%)", stages.stages, n_data, m,
                    100 * (stages.stages - 1) / (m + stages.stages - 1))
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
    ds = CTDataset(pipeline=pipe, cache_dir=args.cache_data_dir,
                   cache_dtype=args.cache_dtype, out_dtype=args.input_dtype,
                   max_samples=args.max_samples, device=device,
                   **dataset_kwargs)
    if args.num_shards > 1:
        ds.items = ds.items[args.shard_index::args.num_shards]
        logger.info("shard %d/%d", args.shard_index, args.num_shards)
    logger.info("%d volumes to embed on %s", len(ds), device)

    model = VideoMAEModel(config, stages)
    if args.model_name_or_path:
        from smb_vision_tpu_torch.models.convert import load_backbone_into

        load_backbone_into(model, args.model_name_or_path)
    else:
        gen = torch.Generator().manual_seed(args.seed)
        if stages is None:
            model.init_weights(gen)
        else:
            from smb_vision_tpu_torch.models.pipelined import stage_state

            dense = VideoMAEModel(config).init_weights(gen)
            model.load_state_dict(stage_state(model, dense.state_dict()))
        logger.info("no checkpoint: random weights from seed %d", args.seed)
    model.to(device).eval()

    writer = EmbeddingWriter(args.output_dir, fmt=args.format,
                             model_id=args.model_id)

    if args.sliding_window:
        stats = _embed_sliding_window(args, ds, model, pipe, writer, device)
    else:
        def embed_fn(pixels, scale=None, offset=None) -> np.ndarray:
            # the cast (or the uint8 codes) on the host before the copy:
            # the copy is what a narrower input dtype saves
            px = torch.as_tensor(pixels)
            if scale is None:
                px = px.to(in_dt).to(device)
            else:
                px = dequantize_pixels(px.to(device), torch.from_numpy(scale),
                                       torch.from_numpy(offset),
                                       torch.bfloat16)
            if mesh is not None:
                return _embed_pipelined(model, px, mesh, args.batch_size)
            with torch.inference_mode():
                out, _ = model(px)
            return out.float().cpu().numpy()

        stats = run_embedding(ds, embed_fn, writer if mesh is None
                              else _MainWriter(writer),
                              batch_size=args.batch_size, resume=args.resume,
                              num_workers=args.num_workers,
                              fatal=mesh is not None)
    logger.info("done: %s", stats)
    print(json.dumps(stats))
    if mesh is not None and made:
        torch.distributed.destroy_process_group()
    return stats


def _embed_pipelined(model, px, mesh, batch_size: int):
    """One batch through the pipelined model: padded to batch_size rows
    (a short last batch repeats its last row), this data rank's rows
    through the stages, every data rank's rows gathered back; the padding
    is cut off."""
    import numpy as np
    import torch

    from smb_vision_tpu_torch.parallel.collectives import (
        gather_rows,
        share_rows,
    )
    from smb_vision_tpu_torch.parallel.mesh import use_mesh

    n = px.shape[0]
    if n < batch_size:
        px = torch.cat([px, px[-1:].expand(batch_size - n,
                                           *px.shape[1:])])
    with torch.inference_mode(), use_mesh(mesh):
        out, _ = model(share_rows(px))
        out = gather_rows(out.float())
    return np.ascontiguousarray(out[:n].cpu().numpy())


class _MainWriter:
    """An EmbeddingWriter that every rank reads (the uids already done)
    and only rank 0 writes through."""

    def __init__(self, writer):
        from smb_vision_tpu_torch.parallel.mesh import is_main_process

        self.inner, self.main = writer, is_main_process()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def write(self, item, emb) -> None:
        if self.main:
            self.inner.write(item, emb)

    def finalize(self, errors) -> None:
        if self.main:
            self.inner.finalize(errors)


def _embed_sliding_window(args, ds, model, pipe, writer, device) -> dict:
    """One volume at a time: resample and window at its whole extent
    (`preprocess_volume_full`), then dense windows at the model's grid
    through the model, args.batch_size windows a call. Writes emb[0],
    (n_win, L, D), per uid."""
    import torch

    from smb_vision_tpu_torch.data.nifti import load_nifti
    from smb_vision_tpu_torch.data.preprocess import preprocess_volume_full
    from smb_vision_tpu_torch.inference.sliding_window import (
        sliding_window_embed,
    )

    config = model.config
    roi = (config.image_size, config.image_size, config.num_frames)

    def window_embedder(wins):
        # (N, C, h, w, d) -> the model's (N, d, C, h, w) -> (N, L, D)
        out, _ = model(wins.permute(0, 4, 1, 2, 3))
        return out.float()

    def embed_one(item):
        img = load_nifti(item[ds.image_key])
        vol = preprocess_volume_full(img.data, img.affine, pipe,
                                     device=device)
        v = torch.from_numpy(vol)[None, None].to(device)   # (1, 1, H, W, D)
        with torch.inference_mode():
            emb, _ = sliding_window_embed(
                v, roi, window_embedder, overlap=args.sw_overlap,
                sw_batch_size=args.batch_size)
        return emb[0].cpu().numpy()

    done = writer.existing_uids() if args.resume else set()
    errors, n_ok, n_skip = [], 0, 0
    for item in ds.items:
        if writer.uid_of(item) in done:
            n_skip += 1
            continue
        try:
            writer.write(item, embed_one(item))
            n_ok += 1
        except Exception as e:  # noqa: BLE001 -- recorded, the run goes on
            logger.error("sliding-window embedding of %s failed: %s",
                         item.get(ds.image_key), e)
            errors.append({"item": item, "error": str(e)})
    writer.finalize(errors)
    return {"embedded": n_ok, "failed": len(errors), "skipped": n_skip}


if __name__ == "__main__":
    main()
