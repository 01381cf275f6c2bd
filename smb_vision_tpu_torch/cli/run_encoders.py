"""Encoder-zoo CLI on PyTorch / CUDA: batch embeddings through a named
encoder.

Counterpart of `smb_vision_tpu/cli/run_encoders.py`, with the same flags,
messages and outputs, and one more flag: --device (default cuda; the CLI
refuses to run if CUDA is absent, and a CPU run must ask for it with
--device cpu). --siglip_backend and --merlin_backend keep
the JAX package's values: "jax" names the first-party tower, the PyTorch
one in this package, and "torch" the third-party model.

    python -m smb_vision_tpu_torch.cli.run_encoders \\
        --encoder smb-vision --input_json manifest.json \\
        --output_dir out/emb --checkpoint out/mim/model.safetensors \\
        --config_path out/mim/config.json --batch_size 2

manifest.json: {"images": [{"uid": ..., "image_path": ...}, ...]}
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger("run_encoders")


@dataclass
class EncoderArguments:
    encoder: str = field(default="smb-vision", metadata={
        "help": "smb-vision | siglip | merlin"})
    input_json: Optional[str] = None
    output_dir: str = "embeddings"
    checkpoint: Optional[str] = None
    config_path: Optional[str] = None
    model_id: Optional[str] = None
    format: str = "parquet"
    batch_size: int = 1
    num_workers: int = 8
    resume: bool = True
    siglip_backend: str = field(default="jax", metadata={
        "help": "jax | torch (jax: the first-party SigLIP tower, PyTorch in "
                "this package; torch: transformers' SiglipVisionModel)"})
    merlin_backend: str = field(default="jax", metadata={
        "help": "jax | torch (jax: the first-party inflated-3D ResNet, "
                "PyTorch in this package, needs --checkpoint; torch: the "
                "external `merlin` package)"})
    target_size: Optional[str] = field(default=None, metadata={
        "help": "comma-separated 3 ints, e.g. 224,224,160"})
    device: str = field(default="cuda", metadata={
        "help": "cuda | cuda:N | cpu"})


def parse_target_size(text: Optional[str]):
    """(a0, a1, a2) from "224,224,160"; None for None; anything else but
    3 ints raises SystemExit."""
    if not text:
        return None
    try:
        size = tuple(int(s) for s in text.split(","))
    except ValueError:
        size = ()
    if len(size) != 3:
        raise SystemExit(f"--target_size needs 3 comma-separated ints, got "
                         f"{text!r}")
    return size


def main(argv=None) -> dict:
    from smb_vision_tpu_torch.inference.runner import (
        BaseEncoderRunner,
        SmbVisionEncoder,
    )

    (args,) = parse_args_into_dataclasses((EncoderArguments,), argv)
    if not args.input_json:
        raise SystemExit("--input_json is required")
    if args.encoder == "smb-vision":
        enc = SmbVisionEncoder(
            checkpoint=args.checkpoint, config_path=args.config_path,
            model_id=args.model_id or "smb-vision-tpu-base",
            device=args.device)
    elif args.encoder == "siglip":
        from smb_vision_tpu_torch.inference.encoders import SiglipEncoder

        if not args.checkpoint:
            raise SystemExit(
                "--checkpoint is required for siglip: pass a local HF "
                "checkpoint directory (zero-egress environments cannot "
                "pull from the hub)")
        enc = SiglipEncoder(model_path=args.checkpoint,
                            model_id=args.model_id or "siglip",
                            backend=args.siglip_backend, device=args.device)
    elif args.encoder == "merlin":
        from smb_vision_tpu_torch.inference.encoders import MerlinEncoder

        if args.merlin_backend == "jax" and not args.checkpoint:
            raise SystemExit(
                "--checkpoint is required for merlin with the jax "
                "backend: pass the local Merlin image-tower state dict "
                "(.pt/.safetensors); --merlin_backend torch uses the "
                "external `merlin` package instead")
        enc = MerlinEncoder(model_id=args.model_id or "merlin",
                            checkpoint=args.checkpoint,
                            backend=args.merlin_backend,
                            target_size=parse_target_size(args.target_size),
                            device=args.device)
    else:
        raise SystemExit(f"unknown encoder {args.encoder}")
    runner = BaseEncoderRunner(enc, args.output_dir, fmt=args.format,
                               batch_size=args.batch_size,
                               num_workers=args.num_workers)
    items = runner.load_input_json(args.input_json)
    stats = runner.run(items, resume=args.resume)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
