"""Embedding server on PyTorch / CUDA: the online surface of the encoder.

Counterpart of `smb_vision_tpu/cli/serve.py`, with the same flags, routes
and answers (--encoder smb-vision, or merlin: the inflated-3D ResNet from
a torch state dict, on the "merlin" CT pipeline), and two more flags:
--device (default cuda; the server refuses to start if CUDA is absent,
and a CPU run must ask for it with --device cpu) and --seed (the random
initialisation used when no checkpoint is given). Standard library HTTP
only:

    python -m smb_vision_tpu_torch.cli.serve \\
        --model_name_or_path out/mim/model.safetensors \\
        --config_path out/mim/config.json --port 8000

    GET  /healthz                -> {"status": "ok", model, device, ...}
    POST /embed                  body: {"image": "/path.nii.gz"} or
                                 {"images": [...paths]}
                                 optional: {"pool": "mean"|"none"}
      -> {"embeddings": [[...]], "shape": ...}   (pool=mean: one vector
         per volume; pool=none: full token grids, large)
    POST /embed?pool=...         body: raw NIfTI bytes
                                 (Content-Type: application/octet-stream)
      -> the same answer, for clients without a shared filesystem

The model stays resident on the device. Requests are cut into chunks of
--batch_size volumes and the last chunk is padded to it, so the model runs
at one batch shape. Decode and preprocessing run in the request's thread;
the device's work (the copy, the uint8 decode, the forward and the pooling)
is serialised by a lock. --cache_data_dir keeps preprocessed volumes, so a
repeated path skips decode and resample (raw-bytes requests bypass it).
Each request's time is logged split into preprocess, copy, encode and
response. The answer carries its split in a `Server-Timing` header
(`server_timing` reads it back).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger("serve")


@dataclass
class ServeArguments:
    host: str = "127.0.0.1"
    port: int = 8000
    encoder: str = field(
        default="smb-vision",
        metadata={"help": "smb-vision (ViT) | merlin (I3D ResNet; "
                          "--model_name_or_path is its torch state dict)"})
    model_name_or_path: Optional[str] = field(
        default=None, metadata={"help": "safetensors checkpoint (the JAX "
                                        "package's export or HF layout)"})
    config_path: Optional[str] = field(
        default=None, metadata={"help": "model config json"})
    target_size: Optional[str] = field(
        default=None, metadata={"help": "merlin only: override the "
                                        "resample grid, 3 comma-separated "
                                        "ints (default 224,224,160)"})
    model_id: str = "smb-vision-tpu-base"
    pipeline: str = "smb-vision"
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    batch_size: int = field(
        default=1, metadata={"help": "the model's batch; requests are "
                                     "chunked and padded to it"})
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "preprocessed-volume cache dir "
                                        "(repeat requests skip decode and "
                                        "resample)"})
    warmup: bool = field(
        default=True, metadata={"help": "run one forward at --batch_size "
                                        "before the first request (builds "
                                        "the kernels)"})
    input_dtype: str = field(
        default="float32",
        metadata={"help": "dtype pixels are copied to the device in: "
                          "float32 | bfloat16 | float16 | uint8 (per-volume "
                          "affine codes decoded on the device, max abs err "
                          "(max-min)/510)"})
    device: str = field(
        default="cuda", metadata={"help": "cuda | cuda:N | cpu"})
    seed: int = field(
        default=0, metadata={"help": "seed of the random initialisation "
                                     "used without a checkpoint"})


class EmbeddingService:
    """Owns the resident encoder; thread-safe embed() over volume paths."""

    def __init__(self, args: ServeArguments):
        self.args = args
        if args.encoder == "merlin":
            from smb_vision_tpu_torch.cli.run_encoders import (
                parse_target_size,
            )
            from smb_vision_tpu_torch.inference.encoders import MerlinEncoder

            if not args.model_name_or_path:
                raise ValueError(
                    "--model_name_or_path is required for --encoder "
                    "merlin: the local Merlin image-tower torch state "
                    "dict (.pt/.safetensors)")
            try:
                target_size = parse_target_size(args.target_size)
            except SystemExit as e:
                raise ValueError(str(e)) from None
            self.encoder = MerlinEncoder(
                model_id=args.model_id if args.model_id !=
                "smb-vision-tpu-base" else "merlin",
                checkpoint=args.model_name_or_path, dtype=args.dtype,
                target_size=target_size, device=args.device)
        elif args.encoder == "smb-vision":
            from smb_vision_tpu_torch.inference.runner import (
                SmbVisionEncoder,
            )

            self.encoder = SmbVisionEncoder(
                checkpoint=args.model_name_or_path,
                config_path=args.config_path, model_id=args.model_id,
                pipeline=args.pipeline, dtype=args.dtype,
                attn_impl=args.attn_impl, device=args.device, seed=args.seed)
        else:
            raise ValueError(f"unknown encoder {args.encoder!r}; "
                             "valid: 'smb-vision', 'merlin'")
        self.encoder.setup_model()
        self._lock = threading.Lock()      # serialises the device's work
        self.requests = 0
        if args.warmup:
            import numpy as np

            shape = (args.batch_size, *self._pixel_shape())
            with self._lock:
                if args.input_dtype == "uint8":
                    self.encoder.generate_embedding(
                        np.zeros(shape, np.uint8),
                        scale=np.ones(args.batch_size, np.float32),
                        offset=np.zeros(args.batch_size, np.float32))
                else:
                    self.encoder.generate_embedding(
                        np.zeros(shape, np.float32))
            logger.info("warmup forward done (batch %d, input %s)",
                        args.batch_size, args.input_dtype)

    def _pixel_shape(self):
        """One volume's pixel shape: (D, C, H, W), or Merlin's (C, a0, a1,
        a2)."""
        if self.args.encoder == "merlin":
            return (1, *self.encoder.pipeline().target_size)
        cfg = self.encoder._config()
        return (cfg.num_frames, 1, cfg.image_size, cfg.image_size)

    def _preprocess(self, paths, cache: bool = True):
        """Decode and resample each path to the model grid -> (pixels
        (N, D, C, H, W), scale, offset); scale and offset are the per-volume
        affine when input_dtype is "uint8", else None."""
        import numpy as np

        from smb_vision_tpu_torch.data.dataset import stack_pixels

        ds = self.encoder.create_dataset(
            [{"image": p} for p in paths], out_dtype=self.args.input_dtype,
            cache_dir=self.args.cache_data_dir if cache else None)
        exs = [ds[i] for i in range(len(paths))]
        pixels = stack_pixels([e["image"] for e in exs])
        if "image_scale" in exs[0]:
            return (pixels,
                    np.asarray([e["image_scale"] for e in exs], np.float32),
                    np.asarray([e["image_offset"] for e in exs],
                               np.float32))
        return pixels, None, None

    def embed(self, paths, pool: str = "mean", cache: bool = True,
              split: Optional[dict] = None):
        """-> (N, D) float32 mean-pooled vectors (pool='mean') or (N, L, D)
        token grids (pool='none'). `split`, when given, receives the
        milliseconds spent in preprocess, copy (host to device, with the
        uint8 decode) and encode (forward, pooling and the copy back)."""
        import numpy as np
        import torch

        from smb_vision_tpu_torch.data.dataset import pad_to_batch

        if pool not in ("mean", "none"):
            raise ValueError(f"pool must be 'mean' or 'none', got {pool!r}")
        bs = self.args.batch_size
        times = {"preprocess_ms": 0.0, "copy_ms": 0.0, "encode_ms": 0.0}
        outs = []
        for i in range(0, len(paths), bs):
            # preprocess per chunk: a long 'images' list never holds every
            # decoded volume in host memory at once
            t0 = time.perf_counter()
            chunk, sc, of = self._preprocess(paths[i:i + bs], cache=cache)
            n = chunk.shape[0]
            chunk = pad_to_batch(chunk, bs)     # pad to the model's batch
            if sc is not None:
                sc, of = pad_to_batch(sc, bs), pad_to_batch(of, bs)
            t1 = time.perf_counter()
            with self._lock:            # its wait goes in no bucket
                t_lock = time.perf_counter()
                px = self.encoder.to_device(chunk, sc, of)
                if px.is_cuda:      # the copy's time, not its enqueue
                    torch.cuda.synchronize(px.device)
                t2 = time.perf_counter()
                emb = self.encoder.encode(px)[:n]
                if pool == "mean":
                    emb = emb.mean(dim=1)
                outs.append(emb.cpu().numpy())
                t3 = time.perf_counter()
            times["preprocess_ms"] += 1e3 * (t1 - t0)
            times["copy_ms"] += 1e3 * (t2 - t_lock)
            times["encode_ms"] += 1e3 * (t3 - t2)
        with self._lock:
            self.requests += len(paths)
        if split is not None:
            split.update(times)
        return np.concatenate(outs)

    def health(self):
        import torch

        dev = self.encoder.device
        rec = {"status": "ok", "encoder": self.args.encoder,
               "model_id": self.encoder.model_id,
               "checkpoint": self.args.model_name_or_path,
               "batch_size": self.args.batch_size,
               "input_dtype": self.args.input_dtype,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "requests_served": self.requests}
        if self.args.encoder == "merlin":
            rec["pixel_shape"] = list(self._pixel_shape())
            rec["hidden_size"] = self.encoder.config.hidden_size
        else:
            cfg = self.encoder._config()
            rec["grid"] = list(cfg.grid)
            rec["hidden_size"] = cfg.hidden_size
        return rec


def server_timing(header: str) -> dict:
    """{"preprocess_ms": 1786.2, ...} from an answer's Server-Timing header
    ("preprocess;dur=1786.2, copy;dur=...")."""
    out = {}
    for metric in header.split(","):
        name, _, dur = metric.strip().partition(";dur=")
        out[f"{name}_ms"] = float(dur)
    return out


def make_server(args: ServeArguments) -> ThreadingHTTPServer:
    """Build (but do not run) the HTTP server. `srv.service` is the
    EmbeddingService."""
    service = EmbeddingService(args)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):    # through the package's logger
            logger.info("%s " + fmt, self.address_string(), *a)

        def _send(self, code: int, body: bytes,
                  timing: Optional[dict] = None) -> None:
            """A JSON body, with `timing` ({"name_ms": ms}) as its
            Server-Timing header when given."""
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if timing:
                self.send_header("Server-Timing", ", ".join(
                    f"{k.removesuffix('_ms')};dur={v:.3f}"
                    for k, v in timing.items()))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode())

        def _embedded(self, emb, split: dict, t0: float) -> None:
            """Answer with the embeddings and, in its Server-Timing
            header, the split (the JSON serialisation included); log the
            split with the response's write."""
            t1 = time.perf_counter()
            body = json.dumps({"embeddings": emb.tolist(),
                               "shape": list(emb.shape)}).encode()
            split["serialize_ms"] = 1e3 * (time.perf_counter() - t1)
            self._send(200, body, timing=split)
            split["respond_ms"] = 1e3 * (time.perf_counter() - t1)
            split["total_ms"] = 1e3 * (time.perf_counter() - t0)
            logger.info("embed %d volumes: %s", emb.shape[0], ", ".join(
                f"{k} {v:.1f}" for k, v in split.items()))

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/healthz"):
                return self._json(200, service.health())
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            t0 = time.perf_counter()
            split: dict = {}
            url = urlparse(self.path)
            if url.path.rstrip("/") != "/embed":
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if "octet-stream" in ctype:
                    # raw NIfTI bytes: clients without a shared filesystem
                    import os
                    import tempfile

                    pool = parse_qs(url.query).get("pool", ["mean"])[0]
                    sfx = ".nii.gz" if body[:2] == b"\x1f\x8b" else ".nii"
                    fd, tmp = tempfile.mkstemp(suffix=sfx)
                    try:
                        with os.fdopen(fd, "wb") as f:
                            f.write(body)
                        # cache=False: a one-shot temp path would fill the
                        # cache with entries never read again
                        emb = service.embed([tmp], pool=pool, cache=False,
                                            split=split)
                    finally:
                        os.unlink(tmp)
                    return self._embedded(emb, split, t0)
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    return self._json(
                        400, {"error": "body must be a JSON object like "
                              '{"images": [...]} or {"image": "..."}'})
                paths = req.get("images") or (
                    [req["image"]] if "image" in req else None)
                if isinstance(paths, str):   # one path under 'images'
                    paths = [paths]
                if not paths or not isinstance(paths, list) or not all(
                        isinstance(p, str) for p in paths):
                    return self._json(
                        400, {"error": "body needs 'image' (str) or "
                              "'images' (list of str)"})
                emb = service.embed(paths, pool=req.get("pool", "mean"),
                                    split=split)
                return self._embedded(emb, split, t0)
            except FileNotFoundError as e:
                return self._json(404, {"error": str(e)})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- report, keep serving
                logger.exception("embed failed")
                return self._json(500, {"error": str(e)})

    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    srv.service = service
    return srv


def main(argv=None):
    (args,) = parse_args_into_dataclasses((ServeArguments,), argv)
    srv = make_server(args)
    logger.info("serving on http://%s:%d (model %s, device %s)",
                *srv.server_address[:2], args.model_id,
                srv.service.health()["device"])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
