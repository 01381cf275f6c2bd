"""Checkpoints in and out of the port: the JAX package's safetensors export
and HF-layout VideoMAE files.

Counterpart of `smb_vision_tpu/models/convert.py` for VideoMAE and the
V-JEPA2 pretraining tree. `params_from_flax` maps the JAX package's flattened parameter names
(`params.encoder.layer_0.attention.query.kernel`, ...) to this package's
state_dict (`encoder.layer_0.attention.query.weight`, ...): Dense kernels
are transposed into Linear weights, LayerNorm `scale` becomes `weight`, and
the Conv3d layout of `patch_embed_kernel` is kept; `params_to_flax` is its
inverse, which `Trainer.save_model` writes. The safetensors reader and
writer are small numpy ones (the format: an 8-byte little-endian header
length, a JSON header, raw little-endian tensor bytes), so no `safetensors`
package is needed.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v).name: k for k, v in _ST_DTYPES.items()}
_WRAPPERS = ("videomae.",)
_BACKBONE = re.compile(r"^(patch_embed_(kernel|bias)|encoder\.|layernorm\.)")
# the pretraining tree: the backbone under `videomae.` and the decoder side
_PRETRAINING = re.compile(
    r"^(videomae\.(patch_embed_(kernel|bias)|encoder\.|layernorm\.)"
    r"|encoder_to_decoder\.|mask_token$|decoder\.|decoder_norm\."
    r"|decoder_head\.)")
# the V-JEPA2 tree (VJEPA2Model; its EMA teacher has the same names)
_VJEPA = re.compile(
    r"^(encoder\.(patch_embed_(kernel|bias)$|encoder\.|layernorm\.)"
    r"|predictor\.(predictor_embeddings\.|mask_tokens$|stack\.|layernorm\."
    r"|proj\.))")


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """All tensors of one .safetensors file as numpy arrays (bf16 widens
    to float32)."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    n = int.from_bytes(raw[:8], "little")
    if n > len(raw) - 8:
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        begin, end = spec["data_offsets"]
        buf = raw[base + begin:base + end]
        shape = tuple(spec["shape"])
        if spec["dtype"] == "BF16":
            bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif spec["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(buf, dtype=np.dtype(
                _ST_DTYPES[spec["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {spec['dtype']}")
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name!r} holds {arr.size} "
                             f"values for shape {shape}")
        out[name] = arr.reshape(shape)
    return out


def write_safetensors(path: Union[str, Path],
                      tensors: Dict[str, np.ndarray]) -> None:
    """Write numpy arrays as one .safetensors file, in sorted name order
    with contiguous offsets and the header padded to 8 bytes."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        dt = _ST_NAMES.get(arr.dtype.name)
        if dt is None:
            raise ValueError(f"tensor {name!r}: dtype {arr.dtype} has no "
                             "safetensors name here")
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def params_from_flax(flat: Dict[str, np.ndarray], *,
                     pretraining: bool = False,
                     vjepa: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's flattened parameters -> this package's state_dict.
    Keys may carry `params.`. By default the backbone for VideoMAEModel:
    a `videomae.` wrapper (a pretraining or classification export) is
    taken off and parameters outside the backbone are left out. With
    pretraining=True the whole VideoMAEForPreTraining tree, wrapper kept;
    with vjepa=True the VJEPA2Model tree (encoder and predictor)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        k = key[len("params."):] if key.startswith("params.") else key
        if vjepa or pretraining:
            if not (_VJEPA if vjepa else _PRETRAINING).match(k):
                continue
        else:
            for w in _WRAPPERS:
                if k.startswith(w):
                    k = k[len(w):]
            if not _BACKBONE.match(k):
                continue
        arr = np.array(val, dtype=np.float32)   # a writable copy
        if k.endswith(".kernel"):
            if arr.ndim != 2:
                raise ValueError(f"{key}: Dense kernel of shape {arr.shape}")
            k, arr = k[:-len(".kernel")] + ".weight", arr.T
        elif k.endswith(".scale"):
            k = k[:-len(".scale")] + ".weight"
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_flax`: a state_dict -> the JAX package's flat
    names under `params.` (float32): 2-D `.weight`s become transposed
    `.kernel`s, 1-D ones (LayerNorm) `.scale`s."""
    out: Dict[str, np.ndarray] = {}
    for k, t in state.items():
        arr = t.detach().float().cpu().numpy()
        if k.endswith(".weight"):
            base = k[:-len(".weight")]
            if arr.ndim == 2:
                k, arr = base + ".kernel", arr.T
            elif arr.ndim == 1:
                k = base + ".scale"
            else:
                raise ValueError(f"{k}: weight of shape {arr.shape}")
        out["params." + k] = np.ascontiguousarray(arr)
    return out


def _hf_videomae_to_flax(hf: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Backbone part of the JAX `convert_hf_videomae`: HF VideoMAE names
    (`[videomae.]encoder.layer.{i}.attention.attention.query.weight`, ...)
    -> flattened JAX names."""
    base = "videomae." if any(k.startswith("videomae.") for k in hf) else ""
    pairs = [
        ("attention.attention.query.weight", "attention.query.kernel", True),
        ("attention.attention.key.weight", "attention.key.kernel", True),
        ("attention.attention.value.weight", "attention.value.kernel", True),
        ("attention.attention.q_bias", "attention.query.bias", False),
        ("attention.attention.v_bias", "attention.value.bias", False),
        ("attention.output.dense.weight", "attention.proj.kernel", True),
        ("attention.output.dense.bias", "attention.proj.bias", False),
        ("intermediate.dense.weight", "mlp.fc1.kernel", True),
        ("intermediate.dense.bias", "mlp.fc1.bias", False),
        ("output.dense.weight", "mlp.fc2.kernel", True),
        ("output.dense.bias", "mlp.fc2.bias", False),
        ("layernorm_before.weight", "norm1.scale", False),
        ("layernorm_before.bias", "norm1.bias", False),
        ("layernorm_after.weight", "norm2.scale", False),
        ("layernorm_after.bias", "norm2.bias", False),
    ]
    out: Dict[str, np.ndarray] = {}
    rx = re.compile(re.escape(base) + r"encoder\.layer\.(\d+)\.(.+)$")
    for k, v in hf.items():
        m = rx.match(k)
        if m:
            for src, dst, transpose in pairs:
                if m.group(2) == src:
                    out[f"params.encoder.layer_{m.group(1)}.{dst}"] = (
                        np.asarray(v).T if transpose else np.asarray(v))
    top = {"embeddings.patch_embeddings.projection.weight":
           "params.patch_embed_kernel",
           "embeddings.patch_embeddings.projection.bias":
           "params.patch_embed_bias",
           "layernorm.weight": "params.layernorm.scale",
           "layernorm.bias": "params.layernorm.bias"}
    for src, dst in top.items():
        if base + src in hf:
            out[dst] = np.asarray(hf[base + src])
    return out


def load_backbone(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Read a backbone checkpoint into this package's state_dict layout:
    the JAX package's export (`params.*` keys) or an HF-layout VideoMAE
    file; a directory reads every *.safetensors shard in it."""
    p = Path(path)
    if p.is_dir():
        files = sorted(p.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no *.safetensors files in {p}")
    elif p.is_file():
        files = [p]
    else:
        raise FileNotFoundError(f"checkpoint {p} does not exist")
    flat: Dict[str, np.ndarray] = {}
    for f in files:
        flat.update(read_safetensors(f))
    if not any(k.startswith("params.") for k in flat):
        flat = _hf_videomae_to_flax(flat)
    return params_from_flax(flat)


def load_backbone_into(model: torch.nn.Module, path: Union[str, Path]):
    """Load `path` into `model`; every parameter of the model must be in
    the checkpoint with the same shape, else the error names it."""
    src = load_backbone(path)
    target = model.state_dict()
    for name, t in target.items():
        if name not in src:
            raise KeyError(f"checkpoint {path} has no tensor for {name!r} "
                           f"(it holds {len(src)} backbone tensors)")
        if tuple(src[name].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {path}: {name!r} has shape "
                             f"{tuple(src[name].shape)}, the model "
                             f"{tuple(t.shape)}")
    unused = sorted(set(src) - set(target))
    model.load_state_dict({k: src[k] for k in target})
    logger.info("loaded %d tensors from %s (%d unused)", len(target), path,
                len(unused))
    return model
