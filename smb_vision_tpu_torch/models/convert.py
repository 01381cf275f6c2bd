"""Checkpoints in and out of the port: the JAX package's safetensors export
and HF-layout VideoMAE and DINOv2 files.

Counterpart of `smb_vision_tpu/models/convert.py` for VideoMAE, DINOv2, the
V-JEPA2 pretraining tree and the three classification models.
`params_from_flax` maps the JAX package's flattened parameter names
(`params.encoder.layer_0.attention.query.kernel`, ...) to this package's
state_dict (`encoder.layer_0.attention.query.weight`, ...): Dense kernels
are transposed into Linear weights, LayerNorm `scale` becomes `weight`, and
the Conv3d layout of `patch_embed_kernel` is kept; `params_to_flax` is its
inverse, which `Trainer.save_model` writes. `convert_hf_dinov2` and
`export_hf_dinov2` map the HF DINOv2 layout. The safetensors reader and
writer are small numpy ones (the format: an 8-byte little-endian header
length, a JSON header, raw little-endian tensor bytes), so no `safetensors`
package is needed.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Union

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
# each backbone family: the wrapper a head model holds it under, and the
# backbone's own names once the wrapper is taken off
FAMILIES = ("videomae", "dinov2", "vjepa2")
_BACKBONES = {
    "videomae": re.compile(
        r"^(patch_embed_(kernel|bias)|encoder\.|layernorm\.)"),
    "dinov2": re.compile(
        r"^(patch_embed_(kernel|bias)$|mask_token$|cls_token$"
        r"|position_embeddings_3d$|encoder\.|layernorm\.)"),
    "vjepa2": re.compile(
        r"^encoder\.(patch_embed_(kernel|bias)$|encoder\.|layernorm\.)"),
}
# the classification models, whole: backbone wrapper, neck, pooler, head
_CLASSIFICATION = re.compile(
    r"^((videomae|dinov2|vjepa2)\.|fc_norm\.|pooler\.|classifier\.)")
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
                     pretraining: bool = False, vjepa: bool = False,
                     classification: bool = False,
                     backbone: str = "videomae") -> Dict[str, torch.Tensor]:
    """The JAX package's flattened parameters -> this package's state_dict.
    Keys may carry `params.`. By default the backbone of `backbone`'s
    family (VideoMAEModel, Dinov2Model, or VJEPA2Model without its
    predictor): the family's wrapper (`videomae.`, `dinov2.`, `vjepa2.`:
    a head model's export) is taken off and parameters outside the
    backbone are left out. With pretraining=True the whole
    VideoMAEForPreTraining tree, wrapper kept; with vjepa=True the
    VJEPA2Model tree (encoder and predictor); with classification=True a
    whole classification model (wrapper, neck, pooler and head)."""
    if backbone not in FAMILIES:
        raise ValueError(f"unknown backbone family {backbone!r}")
    out: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        k = key[len("params."):] if key.startswith("params.") else key
        if vjepa or pretraining or classification:
            rx = (_VJEPA if vjepa else _PRETRAINING if pretraining
                  else _CLASSIFICATION)
            if not rx.match(k):
                continue
        else:
            if k.startswith(backbone + "."):
                k = k[len(backbone) + 1:]
            if not _BACKBONES[backbone].match(k):
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


def _layer_count(flat: Dict[str, np.ndarray], pattern: str) -> int:
    rx = re.compile(pattern)
    idx = [int(m.group(1)) for k in flat for m in [rx.search(k)] if m]
    return 1 + max(idx) if idx else 0


# HF DINOv2 block names -> the JAX package's, within one layer (Linear
# weights are transposed into Dense kernels)
_HF_DINOV2_BLOCK = (
    ("attention.attention.query.weight", "attention.query.kernel"),
    ("attention.attention.query.bias", "attention.query.bias"),
    ("attention.attention.key.weight", "attention.key.kernel"),
    ("attention.attention.key.bias", "attention.key.bias"),
    ("attention.attention.value.weight", "attention.value.kernel"),
    ("attention.attention.value.bias", "attention.value.bias"),
    ("attention.output.dense.weight", "attention.proj.kernel"),
    ("attention.output.dense.bias", "attention.proj.bias"),
    ("layer_scale1.lambda1", "layerscale1"),
    ("layer_scale2.lambda1", "layerscale2"),
    ("norm1.weight", "norm1.scale"),
    ("norm1.bias", "norm1.bias"),
    ("norm2.weight", "norm2.scale"),
    ("norm2.bias", "norm2.bias"),
    ("mlp.fc1.weight", "mlp.fc1.kernel"),
    ("mlp.fc1.bias", "mlp.fc1.bias"),
    ("mlp.fc2.weight", "mlp.fc2.kernel"),
    ("mlp.fc2.bias", "mlp.fc2.bias"),
    ("mlp.weights_in.weight", "mlp.weights_in.kernel"),
    ("mlp.weights_in.bias", "mlp.weights_in.bias"),
    ("mlp.weights_out.weight", "mlp.weights_out.kernel"),
    ("mlp.weights_out.bias", "mlp.weights_out.bias"),
)
_HF_DINOV2_TOP = (
    ("embeddings.patch_embeddings.projection.weight", "patch_embed_kernel"),
    ("embeddings.patch_embeddings.projection.bias", "patch_embed_bias"),
    ("embeddings.cls_token", "cls_token"),
    ("embeddings.mask_token", "mask_token"),
    ("embeddings.position_embeddings_3d", "position_embeddings_3d"),
    ("layernorm.weight", "layernorm.scale"),
    ("layernorm.bias", "layernorm.bias"),
)


def _kernel_t(name: str, arr) -> np.ndarray:
    arr = np.asarray(arr)
    return np.ascontiguousarray(arr.T) if name.endswith(".kernel") else arr


def convert_hf_dinov2(hf: Dict[str, np.ndarray],
                      num_layers: Optional[int] = None,
                      depth_patch: Optional[int] = None,
                      depth_grid: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """An HF-layout DINOv2 state dict (`[dinov2.]embeddings.*`,
    `[dinov2.]encoder.layer.{i}.*`, `classifier.*`) -> the JAX package's
    flat names for Dinov2ForImageClassification (`params.dinov2.*`,
    `params.classifier.*`), as `convert_hf_dinov2` there builds them.
    The 3D Conv3d patch embed is taken as is; a 2D checkpoint (4-D weight)
    is depth-inflated over depth_patch taps scaled by 1/depth_patch, and
    its 2D position table, given depth_grid, is tiled over depth in the
    model's (h, w, d) token order (depth fastest: every 2D position
    repeated depth_grid times in a row). `position_embeddings` is read as
    `position_embeddings_3d`. num_layers: counted from the keys when
    None."""
    base = "dinov2." if any(k.startswith("dinov2.") for k in hf) else ""
    if num_layers is None:
        num_layers = _layer_count(hf, r"encoder\.layer\.(\d+)\.")
    src = dict(hf)
    pos2d = base + "embeddings.position_embeddings"
    if pos2d in src:
        src[base + "embeddings.position_embeddings_3d"] = src.pop(pos2d)
    out: Dict[str, np.ndarray] = {}
    for hf_name, name in _HF_DINOV2_TOP:
        if base + hf_name in src:
            out["params.dinov2." + name] = np.asarray(src[base + hf_name])
    kern = "params.dinov2.patch_embed_kernel"
    if kern in out and out[kern].ndim == 4:
        if not depth_patch:
            raise ValueError("a 2D DINOv2 checkpoint needs depth_patch for "
                             "the Conv3d inflation")
        out[kern] = np.repeat(out[kern][..., None], depth_patch,
                              axis=-1) / depth_patch
        pos = "params.dinov2.position_embeddings_3d"
        if pos in out and depth_grid:
            table = out[pos]
            out[pos] = np.concatenate(
                [table[:, :1], np.repeat(table[:, 1:], depth_grid, axis=1)],
                axis=1)
    for i in range(num_layers):
        p, o = f"{base}encoder.layer.{i}.", f"params.dinov2.encoder.layer_{i}."
        for hf_name, name in _HF_DINOV2_BLOCK:
            if p + hf_name in src:
                out[o + name] = _kernel_t(name, src[p + hf_name])
    for hf_name, name in (("classifier.weight", "classifier.kernel"),
                          ("classifier.bias", "classifier.bias")):
        if hf_name in src:
            out["params." + name] = _kernel_t(name, src[hf_name])
    return out


def export_hf_dinov2(state: Dict[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """A Dinov2Model or Dinov2ForImageClassification state_dict -> the HF
    DINOv2 layout, the inverse of `convert_hf_dinov2` for 3D checkpoints
    (the JAX package's `export_hf_dinov2`): a classification model's keys
    keep the `dinov2.` prefix, a bare backbone's have none."""
    flat = params_to_flax(state)
    wrapped = any(k.startswith("params.dinov2.") for k in flat)
    enc = "params.dinov2." if wrapped else "params."
    base = "dinov2." if wrapped else ""
    out: Dict[str, np.ndarray] = {}
    for hf_name, name in _HF_DINOV2_TOP:
        if enc + name in flat:
            out[base + hf_name] = flat[enc + name]
    layers = _layer_count(flat, r"encoder\.layer_(\d+)\.")
    for i in range(layers):
        o, p = f"{enc}encoder.layer_{i}.", f"{base}encoder.layer.{i}."
        for hf_name, name in _HF_DINOV2_BLOCK:
            if o + name in flat:
                out[p + hf_name] = _kernel_t(name, flat[o + name])
    for hf_name, name in (("classifier.weight", "classifier.kernel"),
                          ("classifier.bias", "classifier.bias")):
        if "params." + name in flat:
            out[hf_name] = _kernel_t(name, flat["params." + name])
    return out


def load_backbone(path: Union[str, Path],
                  family: str = "videomae") -> Dict[str, torch.Tensor]:
    """Read a backbone checkpoint of `family` (videomae | dinov2 | vjepa2)
    into this package's state_dict layout: the JAX package's export
    (`params.*` keys; a head model's or a pretraining export) or an
    HF-layout VideoMAE or DINOv2 file; a directory reads every
    *.safetensors shard in it."""
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
        if family == "videomae":
            flat = _hf_videomae_to_flax(flat)
        elif family == "dinov2":
            flat = convert_hf_dinov2(flat)
        else:
            raise ValueError(f"{path}: not the JAX package's export (no "
                             "'params.' keys); HF-layout V-JEPA2 checkpoints "
                             "are not ported yet (ROADMAP.md queue 1, "
                             "checkpoints)")
    return params_from_flax(flat, backbone=family)


def load_backbone_into(model: torch.nn.Module, path: Union[str, Path]):
    """Load `path` into `model`'s backbone: the model itself (a
    VideoMAEModel, Dinov2Model or VJEPA2Model) or the one a head model
    holds under `videomae.`, `dinov2.` or `vjepa2.`. Every parameter of
    the backbone must be in the checkpoint with the same shape, else the
    error names it. Returns `model`."""
    for family in FAMILIES:
        sub = getattr(model, family, None)
        if isinstance(sub, torch.nn.Module):
            load_backbone_into(sub, path)
            return model
    family = model.config.model_type
    src = load_backbone(path, family)
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
