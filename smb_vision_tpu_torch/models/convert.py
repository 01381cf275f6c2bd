"""Checkpoints in and out of the port: the JAX package's safetensors export
and the HF layouts of VideoMAE, V-JEPA2 and DINOv2.

Counterpart of `smb_vision_tpu/models/convert.py` for VideoMAE, DINOv2, the
V-JEPA2 pretraining tree, the three classification models, the SigLIP
vision tower (`convert_hf_siglip`, `export_hf_siglip`) and Merlin's
inflated-3D ResNet (`resnet3d_config_from_state_dict`,
`convert_torch_resnet3d`, `inflate_resnet2d`, `export_torch_resnet3d`).
`params_from_flax` maps the JAX package's flattened parameter names
(`params.encoder.layer_0.attention.query.kernel`, ...) to this package's
state_dict (`encoder.layer_0.attention.query.weight`, ...): Dense kernels
are transposed into Linear weights, LayerNorm `scale` becomes `weight`, and
the Conv3d layout of `patch_embed_kernel` is kept; `params_to_flax` is its
inverse, which `Trainer.save_model` writes. `convert_hf_videomae`,
`convert_hf_vjepa2` and `convert_hf_dinov2` map an HF-layout state dict to
the JAX package's flat names, `convert_hf_auto` picks the family from the
key schema, and `export_hf_*` map a state_dict back to the HF layout
(transformers' VideoMAE and VJEPA2 models load them). `load_backbone`,
`load_backbone_into` and `load_params_into` (the grafts of fine-tuning and
of continued pretraining) take either layout, a directory of shards or an
'org/name' hub id (`resolve_checkpoint_source`). The safetensors reader and
writer are small numpy ones (the format: an 8-byte little-endian header
length, a JSON header, raw little-endian tensor bytes), so no `safetensors`
package is needed.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

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
                     classification: bool = False, whole: bool = False,
                     backbone: str = "videomae") -> Dict[str, torch.Tensor]:
    """The JAX package's flattened parameters -> this package's state_dict.
    Keys may carry `params.`. By default the backbone of `backbone`'s
    family (VideoMAEModel, Dinov2Model, or VJEPA2Model without its
    predictor): the family's wrapper (`videomae.`, `dinov2.`, `vjepa2.`:
    a head model's export) is taken off and parameters outside the
    backbone are left out. With pretraining=True the whole
    VideoMAEForPreTraining tree, wrapper kept; with vjepa=True the
    VJEPA2Model tree (encoder and predictor); with classification=True a
    whole classification model (wrapper, neck, pooler and head); with
    whole=True every tensor (the SigLIP tower, the ResNet3D tower, whose
    5-D conv kernels (k0, k1, k2, I, O) become Conv3d weights)."""
    if backbone not in FAMILIES:
        raise ValueError(f"unknown backbone family {backbone!r}")
    out: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        k = key[len("params."):] if key.startswith("params.") else key
        if whole:
            pass
        elif vjepa or pretraining or classification:
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
            if arr.ndim not in (2, 5):
                raise ValueError(f"{key}: Dense kernel of shape {arr.shape}")
            k = k[:-len(".kernel")] + ".weight"
            arr = arr.T if arr.ndim == 2 else arr.transpose(4, 3, 0, 1, 2)
        elif k.endswith(".scale"):
            k = k[:-len(".scale")] + ".weight"
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_flax`: a state_dict -> the JAX package's flat
    names under `params.` (float32): 2-D `.weight`s become transposed
    `.kernel`s, 5-D ones (Conv3d) `.kernel`s in the (k0, k1, k2, I, O)
    layout, 1-D ones (LayerNorm, frozen BatchNorm) `.scale`s."""
    out: Dict[str, np.ndarray] = {}
    for k, t in state.items():
        arr = t.detach().float().cpu().numpy()
        if k.endswith(".weight"):
            base = k[:-len(".weight")]
            if arr.ndim == 2:
                k, arr = base + ".kernel", arr.T
            elif arr.ndim == 5:
                k, arr = base + ".kernel", arr.transpose(2, 3, 4, 1, 0)
            elif arr.ndim == 1:
                k = base + ".scale"
            else:
                raise ValueError(f"{k}: weight of shape {arr.shape}")
        out["params." + k] = np.ascontiguousarray(arr)
    return out


def _linear(hf: str, ours: str) -> tuple:
    """(HF name, JAX name) of a Linear's weight (a Dense kernel: ".kernel")
    and its bias."""
    return ((f"{hf}.weight", f"{ours}.kernel"), (f"{hf}.bias", f"{ours}.bias"))


def _norm(hf: str, ours: str) -> tuple:
    """(HF name, JAX name) of a LayerNorm's weight (`scale`) and bias."""
    return ((f"{hf}.weight", f"{ours}.scale"), (f"{hf}.bias", f"{ours}.bias"))


# one transformer block, HF name -> the JAX package's name within the
# layer; a Dense kernel (".kernel") is the transposed Linear weight
_HF_BLOCKS = {
    "videomae": (
        ("attention.attention.query.weight", "attention.query.kernel"),
        ("attention.attention.key.weight", "attention.key.kernel"),
        ("attention.attention.value.weight", "attention.value.kernel"),
        ("attention.attention.q_bias", "attention.query.bias"),
        ("attention.attention.v_bias", "attention.value.bias"),
        ("attention.output.dense.weight", "attention.proj.kernel"),
        ("attention.output.dense.bias", "attention.proj.bias"),
        ("intermediate.dense.weight", "mlp.fc1.kernel"),
        ("intermediate.dense.bias", "mlp.fc1.bias"),
        ("output.dense.weight", "mlp.fc2.kernel"),
        ("output.dense.bias", "mlp.fc2.bias"),
        ("layernorm_before.weight", "norm1.scale"),
        ("layernorm_before.bias", "norm1.bias"),
        ("layernorm_after.weight", "norm2.scale"),
        ("layernorm_after.bias", "norm2.bias"),
    ),
    "siglip": sum((_linear(a, b) for a, b in (
        ("self_attn.q_proj", "attention.query"),
        ("self_attn.k_proj", "attention.key"),
        ("self_attn.v_proj", "attention.value"),
        ("self_attn.out_proj", "attention.proj"),
        ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2"))), ())
    + _norm("layer_norm1", "norm1") + _norm("layer_norm2", "norm2"),
    "vjepa": sum((_linear(m, m) for m in (
        "attention.query", "attention.key", "attention.value",
        "attention.proj", "mlp.fc1", "mlp.fc2")), ())
    + _norm("norm1", "norm1") + _norm("norm2", "norm2"),
}


def _put(src: Dict[str, np.ndarray], out: Dict[str, np.ndarray],
         pairs) -> None:
    """out[dst] = src[name] (transposed where either is a Dense kernel)
    for each (name, dst) pair whose name is in src."""
    for name, dst in pairs:
        if name in src:
            kern = name.endswith(".kernel") or dst.endswith(".kernel")
            arr = np.asarray(src[name])
            out[dst] = np.ascontiguousarray(arr.T) if kern else arr


def _block_map(hf: Dict[str, np.ndarray], hf_prefix: str, layer: int,
               out: Dict[str, np.ndarray], our_prefix: str,
               style: str) -> None:
    """One HF block (`{hf_prefix}.{layer}.*`) -> the JAX package's names
    (`{our_prefix}.layer_{layer}.*`)."""
    p, o = f"{hf_prefix}.{layer}.", f"{our_prefix}.layer_{layer}."
    _put(hf, out, [(p + a, o + b) for a, b in _HF_BLOCKS[style]])


def _invert_block(flat: Dict[str, np.ndarray], our_prefix: str, layer: int,
                  out: Dict[str, np.ndarray], hf_prefix: str,
                  style: str) -> None:
    """Inverse of `_block_map`."""
    o, p = f"{our_prefix}.layer_{layer}.", f"{hf_prefix}.{layer}."
    _put(flat, out, [(o + b, p + a) for a, b in _HF_BLOCKS[style]])


def convert_hf_videomae(hf: Dict[str, np.ndarray],
                        num_layers: Optional[int] = None,
                        decoder_layers: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """An HF VideoMAE state dict (VideoMAEModel, ...ForPreTraining or
    ...ForVideoClassification) -> the JAX package's flat names under
    `params.videomae.` and the heads (`convert_hf_videomae` there). Layer
    counts are read from the keys when None."""
    base = "videomae." if any(k.startswith("videomae.") for k in hf) else ""
    if num_layers is None:
        num_layers = _layer_count(hf, r"^(?:videomae\.)?encoder\.layer\."
                                      r"(\d+)\.")
    if decoder_layers is None:
        decoder_layers = _layer_count(hf, r"decoder\.decoder_layers\."
                                          r"(\d+)\.")
    out: Dict[str, np.ndarray] = {}
    v = "params.videomae."
    _put(hf, out, (
        (base + "embeddings.patch_embeddings.projection.weight",
         v + "patch_embed_kernel"),
        (base + "embeddings.patch_embeddings.projection.bias",
         v + "patch_embed_bias")))
    for i in range(num_layers):
        _block_map(hf, base + "encoder.layer", i, out, v + "encoder",
                   "videomae")
    _put(hf, out, (
        (base + "layernorm.weight", v + "layernorm.scale"),
        (base + "layernorm.bias", v + "layernorm.bias"),
        ("encoder_to_decoder.weight", "params.encoder_to_decoder.kernel"),
        ("mask_token", "params.mask_token")))
    for i in range(decoder_layers):
        _block_map(hf, "decoder.decoder_layers", i, out, "params.decoder",
                   "videomae")
    _put(hf, out, _VIDEOMAE_HEADS)
    return out


# the pretraining decoder's norm and head, and the classification head
_VIDEOMAE_HEADS = (
    ("decoder.norm.weight", "params.decoder_norm.scale"),
    ("decoder.norm.bias", "params.decoder_norm.bias"),
    ("decoder.head.weight", "params.decoder_head.kernel"),
    ("decoder.head.bias", "params.decoder_head.bias"),
    ("fc_norm.weight", "params.fc_norm.scale"),
    ("fc_norm.bias", "params.fc_norm.bias"),
    ("classifier.weight", "params.classifier.kernel"),
    ("classifier.bias", "params.classifier.bias"),
)


def export_hf_videomae(state: Dict[str, torch.Tensor],
                       num_layers: Optional[int] = None,
                       decoder_layers: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """A VideoMAEModel, VideoMAEForPreTraining or
    VideoMAEForVideoClassification state_dict -> HF VideoMAE arrays (the
    JAX package's `export_hf_videomae`): a wrapped tree with a head keeps
    the `videomae.` prefix, a bare encoder (or a wrapped one without a
    head) has none. Layer counts are read from the keys when None. A
    pipelined model's state is its stages' merged
    (`Trainer.full_model_state`): the dense names, the dense export."""
    flat = params_to_flax(state)
    if any(k.startswith("params.videomae.") for k in flat):
        enc = "params.videomae"
        base = "videomae." if any(
            k.startswith(("params.encoder_to_decoder", "params.fc_norm",
                          "params.classifier")) for k in flat) else ""
    else:
        enc, base = "params", ""
    if num_layers is None:
        num_layers = _layer_count(flat, re.escape(enc) + r"\.encoder\."
                                        r"layer_(\d+)\.")
    if decoder_layers is None:
        decoder_layers = _layer_count(flat, r"^params\.decoder\.layer_"
                                            r"(\d+)\.")
    out: Dict[str, np.ndarray] = {}
    _put(flat, out, (
        (enc + ".patch_embed_kernel",
         base + "embeddings.patch_embeddings.projection.weight"),
        (enc + ".patch_embed_bias",
         base + "embeddings.patch_embeddings.projection.bias")))
    for i in range(num_layers):
        _invert_block(flat, enc + ".encoder", i, out, base + "encoder.layer",
                      "videomae")
    _put(flat, out, (
        (enc + ".layernorm.scale", base + "layernorm.weight"),
        (enc + ".layernorm.bias", base + "layernorm.bias"),
        ("params.encoder_to_decoder.kernel", "encoder_to_decoder.weight"),
        ("params.mask_token", "mask_token")))
    for i in range(decoder_layers):
        _invert_block(flat, "params.decoder", i, out,
                      "decoder.decoder_layers", "videomae")
    _put(flat, out, [(b, a) for a, b in _VIDEOMAE_HEADS])
    return out


# the V-JEPA2 attentive pooler's cross-attention layer, HF -> the JAX
# package's names under `pooler.cross_attention_layer.` / `params.pooler.`
_VJEPA_CROSS = (
    _norm("layer_norm1", "cross_norm1") + _norm("layer_norm2", "cross_norm2")
    + _linear("cross_attn.q_proj", "cross_attn.query")
    + _linear("cross_attn.k_proj", "cross_attn.key")
    + _linear("cross_attn.v_proj", "cross_attn.value")
    + _linear("mlp.fc1", "cross_mlp.fc1")
    + _linear("mlp.fc2", "cross_mlp.fc2"))
# one pooler self-attention layer, under `self_attention_layers.{i}.` /
# `self_layer_{i}_`
_VJEPA_POOL_SELF = (
    _norm("layer_norm1", "norm1") + _norm("layer_norm2", "norm2")
    + _linear("self_attn.q_proj", "attn.query")
    + _linear("self_attn.k_proj", "attn.key")
    + _linear("self_attn.v_proj", "attn.value")
    + _linear("self_attn.out_proj", "attn.proj")
    + _linear("mlp.fc1", "mlp.fc1") + _linear("mlp.fc2", "mlp.fc2"))


def _vjepa_top(base: str, conv: str):
    """(HF name, JAX name) of V-JEPA2's non-block tensors."""
    e, p = base + "encoder.", base + "predictor."
    return (
        (e + f"embeddings.patch_embeddings.{conv}.weight",
         "params.encoder.patch_embed_kernel"),
        (e + f"embeddings.patch_embeddings.{conv}.bias",
         "params.encoder.patch_embed_bias"),
        (e + "layernorm.weight", "params.encoder.layernorm.scale"),
        (e + "layernorm.bias", "params.encoder.layernorm.bias"),
        (p + "embeddings.predictor_embeddings.weight",
         "params.predictor.predictor_embeddings.kernel"),
        (p + "embeddings.predictor_embeddings.bias",
         "params.predictor.predictor_embeddings.bias"),
        (p + "embeddings.mask_tokens", "params.predictor.mask_tokens"),
        (p + "layernorm.weight", "params.predictor.layernorm.scale"),
        (p + "layernorm.bias", "params.predictor.layernorm.bias"),
        (p + "proj.weight", "params.predictor.proj.kernel"),
        (p + "proj.bias", "params.predictor.proj.bias"),
        ("classifier.weight", "params.classifier.kernel"),
        ("classifier.bias", "params.classifier.bias"),
    )


def convert_hf_vjepa2(hf: Dict[str, np.ndarray],
                      num_layers: Optional[int] = None,
                      pred_layers: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """An HF V-JEPA2 state dict (VJEPA2Model, or with the `vjepa2.` prefix
    and the attentive pooler VJEPA2ForVideoClassification) -> the JAX
    package's flat names (`params.encoder.*`, `params.predictor.*`,
    `params.pooler.*`, `params.classifier.*`), as its `convert_hf_vjepa2`
    builds them. The patch-embed conv may be named `proj` (upstream
    transformers) or `proj_3d`. Layer counts are read from the keys when
    None."""
    base = "vjepa2." if any(k.startswith("vjepa2.") for k in hf) else ""
    if num_layers is None:
        num_layers = _layer_count(hf, r"encoder\.layer\.(\d+)\.")
    if pred_layers is None:
        pred_layers = _layer_count(hf, r"predictor\.layer\.(\d+)\.")
    out: Dict[str, np.ndarray] = {}
    for conv in ("proj_3d", "proj"):
        _put(hf, out, _vjepa_top(base, conv))
    for i in range(num_layers):
        _block_map(hf, base + "encoder.layer", i, out,
                   "params.encoder.encoder", "vjepa")
    for i in range(pred_layers):
        _block_map(hf, base + "predictor.layer", i, out,
                   "params.predictor.stack", "vjepa")
    if any(k.startswith("pooler.") for k in hf):
        _put(hf, out, [("pooler.query_tokens", "params.pooler.query_tokens")]
             + [("pooler.cross_attention_layer." + a, "params.pooler." + b)
                for a, b in _VJEPA_CROSS])
        i = 0
        while any(k.startswith(f"pooler.self_attention_layers.{i}.")
                  for k in hf):
            _put(hf, out, [(f"pooler.self_attention_layers.{i}.{a}",
                            f"params.pooler.self_layer_{i}_{b}")
                           for a, b in _VJEPA_POOL_SELF])
            i += 1
    return out


def export_hf_vjepa2(state: Dict[str, torch.Tensor],
                     num_layers: Optional[int] = None,
                     pred_layers: Optional[int] = None,
                     pooler_self_layers: Optional[int] = None, *,
                     wrap: bool = False, conv_name: str = "proj"
                     ) -> Dict[str, np.ndarray]:
    """A VJEPA2Model state_dict (encoder, predictor; with a pooler and a
    classifier at the top level, as `convert_hf_vjepa2` builds them) ->
    HF V-JEPA2 arrays, its inverse (the JAX package's `export_hf_vjepa2`):
    wrap=True prefixes the backbone's keys with
    `vjepa2.` (the classification layout); conv_name names the patch-embed
    conv, `proj` (upstream transformers) or `proj_3d`. Layer counts are
    read from the keys when None."""
    flat = params_to_flax(state)
    if not any(k.startswith("params.encoder.") for k in flat):
        raise ValueError("the state does not look like a V-JEPA2 model "
                         "(no encoder.* tensors)")
    if num_layers is None:
        num_layers = _layer_count(flat, r"^params\.encoder\.encoder\."
                                        r"layer_(\d+)\.")
    if pred_layers is None:
        pred_layers = _layer_count(flat, r"^params\.predictor\.stack\."
                                         r"layer_(\d+)\.")
    if pooler_self_layers is None:
        pooler_self_layers = _layer_count(flat, r"^params\.pooler\."
                                                r"self_layer_(\d+)_")
    base = "vjepa2." if wrap else ""
    out: Dict[str, np.ndarray] = {}
    _put(flat, out, [(b, a) for a, b in _vjepa_top(base, conv_name)
                     if not a.startswith("classifier.")])
    for i in range(num_layers):
        _invert_block(flat, "params.encoder.encoder", i, out,
                      base + "encoder.layer", "vjepa")
    for i in range(pred_layers):
        _invert_block(flat, "params.predictor.stack", i, out,
                      base + "predictor.layer", "vjepa")
    if any(k.startswith("params.pooler.") for k in flat):
        _put(flat, out, [("params.pooler.query_tokens", "pooler.query_tokens")]
             + [("params.pooler." + b, "pooler.cross_attention_layer." + a)
                for a, b in _VJEPA_CROSS])
        for i in range(pooler_self_layers):
            _put(flat, out, [(f"params.pooler.self_layer_{i}_{b}",
                              f"pooler.self_attention_layers.{i}.{a}")
                             for a, b in _VJEPA_POOL_SELF])
    _put(flat, out, (("params.classifier.kernel", "classifier.weight"),
                     ("params.classifier.bias", "classifier.bias")))
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


def resolve_checkpoint_source(name_or_path: str) -> str:
    """A local path passes through; an 'org/name' HuggingFace hub id is
    downloaded (safetensors, bin and json files) by
    `huggingface_hub.snapshot_download` and resolves to the snapshot
    directory. Without huggingface_hub the error says what to do, and a
    missing path with a checkpoint file's suffix is never taken for a hub
    id."""
    name_or_path = str(name_or_path)
    if os.path.exists(name_or_path):
        return name_or_path
    looks_like_file = name_or_path.endswith(
        (".safetensors", ".bin", ".pt", ".pth", ".json"))
    if (not looks_like_file
            and re.fullmatch(r"[\w.\-]+/[\w.\-]+", name_or_path)):
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise ImportError(
                f"'{name_or_path}' is not a local path; to pull it as a "
                "HuggingFace hub repo id install huggingface_hub "
                "(pip install huggingface_hub), or pass a local "
                "checkpoint path") from e
        logger.info("downloading hub checkpoint %s", name_or_path)
        try:
            return snapshot_download(
                name_or_path,
                allow_patterns=["*.safetensors", "*.bin", "*.json"])
        except Exception as e:
            raise FileNotFoundError(
                f"{name_or_path}: no such local path, and resolving it "
                f"as a hub repo id failed ({type(e).__name__}: {e})"
            ) from e
    raise FileNotFoundError(
        f"{name_or_path}: not a local path and not an 'org/name' hub "
        "repo id")


def load_hf_checkpoint_numpy(path: Union[str, Path]
                             ) -> Dict[str, np.ndarray]:
    """One checkpoint file, or every shard of a directory (its
    *.safetensors, else its *.bin), as one flat numpy dict; a torch .bin
    is read with torch.load(weights_only=True)."""
    path = Path(path)
    files = [path]
    if path.is_dir():
        files = sorted(path.glob("*.safetensors")) or sorted(
            path.glob("*.bin"))
        if not files:
            raise FileNotFoundError(f"no checkpoint files in {path}")
    elif not path.is_file():
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    out: Dict[str, np.ndarray] = {}
    for f in files:
        if f.suffix == ".safetensors":
            out.update(read_safetensors(f))
        else:
            state = torch.load(str(f), map_location="cpu",
                               weights_only=True)
            out.update({k: v.float().numpy() if v.dtype == torch.bfloat16
                        else v.numpy() for k, v in state.items()})
    return out


def convert_hf_auto(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pick the family of an HF-layout state dict from its key schema and
    convert it (layer counts from the keys): V-JEPA2 (a predictor, or the
    `proj`/`proj_3d` patch conv), SigLIP (`vision_model.*` or a
    `patch_embedding` conv), DINOv2 (a CLS token; 3D checkpoints),
    VideoMAE (the `projection` patch conv); anything else is an error."""
    keys = flat.keys()

    def has(frag):
        return any(frag in k for k in keys)

    if (has("predictor.") or has("patch_embeddings.proj.")
            or has("patch_embeddings.proj_3d.")):
        return convert_hf_vjepa2(flat)
    if has("vision_model.") or has("embeddings.patch_embedding.weight"):
        return convert_hf_siglip(flat)
    if has("embeddings.cls_token"):
        proj = next((k for k in keys
                     if k.endswith("patch_embeddings.projection.weight")),
                    None)
        if proj is not None and np.ndim(flat[proj]) == 4:
            raise ValueError(
                "2D DINOv2 checkpoint: depth inflation needs the target "
                "geometry; call convert_hf_dinov2(flat, depth_patch=..., "
                "depth_grid=...) directly")
        return convert_hf_dinov2(flat)
    if has("embeddings.patch_embeddings.projection.weight"):
        return convert_hf_videomae(flat)
    raise ValueError(
        "unrecognised HF checkpoint schema (no VideoMAE/VJEPA2/DINOv2/"
        f"SigLIP markers; first keys: {list(keys)[:3]})")


def _read_flat(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """A checkpoint (file, shard directory or hub id) in the JAX package's
    flat names: its own export as is, an HF layout through
    `convert_hf_auto`."""
    flat = load_hf_checkpoint_numpy(resolve_checkpoint_source(path))
    if any(k.startswith("params.") for k in flat):
        return flat
    return convert_hf_auto(flat)


def load_backbone(path: Union[str, Path],
                  family: str = "videomae") -> Dict[str, torch.Tensor]:
    """Read a backbone checkpoint of `family` (videomae | dinov2 | vjepa2)
    into this package's state_dict layout: the JAX package's export
    (`params.*` keys; a head model's or a pretraining export) or an HF
    layout; a file, a directory of *.safetensors shards or a hub id."""
    return params_from_flax(_read_flat(path), backbone=family)


def load_params_into(model: torch.nn.Module, path: Union[str, Path], *,
                     tree: str) -> Tuple[List[str], List[str]]:
    """Graft a checkpoint into `model` (the JAX package's
    `load_params_into` of continued pretraining): every tensor whose name
    and shape match a tensor of the model is copied into it, the rest of
    the model keeps its initialisation. tree: "pretraining" (a
    VideoMAEForPreTraining) or "vjepa" (a VJEPA2Model). The checkpoint is
    the JAX package's export or an HF layout. Returns (the model's names
    that were loaded, the checkpoint's names that were not); nothing
    matching is an error."""
    if tree not in ("pretraining", "vjepa"):
        raise ValueError(f"tree {tree!r}: expected pretraining or vjepa")
    flat = _read_flat(path)
    src = params_from_flax(flat, **{tree: True})
    target = model.state_dict()
    hits = [k for k, v in src.items()
            if k in target and tuple(v.shape) == tuple(target[k].shape)]
    if not hits:
        raise ValueError(f"no tensor in {path} matches the {tree} "
                         "parameter tree (names and shapes): wrong "
                         "checkpoint for this architecture?")
    with torch.no_grad():
        for k in hits:
            target[k].copy_(src[k])
    rx = _VJEPA if tree == "vjepa" else _PRETRAINING
    skipped = sorted(set(src) - set(hits)) + sorted(
        k for k in flat if not rx.match(k[len("params."):]
                                        if k.startswith("params.") else k))
    logger.info("initialised %d of %d tensors from %s (%d checkpoint "
                "tensors unused)", len(hits), len(target), path,
                len(skipped))
    return sorted(hits), skipped


def load_backbone_into(model: torch.nn.Module, path: Union[str, Path]):
    """Load `path` into `model`'s backbone: the model itself (a
    VideoMAEModel, Dinov2Model or VJEPA2Model) or the one a head model
    holds under `videomae.`, `dinov2.` or `vjepa2.`. Every parameter of
    the backbone must be in the checkpoint with the same shape, else the
    error names it; a model built with `pipe` (one pipeline stage,
    `models/pipelined.py`) holds its layers under their dense names and
    loads them from a dense checkpoint. Returns `model`."""
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


def convert_hf_siglip(hf: Dict[str, np.ndarray],
                      num_layers: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """An HF SiglipVisionModel (or whole SiglipModel: `vision_model.*`)
    state dict -> the JAX package's flat names of the SigLIP tower. The MAP
    head's nn.MultiheadAttention packs q, k and v into in_proj_weight /
    in_proj_bias, (3D, D) / (3D,): split row-wise into three Dense
    kernels. The layer count is read from the keys when None."""
    v = "vision_model." if any(k.startswith("vision_model.") for k in hf) \
        else ""
    if num_layers is None:
        num_layers = _layer_count(hf, re.escape(v) + r"encoder\.layers\."
                                      r"(\d+)\.")
    out: Dict[str, np.ndarray] = {}
    _put(hf, out, (
        (v + "embeddings.patch_embedding.weight", "params.patch_embedding"),
        (v + "embeddings.patch_embedding.bias", "params.patch_bias"),
        (v + "embeddings.position_embedding.weight",
         "params.position_embedding"),
        (v + "post_layernorm.weight", "params.post_layernorm.scale"),
        (v + "post_layernorm.bias", "params.post_layernorm.bias")))
    for i in range(num_layers):
        _block_map(hf, v + "encoder.layers", i, out, "params.encoder",
                   "siglip")
    h, o = v + "head.", "params.head."
    if h + "attention.in_proj_weight" in hf:
        w3 = np.asarray(hf[h + "attention.in_proj_weight"])
        b3 = np.asarray(hf[h + "attention.in_proj_bias"])
        d = w3.shape[0] // 3
        for j, name in enumerate(("query", "key", "value")):
            out[o + f"attention.{name}.kernel"] = np.ascontiguousarray(
                w3[j * d:(j + 1) * d].T)
            out[o + f"attention.{name}.bias"] = b3[j * d:(j + 1) * d]
    _put(hf, out, ((h + "probe", o + "probe"),)
         + _linear(h + "attention.out_proj", o + "attention.proj")
         + _norm(h + "layernorm", o + "layernorm")
         + _linear(h + "mlp.fc1", o + "mlp.fc1")
         + _linear(h + "mlp.fc2", o + "mlp.fc2"))
    return out


def export_hf_siglip(state: Dict[str, torch.Tensor],
                     num_layers: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    """Inverse of `convert_hf_siglip` from a SiglipVisionModel state_dict:
    the HF `vision_model.*` names, q, k and v packed again into the head's
    in_proj_weight / in_proj_bias (transformers' SiglipVisionModel loads
    it)."""
    flat = params_to_flax(state)
    if num_layers is None:
        num_layers = _layer_count(flat, r"^params\.encoder\.layer_(\d+)\.")
    v = "vision_model."
    out: Dict[str, np.ndarray] = {}
    _put(flat, out, (
        ("params.patch_embedding", v + "embeddings.patch_embedding.weight"),
        ("params.patch_bias", v + "embeddings.patch_embedding.bias"),
        ("params.position_embedding",
         v + "embeddings.position_embedding.weight"),
        ("params.post_layernorm.scale", v + "post_layernorm.weight"),
        ("params.post_layernorm.bias", v + "post_layernorm.bias")))
    for i in range(num_layers):
        _invert_block(flat, "params.encoder", i, out, v + "encoder.layers",
                      "siglip")
    o, h = "params.head.", v + "head."
    if o + "attention.query.kernel" in flat:
        names = ("query", "key", "value")
        out[h + "attention.in_proj_weight"] = np.concatenate(
            [flat[o + f"attention.{n}.kernel"].T for n in names])
        out[h + "attention.in_proj_bias"] = np.concatenate(
            [flat[o + f"attention.{n}.bias"] for n in names])
    pairs = (((h + "probe", o + "probe"),)
             + _linear(h + "attention.out_proj", o + "attention.proj")
             + _norm(h + "layernorm", o + "layernorm")
             + _linear(h + "mlp.fc1", o + "mlp.fc1")
             + _linear(h + "mlp.fc2", o + "mlp.fc2"))
    _put(flat, out, [(b, a) for a, b in pairs])
    return out


# the module prefixes a Merlin checkpoint nests its I3D ResNet under (a
# bare torchvision-style state dict has none)
_RESNET3D_PREFIXES = ("", "module.", "model.", "i3_resnet.",
                      "encode_image.i3_resnet.",
                      "model.encode_image.i3_resnet.",
                      "image_encoder.i3_resnet.")


def _resnet3d_prefix(flat: Dict[str, np.ndarray]) -> str:
    """The prefix whose `conv1.weight` is a 5-D conv kernel, longest
    first, so a nested tower wins over a same-named outer key."""
    for p in sorted(_RESNET3D_PREFIXES, key=len, reverse=True):
        w = flat.get(p + "conv1.weight")
        if w is not None and np.ndim(w) == 5:
            return p
    raise ValueError(
        "no inflated-3D resnet found: no '<prefix>conv1.weight' 5D kernel "
        f"under any of {_RESNET3D_PREFIXES}")


def resnet3d_config_from_state_dict(flat: Dict[str, np.ndarray],
                                    **overrides):
    """A ResNet3DConfig from a torch state dict's shapes: channels, stage
    depths and the axis-0 kernel sizes; axis-0 strides stay at the I3D
    defaults unless `overrides` set them."""
    from smb_vision_tpu_torch.models.configs import ResNet3DConfig

    p = _resnet3d_prefix(flat)
    conv1 = np.asarray(flat[p + "conv1.weight"])
    stage_sizes = []
    for i in range(1, 100):
        n = _layer_count(flat, re.escape(p) + rf"layer{i}\.(\d+)\.conv1\."
                                              r"weight")
        if n == 0:
            break
        stage_sizes.append(n)
    if not stage_sizes:
        raise ValueError(f"no layer1.*.conv1.weight under prefix {p!r}")
    c3 = np.asarray(flat[p + "layer1.0.conv3.weight"])
    conv2_ts = {np.asarray(flat[k]).shape[2] for k in flat
                if k.startswith(p) and ".conv2.weight" in k}
    if len(conv2_ts) != 1:
        raise ValueError(
            f"non-uniform bottleneck conv2 axis-0 kernels {conv2_ts}: "
            "this tower family inflates uniformly; pass an explicit "
            "config for exotic checkpoints")
    fc = flat.get(p + "fc.weight")
    cfg = ResNet3DConfig(
        num_channels=int(conv1.shape[1]), base_width=int(conv1.shape[0]),
        stage_sizes=tuple(stage_sizes),
        expansion=int(c3.shape[0]) // int(c3.shape[1]),
        stem_kernel_t=int(conv1.shape[2]),
        conv2_kernel_t=int(conv2_ts.pop()),
        num_labels=int(np.asarray(fc).shape[0]) if fc is not None else 0)
    cfg.update(overrides)
    return cfg


def _resnet3d_pairs(config):
    """(torch name, JAX flat name) of every tensor of the tower: convs
    (`.weight` -> `.kernel`), frozen BNs (weight, bias, running_mean,
    running_var -> scale, bias, mean, var) and the head."""
    def conv(src, dst):
        return ((f"{src}.weight", f"params.{dst}.kernel"),)

    def bn(src, dst):
        return tuple((f"{src}.{a}", f"params.{dst}.{b}") for a, b in (
            ("weight", "scale"), ("bias", "bias"),
            ("running_mean", "mean"), ("running_var", "var")))

    pairs = conv("conv1", "stem.conv") + bn("bn1", "stem.bn")
    for i, n in enumerate(config.stage_sizes):
        for j in range(n):
            src, dst = f"layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for c in (1, 2, 3):
                pairs += conv(f"{src}.conv{c}", f"{dst}.cb{c}.conv")
                pairs += bn(f"{src}.bn{c}", f"{dst}.cb{c}.bn")
            if j == 0:
                pairs += conv(f"{src}.downsample.0", f"{dst}.downsample.conv")
                pairs += bn(f"{src}.downsample.1", f"{dst}.downsample.bn")
    if config.num_labels > 0:
        pairs += (("fc.weight", "params.head.kernel"),
                  ("fc.bias", "params.head.bias"))
    return pairs


def convert_torch_resnet3d(flat: Dict[str, np.ndarray], config=None
                           ) -> Dict[str, np.ndarray]:
    """A torch-schema inflated-3D ResNet state dict (torchvision names,
    under any of the Merlin prefixes) -> the JAX package's flat names of
    the tower. Every expected tensor must be there: a partial tower would
    embed garbage."""
    if config is None:
        config = resnet3d_config_from_state_dict(flat)
    p = _resnet3d_prefix(flat)
    out: Dict[str, np.ndarray] = {}
    for src, dst in _resnet3d_pairs(config):
        if p + src not in flat:
            raise KeyError(f"missing {p + src}")
        arr = np.asarray(flat[p + src], dtype=np.float32)
        if dst.endswith(".kernel"):
            arr = np.ascontiguousarray(arr.T if arr.ndim == 2
                                       else arr.transpose(2, 3, 4, 1, 0))
        out[dst] = arr
    return out


def export_torch_resnet3d(state: Dict[str, torch.Tensor], config
                          ) -> Dict[str, np.ndarray]:
    """Inverse of `convert_torch_resnet3d` from a ResNet3D state_dict: a
    bare torchvision-schema 3D state dict (no prefix), which
    `convert_torch_resnet3d` reads back."""
    flat = params_to_flax(state)
    out: Dict[str, np.ndarray] = {}
    for src, dst in _resnet3d_pairs(config):
        arr = flat[dst]
        if dst.endswith(".kernel"):
            arr = np.ascontiguousarray(arr.T if arr.ndim == 2
                                       else arr.transpose(4, 3, 0, 1, 2))
        out[src] = arr
    return out


def inflate_resnet2d(flat2d: Dict[str, np.ndarray], *,
                     stem_kernel_t: int = 7, conv2_kernel_t: int = 3,
                     mode: str = "center") -> Dict[str, np.ndarray]:
    """I3D inflation of a torchvision-schema 2D ResNet state dict into the
    3D one `convert_torch_resnet3d` reads: the stem conv to stem_kernel_t
    on axis 0, bottleneck conv2 to conv2_kernel_t, 1x1 convs to size 1.
    mode "center" puts the 2D weight in the centre slice (a fresh 3D net
    computes the 2D response of each slice); "average" replicates it
    divided by k_t (the I3D paper's init, equal to 2D on axis-0-constant
    inputs away from the zero-padded borders)."""
    if mode not in ("center", "average"):
        raise ValueError(f"unknown inflation mode {mode!r}")
    out: Dict[str, np.ndarray] = {}
    for k, v in flat2d.items():
        v = np.asarray(v)
        if k.endswith(".weight") and v.ndim == 4:
            if k.endswith("conv1.weight") and "layer" not in k:
                kt = stem_kernel_t
            elif ".conv2.weight" in k:
                kt = conv2_kernel_t
            else:
                kt = 1
            w3 = np.zeros(v.shape[:2] + (kt,) + v.shape[2:], v.dtype)
            if mode == "center":
                w3[:, :, kt // 2] = v
            else:
                w3[:] = v[:, :, None] / kt
            out[k] = w3
        else:
            out[k] = v
    return out
