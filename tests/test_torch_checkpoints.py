"""The port's checkpoint converters against the JAX package's on the CPU:
the HF exports bit for bit on weights carried across by params_from_flax,
the HF V-JEPA2 and VideoMAE conversions (the JAX package's exports read
back exactly), transformers' VJEPA2Model and VideoMAEForPreTraining
(random init) loading the port's exports as a third witness, the family
detection of convert_hf_auto, hub ids through a mocked snapshot_download,
the graft of continued pretraining, and scripts/export_hf_torch.py against
scripts/export_hf.py."""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models import convert as jconvert
from smb_vision_tpu.models.configs import VideoMAEConfig as JVConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JJConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JPre
from smb_vision_tpu.models.videomae import VideoMAEModel as JVModel
from smb_vision_tpu.models.vjepa import VJEPA2Model as JJModel
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VideoMAEConfig, VJEPA2Config
from smb_vision_tpu_torch.models.videomae import (
    VideoMAEForPreTraining,
    VideoMAEModel,
)
from smb_vision_tpu_torch.models.vjepa import VJEPA2Model

torch.set_num_threads(1)

TOL_HF = dict(atol=2e-4, rtol=2e-4)     # tests/test_hf_parity.py
VM = dict(image_size=32, patch_size=8, num_channels=1, num_frames=16,
          tubelet_size=8, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=64)
VM_DEC = dict(decoder_hidden_size=24, decoder_num_hidden_layers=1,
              decoder_num_attention_heads=2, decoder_intermediate_size=48)
VJ = dict(patch_size=8, crop_size=32, frames_per_clip=16, tubelet_size=8,
          in_chans=1, hidden_size=48, num_attention_heads=2,
          num_hidden_layers=2, pred_hidden_size=24,
          pred_num_attention_heads=2, pred_num_hidden_layers=2,
          pred_num_mask_tokens=4)


def _x(seed=0):
    return np.random.default_rng(seed).normal(
        size=(1, 16, 1, 32, 32)).astype(np.float32)


def _mim_mask():
    n = JVConfig(**VM).seq_len
    mask = np.zeros(n, bool)
    mask[np.arange(0, n, 2)] = True
    return mask


def _jax_videomae(pretraining: bool):
    """JAX params of a tiny VideoMAEForPreTraining (or VideoMAEModel) and
    the port's model holding the same weights."""
    x = jnp.asarray(_x())
    if pretraining:
        jcfg = JVConfig(norm_pix_loss=True, dtype="float32",
                        attn_impl="xla", **VM, **VM_DEC)
        mask = _mim_mask()
        params = JPre(jcfg).init(jax.random.PRNGKey(3), x,
                                 jnp.asarray(mask)[None], int(mask.sum()))
        model = VideoMAEForPreTraining(VideoMAEConfig(
            norm_pix_loss=True, dtype="float32", attn_impl="xla", **VM,
            **VM_DEC))
        model.load_state_dict(convert.params_from_flax(
            flatten_params(params), pretraining=True))
    else:
        jcfg = JVConfig(dtype="float32", attn_impl="xla", **VM)
        params = JVModel(jcfg).init(jax.random.PRNGKey(3), x)
        model = VideoMAEModel(VideoMAEConfig(dtype="float32",
                                             attn_impl="xla", **VM))
        model.load_state_dict(convert.params_from_flax(
            flatten_params(params)))
    return params, model.eval()


def _jax_vjepa():
    n = JJConfig(**VJ).seq_len
    params = JJModel(JJConfig(dtype="float32", attn_impl="xla", **VJ)).init(
        jax.random.PRNGKey(7), jnp.asarray(_x()),
        context_mask=[jnp.arange(0, n, 2)[None]],
        target_mask=[jnp.arange(1, n, 2)[None]])
    model = VJEPA2Model(VJEPA2Config(dtype="float32", attn_impl="xla", **VJ))
    model.load_state_dict(convert.params_from_flax(flatten_params(params),
                                                   vjepa=True))
    return params, model.eval()


def _assert_same_arrays(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("pretraining", [True, False],
                         ids=["pretraining", "encoder"])
def test_export_hf_videomae_is_the_jax_export(pretraining):
    params, model = _jax_videomae(pretraining)
    layers = dict(num_layers=2, decoder_layers=1 if pretraining else 0)
    want = jconvert.export_hf_videomae(params, **layers)
    _assert_same_arrays(convert.export_hf_videomae(model.state_dict(),
                                                   **layers), want)
    # layer counts read from the keys give the same export
    _assert_same_arrays(convert.export_hf_videomae(model.state_dict()),
                        want)


@pytest.mark.parametrize("wrap,conv", [(False, "proj"), (True, "proj_3d")])
def test_export_hf_vjepa2_is_the_jax_export(wrap, conv):
    params, model = _jax_vjepa()
    want = jconvert.export_hf_vjepa2(params, num_layers=2, pred_layers=2,
                                     wrap=wrap, conv_name=conv)
    _assert_same_arrays(convert.export_hf_vjepa2(
        model.state_dict(), wrap=wrap, conv_name=conv), want)
    with pytest.raises(ValueError, match="V-JEPA2"):
        convert.export_hf_vjepa2({"head.weight": torch.zeros(2, 2)})


def test_convert_hf_reads_the_jax_exports_back():
    """convert_hf_vjepa2 and convert_hf_videomae of the JAX package's HF
    exports give the JAX package's own names and values, exactly; the
    port's convert agrees with the JAX one on the same file."""
    params, _ = _jax_vjepa()
    hf = jconvert.export_hf_vjepa2(params, num_layers=2, pred_layers=2)
    flat = flatten_params(params)
    _assert_same_arrays(convert.convert_hf_vjepa2(hf), flat)
    _assert_same_arrays(convert.convert_hf_vjepa2(hf), flatten_params(
        jconvert.convert_hf_vjepa2(hf, 2, 2)))
    mparams, _ = _jax_videomae(True)
    hf = jconvert.export_hf_videomae(mparams, num_layers=2, decoder_layers=1)
    _assert_same_arrays(convert.convert_hf_videomae(hf), flatten_params(
        jconvert.convert_hf_videomae(hf, 2, 1)))


def test_load_backbone_takes_hf_vjepa2(tmp_path):
    """An HF-layout V-JEPA2 file loads into the port's VJEPA2Model with
    every tensor of the JAX package's weights (this raised before)."""
    params, model = _jax_vjepa()
    path = tmp_path / "vjepa_hf.safetensors"
    convert.write_safetensors(path, convert.export_hf_vjepa2(
        model.state_dict()))
    fresh = VJEPA2Model(VJEPA2Config(dtype="float32", attn_impl="xla", **VJ),
                        predictor=False)
    convert.load_backbone_into(fresh, path)
    want = model.state_dict()
    assert fresh.state_dict().keys() == {k for k in want
                                         if k.startswith("encoder.")}
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_transformers_vjepa2_loads_the_port_export():
    """transformers' VJEPA2Model, random init, takes the port's export with
    no key missing or unexpected, and its encoder and predictor outputs
    match the port's forward (tests/test_hf_parity.py's tolerance)."""
    from transformers import VJEPA2Config as HFConfig
    from transformers import VJEPA2Model as HFModel

    _, model = _jax_vjepa()
    hf = HFModel(HFConfig(**VJ)).eval()
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         convert.export_hf_vjepa2(model.state_dict()).items()}, strict=False)
    assert not missing and not unexpected
    n = VJEPA2Config(**VJ).seq_len
    ctx, tgt = [torch.arange(0, n, 2)[None]], [torch.arange(1, n, 2)[None]]
    x = torch.from_numpy(_x())
    with torch.no_grad():
        ref = hf(pixel_values_videos=x, context_mask=ctx, target_mask=tgt)
        out = model(x, context_mask=ctx, target_mask=tgt)
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               ref.last_hidden_state.numpy(), **TOL_HF)
    np.testing.assert_allclose(
        out["predictor_output"].numpy(),
        ref.predictor_output.last_hidden_state.numpy(), **TOL_HF)


def test_transformers_videomae_loads_the_port_export():
    """transformers' VideoMAEForPreTraining, random init, takes the port's
    export (only its fixed sincos position buffers are absent) and gives
    the port's logits and loss (tests/test_hf_parity.py's tolerance)."""
    from transformers import VideoMAEConfig as HFConfig
    from transformers import VideoMAEForPreTraining as HFModel

    _, model = _jax_videomae(True)
    hf = HFModel(HFConfig(norm_pix_loss=True, **VM, **VM_DEC)).eval()
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         convert.export_hf_videomae(model.state_dict()).items()},
        strict=False)
    assert not unexpected
    assert all("position_embeddings" in m for m in missing), missing
    mask = _mim_mask()
    x = torch.from_numpy(_x())
    with torch.no_grad():
        ref = hf(x, bool_masked_pos=torch.tensor(mask)[None])
        out = model(x, torch.tensor(mask)[None], int(mask.sum()))
    np.testing.assert_allclose(out["logits"].numpy(), ref.logits.numpy(),
                               **TOL_HF)
    np.testing.assert_allclose(float(out["loss"]), float(ref.loss),
                               rtol=1e-4)


def test_convert_hf_auto_detects_families():
    """The schema markers of tests/test_hub_interop.py, and DINOv2; SigLIP
    waits for the zoo; a 2D DINOv2 needs its geometry; the unknown is an
    error."""
    vm = {"embeddings.patch_embeddings.projection.weight":
          np.zeros((4, 1, 8, 8, 8), np.float32),
          "encoder.layer.0.layernorm_before.weight":
          np.ones((4,), np.float32)}
    out = convert.convert_hf_auto(vm)
    assert set(out) == {"params.videomae.patch_embed_kernel",
                        "params.videomae.encoder.layer_0.norm1.scale"}
    assert "videomae" in jconvert.convert_hf_auto(vm)["params"]
    vj = {"encoder.embeddings.patch_embeddings.proj.weight":
          np.zeros((4, 1, 8, 8, 8), np.float32),
          "encoder.layer.0.norm1.weight": np.ones((4,), np.float32),
          "predictor.layer.0.norm1.weight": np.ones((4,), np.float32)}
    assert set(convert.convert_hf_auto(vj)) == set(flatten_params(
        jconvert.convert_hf_auto(vj)))
    dino = {"embeddings.cls_token": np.zeros((1, 1, 4), np.float32),
            "embeddings.patch_embeddings.projection.weight":
            np.zeros((4, 1, 8, 8, 8), np.float32),
            "encoder.layer.0.norm1.weight": np.ones((4,), np.float32)}
    assert set(convert.convert_hf_auto(dino)) == set(flatten_params(
        jconvert.convert_hf_auto(dino)))
    dino["embeddings.patch_embeddings.projection.weight"] = np.zeros(
        (4, 1, 8, 8), np.float32)
    with pytest.raises(ValueError, match="2D DINOv2"):
        convert.convert_hf_auto(dino)
    siglip = {"vision_model.post_layernorm.weight": np.ones((4,), np.float32)}
    assert set(convert.convert_hf_auto(siglip)) == set(flatten_params(
        jconvert.convert_hf_auto(siglip))) == {"params.post_layernorm.scale"}
    with pytest.raises(ValueError, match="unrecognised"):
        convert.convert_hf_auto({"foo.bar": np.zeros((1,), np.float32)})


def test_hub_repo_id_mocked_download(tmp_path, monkeypatch):
    """'org/name' resolves through huggingface_hub.snapshot_download
    (mocked: there is no network), and load_backbone reads the snapshot;
    local paths pass through; a missing file path is never taken for a
    hub id; a failed download reports both readings."""
    _, model = _jax_videomae(False)
    snap = tmp_path / "snapshot"
    snap.mkdir()
    convert.write_safetensors(snap / "model.safetensors",
                              convert.export_hf_videomae(model.state_dict()))
    calls = []

    def snapshot_download(repo_id, **kw):
        calls.append((repo_id, kw))
        return str(snap)

    fake = types.ModuleType("huggingface_hub")
    fake.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    assert convert.resolve_checkpoint_source("acme/ct-model") == str(snap)
    assert calls[0][0] == "acme/ct-model"
    assert calls[0][1]["allow_patterns"] == ["*.safetensors", "*.bin",
                                             "*.json"]
    loaded = convert.load_backbone("acme/ct-model")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k
    assert convert.resolve_checkpoint_source(str(snap)) == str(snap)

    def boom(*a, **k):
        raise AssertionError("hub lookup attempted for a file path")

    fake.snapshot_download = boom
    with pytest.raises(FileNotFoundError, match="hub"):
        convert.resolve_checkpoint_source("outputs/best.safetensors")
    with pytest.raises(FileNotFoundError, match="hub"):
        convert.resolve_checkpoint_source("not-a-repo-id")

    def down(*a, **k):
        raise RuntimeError("401 repo not found")

    fake.snapshot_download = down
    with pytest.raises(FileNotFoundError, match="no such local path"):
        convert.resolve_checkpoint_source("outputs/best")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        convert.resolve_checkpoint_source("acme/ct-model")


def test_load_params_into_grafts_what_matches(tmp_path):
    """The graft of continued pretraining: an encoder-only V-JEPA2 export
    loads the student's encoder and leaves the predictor at its init; the
    loaded and skipped names are returned; a checkpoint of another tree
    matches nothing and is an error."""
    _, model = _jax_vjepa()
    enc = {k: v for k, v in convert.export_hf_vjepa2(
        model.state_dict()).items() if k.startswith("encoder.")}
    enc["extra.weight"] = np.ones((2, 2), np.float32)
    path = tmp_path / "enc.safetensors"
    convert.write_safetensors(path, enc)
    fresh = VJEPA2Model(VJEPA2Config(dtype="float32", attn_impl="xla", **VJ))
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    loaded, skipped = convert.load_params_into(fresh, path, tree="vjepa")
    assert set(loaded) == {k for k in before if k.startswith("encoder.")}
    assert skipped == []        # the extra tensor was not HF V-JEPA2
    after, want = fresh.state_dict(), model.state_dict()
    for k in before:
        ref = want[k] if k in loaded else before[k]
        assert torch.equal(after[k], ref), k
    mim = tmp_path / "mim.safetensors"
    _, vm = _jax_videomae(True)
    convert.write_safetensors(mim, convert.params_to_flax(vm.state_dict()))
    with pytest.raises(ValueError, match="no tensor"):
        convert.load_params_into(fresh, mim, tree="vjepa")
    loaded, skipped = convert.load_params_into(
        VideoMAEForPreTraining(vm.config), mim, tree="pretraining")
    assert set(loaded) == set(vm.state_dict()) and skipped == []


@pytest.mark.parametrize("family", ["videomae", "vjepa2"])
def test_export_script_matches_the_jax_script(tmp_path, family):
    """scripts/export_hf_torch.py on a training CLI's output directory
    writes the same tensors, bit for bit, as the JAX package's
    scripts/export_hf.py, and copies config.json."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, root / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    if family == "vjepa2":
        _, model = _jax_vjepa()
        cfg = dict(VJ, model_type="vjepa2")
    else:
        _, model = _jax_videomae(True)
        cfg = dict(VM, **VM_DEC, model_type="videomae")
    flat = convert.params_to_flax(model.state_dict())
    # the JAX script reads a tree saved without its "params" root (its own
    # test's input); the port's script reads that and the CLIs' export
    bare, src = tmp_path / "bare", tmp_path / "run"
    for d, names in ((bare, {k[len("params."):]: v for k, v in flat.items()}),
                     (src, flat)):
        d.mkdir()
        convert.write_safetensors(d / "model.safetensors", names)
        (d / "config.json").write_text(json.dumps(cfg))
    load("export_hf").main(["--model_dir", str(bare), "--out",
                            str(tmp_path / "j")])
    want = convert.read_safetensors(tmp_path / "j" / "model.safetensors")
    for d in (bare, src):
        out = load("export_hf_torch").main([
            "--model_dir", str(d), "--out", str(tmp_path / f"t_{d.name}")])
        _assert_same_arrays(convert.read_safetensors(out), want)
        assert json.loads((out.parent / "config.json").read_text()) == cfg
