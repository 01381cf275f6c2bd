"""The port's SigLIP vision tower (`models/siglip.py`), its converters and
`SiglipEncoder` on the CPU: the counterparts of tests/test_siglip.py,
each against the JAX package and transformers' SiglipVisionModel
(4.57.6) at TINY, atol/rtol 2e-4; the tower in bf16 on the kernel routes
within 3e-2 of max of the float32 JAX tower; `run_encoders --encoder
siglip` against the JAX CLI's output."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models import convert as jconvert
from smb_vision_tpu.models.configs import SiglipVisionConfig as JConfig
from smb_vision_tpu.models.siglip import SiglipVisionModel as JSiglip
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import SiglipVisionConfig
from smb_vision_tpu_torch.models.siglip import SiglipVisionModel
from smb_vision_tpu_torch.ops.patches import patch_embed_2d

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
TINY = dict(image_size=32, patch_size=8, num_channels=3, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64)


def _hf(**kw):
    from transformers import SiglipVisionConfig as HFConfig
    from transformers import SiglipVisionModel as HFModel

    torch.manual_seed(0)
    return HFModel(HFConfig(**dict(TINY, **kw))).eval()


def _state(hf):
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


def _ours(hf, **kw):
    """The port's tower with the HF model's weights (through the port's
    converter) and the JAX tower's params (through the JAX one)."""
    cfg = SiglipVisionConfig(dtype="float32", attn_impl="xla",
                             **dict(TINY, **kw))
    model = SiglipVisionModel(cfg).eval()
    model.load_state_dict(convert.params_from_flax(
        convert.convert_hf_siglip(_state(hf)), whole=True))
    params = jconvert.convert_hf_siglip(_state(hf), cfg.num_hidden_layers)
    return model, params


@pytest.fixture(scope="module")
def pair():
    hf = _hf()
    model, params = _ours(hf)
    return hf, model, params


def test_siglip_matches_hf_and_jax(pair):
    hf, model, params = pair
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = hf(x)
        tokens, pooled = model(x)
    np.testing.assert_allclose(tokens.numpy(),
                               ref.last_hidden_state.numpy(), **TOL)
    np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(),
                               **TOL)
    jt, jp = JSiglip(JConfig(dtype="float32", attn_impl="xla", **TINY)
                     ).apply(params, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jp), **TOL)


def test_convert_matches_jax_bit_for_bit(pair):
    """convert_hf_siglip: the same flat names and arrays as the JAX
    package's (the head's in_proj split in three)."""
    hf, _, params = pair
    ours = convert.convert_hf_siglip(_state(hf))
    want = flatten_params(params)
    assert set(ours) == set(want)
    for k in want:
        np.testing.assert_array_equal(ours[k], np.asarray(want[k]), k)
    assert convert.convert_hf_auto(_state(hf)).keys() == want.keys()


def test_siglip_no_head():
    hf = _hf(vision_use_head=False)
    model, _ = _ours(hf, vision_use_head=False)
    assert model.head is None
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        tokens, pooled = model(x)
        ref = hf(x).last_hidden_state
    assert pooled is None
    np.testing.assert_allclose(tokens.numpy(), ref.numpy(), **TOL)


def test_siglip_export_roundtrip(pair):
    """The port's state_dict -> HF layout: bit for bit the JAX package's
    export of the same weights; it loads into transformers' model with
    the same output and converts back bit for bit."""
    hf, model, params = pair
    state = convert.export_hf_siglip(model.state_dict())
    want = jconvert.export_hf_siglip(params, num_layers=2)
    assert set(state) == set(want)
    for k in want:
        np.testing.assert_array_equal(state[k], np.asarray(want[k]), k)
    hf2 = _hf()
    missing, unexpected = hf2.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in state.items()}, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        np.testing.assert_allclose(hf2(x).pooler_output.numpy(),
                                   hf(x).pooler_output.numpy(), atol=1e-6)
    back = convert.params_from_flax(convert.convert_hf_siglip(state),
                                    whole=True)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_siglip_wrong_geometry_raises(pair):
    _, model, _ = pair
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros(1, 3, 48, 48))


def test_patch_embed_2d_non_divisible_matches_conv2d_and_jax():
    """A patch size that does not divide the image (so400m-patch14-384:
    384 % 14 == 6) drops the trailing pixels as Conv2d's valid padding
    does."""
    from smb_vision_tpu.ops.patches import patch_embed_2d as jpatch

    rng = np.random.default_rng(7)
    px = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    kernel = rng.normal(size=(16, 3, 12, 12)).astype(np.float32) * 0.05
    bias = rng.normal(size=(16,)).astype(np.float32)
    conv = torch.nn.Conv2d(3, 16, kernel_size=12, stride=12)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel))
        conv.bias.copy_(torch.from_numpy(bias))
        ref = conv(torch.from_numpy(px)).flatten(2).transpose(1, 2).numpy()
    out = patch_embed_2d(torch.from_numpy(px), torch.from_numpy(kernel),
                         torch.from_numpy(bias), dtype=torch.float32)
    assert tuple(out.shape) == (2, 4, 16)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    want = jpatch(jnp.asarray(px), jnp.asarray(kernel), jnp.asarray(bias),
                  dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="channels"):
        patch_embed_2d(torch.from_numpy(px[:, :2]), torch.from_numpy(kernel),
                       None)


def test_siglip_non_divisible_geometry_matches_hf():
    hf = _hf(patch_size=12)                      # 32 % 12 == 8
    model, _ = _ours(hf, patch_size=12)
    assert model.config.seq_len == 4
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = hf(x)
        tokens, pooled = model(x)
    np.testing.assert_allclose(tokens.numpy(),
                               ref.last_hidden_state.numpy(), **TOL)
    np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(),
                               **TOL)


def test_sharded_checkpoint_merge(tmp_path):
    """A directory of model-0000i-of-0000N shards loads as their union."""
    a = {"vision_model.embeddings.patch_embedding.weight":
         np.ones((4, 3, 2, 2), np.float32)}
    b = {"vision_model.post_layernorm.weight": np.ones(4, np.float32)}
    convert.write_safetensors(tmp_path / "model-00001-of-00002.safetensors",
                              a)
    convert.write_safetensors(tmp_path / "model-00002-of-00002.safetensors",
                              b)
    state = convert.load_hf_checkpoint_numpy(str(tmp_path))
    assert set(state) == set(a) | set(b)
    assert set(convert.convert_hf_auto(state)) == {
        "params.patch_embedding", "params.post_layernorm.scale"}


def test_siglip_kernel_routes_bf16():
    """hidden 128 in 2 heads of 64, MLP 256, bf16 under "auto": the
    attention on K1's route and the MLP half-block on K2's with act
    gelu_new (their plain versions on the CPU); tokens and pooled output
    within 3e-2 of max of the float32 JAX tower."""
    from smb_vision_tpu_torch.ops import mlp as M

    kw = dict(TINY, hidden_size=128, intermediate_size=256)
    hf = _hf(**kw)
    cfg = SiglipVisionConfig(dtype="bfloat16", attn_impl="auto", **kw)
    model = SiglipVisionModel(cfg).eval()
    model.load_state_dict(convert.params_from_flax(
        convert.convert_hf_siglip(_state(hf)), whole=True))
    params = jconvert.convert_hf_siglip(_state(hf), 2)
    assert M.kernel_maps(128, 256, "gelu_new")
    x = np.random.default_rng(5).normal(size=(2, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        tokens, pooled = model(torch.from_numpy(x))
    jt, jp = JSiglip(JConfig(dtype="float32", attn_impl="xla", **kw)).apply(
        params, jnp.asarray(x))
    for got, want in ((tokens, jt), (pooled, jp)):
        got = got.float().numpy()
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def _save_ckpt(hf, path):
    hf.save_pretrained(path)
    return str(path)


def test_siglip_encoder(tmp_path, pair):
    """SiglipEncoder on a saved HF checkpoint: backend "jax" (the port's
    tower) takes image_size from config.json and matches transformers'
    pooled output; backend "torch" runs transformers' model; an unknown
    backend raises."""
    from smb_vision_tpu_torch.inference.encoders import SiglipEncoder

    hf, _, _ = pair
    ckpt = _save_ckpt(hf, tmp_path / "ckpt")
    batch = np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(batch)).pooler_output.numpy()
    for backend in ("jax", "torch"):
        enc = SiglipEncoder(ckpt, backend=backend, dtype="float32",
                            attn_impl="xla", device="cpu")
        enc.setup_model()
        assert enc.image_size == 32
        np.testing.assert_allclose(enc.generate_embedding(batch), ref, **TOL)
    with pytest.raises(ValueError, match="backend"):
        SiglipEncoder("/nonexistent", backend="cuda", device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        SiglipEncoder(str(tmp_path), device="cpu").setup_model()


def test_run_encoders_siglip_cli_matches_jax(tmp_path, pair):
    """manifest -> the port's SigLIP -> one parquet per uid, the vectors
    within 3e-2 of max of the JAX CLI's (both bf16); a second run skips
    every uid."""
    import pandas as pd
    from PIL import Image

    from smb_vision_tpu.cli.run_encoders import main as jmain
    from smb_vision_tpu_torch.cli.run_encoders import main

    hf, _, _ = pair
    ckpt = _save_ckpt(hf, tmp_path / "ckpt")
    rng = np.random.default_rng(1)
    items = []
    for uid in ("xr-1", "xr-2", "xr-3"):
        p = tmp_path / f"{uid}.png"
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(p)
        items.append({"uid": uid, "image_path": str(p)})
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"images": items}))

    def argv(out):
        return ["--encoder", "siglip", "--checkpoint", ckpt, "--input_json",
                str(manifest), "--output_dir", str(out), "--batch_size", "2",
                "--siglip_backend", "jax"]

    stats = main(argv(tmp_path / "emb") + ["--device", "cpu"])
    assert stats == {"embedded": 3, "failed": 0, "skipped": 0}
    jmain(argv(tmp_path / "jemb"))
    for uid in ("xr-1", "xr-2", "xr-3"):
        got = pd.read_parquet(tmp_path / "emb" / "model_id=siglip"
                              / f"{uid}.parquet").iloc[0]
        want = pd.read_parquet(tmp_path / "jemb" / "model_id=siglip"
                               / f"{uid}.parquet").iloc[0]
        assert got["model_id"] == "siglip"
        assert list(got["embedding_shape"]) == list(want["embedding_shape"])
        g, w = np.asarray(got["embedding"]), np.asarray(want["embedding"])
        assert len(g) == 32 and np.abs(g - w).max() <= 3e-2 * np.abs(w).max()
    assert main(argv(tmp_path / "emb") + ["--device", "cpu"])["skipped"] == 3
    with pytest.raises(SystemExit, match="checkpoint"):
        main(["--encoder", "siglip", "--input_json", str(manifest),
              "--device", "cpu"])


def test_so400m_shapes_take_the_plain_path():
    """SigLIP so400m-patch14-384 (hidden 1,152, 16 heads of 72, MLP
    4,304; ROADMAP.md queue 2, G3): "auto" runs the attention on K1 at d
    72 (with K4 under autograd) and the MLP on the plain path, as the JAX
    package does (its `_plan_with` refuses F 4,304, no multiple of 128;
    here no multiple of 32), and a forced kernel impl refuses the MLP. K
    1,152 itself maps."""
    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    q = torch.zeros(1, 729, 16, 72, dtype=torch.bfloat16)
    assert A._auto_impl(q, None) == "pallas"
    assert A._auto_impl(q.float(), None) == "xla"
    assert not M.kernel_maps(1152, 4304, "gelu_new")
    assert M.kernel_maps(1152, 4608, "gelu_new")
    assert M.kernel_maps(768, 3072, "gelu_new")
    x = torch.zeros(8, 1152, dtype=torch.bfloat16)
    w1 = torch.zeros(1152, 4304, dtype=torch.bfloat16)
    w2 = torch.zeros(4304, 1152, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel|cannot map"):
        M.mlp_forward(x, w1, torch.zeros(4304), w2, torch.zeros(1152),
                      act="gelu_new", impl="pallas")
