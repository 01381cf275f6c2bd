"""The PyTorch port's VideoMAE encoder against the JAX model on the CPU,
with the same weights carried across by `params_from_flax`, and the
checkpoint readers."""

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.convert import export_hf_videomae
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.utils.serialization import (
    flatten_params,
    save_params_safetensors,
)
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.videomae import VideoMAEModel

torch.set_num_threads(1)


def _pair(**kw):
    """A JAX model with random params and the port's model holding the same
    weights, for the geometry in kw (64^3 volumes, patch 16)."""
    base = dict(image_size=64, num_frames=64, patch_size=16, tubelet_size=16)
    jcfg = JConfig(**base, **kw)
    jmodel = JModel(jcfg)
    px0 = np.zeros((1, 64, 1, 64, 64), np.float32)
    params = jax.jit(JModel(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), px0)
    # perturb norms and biases away from their identity/zero init so the
    # comparison sees every parameter
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)
    model = VideoMAEModel(VideoMAEConfig(**base, **kw))
    model.load_state_dict(convert.params_from_flax(flatten_params(params)))
    return jmodel, params, model.eval()


def _pixels(b=2):
    rng = np.random.default_rng(1)
    return rng.uniform(0, 1, (b, 64, 1, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("mean_pool", [True, False])
def test_videomae_f32_matches_jax(mean_pool):
    jmodel, params, model = _pair(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, dtype="float32", use_mean_pooling=mean_pool)
    px = _pixels()
    ref, _ = jmodel.apply(params, px)
    with torch.no_grad():
        out, order = model(torch.from_numpy(px))
    assert order is None and out.shape == (2, 64, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("attn_impl,mlp_impl", [
    ("pallas", "pallas"),          # K1 + K2 routes
    ("pallas_int8", "pallas_bwd"),  # K3 + K6 routes
])
def test_videomae_bf16_matches_jax_kernels(attn_impl, mlp_impl):
    """bf16 model on the kernels' routes (their plain versions on the CPU)
    against the JAX model running its Pallas kernels in interpret mode."""
    jmodel, params, model = _pair(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=512, dtype="bfloat16", attn_impl=attn_impl,
        mlp_impl=mlp_impl)
    px = _pixels()
    ref, _ = jmodel.apply(params, px)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(px))
    assert out.dtype == torch.bfloat16
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 2e-2


@pytest.mark.parametrize("layout", ["flax", "hf"])
def test_load_backbone_round_trip(tmp_path, layout):
    """The JAX package's safetensors export and its HF-layout export both
    load into the port with every weight in place."""
    _, params, model = _pair(hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=128,
                             dtype="float32", use_mean_pooling=False)
    path = tmp_path / "model.safetensors"
    if layout == "flax":
        # a pretraining export nests the backbone under `videomae`
        save_params_safetensors({"params": {"videomae": params["params"]}},
                                path)
    else:
        from safetensors.numpy import save_file

        save_file(export_hf_videomae(params, num_layers=2), str(path))
    fresh = VideoMAEModel(model.config)
    convert.load_backbone_into(fresh, path)
    want = model.state_dict()
    got = fresh.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_load_backbone_names_missing_and_misshaped(tmp_path):
    _, params, model = _pair(hidden_size=64, num_hidden_layers=1,
                             num_attention_heads=4, intermediate_size=128,
                             dtype="float32")
    flat = flatten_params(params)
    from safetensors.numpy import save_file

    short = {k: v for k, v in flat.items() if "fc2.bias" not in k}
    save_file(short, str(tmp_path / "short.safetensors"))
    with pytest.raises(KeyError, match="mlp.fc2.bias"):
        convert.load_backbone_into(VideoMAEModel(model.config),
                                   tmp_path / "short.safetensors")
    bad = dict(flat)
    bad["params.encoder.layer_0.norm1.scale"] = np.ones(3, np.float32)
    save_file(bad, str(tmp_path / "bad.safetensors"))
    with pytest.raises(ValueError, match="norm1.weight"):
        convert.load_backbone_into(VideoMAEModel(model.config),
                                   tmp_path / "bad.safetensors")


def test_read_safetensors_bf16_and_dtypes(tmp_path):
    from safetensors.numpy import save_file

    import ml_dtypes

    vals = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": (np.arange(4, dtype=np.float32) / 3).astype(
                ml_dtypes.bfloat16),
            "c": np.arange(5, dtype=np.int64)}
    save_file(vals, str(tmp_path / "t.safetensors"))
    got = convert.read_safetensors(tmp_path / "t.safetensors")
    np.testing.assert_array_equal(got["a"], vals["a"])
    np.testing.assert_array_equal(got["b"], vals["b"].astype(np.float32))
    np.testing.assert_array_equal(got["c"], vals["c"])


def test_unported_options_raise():
    # quant8 is ported (tests/test_torch_w8a8.py): the model builds with
    # W8A8 projections, runs under no_grad within the JAX package's 5e-2
    # of the unquantised model on the same weights, and raises under
    # autograd (inference only)
    quant = dict(image_size=32, num_frames=32, hidden_size=32,
                 num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=64, dtype="float32", attn_impl="xla")
    px = torch.rand(1, 32, 1, 32, 32)
    plain = VideoMAEModel(VideoMAEConfig(**quant)).init_weights(
        torch.Generator().manual_seed(0)).eval()
    q8 = VideoMAEModel(VideoMAEConfig(**quant, quant8=True)).eval()
    q8.load_state_dict(plain.state_dict())
    with torch.no_grad():
        out, ref = q8(px)[0], plain(px)[0]
    assert 0 < float((out - ref).abs().max() / ref.abs().max()) < 5e-2
    with pytest.raises(RuntimeError, match="inference-only"):
        q8(px)
    # sequence parallelism is ported: without a mesh (one model rank) the
    # model is the dense one, both variants
    # (tests/test_torch_sequence_parallel.py splits the tokens over ranks)
    dense_px = torch.rand(1, 32, 1, 32, 32)
    base = dict(image_size=32, num_frames=32, hidden_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, dtype="float32", attn_impl="xla")
    dense = VideoMAEModel(VideoMAEConfig(**base)).init_weights(
        torch.Generator().manual_seed(0)).eval()
    for variant in ("gather", "ring"):
        sp = VideoMAEModel(VideoMAEConfig(
            **base, sequence_parallel=True, sp_variant=variant)).eval()
        sp.load_state_dict(dense.state_dict())
        with torch.no_grad():
            torch.testing.assert_close(sp(dense_px)[0], dense(dense_px)[0],
                                       rtol=0, atol=0)
    # the glue kernels (K10a/K10b), fused_qkv and int8 p v (K8) are ported:
    # those models build and run (tests/test_torch_attn_glue.py holds them
    # against the JAX package); the glue still refuses a width it cannot map
    px = torch.rand(1, 32, 1, 32, 32)
    for kw in ({"glue_impl": "pallas", "hidden_size": 128},
               {"fused_qkv": True}, {"attn_impl": "pallas_int8pv"}):
        cfg = VideoMAEConfig(**{**dict(
            image_size=32, num_frames=32, hidden_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, dtype="float32"), **kw})
        with torch.no_grad():
            out, _ = VideoMAEModel(cfg).eval()(px)
        assert out.shape == (1, 8, cfg.hidden_size), kw
    cfg = VideoMAEConfig(image_size=32, num_frames=32, hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, glue_impl="pallas")
    with pytest.raises(ValueError, match="cannot map"):
        VideoMAEModel(cfg)(px)
    from smb_vision_tpu_torch.cli import run_classification
    from smb_vision_tpu_torch.models.layers import Block

    # K9 is ported: the SwiGLU Block builds; fine-tuning's LoRA and 8-bit
    # AdamW are too: their flags pass the refusals and the run stops only
    # for want of data
    assert Block(32, 2, 64, use_swiglu=True).use_swiglu
    with pytest.raises(SystemExit, match="train_data_path"):
        run_classification.main(["--device", "cpu", "--lora_enable", "true"])
    with pytest.raises(SystemExit, match="train_data_path"):
        run_classification.main(["--device", "cpu", "--optim", "adamw8bit"])
    # DropPath trains since the V-JEPA slice
    # (tests/test_torch_vjepa.py::test_droppath_trains)
    block = Block(32, 2, 64, drop_path_rate=0.1,
                  dtype=torch.float32).eval()
    x = torch.ones(1, 4, 32)
    assert torch.equal(block.drop_path(x), x)          # eval: identity
    assert block.train()(x).shape == x.shape


def test_init_weights_is_seeded():
    cfg = VideoMAEConfig(image_size=32, num_frames=32, hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64)
    a = VideoMAEModel(cfg).init_weights(torch.Generator().manual_seed(3))
    b = VideoMAEModel(cfg).init_weights(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    w = a.encoder.layer_0.attention.query.weight.detach()
    assert float(w.abs().max()) <= 2 * cfg.initializer_range
    assert float(a.encoder.layer_0.norm1.weight.detach().min()) == 1.0
