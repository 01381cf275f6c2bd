"""Pipelined models on the port (`models/pipelined.py`): each rank of the
model axis builds one stage of every stack, under the dense names, on
gloo ranks; against the JAX package's dense models on the same weights
and inputs: every case of tests/test_pipelined_models.py (the VideoMAE,
V-JEPA2 and DINOv2 encodes, the guards, the MIM and V-JEPA2 pretraining
losses and gradients, the stacked layouts, the pipelined workloads
training under "pipeline" and "pipeline+fsdp", LayerScale / SwiGLU
stages, DropPath), and the export gathered from the stages byte for byte
the dense one's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.models.configs import Dinov2Config as JDConfig
from smb_vision_tpu.models.configs import VideoMAEConfig as JVConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JJConfig
from smb_vision_tpu.models.dinov2 import Dinov2Model as JDino
from smb_vision_tpu.models.layers import Encoder as JEncoder
from smb_vision_tpu.models.pipelined import (
    to_pipeline_pretrain_params as jto_pretrain,
)
from smb_vision_tpu.models.pipelined import (
    to_pipeline_vjepa_params as jto_vjepa,
)
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JMIM
from smb_vision_tpu.models.videomae import VideoMAEModel as JVideo
from smb_vision_tpu.models.vjepa import VJEPA2Encoder as JVJEnc
from smb_vision_tpu.models.vjepa import VJEPA2Model as JVJ
from smb_vision_tpu.models.vjepa import vjepa_loss as jvjepa_loss
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.ops.masking import num_masked_tokens
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu.utils.serialization import unflatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models import pipelined as P
from smb_vision_tpu_torch.models.layers import Encoder

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
VIDEO = dict(image_size=32, num_frames=16, patch_size=8, tubelet_size=8,
             num_channels=1, hidden_size=64, num_hidden_layers=4,
             num_attention_heads=4, intermediate_size=128,
             dtype="float32", attn_impl="xla")
PRETRAIN = dict(VIDEO, decoder_hidden_size=32, decoder_num_hidden_layers=2,
                decoder_num_attention_heads=2, decoder_intermediate_size=64)
VJ = dict(crop_size=32, frames_per_clip=16, patch_size=8, tubelet_size=8,
          in_chans=1, hidden_size=64, num_hidden_layers=4,
          num_attention_heads=4, mlp_ratio=2.0, pred_hidden_size=32,
          pred_num_hidden_layers=2, pred_num_attention_heads=2,
          pred_mlp_ratio=2.0, dtype="float32", attn_impl="xla")
DINO = dict(image_size=32, depth=16, patch_size=8, num_channels=1,
            hidden_size=48, num_hidden_layers=4, num_attention_heads=4,
            mlp_ratio=2, layerscale_value=1e-5, use_swiglu_ffn=True,
            dtype="float32", attn_impl="xla")
SWIGLU = dict(num_layers=4, hidden_size=32, num_heads=4,
              intermediate_size=48, layerscale_value=1e-5, use_swiglu=True)
DROP = dict(num_layers=4, hidden_size=16, num_heads=2, intermediate_size=32,
            drop_path_rate=0.5)
OPT = dict(learning_rate=1e-3, total_steps=4, schedule="constant")


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _jax_tree(module) -> dict:
    """A port module's weights as the JAX package's parameter tree
    (`models/convert.py`)."""
    return unflatten_params({k: np.asarray(v) for k, v in
                             convert.params_to_flax(module.state_dict())
                             .items()})


def _init(module, seed: int = 0):
    """The port's initialisation of a module from a seed."""
    gen = torch.Generator().manual_seed(seed)
    if hasattr(module, "init_weights"):
        return module.init_weights(gen)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return module


@pytest.fixture(scope="module")
def refs():
    """The JAX package's dense models on the port's initialisation
    (carried by `models/convert.py`): weights for the port, inputs and
    outputs (losses and gradients for pretraining)."""
    from smb_vision_tpu_torch.models.configs import (
        Dinov2Config,
        VideoMAEConfig,
        VJEPA2Config,
    )
    from smb_vision_tpu_torch.models.dinov2 import Dinov2Model
    from smb_vision_tpu_torch.models.videomae import (
        VideoMAEForPreTraining,
        VideoMAEModel,
    )
    from smb_vision_tpu_torch.models.vjepa import VJEPA2Encoder, VJEPA2Model
    from smb_vision_tpu_torch.ops.masking import mim_mask, vjepa_target_mask

    out = {}
    rng = np.random.default_rng(0)
    px4 = rng.standard_normal((4, 16, 1, 32, 32)).astype(np.float32)
    px2 = px4[:2]
    port = _init(VideoMAEModel(VideoMAEConfig(**VIDEO)))
    video = JVideo(JVConfig(**VIDEO))
    out["videomae"] = dict(
        weights=_np(port.state_dict()), px=px4,
        ref=np.asarray(jax.jit(video.apply)(_jax_tree(port), px4)[0]))
    port = _init(VJEPA2Encoder(VJEPA2Config(**VJ)))
    venc = JVJEnc(JJConfig(**VJ))
    out["vjepa"] = dict(
        weights=_np(port.state_dict()), px=px2,
        ref=np.asarray(jax.jit(venc.apply)(_jax_tree(port), px2)))
    port = _init(Dinov2Model(Dinov2Config(**DINO)))
    dino = JDino(JDConfig(**DINO))
    dpx = rng.standard_normal((4, 1, 32, 32, 16)).astype(np.float32)
    out["dinov2"] = dict(
        weights=_np(port.state_dict()), px=dpx,
        ref=np.asarray(jax.jit(dino.apply)(_jax_tree(port), dpx)))
    port = _init(Encoder(**SWIGLU, dtype=torch.float32, attn_impl="xla"))
    enc = JEncoder(**SWIGLU, dtype=jnp.float32, attn_impl="xla")
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    out["swiglu"] = dict(
        weights=_np(port.state_dict()), x=x,
        ref=np.asarray(jax.jit(enc.apply)(_jax_tree(port), x)))

    port = _init(VideoMAEForPreTraining(VideoMAEConfig(**PRETRAIN)))
    mim = JMIM(JVConfig(**PRETRAIN))
    m = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(torch.Generator().manual_seed(0), 4, input_size=32,
                    depth=16, mask_patch_size=8, model_patch_size=8,
                    mask_ratio=0.5).numpy()
    p = _jax_tree(port)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q: mim.apply(q, px4, mask, m)["loss"]))(p)
    out["mim"] = dict(
        weights=_np(port.state_dict()), jax_params=p, px=px4, mask=mask,
        num_masked=m, loss=float(loss), grads=flatten_params(grads))

    port = _init(VJEPA2Model(VJEPA2Config(**VJ)))
    vj = JVJ(JJConfig(**VJ))
    tb = vjepa_target_mask(torch.Generator().manual_seed(0), 4,
                           grid=JJConfig(**VJ).grid).numpy()
    p = _jax_tree(port)
    teacher = jax.tree_util.tree_map(lambda a: a + np.float32(0.01), p)

    def vloss(q):
        o = vj.apply(q, px4, target_bool=tb, deterministic=True)
        tgt = vj.apply(teacher, px4, target_bool=tb,
                       skip_predictor=True)["last_hidden_state"]
        return jvjepa_loss(o["predictor_output"],
                           jax.lax.stop_gradient(tgt), tb)

    loss, grads = jax.jit(jax.value_and_grad(vloss))(p)
    weights = _np(port.state_dict())
    out["vjepa_pretrain"] = dict(
        weights=weights, teacher={k: v + np.float32(0.01)
                                  for k, v in weights.items()},
        jax_params=p, px=px4, mask=tb, loss=float(loss),
        grads=flatten_params(grads))

    # DropPath: the check is against the port's dense stack on the same
    # draws
    enc = _init(Encoder(**DROP, dtype=torch.float32, attn_impl="xla"))
    out["droppath_weights"] = _np(enc.state_dict())
    out["droppath_x"] = rng.standard_normal((4, 8, 16)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def port(refs, tmp_path_factory):
    r = refs
    jobs = {
        "videomae": dict(kind="videomae_encode", config=VIDEO,
                         weights=r["videomae"]["weights"],
                         pixel_values=r["videomae"]["px"], model=2,
                         microbatches=2),
        "vjepa": dict(kind="vjepa_encode", config=VJ,
                      weights=r["vjepa"]["weights"],
                      pixel_values=r["vjepa"]["px"], model=4,
                      microbatches=2),
        "dinov2": dict(kind="dinov2_encode", config=DINO,
                       weights=r["dinov2"]["weights"],
                       pixel_values=r["dinov2"]["px"], model=2,
                       microbatches=2),
        "swiglu": dict(kind="encoder", config=SWIGLU,
                       weights=r["swiglu"]["weights"], x=r["swiglu"]["x"],
                       model=4, microbatches=2),
        "droppath": dict(kind="encoder", config=DROP,
                         weights=r["droppath_weights"],
                         x=r["droppath_x"], model=4, microbatches=2,
                         seed=7),
        "mim": dict(kind="mim", config=PRETRAIN,
                    weights=r["mim"]["weights"],
                    pixel_values=r["mim"]["px"], mask=r["mim"]["mask"],
                    num_masked=r["mim"]["num_masked"], model=2,
                    microbatches=2),
        "vjepa_pretrain": dict(
            kind="vjepa", config=VJ, weights=r["vjepa_pretrain"]["weights"],
            teacher=r["vjepa_pretrain"]["teacher"],
            pixel_values=r["vjepa_pretrain"]["px"],
            mask=r["vjepa_pretrain"]["mask"], model=2, microbatches=2),
    }
    rng = np.random.default_rng(4)
    batch = rng.standard_normal((8, 16, 1, 32, 32)).astype(np.float32)
    train = dict(pixel_values=batch, opt=OPT, microbatches=2, steps=4)
    cases = {
        "models": ("pipeline", {"jobs": jobs}),
        "mim_train": ("pipe_train", dict(train, kind="mim",
                                         config=PRETRAIN,
                                         policy="pipeline")),
        "mim_train_fsdp": ("pipe_train", dict(
            train, kind="mim", config=PRETRAIN, policy="pipeline+fsdp")),
        "vjepa_train": ("pipe_train", dict(train, kind="vjepa", config=VJ,
                                           policy="pipeline")),
        "vjepa_drop": ("pipe_train", dict(
            train, kind="vjepa", config=dict(VJ, drop_path_rate=0.3),
            policy="pipeline")),
    }
    return W.run_ranks("many", 4, {"cases": cases},
                       tmp_path_factory.mktemp("pipelined"))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_videomae_pipeline_encode_matches_dense(refs, port):
    _close(port["models"]["videomae"]["out"], refs["videomae"]["ref"])


def test_vjepa2_pipeline_encode_matches_dense(refs, port):
    _close(port["models"]["vjepa"]["out"], refs["vjepa"]["ref"])


def test_dinov2_pipeline_encode_matches_dense(refs, port):
    _close(port["models"]["dinov2"]["out"], refs["dinov2"]["ref"])


def test_pipelined_encoder_guards():
    x = torch.randn(2, 8, 16)
    enc = Encoder(num_layers=2, hidden_size=16, num_heads=2,
                  intermediate_size=32, dtype=torch.float32,
                  attn_impl="xla", drop_path_rate=0.1)
    with pytest.raises(ValueError, match="deterministic"):
        P.pipelined_encoder(enc, x, num_microbatches=2,
                            deterministic=False)
    enc_sp = Encoder(num_layers=2, hidden_size=16, num_heads=2,
                     intermediate_size=32, dtype=torch.float32,
                     attn_impl="xla", sequence_parallel=True)
    with pytest.raises(ValueError, match="sequence_parallel"):
        P.pipelined_encoder(enc_sp, x, num_microbatches=2)


def _grads_match(got, want):
    flat = convert.params_to_flax({k: torch.from_numpy(v)
                                   for k, v in got.items()})
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(flat[k], v, rtol=5e-4, atol=5e-5,
                                   err_msg=k)


def test_videomae_pipeline_pretrain_matches_dense(refs, port):
    """The MIM loss and every gradient through both pipelined stacks (2 x
    2 (data, model)) as the dense JAX model's; the stacked layout is the
    JAX package's, and converts back exactly."""
    r, got = refs["mim"], port["models"]["mim"]
    np.testing.assert_allclose(got["loss"], r["loss"], rtol=2e-5, atol=2e-5)
    _grads_match(got["grads"], r["grads"])
    sd = {k: torch.from_numpy(v) for k, v in r["weights"].items()}
    stacked = P.to_pipeline_pretrain_params(sd)
    back = P.from_pipeline_pretrain_params(stacked)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    jst = jto_pretrain(r["jax_params"])["params"]
    np.testing.assert_array_equal(
        stacked["videomae.encoder_stacked.attention.query.weight"].numpy(),
        np.swapaxes(np.asarray(jst["videomae"]["encoder_stacked"][
            "attention"]["query"]["kernel"]), 1, 2))
    np.testing.assert_array_equal(
        stacked["decoder_stacked.mlp.fc2.bias"].numpy(),
        np.asarray(jst["decoder_stacked"]["mlp"]["fc2"]["bias"]))


def _trained(got, steps=4):
    assert len(got["losses"]) == steps
    assert all(np.isfinite(got["losses"]))
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    assert np.isfinite(got["evals"][0]) and got["evals"][0] == got[
        "evals"][1]


@pytest.mark.parametrize("case", ["mim_train", "mim_train_fsdp"])
def test_pipelined_mim_workload_trains_sharded(port, case):
    """4 steps of the pipelined MIM workload under "pipeline" (and
    "pipeline+fsdp") on 2 x 2 (data, model): the loss falls, the eval is
    finite and repeatable, each stage holds its own layers only; the
    export gathered from the stages is byte for byte the dense model's of
    the same weights, and so is its HF layout."""
    got = port[case]
    _trained(got)
    names = got["names"]
    enc = [{n.split(".")[2] for n in names[r]
            if n.startswith("videomae.encoder.layer_")} for r in range(4)]
    dec = [{n.split(".")[1] for n in names[r]
            if n.startswith("decoder.layer_")} for r in range(4)]
    # ranks are data-major: rank = data index * 2 + stage
    assert enc == [{"layer_0", "layer_1"}, {"layer_2", "layer_3"}] * 2
    assert dec == [{"layer_0"}, {"layer_1"}] * 2
    assert got["export"] == got["dense_export"]
    assert set(got["hf"]) == set(got["dense_hf"])
    for k, v in got["dense_hf"].items():
        np.testing.assert_array_equal(got["hf"][k], v)
    assert not any("stacked" in k for k in got["flax"])


def test_vjepa2_pipeline_pretrain_matches_dense(refs, port):
    """The V-JEPA2 loss and the student's every gradient through the
    pipelined student, predictor and teacher (2 x 2) as the dense JAX
    model's; the stacked layout converts back exactly."""
    r, got = refs["vjepa_pretrain"], port["models"]["vjepa_pretrain"]
    np.testing.assert_allclose(got["loss"], r["loss"], rtol=2e-5, atol=2e-5)
    _grads_match(got["grads"], r["grads"])
    sd = {k: torch.from_numpy(v) for k, v in r["weights"].items()}
    stacked = P.to_pipeline_vjepa_params(sd)
    back = P.from_pipeline_vjepa_params(stacked)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    jst = jto_vjepa(r["jax_params"])["params"]
    np.testing.assert_array_equal(
        stacked["predictor.stack_stacked.attention.key.weight"].numpy(),
        np.swapaxes(np.asarray(jst["predictor"]["stack_stacked"][
            "attention"]["key"]["kernel"]), 1, 2))


def test_pipelined_vjepa_workload_trains_sharded(port):
    """The pipelined V-JEPA workload: the loss falls, and the EMA teacher
    (each stage's from the student's same layers) moved toward the
    student but is not equal to it."""
    got = port["vjepa_train"]
    _trained(got)
    assert 0 < got["ema_gap"] < 1.0


def test_pipelined_encoder_layerscale_swiglu(refs, port):
    """LayerScale + SwiGLU blocks over 4 stages: every per-layer parameter
    kind travels with its stage."""
    _close(port["models"]["swiglu"]["out"], refs["swiglu"]["ref"])


def test_pipelined_encoder_droppath_matches_layer_loop(refs, port):
    """DropPath in train mode through 4 stages x 2 microbatches draws, from
    the same generator, the masks the dense stack draws (every layer's,
    in order, for the whole batch): the output equals the port's dense
    Encoder's; DropPath fired (train differs from eval), and the same seed
    repeats it."""
    got = port["models"]["droppath"]
    enc = Encoder(**DROP, dtype=torch.float32, attn_impl="xla")
    enc.load_state_dict({k: torch.from_numpy(v)
                         for k, v in refs["droppath_weights"].items()})
    x = torch.from_numpy(refs["droppath_x"])
    with torch.no_grad():
        want = enc.train()(x, generator=torch.Generator().manual_seed(7))
        det = enc.eval()(x)
    np.testing.assert_allclose(got["out"], want.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got["eval"], det.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert float(np.abs(got["out"] - got["eval"]).max()) > 1e-3
    np.testing.assert_array_equal(got["out"], got["again"])


def test_pipelined_vjepa_droppath_trains(port):
    """V-JEPA with drop_path_rate 0.3 through the pipeline: the student
    and predictor drop paths, the teacher does not; the loss falls and
    the eval (no DropPath) repeats exactly."""
    _trained(port["vjepa_drop"])


def test_jax_package_refusals():
    """The JAX package's refusals: the pipeline with sequence
    parallelism, a stack the stages do not divide, a batch the
    microbatches do not divide."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.train.mim import make_pipelined_mim_workload

    kw = dict(mask_patch_size=8, mask_ratio=0.5, tx=None, mesh=None,
              num_microbatches=2)
    with pytest.raises(ValueError, match="sequence parallelism"):
        make_pipelined_mim_workload(
            VideoMAEConfig(**PRETRAIN, sequence_parallel=True), **kw)
    cfg = dataclasses.replace(VideoMAEConfig(**PRETRAIN),
                              num_hidden_layers=3)
    from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
    from smb_vision_tpu_torch.parallel.pipeline import PipeStages

    with pytest.raises(ValueError, match="pipe stages"):
        VideoMAEForPreTraining(cfg, PipeStages(2, 0, 2))
    model = VideoMAEForPreTraining(VideoMAEConfig(**PRETRAIN),
                                   PipeStages(1, 0, 3))
    px = torch.randn(4, 16, 1, 32, 32)
    mask = torch.from_numpy(np.array(jmim_mask(
        KEY, 4, input_size=32, depth=16, mask_patch_size=8,
        model_patch_size=8, mask_ratio=0.5)))
    with pytest.raises(ValueError, match="microbatches"):
        model(px, mask, 16)
