"""Sequence parallelism in the port's models: VideoMAE pretraining (the
encoder and the decoder) and V-JEPA2 (the encoder, the predictor and the
EMA teacher, RoPE tables cut with the tokens) with the tokens split over
the model axis of gloo ranks, in both variants ("gather", "ring"),
against the JAX package: the loss and every parameter's gradient against
the dense JAX model on the same weights and inputs (the cases of
tests/test_sequence_parallel.py, and token counts the axis does not
divide), the routed attention calls, and two whole Trainer steps under
"dp", "fsdp", "tp" and "fsdp+tp" on a 2 x 2 (data, model) mesh (MIM with
both variants, V-JEPA with "gather") against the JAX package's
sequence-parallel steps on its CPU mesh, whose parameters are placed by
the same policy; and a split weight's gradient under "tp" against the
dense JAX gradient (a missing model-axis sum reads half of it)."""

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.models.configs import VideoMAEConfig as JVConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JJConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JMIM
from smb_vision_tpu.models.vjepa import VJEPA2Model as JVJ
from smb_vision_tpu.models.vjepa import vjepa_loss as jvjepa_loss
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.ops.masking import num_masked_tokens
from smb_vision_tpu.ops.masking import vjepa_target_mask as jtarget_mask
from smb_vision_tpu.parallel.mesh import batch_sharding
from smb_vision_tpu.parallel.mesh import create_mesh as jcreate_mesh
from smb_vision_tpu.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_params,
)
from smb_vision_tpu.train import mim as jmim
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.train import vjepa as jvjepa
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu.utils.serialization import unflatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.configs import VJEPA2Config
from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu_torch.models.vjepa import VJEPA2Model
from smb_vision_tpu_torch.ops.masking import mim_mask, vjepa_target_mask

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
# tests/test_sequence_parallel.py's model: 32 tokens, 16 visible
MIM = dict(image_size=32, num_frames=16, patch_size=8, tubelet_size=8,
           num_channels=1, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           decoder_hidden_size=32, decoder_num_hidden_layers=1,
           decoder_num_attention_heads=2, decoder_intermediate_size=64,
           dtype="float32", attn_impl="xla")
# 18 tokens (2 x 3 x 3), 9 visible: neither divides over 4 ranks
MIM_UNEVEN = dict(MIM, image_size=24)
VJ = dict(crop_size=32, frames_per_clip=16, patch_size=8, tubelet_size=8,
          in_chans=1, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, mlp_ratio=2.0, pred_hidden_size=32,
          pred_num_hidden_layers=1, pred_num_attention_heads=2,
          pred_mlp_ratio=2.0, dtype="float32", attn_impl="xla")
VJ_UNEVEN = dict(VJ, crop_size=24)
OPT = dict(learning_rate=1e-3, total_steps=2, weight_decay=0.05,
           grad_clip=0.05)
MASK = dict(mask_patch_size=8, mask_ratio=0.5)


def _jax_tree(module) -> dict:
    """A port module's weights as the JAX package's parameter tree
    (`models/convert.py`)."""
    return unflatten_params({k: np.asarray(v) for k, v in
                             convert.params_to_flax(module.state_dict())
                             .items()})


def _mim_case(cfg, b=2):
    """The JAX dense MIM model's loss and gradients on the port's
    initialisation, with the weights and the batch for the port."""
    c = JVConfig(**cfg)
    model = JMIM(c)
    m = num_masked_tokens(c.image_size, c.num_frames, 8, 8, 0.5)
    rng = np.random.default_rng(0)
    px = rng.standard_normal((b, c.num_frames, 1, c.image_size,
                              c.image_size)).astype(np.float32)
    mask = mim_mask(torch.Generator().manual_seed(0), b,
                    input_size=c.image_size, depth=c.num_frames,
                    model_patch_size=8, **MASK).numpy()
    port = VideoMAEForPreTraining(VideoMAEConfig(**cfg)).init_weights(
        torch.Generator().manual_seed(0))
    params = _jax_tree(port)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply(p, px, mask, m)["loss"]))(params)
    return dict(kind="mim", config=cfg, weights={
        k: v.detach().numpy() for k, v in port.state_dict().items()},
        batch={"pixel_values": px, "mask": mask, "num_masked": m}), \
        float(loss), flatten_params(grads)


def _vjepa_case(cfg, b=2):
    """The JAX dense V-JEPA loss (teacher = student + 0.01, as
    tests/test_pipelined_models.py builds it) and the student's
    gradients, on the port's initialisation."""
    c = JJConfig(**cfg)
    model = JVJ(c)
    rng = np.random.default_rng(0)
    px = rng.standard_normal((b, c.frames_per_clip, 1, c.crop_size,
                              c.crop_size)).astype(np.float32)
    tb = vjepa_target_mask(torch.Generator().manual_seed(0), b,
                           grid=c.grid).numpy()
    port = VJEPA2Model(VJEPA2Config(**cfg)).init_weights(
        torch.Generator().manual_seed(0))
    weights = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    teacher_w = {k: v + np.float32(0.01) for k, v in weights.items()}
    params = _jax_tree(port)
    teacher = jax.tree_util.tree_map(lambda a: a + np.float32(0.01), params)

    def loss_fn(p):
        out = model.apply(p, px, target_bool=tb, deterministic=True)
        tgt = model.apply(teacher, px, target_bool=tb,
                          skip_predictor=True)["last_hidden_state"]
        return jvjepa_loss(out["predictor_output"],
                           jax.lax.stop_gradient(tgt), tb)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(kind="vjepa", config=cfg, weights=weights,
                teacher=teacher_w, batch={"pixel_values": px, "mask": tb}), \
        float(loss), flatten_params(grads)


JOBS = {
    # name: (the JAX case's maker, config, variant, model axis, batch)
    "gather": (_mim_case, MIM, "gather", 4, 2),
    "ring": (_mim_case, MIM, "ring", 4, 2),
    "ring_uneven": (_mim_case, MIM_UNEVEN, "ring", 4, 2),
    "gather_dp": (_mim_case, MIM, "gather", 2, 2),
    "vjepa_ring": (_vjepa_case, VJ, "ring", 4, 2),
    "vjepa_gather_uneven": (_vjepa_case, VJ_UNEVEN, "gather", 4, 2),
}


# the tiny models shard at this size under "fsdp" (every (64, 64) matrix)
MIN_FSDP = W.MIN_FSDP
# the Trainer steps: {job: (kind, sp_variant, the JAX package's placement,
# the port's policies)}, each on a 2 x 2 (data, model) mesh
STEP_JOBS = {
    "mim_sp": ("mim", "gather", "dp", ["dp", "fsdp"]),
    "mim_sp_tp": ("mim", "gather", "fsdp+tp", ["tp", "fsdp+tp"]),
    "mim_ring_tp": ("mim", "ring", "fsdp+tp", ["tp", "fsdp+tp"]),
    "vjepa_sp_tp": ("vjepa", "gather", "fsdp+tp", ["tp", "fsdp+tp"]),
}


def _jax_sp_steps(devices, kind="mim", variant="gather", policy="dp"):
    """Two steps of the JAX package's sequence-parallel workload of `kind`
    (`variant`) on a 2 x 2 (data, model) CPU mesh, its parameters (and
    V-JEPA's teacher) and the optimizer state placed by `policy` as
    __graft_entry__.py places them ("dp": replicated), and the port's job
    of the same weights, batches and masks."""
    tx = joptim.make_optimizer(**OPT)
    sp = dict(sequence_parallel=True, sp_variant=variant)
    if kind == "mim":
        cfg = dict(MIM, **sp)
        _, jinit, jstep, _ = jmim.make_mim_workload(JVConfig(**cfg), tx=tx,
                                                    **MASK)
    else:
        cfg = dict(VJ, **sp)
        _, jinit, jstep, _ = jvjepa.make_vjepa_workload(JJConfig(**cfg),
                                                        tx=tx)
    mesh = jcreate_mesh(model=2, devices=devices[:4])
    rng = np.random.default_rng(3)
    batches = [{"pixel_values": rng.uniform(0, 1, (4, 16, 1, 32, 32))
                .astype(np.float32)} for _ in range(2)]
    keys = [jax.random.PRNGKey(300 + i) for i in range(2)]
    with jax.set_mesh(mesh):
        st = jinit(KEY)
        w0 = convert.params_from_flax(flatten_params(st["params"]),
                                      pretraining=kind == "mim",
                                      vjepa=kind == "vjepa")
        if policy != "dp":
            p_sh = param_shardings(st["params"], mesh, policy,
                                   min_fsdp_size=MIN_FSDP)
            params = st["params"]
            st = dict(st, params=shard_params(params, p_sh))
            if "teacher" in st:
                st["teacher"] = shard_params(st["teacher"], param_shardings(
                    st["teacher"], mesh, policy, min_fsdp_size=MIN_FSDP))
            st["opt_state"] = jax.device_put(
                st["opt_state"], opt_state_shardings(
                    st["opt_state"], p_sh, mesh, params=params))
        losses = []
        step = jax.jit(jstep)
        for b, k in zip(batches, keys):
            st, m = step(st, jax.device_put(b, batch_sharding(mesh)), k)
            losses.append(float(m["loss"]))
    if kind == "mim":
        masks = [np.asarray(jmim_mask(k, 4, input_size=32, depth=16,
                                      model_patch_size=8, **MASK))
                 for k in keys]
    else:
        grid = JJConfig(**cfg).grid
        masks = [np.asarray(jtarget_mask(jax.random.split(k)[0], 4,
                                         grid=grid)) for k in keys]
    job = dict(kind=kind, config=cfg, opt=OPT, batches=batches,
               masks=masks, weights={k: v.numpy() for k, v in w0.items()})
    want = {"losses": losses, "params": {
        k: np.asarray(v) for k, v in flatten_params(st["params"]).items()}}
    return job, want


def _jax_split_grad():
    """The dense JAX MIM model's gradient of one weight the "tp" rules
    split (the first encoder layer's fc1), on the port's initialisation,
    with the job that gives the port the same loss under sequence
    parallelism on a 2 x 2 mesh."""
    job, _, grads = _mim_case(MIM, b=2)
    return job, grads["params.videomae.encoder.layer_0.mlp.fc1.kernel"]


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    jobs, want, built = {}, {}, {}
    for name, (build, cfg, variant, model, b) in JOBS.items():
        key = (build.__name__, cfg["image_size" if "image_size" in cfg
                                   else "crop_size"])
        if key not in built:
            built[key] = build(cfg, b)
        job, loss, grads = built[key]
        jobs[name] = dict(job, variant=variant, model=model)
        want[name] = (loss, grads)
    steps, steps_want = {}, {}
    for name, (kind, variant, jpolicy, policies) in STEP_JOBS.items():
        job, steps_want[name] = _jax_sp_steps(eight_devices, kind, variant,
                                              jpolicy)
        steps[name] = dict(job, runs=[(p, 2) for p in policies])
    split_job, split_want = _jax_split_grad()
    want["split"] = split_want
    # the model tests, the Trainer steps and the split weight's gradient
    # in one spawn of 4 ranks
    got = W.run_ranks("many", 4, {"cases": {
        "models": ("sp_models", {"jobs": jobs}),
        "steps": ("steps", {"jobs": steps}),
        "split": ("sp_split_grad", dict(split_job, variant="gather",
                                        model=2))}},
        tmp_path_factory.mktemp("sp"))
    return got, want, steps_want


def _check(runs, name, rtol):
    got, want, _ = runs
    loss, grads = want[name]
    g = got["models"][name]
    np.testing.assert_allclose(g["loss"], loss, rtol=rtol)
    flat = convert.params_to_flax({k: torch.from_numpy(v)
                                   for k, v in g["grads"].items()})
    assert set(flat) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(flat[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_sequence_parallel_step_matches_dense(runs):
    """Gather, 4 model ranks: the loss within 2e-5 of the dense JAX
    model's and every gradient (the encoder's and decoder's blocks summed
    over the model axis; the embed, mask token and head whole on each
    rank) within 1e-4."""
    _check(runs, "gather", 2e-5)


def _check_steps(runs, name):
    got, _, wants = runs
    want = wants[name]
    for policy in STEP_JOBS[name][3]:
        r = got["steps"][(name, policy, 2)]
        for a, b in zip(r["losses"], want["losses"]):
            assert abs(a - b) <= 1e-3 * abs(b), policy
        flat = convert.params_to_flax({k: torch.from_numpy(v)
                                       for k, v in r["params"].items()})
        assert set(flat) == set(want["params"])
        err = max(float(np.abs(flat[k] - v).max())
                  for k, v in want["params"].items())
        assert err < 1e-4, (policy, err)
    assert want["losses"][1] < want["losses"][0]


def test_sequence_parallel_train_step(runs):
    """Two Trainer steps (the clip active) under dp and fsdp on a 2 x 2
    (data, model) mesh against the JAX package's sequence-parallel steps:
    each loss within 1e-3, every parameter within 1e-4 after the steps."""
    _check_steps(runs, "mim_sp")


@pytest.mark.parametrize("name", ["mim_sp_tp", "mim_ring_tp",
                                  "vjepa_sp_tp"])
def test_sequence_parallel_train_step_under_tp(runs, name):
    """Two Trainer steps under "tp" and "fsdp+tp" with the tokens and the
    split weights on the same model axis of a 2 x 2 mesh (MIM with both
    variants, V-JEPA with "gather": its encoder, predictor and EMA teacher)
    against the JAX package's steps with its parameters placed by
    "fsdp+tp": each loss within 1e-3, every parameter (the teacher's too,
    through the EMA of the student's) within 1e-4."""
    _check_steps(runs, name)


def test_split_weight_gradient_is_summed_over_the_model_axis(runs):
    """Under "tp" with the tokens on the model axis, the gradient of a
    split weight (fc1 of the first encoder layer) gathered from both
    model ranks' pieces is the dense JAX model's within 1e-4 relative:
    each rank's own tokens give it part of the gradient, so the gather's
    backward sums it over the axis before keeping the rank's piece."""
    got, want, _ = runs
    g = got["split"]
    ref = np.asarray(want["split"])
    assert g.shape == ref.shape
    np.testing.assert_allclose(g, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_sequence_parallel_uses_flash_wrapper(runs):
    """Every self-attention of a sequence-parallel model goes through the
    context-parallel wrappers: encoder 2 layers + decoder 1 layer = 3
    calls on each rank (V-JEPA: 2 encoder + 1 predictor, the teacher
    under no_grad 2 more)."""
    got, _, _ = runs
    for name in ("gather", "ring", "ring_uneven", "gather_dp"):
        assert got["models"][name]["calls"] == 3, name
    assert got["models"]["vjepa_ring"]["calls"] == 5


def test_sequence_parallel_ring_variant_matches_dense(runs):
    _check(runs, "ring", 3e-5)


@pytest.mark.parametrize("name,rtol", [("ring_uneven", 3e-5),
                                       ("gather_dp", 2e-5),
                                       ("vjepa_ring", 3e-5),
                                       ("vjepa_gather_uneven", 2e-5)])
def test_sequence_parallel_cases_match_dense(runs, name, rtol):
    """Token counts the axis does not divide (18 tokens / 9 visible over 4
    ranks), the data axis beside the model axis (2 x 2, a row a data
    rank), and
    V-JEPA2 (RoPE tables cut with the tokens; ring and uneven gather): the
    loss and every gradient as the dense JAX model's."""
    _check(runs, name, rtol)
