"""The port's training on several gloo ranks on the CPU: the Cox
classification step with a tabular feature under dp, fsdp, tp (2 ranks)
and fsdp+tp (4 ranks) against the JAX package's sharded step on the
8-device CPU mesh and against the port's own single-process step on the
same global batch; and the N-rank step with the clip active, gradient
accumulation 2 and the 8-bit AdamW against one process (Cox, MIM). The
V-JEPA step, on the same helpers, is in
tests/test_torch_distributed_vjepa.py."""

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.models.configs import VideoMAEConfig as JVConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JJConfig
from smb_vision_tpu.models.videomae import VideoMAEForVideoClassification \
    as JVideo
from smb_vision_tpu.ops.masking import vjepa_target_mask as jtarget_mask
from smb_vision_tpu.parallel.mesh import batch_sharding
from smb_vision_tpu.parallel.mesh import create_mesh as jcreate_mesh
from smb_vision_tpu.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_params,
)
from smb_vision_tpu.train import classification as jcls
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.train import vjepa as jvjepa
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.ops.masking import mim_mask

torch.set_num_threads(1)

POLICIES = ("dp", "fsdp", "tp", "fsdp+tp")
RUNS2 = [("dp", 1), ("fsdp", 1), ("tp", 2)]
RUNS4 = [("fsdp+tp", 2)]
B = 4
OPT = dict(learning_rate=1e-3, total_steps=2, weight_decay=0.05,
           grad_clip=0.05)


def _jax_mesh(policy, devices):
    if "tp" in policy:
        return jcreate_mesh(model=2, devices=devices)
    return jcreate_mesh(devices=devices[:4])


def _jax_run(state, step, batches, keys, policy, devices):
    """Two JAX steps with params (and the teacher) and the optimizer state
    placed by `policy` on the CPU mesh, the batch split over "data"."""
    mesh = _jax_mesh(policy, devices)
    p_sh = param_shardings(state["params"], mesh, policy,
                           min_fsdp_size=W.MIN_FSDP)
    st = dict(state, params=shard_params(state["params"], p_sh))
    if "teacher" in st:
        st["teacher"] = shard_params(st["teacher"], param_shardings(
            state["teacher"], mesh, policy, min_fsdp_size=W.MIN_FSDP))
    st["opt_state"] = jax.device_put(st["opt_state"], opt_state_shardings(
        st["opt_state"], p_sh, mesh, params=state["params"]))
    losses = []
    with jax.set_mesh(mesh):
        for b, k in zip(batches, keys):
            st, m = step(st, jax.device_put(b, batch_sharding(mesh)), k)
            losses.append(float(m["loss"]))
    out = {"losses": losses, "params": {
        k: np.asarray(v) for k, v in flatten_params(st["params"]).items()}}
    if "teacher" in st:
        out["teacher"] = {k: np.asarray(v) for k, v in
                          flatten_params(st["teacher"]).items()}
    return out


def _jobs(family: str):
    """The JAX runs and the port's jobs (weights carried across) of a
    family: "vjepa" (V-JEPA, and with accumulation 2 and the 8-bit AdamW)
    or "cox" (Cox survival with one tabular column, its 8-bit variant
    and the MIM step with accumulation 2 and the 8-bit AdamW)."""
    rng = np.random.default_rng(7)
    keys = [jax.random.PRNGKey(200 + i) for i in range(2)]
    opt8 = dict(OPT, optim="adamw8bit")
    if family == "vjepa":
        # the masks as the JAX step draws them
        _, jinit, jstep, _ = jvjepa.make_vjepa_workload(
            JJConfig(**W.VJ_TINY), tx=joptim.make_optimizer(**OPT))
        vj0 = jinit(jax.random.PRNGKey(0))
        vjb = [{"pixel_values": rng.uniform(0, 1, (B, 32, 1, 32, 32))
                .astype(np.float32)} for _ in range(2)]
        grid = JJConfig(**W.VJ_TINY).grid
        vjm = [np.asarray(jtarget_mask(jax.random.split(k)[0], B,
                                       grid=grid)) for k in keys]
        job = dict(kind="vjepa", config=W.VJ_TINY, opt=OPT, batches=vjb,
                   masks=vjm, weights={k: v.numpy() for k, v in
                                       convert.params_from_flax(
                                           flatten_params(vj0["params"]),
                                           vjepa=True).items()})
        return ({"vjepa": (vj0, jax.jit(jstep), vjb, keys)},
                {"vjepa": job, "vjepa8": dict(job, opt=opt8, accum=2)})
    jcfg = JVConfig(**W.CLS_TINY, problem_type=None)
    cinit, cstep, _ = jcls.make_classification_workload(
        JVideo(jcfg), jcfg, task_type="survival",
        tx=joptim.make_optimizer(**OPT))
    cb = []
    for i in range(2):
        cb.append({"pixel_values": rng.uniform(0, 1, (B, 32, 1, 32, 32))
                   .astype(np.float32),
                   "duration": rng.uniform(10, 900, B).astype(np.float32),
                   "event": np.array([1, 0, 1, 1], np.float32)[
                       np.roll(np.arange(B), i)],
                   "additional_features": rng.normal(size=(B, 1))
                   .astype(np.float32)})
    c0 = cinit(jax.random.PRNGKey(0), cb[0])
    job = dict(kind="cls", config=W.CLS_TINY, opt=OPT, batches=cb,
               masks=None, weights={k: v.numpy() for k, v in
                                    convert.params_from_flax(
                                        flatten_params(c0["params"]),
                                        classification=True).items()})
    mcfg = dict(W.GEOM, **W.MIM_TINY)
    mb = [{"pixel_values": rng.uniform(0, 1, (2 * B, 32, 1, 32, 32))
           .astype(np.float32)} for _ in range(2)]
    mm = [mim_mask(torch.Generator().manual_seed(i), 2 * B, input_size=32,
                   depth=32, model_patch_size=16, **W.MIM_MASK).numpy()
          for i in range(2)]
    model, init_fn, *_ = W.make_workload("mim", mcfg, opt8, 2)
    init_fn(0)
    mim8 = dict(kind="mim", config=mcfg, opt=opt8, accum=2, batches=mb,
                masks=mm, weights={k: v.detach().numpy().copy()
                                   for k, v in model.state_dict().items()})
    return ({"cls": (c0, jax.jit(cstep), cb, keys)},
            {"cls": job, "cls8": dict(job, opt=opt8, accum=2),
             "mim8": mim8})


def run_family(family, devices, tmp_path_factory):
    """The JAX sharded runs under each policy, the port's one-process
    runs, and the port's 2-rank and 4-rank runs of a family's jobs."""
    jax_side, jobs = _jobs(family)
    jax_out = {(name, policy): _jax_run(*jax_side[name], policy, devices)
               for name in jax_side for policy in POLICIES}
    single = {name: W.run_steps(dict(job, work=str(
        tmp_path_factory.mktemp(f"single_{name}"))))
        for name, job in jobs.items()}
    port = W.run_ranks("steps", 2, {"jobs": {
        name: dict(job, runs=RUNS2) for name, job in jobs.items()}},
        tmp_path_factory.mktemp("two"))
    port.update(W.run_ranks("steps", 4, {"jobs": {
        name: dict(job, runs=RUNS4) for name, job in jobs.items()}},
        tmp_path_factory.mktemp("four")))
    return jax_out, single, port


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    return run_family("cox", eight_devices, tmp_path_factory)


def _flax(params):
    return convert.params_to_flax({k: torch.from_numpy(v)
                                   for k, v in params.items()})


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_cox_step_matches_jax(runs, policy):
    check_against_jax(runs, "cls", policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["cls", "cls8", "mim8"])
def test_sharded_step_matches_one_process(runs, name, policy):
    check_against_one_process(runs, name, policy)


def check_against_jax(runs, name, policy):
    """Against the JAX sharded step: the loss within 1e-3 relative at each
    step, the parameters (and V-JEPA's EMA teacher) within 1e-4. The Cox
    partial likelihood does not change when every risk moves by the same
    amount, so the survival head's bias has a gradient of rounding noise
    alone (in the one-process port as in the JAX package), which AdamW
    turns into steps of up to lr each: that bias is held to the sum of
    its steps, 2 lr."""
    jax_out, _, port = runs
    got = port[(name, policy, 2 if "tp" in policy else 1)]
    want = jax_out[(name, policy)]
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-3 * abs(b)
    noise = {"params.classifier.bias"} if name == "cls" else set()
    for tree in ("params", "teacher") if name == "vjepa" else ("params",):
        flat = _flax(got[tree])
        assert set(flat) == set(want[tree])
        err = max(float(np.abs(flat[k] - v).max())
                  for k, v in want[tree].items() if k not in noise)
        assert err < 1e-4, tree
        for k in noise:
            assert np.abs(flat[k] - want[tree][k]).max() <= 2 * OPT[
                "learning_rate"]


def check_against_one_process(runs, name, policy):
    """Against the port's one-process step on the global batch (the clip
    active; the "8" jobs with accumulation 2 and the 8-bit AdamW): the
    loss within 1e-5 relative at each step, the first step's gradients
    within 1e-5 of their norm, the parameters within 1e-4 (the Cox head's
    bias within its two AdamW steps, as against the JAX package)."""
    _, single, port = runs
    got = port[(name, policy, 2 if "tp" in policy else 1)]
    want = single[name]
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    grads = {k: g for k, g in want["grads"].items() if g is not None}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads.values()))
    # the clip was active: the gradients after it have its norm
    assert abs(norm - OPT["grad_clip"]) <= 1e-5 * OPT["grad_clip"]
    diff = np.sqrt(sum(float(((got["grads"][k] - g).astype(np.float64)
                              ** 2).sum()) for k, g in grads.items()))
    assert diff <= 1e-5 * norm
    # the Cox head's bias: a gradient of rounding noise (see above)
    noise = {"classifier.bias"} if name.startswith("cls") else set()
    err = max(float(np.abs(got["params"][k] - v).max())
              for k, v in want["params"].items() if k not in noise)
    assert err < 1e-4
    for k in noise:
        assert np.abs(got["params"][k] - want["params"][k]).max() <= 2 * OPT[
            "learning_rate"]
    if "teacher" in want:
        err = max(float(np.abs(got["teacher"][k] - v).max())
                  for k, v in want["teacher"].items())
        assert err < 1e-4
