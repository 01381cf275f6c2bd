"""The port's sharding policies against the JAX package's on the CPU:
each parameter's class (`param_placements` against `param_shardings`, by
flat name, on tiny VideoMAE, V-JEPA and DINOv2 models), the optimizer
state's placement (against `opt_state_shardings`, the 8-bit codes and
scales included), the 8-bit blocks over local shards, and the sharded MIM
step: the JAX step on the 8-device CPU mesh against the port's 2-rank
(4-rank for fsdp+tp) step on gloo, same weights, batches and masks."""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.models.configs import Dinov2Config as JDinoConfig
from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JJConfig
from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification as JDino
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.parallel.mesh import batch_sharding
from smb_vision_tpu.parallel.mesh import create_mesh as jcreate_mesh
from smb_vision_tpu.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_params,
)
from smb_vision_tpu.train import classification as jcls
from smb_vision_tpu.train import mim as jmim
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.train import vjepa as jvjepa
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import (
    Dinov2Config,
    VideoMAEConfig,
    VJEPA2Config,
)
from smb_vision_tpu_torch.models.dinov2 import Dinov2ForImageClassification
from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu_torch.models.vjepa import VJEPA2Model
from smb_vision_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

POLICIES = ("dp", "fsdp", "tp", "fsdp+tp")
MIN = 2 ** 10
DINO = dict(image_size=32, depth=32, patch_size=16, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4, use_swiglu_ffn=True,
            layerscale_value=0.7, dtype="float32", attn_impl="xla",
            mlp_impl="xla", num_labels=3)


def _jax_class(spec, ndim):
    """(tp, data) of a JAX PartitionSpec, as `tsh.Placement`."""
    entries = list(spec) + [None] * (ndim - len(spec))
    tp = None
    if "model" in entries:
        tp = "col" if entries.index("model") == ndim - 1 else "row"
    return tsh.Placement(tp, "data" in entries)


def _jax_mesh(policy, devices):
    if "tp" in policy:
        return jcreate_mesh(model=2, devices=devices)        # (4, 2)
    return jcreate_mesh(devices=devices[:4])                 # (4, 1)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX params, port model) of the three families, same tree."""
    key = jax.random.PRNGKey(0)
    out = {}
    mcfg = dict(W.GEOM, **W.MIM_TINY)
    _, jinit, _, _ = jmim.make_mim_workload(
        JConfig(**mcfg), tx=joptim.make_optimizer(learning_rate=1e-3,
                                                 total_steps=2), **W.MIM_MASK)
    out["videomae"] = (jinit(key)["params"],
                       VideoMAEForPreTraining(VideoMAEConfig(**mcfg)))
    _, jinit, _, _ = jvjepa.make_vjepa_workload(
        JJConfig(**W.VJ_TINY), tx=joptim.make_optimizer(learning_rate=1e-3,
                                                        total_steps=2))
    out["vjepa"] = (jinit(key)["params"],
                    VJEPA2Model(VJEPA2Config(**W.VJ_TINY)))
    jcfg = JDinoConfig(**DINO)
    jinit, _, _ = jcls.make_classification_workload(
        JDino(jcfg), jcfg, task_type="classification",
        tx=joptim.make_optimizer(learning_rate=1e-3, total_steps=2))
    px = np.zeros((1, 1, 32, 32, 32), np.float32)
    out["dinov2"] = (jinit(key, {"pixel_values": px,
                                 "labels": np.zeros(1, np.int32)})["params"],
                     Dinov2ForImageClassification(Dinov2Config(**DINO)))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["videomae", "vjepa", "dinov2"])
def test_param_placements_match_jax(eight_devices, family, policy):
    jparams, model = _models()[family]
    mesh = _jax_mesh(policy, eight_devices)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            param_shardings(jparams, mesh, policy, min_fsdp_size=MIN))[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        want[name] = sh.spec
    shapes = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jparams)[0]}
    got = tsh.param_placements(model, (mesh.shape["data"],
                                       mesh.shape["model"]), policy, MIN)
    seen = set()
    for name, placement in got.items():
        path = "params/" + tsh.jax_path(name, model.get_parameter(
            name).dim())[len("params/"):]
        assert path in want, path
        assert _jax_class(want[path], len(shapes[path])) == placement, path
        seen.add(path)
    assert seen == set(want)
    # the classes are not all alike: the policy splits something
    if policy != "dp":
        assert any(p.tp or p.data for p in got.values())


@pytest.mark.parametrize("optim", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("policy", ["fsdp", "tp", "fsdp+tp"])
def test_opt_state_placement_matches_jax(eight_devices, policy, optim):
    """AdamW's moments take the parameter's class; the 8-bit codes and
    scales shard their block axis over the parameter's axes exactly where
    the JAX `quantized_spec` does (on the tiny VideoMAE every split
    parameter splits into whole blocks: "local" mode)."""
    from smb_vision_tpu.train.quantized import adamw8bit

    jparams, model = _models()["videomae"]
    mesh = _jax_mesh(policy, eight_devices)
    p_sh = param_shardings(jparams, mesh, policy, min_fsdp_size=MIN)
    tx = (adamw8bit(1e-3) if optim == "adamw8bit"
          else joptim.make_optimizer(learning_rate=1e-3, total_steps=2))
    o_sh = opt_state_shardings(jax.eval_shape(tx.init, jparams), p_sh, mesh,
                               params=jparams)
    flat = jax.tree_util.tree_flatten_with_path(o_sh)[0]
    n = {"data": mesh.shape["data"], "model": mesh.shape["model"]}
    got = tsh.param_placements(model, (n["data"], n["model"]), policy, MIN)
    for name, placement in got.items():
        path = tsh.jax_path(name, model.get_parameter(name).dim())[
            len("params/"):]
        leaves = [(p, sh) for p, sh in flat
                  if "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                              for k in p).replace("/.", "/").find(path) >= 0]
        assert leaves, path
        shape = model.get_parameter(name).shape
        for _, sh in leaves:
            axes = [a for e in sh.spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            if optim == "adamw":
                assert _jax_class(sh.spec, len(shape)) == placement, path
            else:
                # the port's block placement of this parameter
                mode = tsh.state_block_axes(placement, shape, n)
                assert sorted(axes) == sorted(mode), (path, axes, mode)


def test_opt_state_follows_each_parameter_not_its_name_suffix(tmp_path):
    """The JAX suffix-boundary case (`opt_state_shardings` must not give
    'a/kernel' the sharding of 'lora_a/kernel'): here the optimizer state
    is keyed by the parameter itself, so under fsdp on 2 ranks the
    sharded lora_a's moments are DTensors of its placement and the
    replicated a's stay plain."""
    got = W.run_ranks("suffix", 2, {}, tmp_path)
    assert got["lora_a.weight"] == ("(Shard(dim=0),)", {
        "exp_avg": "(Shard(dim=0),)", "exp_avg_sq": "(Shard(dim=0),)"})
    assert got["a.weight"] == ("plain", {"exp_avg": "plain",
                                         "exp_avg_sq": "plain"})


def test_eight_bit_blocks_over_shards(tmp_path):
    """AdamW8bit on DTensor parameters over 2 ranks: a dim-0 split into
    whole 256-element blocks keeps local blocks ("local"); a split into
    pieces of a partial block, or a row split, updates its rows of the
    whole parameter's blocks ("rows"); a block count that does not divide
    keeps every block ("full"). Each way three updates give the
    single-process parameters and state byte for byte."""
    rng = np.random.default_rng(0)
    shapes = {"whole": (8, 64), "partial": (6, 64), "tiny": (3,),
              "rowsplit": (4, 128)}
    spec = {"params": {k: rng.normal(size=s).astype(np.float32)
                       for k, s in shapes.items()},
            "grads": [{k: rng.normal(size=s).astype(np.float32)
                       for k, s in shapes.items()} for _ in range(3)]}
    got = W.run_ranks("eight_bit", 2, spec, tmp_path)
    want = W.eight_bit_steps(spec, None)
    assert got["modes"] == {"whole": "local", "partial": "rows",
                            "tiny": "full", "rowsplit": "rows"}
    assert set(want["modes"].values()) == {"plain"}
    for k in shapes:
        np.testing.assert_array_equal(got["params"][k], want["params"][k])
        for key in ("mu", "mu_scale", "nu", "nu_scale"):
            np.testing.assert_array_equal(got["state"][k][key],
                                          want["state"][k][key])


# -- the sharded MIM step against the JAX package -----------------------------

OPT = dict(learning_rate=1e-3, total_steps=2, weight_decay=0.05,
           warmup_ratio=0.0, grad_clip=0.05)
B = 4


def _mim_setup():
    cfg = dict(W.GEOM, **W.MIM_TINY)
    _, jinit, jstep, _ = jmim.make_mim_workload(
        JConfig(**cfg), tx=joptim.make_optimizer(**OPT), **W.MIM_MASK)
    rng = np.random.default_rng(5)
    batches = [{"pixel_values": rng.uniform(0, 1, (B, 32, 1, 32, 32))
                .astype(np.float32)} for _ in range(2)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    masks = [np.asarray(jmim_mask(k, B, input_size=32, depth=32,
                                  model_patch_size=16, **W.MIM_MASK))
             for k in keys]
    return cfg, jinit, jstep, batches, keys, masks


@pytest.fixture(scope="module")
def mim_runs(eight_devices, tmp_path_factory):
    cfg, jinit, jstep, batches, keys, masks = _mim_setup()
    jstate0 = jinit(jax.random.PRNGKey(0))
    weights = {k: v.numpy() for k, v in convert.params_from_flax(
        flatten_params(jstate0["params"]), pretraining=True).items()}
    jax_out = {}
    step = jax.jit(jstep)
    for policy in POLICIES:
        mesh = _jax_mesh(policy, eight_devices)
        p_sh = param_shardings(jstate0["params"], mesh, policy,
                               min_fsdp_size=W.MIN_FSDP)
        st = dict(jstate0, params=shard_params(jstate0["params"], p_sh))
        st["opt_state"] = jax.device_put(st["opt_state"], opt_state_shardings(
            st["opt_state"], p_sh, mesh, params=jstate0["params"]))
        losses = []
        with jax.set_mesh(mesh):
            for b, k in zip(batches, keys):
                st, m = step(st, jax.device_put(b, batch_sharding(mesh)), k)
                losses.append(float(m["loss"]))
        jax_out[policy] = (losses, {k: np.asarray(v) for k, v in
                                    flatten_params(st["params"]).items()})
    job = dict(kind="mim", config=cfg, opt=OPT, weights=weights,
               batches=batches, masks=masks)
    two = W.run_ranks("steps", 2, {"jobs": {"mim": dict(
        job, runs=[("dp", 1), ("fsdp", 1), ("tp", 2)])}},
        tmp_path_factory.mktemp("two"))
    four = W.run_ranks("steps", 4, {"jobs": {"mim": dict(
        job, runs=[("fsdp+tp", 2)])}}, tmp_path_factory.mktemp("four"))
    return jax_out, {**two, **four}


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_mim_step_matches_jax(mim_runs, policy):
    """Two steps under `policy`: the loss within 1e-3 relative of the JAX
    sharded step at each step, the parameters within 1e-4 (max |d|)."""
    jax_out, port = mim_runs
    mp = 2 if "tp" in policy else 1
    got = port[("mim", policy, mp)]
    want_losses, want_params = jax_out[policy]
    for a, b in zip(got["losses"], want_losses):
        assert abs(a - b) <= 1e-3 * abs(b)
    flat = convert.params_to_flax({k: torch.from_numpy(v)
                                   for k, v in got["params"].items()})
    assert set(flat) == set(want_params)
    err = max(float(np.abs(flat[k] - v).max())
              for k, v in want_params.items())
    assert err < 1e-4
