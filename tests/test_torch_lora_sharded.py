"""The port's LoRA fine-tuning under "fsdp", "tp" and "fsdp+tp" on 4 gloo
ranks against the JAX package's LoRA workload placed as its Trainer places
it (`Trainer._apply_shardings`: the frozen base by the policy, the
adapters and the head replicated, the optimizer state by
`opt_state_shardings`) on the same mesh shape of the CPU devices: the
tiny VideoMAE and DINOv2 of tests/test_torch_lora.py, each step's loss and
the adapters and the head after each of three steps; the layout the
Trainer gives the port's model; and a sharded Trainer run under
"fsdp+tp" (its `lora.safetensors` read by the JAX package, its
`model_merged.safetensors` against one process's, a SIGTERM on one rank
and the resume bit for bit the straight run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.parallel.mesh import batch_sharding, replicated
from smb_vision_tpu.parallel.mesh import create_mesh as jcreate_mesh
from smb_vision_tpu.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_params,
)
from smb_vision_tpu.train import lora as jlora
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.utils.serialization import (
    flatten_params,
    load_params_safetensors,
)
from smb_vision_tpu_torch.models import convert
from test_torch_lora import FAMILIES, KEY
from test_torch_parallel import _dcp_tensors, _losses

torch.set_num_threads(1)

# the model axis of each policy on 4 ranks: (4, 1), (2, 2), (2, 2)
POLICIES = {"fsdp": 1, "tp": 2, "fsdp+tp": 2}
B = 4
# every (32, 32) matrix of the tiny VideoMAE and larger is sharded
MIN_FSDP = 1024
OPT = dict(learning_rate=1e-3, total_steps=3, vision_lr=2e-3,
           merger_lr=1e-2, weight_decay=0.1)
TOL = 1e-3      # test_lora_workload_trajectory_matches_jax's, relative
TRAIN = "dinov2"    # the family of the Trainer runs


def _batches(family, n=3, seed=5):
    shape = FAMILIES[family][5]
    rng = np.random.default_rng(seed)
    return [{"pixel_values": rng.uniform(0, 1, (B, *shape))
             .astype(np.float32),
             "labels": rng.integers(0, 2, B).astype(np.int32)}
            for _ in range(n)]


def _lora_flat(tree) -> dict:
    """A JAX `lora` tree as `lora.safetensors` names it."""
    out = {f"adapters.{p}.{ab}": np.asarray(v[ab])
           for p, v in tree["adapters"].items() for ab in "ab"}
    out.update({f"head.{p}": np.asarray(v) for p, v in tree["head"].items()})
    return out


def _jax_family(family, devices):
    """The JAX model and base, the initial LoRA state, and three steps of
    its workload under each policy, placed as its Trainer places a state,
    on the (4 / model, model) mesh of the first 4 devices. Returns the
    port's job (the same base, adapters and batches) and the JAX steps
    (loss, `_lora_flat`) by policy, the initial `_lora_flat` under
    "init"."""
    _, jcfg, jcls, _, geom, _ = FAMILIES[family]
    jmodel = jcls(jcfg(**geom))
    batches = _batches(family)
    params = jax.jit(jmodel.init)(KEY, batches[0]["pixel_values"][:1])
    jinit, jstep, _ = jlora.make_lora_classification_workload(
        jmodel, jmodel.config, task_type="classification",
        tx=joptim.make_optimizer(**OPT), rank=4)
    state0 = jinit(KEY, jax.tree_util.tree_map(jnp.asarray, batches[0]),
                   params)
    step = jax.jit(jstep)
    want = {"init": _lora_flat(state0["lora"])}
    for policy, model in POLICIES.items():
        mesh = jcreate_mesh(model=model, devices=devices[:4])
        p_sh = param_shardings(state0["params"], mesh, policy,
                               min_fsdp_size=MIN_FSDP)
        st = {k: jax.device_put(v, replicated(mesh))
              for k, v in state0.items()
              if k not in ("params", "opt_state")}
        st["params"] = shard_params(state0["params"], p_sh)
        st["opt_state"] = jax.device_put(
            state0["opt_state"], opt_state_shardings(
                state0["opt_state"], p_sh, mesh, params=state0["params"]))
        steps = []
        with jax.set_mesh(mesh):
            for b in batches:
                st, m = step(st, jax.device_put(b, batch_sharding(mesh)),
                             KEY)
                steps.append((float(m["loss"]), _lora_flat(st["lora"])))
        want[policy] = steps
    job = dict(family=family, config=geom, opt=OPT, batches=batches,
               min_fsdp=MIN_FSDP,
               base={k: v.numpy() for k, v in convert.params_from_flax(
                   flatten_params(params), classification=True,
                   backbone=family).items()},
               adapters=jax.tree_util.tree_map(
                   np.asarray, state0["lora"]["adapters"]))
    return jmodel, job, want


@pytest.fixture(scope="module")
def runs(eight_devices, tmp_path_factory):
    jax_side, jobs = {}, {}
    for family in FAMILIES:
        jmodel, job, want = _jax_family(family, eight_devices)
        jax_side[family] = (jmodel, job, want)
        for policy, model in POLICIES.items():
            jobs[f"{family} {policy}"] = dict(job, policy=policy,
                                              model=model)
    train = dict(jax_side[TRAIN][1], policy="fsdp+tp", model=2,
                 batches=_batches(TRAIN, n=4, seed=9))
    work = tmp_path_factory.mktemp("lora_sharded")
    got = W.run_ranks("many", 4, {"cases": {
        "steps": ("lora_steps", {"jobs": jobs}),
        "ckpt": ("ckpt", train)}}, work)
    return jax_side, got, train, work


def _dist(a: dict, b: dict) -> float:
    """The Euclidean distance between two sets of tensors of b's names."""
    return float(np.sqrt(sum(float(((a[k] - v).astype(np.float64) ** 2)
                                   .sum()) for k, v in b.items())))


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_lora_steps_match_jax(runs, family, policy):
    """Three steps under the policy, each rank on its rows of the global
    batch of 4: each step's loss within 1e-3 relative of the JAX
    workload's placed the same way, and the adapters (a, b) and the head
    after each step within 1e-3 of the distance the JAX steps moved them
    from their start. That distance is the scale, not each tensor's
    largest value: AdamW's first steps normalise gradients of rounding
    size (a last layer's attention proj) to steps of lr, which moves
    single entries by up to 1e-2 of their tensor's largest value between
    two placements of the JAX package itself; the whole set moves 1e-4 of
    its step there."""
    jax_side, got, _, _ = runs
    want = jax_side[family][2]
    steps = got["steps"][f"{family} {policy}"]["steps"]
    assert len(steps) == len(want[policy]) == 3
    for (loss, tensors), (jloss, jtensors) in zip(steps, want[policy]):
        assert abs(loss - jloss) <= TOL * abs(jloss)
        assert set(jtensors) <= set(tensors)
        moved = _dist(jtensors, want["init"])
        assert moved > 0
        assert _dist(tensors, jtensors) <= TOL * moved


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sharded_lora_layout(runs, policy):
    """The Trainer's placement of a LoRA model: an adapted weight's frozen
    base split as the policy says (over "model" for the tp policies,
    over "data" for fsdp), its adapters and the head whole on every rank
    (plain tensors), and the optimizer's state over the trainable
    tensors alone."""
    jax_side, got, _, _ = runs
    for family in FAMILIES:
        r = got["steps"][f"{family} {policy}"]
        placed = r["placed"]
        q = [n for n in placed if n.endswith(
            "layer_0.attention.query.parametrizations.weight.original")]
        assert len(q) == 1, family
        where = placed[q[0]]
        assert "Shard" in where, (family, where)
        for axis in ("data", "model"):
            assert (f"'{axis}'" in where) == (
                axis == "model" if policy == "tp" else
                axis == "data" if policy == "fsdp" else True), where
        trained = [n for n in placed if ".parametrizations.weight.0." in n
                   or "classifier" in n]
        assert trained and all(placed[n] == "plain" for n in trained)
        n_trained = len(jax_side[family][2]["init"])
        assert r["opt_state"] == n_trained, family


def test_sharded_lora_run_resumes_bitwise(runs):
    """Under fsdp+tp on 4 ranks: a SIGTERM on rank 1 after step 2 stops
    every rank there with one checkpoint; the resume to step 4 gives the
    straight run's parameters, checkpoint, model.safetensors,
    lora.safetensors and model_merged.safetensors byte for byte, and its
    logged losses."""
    _, got, _, work = runs
    res = got["ckpt"]
    assert res["b_stopped"] == 2 and res["b"]["train_steps"] == 4
    for k, v in res["a"]["params"].items():
        np.testing.assert_array_equal(res["b"]["params"][k], v, err_msg=k)
    a = _dcp_tensors(work / "a" / "checkpoints" / "4", work / "a.pt")
    b = _dcp_tensors(work / "b" / "checkpoints" / "4", work / "b.pt")
    assert set(a) == set(b) and len(a) > 50
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for f in ("model", "lora", "model_merged"):
        assert (work / "a" / f"{f}.safetensors").read_bytes() == (
            work / "b" / f"{f}.safetensors").read_bytes(), f
    assert _losses(work / "a") == _losses(work / "b")


def test_sharded_lora_exports(runs, tmp_path):
    """The 4-rank fsdp+tp run's exports against one process's run of the
    same weights and batches: model.safetensors (the frozen base) equal,
    model_merged.safetensors within 1e-6 of its largest value; and its
    lora.safetensors, read by the JAX package onto its model.safetensors
    (`load_params_safetensors`, `merge_lora`), gives the logits of the
    merged export within 1e-5 of max."""
    jax_side, _, train, work = runs
    out = W.train_run(train, tmp_path / "one", 4)
    assert out["train_steps"] == 4
    one, four = tmp_path / "one", work / "a"
    base1 = convert.read_safetensors(one / "model.safetensors")
    base4 = convert.read_safetensors(four / "model.safetensors")
    assert set(base1) == set(base4)
    for k, v in base1.items():
        np.testing.assert_array_equal(base4[k], v, err_msg=k)
    m1 = convert.read_safetensors(one / "model_merged.safetensors")
    m4 = convert.read_safetensors(four / "model_merged.safetensors")
    assert set(m1) == set(m4)
    top = max(float(np.abs(v).max()) for v in m1.values())
    err = max(float(np.abs(m4[k] - v).max()) for k, v in m1.items())
    assert err <= 1e-6 * top, err
    moved = [k for k in m1 if not np.array_equal(m1[k], base1[k])]
    assert moved, "the merged export equals the base"
    jmodel = jax_side[TRAIN][0]
    px = train["batches"][0]["pixel_values"]
    tree = load_params_safetensors(four / "lora.safetensors")
    base = load_params_safetensors(four / "model.safetensors")
    got = jmodel.apply(jlora.merge_lora(base, tree, train=False),
                       px)["logits"]
    want = jmodel.apply(load_params_safetensors(
        four / "model_merged.safetensors"), px)["logits"]
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())
