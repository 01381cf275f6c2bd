"""The port's multi-process layer on the CPU: the mesh functions against
the JAX package's (shapes, errors, the launcher environment rules), the
Cox loss and the eval metrics over 2 gloo ranks against one process, the
sharded checkpoints (a SIGTERM on one rank and the resume byte for byte, a
world-2 checkpoint resumed by one process, the 2-rank export against a
1-rank one), the three training CLIs under `torch.distributed.run` on 2
gloo ranks, and the refusals that stay: the parts of step 2 of ROADMAP
queue 1 item 9 still refused and --device cuda without CUDA."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.parallel import mesh as jmesh
from smb_vision_tpu_torch.cli import run_classification, run_mim, run_vjepa
from smb_vision_tpu_torch.cli import run_inference as tinfer
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
B = 4


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw", [dict(model=2), dict(data=2), dict(model=3),
                                dict(data=1, dcn=2), {}])
def test_create_mesh_matches_jax_on_one_device(eight_devices, kw):
    """One process: the same errors as the JAX function on one device;
    a 1 x 1 mesh is None (single-device training)."""
    want = _err(lambda: jmesh.create_mesh(devices=eight_devices[:1], **kw))
    got = _err(lambda: tmesh.create_mesh(**kw))
    assert got == want
    if want is None:
        assert tmesh.create_mesh(**kw) is None


def test_local_batch_slice_and_init_batch_size(eight_devices):
    jm = jmesh.create_mesh(devices=eight_devices[:1])
    assert tmesh.local_batch_slice(8, None) == jmesh.local_batch_slice(8, jm)
    assert tmesh.local_batch_slice(8, 2) == 4
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.local_batch_slice(7, 2)
    assert tmesh.init_batch_size() == jmesh.init_batch_size() == 1


LAUNCH = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("env,enable,device,outcome", [
    ({}, None, "cpu", False),
    ({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "1"}, False, "cpu", False),
    ({"RANK": "0"}, None, "cpu", "warn"),
    ({}, True, "cpu", "MASTER_ADDR"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "RANK": "0"}, None,
     "cpu", "MASTER_PORT"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1",
      "RANK": "0", "LOCAL_RANK": "0"}, None, "cuda", "CUDA is not available"),
])
def test_maybe_initialize_distributed_env_rules(monkeypatch, caplog, env,
                                                enable, device, outcome):
    """No launcher: one process. Only guessed from an incomplete
    environment of one process: a warning and one process. Forced, or
    several processes launched, without the rendezvous variables or
    without CUDA for NCCL: an error; never a fallback."""
    for k in LAUNCH:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if outcome is False:
        assert tmesh.maybe_initialize_distributed(enable, device) is False
        assert not torch.distributed.is_initialized()
    elif outcome == "warn":
        assert tmesh.maybe_initialize_distributed(enable, device) is False
        assert "continuing as one process" in caplog.text
    else:
        with pytest.raises(RuntimeError, match=outcome):
            tmesh.maybe_initialize_distributed(enable, device)
        assert not torch.distributed.is_initialized()


def test_maybe_initialize_distributed_under_a_launcher(tmp_path):
    """torch.distributed.run with one process: gloo on --device cpu, a
    second call a no-op, a 1 x 1 mesh."""
    code = ("from smb_vision_tpu_torch.parallel import mesh as m; "
            "import torch.distributed as d; "
            "print(m.maybe_initialize_distributed(None, 'cpu'), "
            "m.maybe_initialize_distributed(None, 'cpu'), d.get_backend(), "
            "tuple(m.create_mesh().shape)); d.destroy_process_group()")
    out = _torchrun(None, tmp_path, code=code)
    assert "True True gloo (1, 1)" in out


def _torchrun(argv, tmp_path, nproc=1, code=None, timeout=240):
    """python -m torch.distributed.run --standalone (a free port) with
    `nproc` processes of `-m module argv` or of a script."""
    if code is not None:
        script = tmp_path / "script.py"
        script.write_text(code)
        target = [str(script)]
    else:
        target = argv
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in LAUNCH:
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *target], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    return r.stdout + r.stderr


@pytest.fixture(scope="module")
def basics(eight_devices, tmp_path_factory):
    rng = np.random.default_rng(4)
    model, init_fn, *_ = W.make_workload(
        "cls", W.CLS_TINY, dict(learning_rate=1e-3, total_steps=1), 1)
    init_fn(0)
    weights = {k: v.detach().numpy().copy()
               for k, v in model.state_dict().items()}

    def batch(n):
        return {"pixel_values": rng.uniform(0, 1, (n, 32, 1, 32, 32))
                .astype(np.float32),
                "duration": rng.uniform(10, 900, n).astype(np.float32),
                "event": (rng.uniform(size=n) > 0.3).astype(np.float32),
                "additional_features": rng.normal(size=(n, 1))
                .astype(np.float32)}

    spec = {"risk": rng.normal(size=6).astype(np.float32),
            "duration": np.array([5, 3, 9, 3, 1, 7], np.float32),
            "event": np.array([1, 0, 1, 1, 0, 1], np.float32),
            "valid": np.array([1, 1, 1, 0, 1, 0], np.float32),
            "weights": weights, "eval": [batch(4), batch(3)]}
    work = tmp_path_factory.mktemp("basics")
    got = W.run_ranks("basics", 2, spec, work)
    want = W.cox_and_eval(dict(spec, work=str(work / "one")))
    jax_err = {}
    for kw in ({"model": 3}, {"data": 3}, {"data": 1, "dcn": 2}):
        jax_err[str(sorted(kw.items()))] = _err(
            lambda: jmesh.create_mesh(devices=eight_devices[:2], **kw))
    return got, want, jax_err


def test_mesh_at_world_two_matches_jax(basics):
    got, _, jax_err = basics
    assert got["shapes"] == {
        "[]": ((2, 1), 4), "[]" + " init": 2,
        "[('model', 2)]": ((1, 2), 8), "[('model', 2)] init": 1,
        "[('data', 2), ('dcn', 2)]": ((2, 1), 4),
        "[('data', 2), ('dcn', 2)] init": 2}
    assert got["errors"] == jax_err
    assert got["again"] is True


@pytest.mark.parametrize("case", ["plain", "valid"])
def test_cox_loss_over_two_ranks_matches_one_process(basics, case):
    """The risk sets span both ranks' rows: the loss, and the gradient of
    the risks (each rank's share times 2, the mean the sync takes), as one
    process computes them over the global batch."""
    got, want, _ = basics
    assert abs(got[case][0] - want[case][0]) <= 1e-6 * abs(want[case][0])
    np.testing.assert_allclose(got[case][1] / 2, want[case][1], rtol=1e-6,
                               atol=1e-7)


def test_eval_metrics_over_two_ranks_match_one_process(basics):
    """Trainer.evaluate on 2 ranks: each reads the global eval batch
    (padded to a multiple of 2) and runs its rows; the loss and the
    C-index are those of one process."""
    got, want, _ = basics
    assert set(got["eval"]) == set(want["eval"]) >= {"eval_loss",
                                                     "eval_c_index"}
    for k, v in want["eval"].items():
        assert abs(got["eval"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k

# -- checkpoints --------------------------------------------------------------

def _ckpt_spec(policy):
    rng = np.random.default_rng(11)
    mcfg = dict(W.GEOM, **W.MIM_TINY)
    opt = dict(learning_rate=1e-3, total_steps=4, weight_decay=0.05,
               grad_clip=0.05)
    model, init_fn, *_ = W.make_workload("mim", mcfg, opt, 1)
    init_fn(0)
    batches = [{"pixel_values": rng.uniform(0, 1, (B, 32, 1, 32, 32))
                .astype(np.float32)} for _ in range(4)]
    return dict(config=mcfg, opt=opt, batches=batches, policy=policy,
                weights={k: v.detach().numpy().copy()
                         for k, v in model.state_dict().items()})


def _dcp_tensors(path, tmp):
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

    dcp_to_torch_save(str(path), str(tmp))
    flat = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(obj, torch.Tensor):
            flat[prefix] = obj

    walk("", torch.load(tmp, weights_only=False))
    return flat


def _losses(out):
    import json

    return {r["step"]: r["loss"] for r in map(
        json.loads, (out / "metrics.jsonl").read_text().splitlines())
        if "loss" in r}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    spec = _ckpt_spec("fsdp")
    work = tmp_path_factory.mktemp("ckpt")
    res = W.run_ranks("ckpt", 2, spec, work)
    return spec, work, res


def test_sigterm_on_one_rank_and_resume_is_bitwise(ckpt, tmp_path):
    """At world 2 under fsdp: a SIGTERM on rank 1 after step 2 stops both
    ranks there with one checkpoint; the resume to step 4 gives the
    straight run's parameters, checkpoint and model.safetensors byte for
    byte, and its logged losses."""
    spec, work, res = ckpt
    assert res["b_stopped"] == 2 and res["b"]["train_steps"] == 4
    for k, v in res["a"]["params"].items():
        np.testing.assert_array_equal(res["b"]["params"][k], v)
    a = _dcp_tensors(work / "a" / "checkpoints" / "4", tmp_path / "a.pt")
    b = _dcp_tensors(work / "b" / "checkpoints" / "4", tmp_path / "b.pt")
    assert set(a) == set(b) and len(a) > 100
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert (work / "a" / "model.safetensors").read_bytes() == (
        work / "b" / "model.safetensors").read_bytes()
    assert _losses(work / "a") == _losses(work / "b")


def test_world2_checkpoint_resumes_in_one_process(ckpt, tmp_path):
    """The world-2 checkpoint of step 2 resumed by one process: steps 3
    and 4 log the world-2 run's losses within 1e-5 relative."""
    spec, work, _ = ckpt
    shutil.copytree(work / "a" / "checkpoints" / "2",
                    tmp_path / "c" / "checkpoints" / "2")
    out = W.train_run(spec, tmp_path / "c", 4)
    assert out["train_steps"] == 4
    want, got = _losses(work / "a"), _losses(tmp_path / "c")
    assert sorted(got) == [3, 4]
    for s in (3, 4):
        assert abs(got[s] - want[s]) <= 1e-5 * abs(want[s])


def test_model_export_of_two_ranks_matches_one(ckpt, tmp_path):
    """The final model.safetensors of the 2-rank run against a 1-rank
    run's: the same names and shapes, the values within 1e-4."""
    spec, work, _ = ckpt
    W.train_run(spec, tmp_path / "d", 4)
    two = convert.read_safetensors(work / "a" / "model.safetensors")
    one = convert.read_safetensors(tmp_path / "d" / "model.safetensors")
    assert {k: v.shape for k, v in two.items()} == {
        k: v.shape for k, v in one.items()}
    assert max(float(np.abs(two[k] - one[k]).max()) for k in one) < 1e-4


def test_mim_masks_are_the_global_draw(tmp_path):
    """The step's masks are drawn for the global batch from the step's
    generator and sliced by rank: two ranks' Trainer steps see the rows
    one process draws (the loss equal within 1e-5)."""
    spec = _ckpt_spec("dp")
    spec["batches"] = spec["batches"][:2]
    spec["opt"]["total_steps"] = 2
    got = W.run_ranks("ckpt_losses", 2, spec, tmp_path / "w")
    W.train_run(spec, tmp_path / "one", 2)
    want = _losses(tmp_path / "one")
    for s, v in want.items():
        assert abs(got[s] - v) <= 1e-5 * abs(v)


# -- the CLIs on 2 ranks ------------------------------------------------------

@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    root = tmp_path_factory.mktemp("vols")
    rng = np.random.default_rng(0)
    items = []
    for i in range(8):
        hu = rng.normal(-200, 400, (16, 16, 16)).clip(-1024, 3000)
        path = root / f"ct_{i}.nii"
        save_nifti(path, hu.astype(np.int16), np.diag([6.0, 6.0, 6.0, 1.0]))
        items.append({"image": str(path), "os": float(3 + 2 * i % 7),
                      "os_event": float(i % 3 != 1), "age": 40.0 + 5 * i})
    spec = root / "data.json"
    spec.write_text(json.dumps({"train": items[:6], "validation": items[6:]}))
    return spec


COMMON = ["--image_size", "32", "--depth", "32", "--patch_size", "16",
          "--hidden_size", "64", "--num_hidden_layers", "2",
          "--num_attention_heads", "2", "--dtype", "float32",
          "--attn_impl", "xla", "--mlp_impl", "xla", "--num_train_steps", "3",
          "--save_steps", "2", "--logging_steps", "1", "--do_eval", "true",
          "--device", "cpu", "--num_workers", "1"]
CLIS = {
    "run_mim": lambda spec: [
        "--json_path", str(spec), "--mask_patch_size", "16",
        "--mask_ratio", "0.5", "--intermediate_size", "128",
        "--gradient_checkpointing", "true", "--config_overrides",
        "decoder_hidden_size=64,decoder_num_hidden_layers=1,"
        "decoder_intermediate_size=128,decoder_num_attention_heads=2",
        "--sharding_policy", "fsdp"],
    "run_vjepa": lambda spec: [
        "--data_path", str(spec), "--pred_hidden_size", "32",
        "--pred_num_hidden_layers", "1", "--pred_num_attention_heads", "2",
        "--teacher_attn_impl", "xla", "--num_mask_blocks", "2",
        "--sharding_policy", "tp", "--model_parallel", "2"],
    "run_classification": lambda spec: [
        "--train_data_path", str(spec), "--val_data_path", str(spec),
        "--task_type", "survival", "--additional_feature_columns", "age",
        "--intermediate_size", "128", "--model_type", "videomae",
        "--per_device_eval_batch_size", "2", "--sharding_policy", "dp"],
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_trains_on_two_gloo_ranks(volumes, tmp_path, cli):
    """Each training CLI under torch.distributed.run on 2 gloo ranks
    (run_mim fsdp, run_vjepa tp over a model axis of 2, run_classification
    dp): rank 0 logs every step and the eval, the checkpoints are sharded
    (`meta.pt`), and model.safetensors and config.json are written once,
    finite."""
    out = tmp_path / "out"
    _torchrun(["-m", f"smb_vision_tpu_torch.cli.{cli}", *COMMON,
               *CLIS[cli](volumes), "--output_dir", str(out)], tmp_path,
              nproc=2)
    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert any("eval_loss" in r for r in recs)
    if cli == "run_classification":
        assert any("eval_c_index" in r for r in recs)
    for step in (2, 3):
        assert (out / "checkpoints" / str(step) / "meta.pt").exists()
    export = convert.read_safetensors(out / "model.safetensors")
    assert export and all(np.isfinite(v).all() for v in export.values())
    assert (out / "config.json").exists()


@pytest.mark.parametrize("call", [
    lambda: run_mim.main(["--device", "cpu", "--sequence_parallel", "true",
                          "--sharding_policy", "tp"]),
    lambda: run_vjepa.main(["--device", "cpu", "--sequence_parallel",
                            "true", "--sharding_policy", "fsdp+tp"]),
    lambda: tinfer.main(["--device", "cpu", "--pipeline_parallel", "2",
                         "--sliding_window", "true"]),
])
def test_step_two_flags_still_raise(call):
    """Context and pipeline parallelism (step 2 of the item) run
    (tests/test_torch_sequence_parallel.py, test_torch_pipeline.py); what
    of them stays refused names ROADMAP queue 1 item 9: sequence
    parallelism under the "tp" policies and the pipeline with the sliding
    window."""
    with pytest.raises(NotImplementedError, match="item 9, Multi-GPU"):
        call()


@pytest.mark.parametrize("main", [run_mim.main, run_vjepa.main,
                                  run_classification.main])
def test_cuda_ranks_without_cuda_raise(monkeypatch, main):
    """WORLD_SIZE=2 on --device cuda without CUDA: an error before any
    process group, never gloo or the CPU."""
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--device", "cuda"])
    assert not torch.distributed.is_initialized()
