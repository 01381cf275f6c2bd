"""The port's V-JEPA2 training against the JAX package on the CPU: the EMA
update, the optimizer trajectory of both `make_vjepa_workload`s on the same
weights, batches and masks (teacher included), bitwise resume with the
teacher, and `run_vjepa` end to end (its export loads into the JAX model's
tree)."""

import functools
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.cli import run_vjepa as jrun_vjepa
from smb_vision_tpu.models.configs import VJEPA2Config as JConfig
from smb_vision_tpu.models.vjepa import VJEPA2Model as JModel
from smb_vision_tpu.ops.masking import vjepa_target_mask as jtarget_mask
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.train import vjepa as jvjepa
from smb_vision_tpu.utils.profiling import (
    vjepa_flops_per_sample as jvjepa_flops,
)
from smb_vision_tpu.utils.serialization import (
    flatten_params,
    load_params_into,
)
from smb_vision_tpu_torch.cli import run_vjepa
from smb_vision_tpu_torch.data.dataset import BatchLoader
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VJEPA2Config
from smb_vision_tpu_torch.train import optim as toptim
from smb_vision_tpu_torch.train import vjepa as tvjepa
from smb_vision_tpu_torch.train.trainer import Trainer, TrainingArguments
from smb_vision_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY = dict(crop_size=64, frames_per_clip=32, patch_size=16, tubelet_size=16,
            in_chans=1, hidden_size=64, num_attention_heads=2,
            num_hidden_layers=2, pred_hidden_size=32,
            pred_num_attention_heads=2, pred_num_hidden_layers=1,
            dtype="float32", attn_impl="xla", mlp_impl="xla")
OPT = dict(learning_rate=1e-3, total_steps=3, weight_decay=0.05,
           warmup_ratio=0.34)
PRESET = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "vjepa_large_384_tpu.json")


def _pixels(seed, b=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 32, 1, 64, 64)).astype(np.float32)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    t = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    s = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    want = joptim.ema_update(t, s, 0.99925)
    teacher, student = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in t.items()}
    ), torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in s.items()})
    toptim.ema_update(teacher, student, 0.99925)
    for k in shapes:
        np.testing.assert_array_equal(teacher[k].detach().numpy(),
                                      np.asarray(want[k]))


@pytest.mark.parametrize("head,impl", [(16, "xla"), (32, "pallas_i8bwd")],
                         ids=["pred_d16-xla", "pred_d32-pallas_i8bwd"])
def test_vjepa_trajectory_and_teacher_match_jax(head, impl):
    """Three optimizer steps of both make_vjepa_workloads from the same
    weights on the same batches, the masks drawn on the JAX side as its
    step draws them: the loss within 1e-3 relative at each step, the
    student within 1e-4 and the EMA teacher within 1e-5 after 3 updates.
    The predictor has 2 heads of `head`; at 32 (the reference heads'
    width) under "pallas_i8bwd" the JAX side runs its flash kernels in
    interpret mode and the port the plain versions of K1 and K7."""
    geometry = dict(TINY, pred_hidden_size=2 * head, attn_impl=impl)
    jtx = joptim.make_optimizer(**OPT)
    jcfg = JConfig(**geometry)
    _, jinit, jstep, _ = jvjepa.make_vjepa_workload(jcfg, tx=jtx)
    jstate = jinit(jax.random.PRNGKey(0))
    jstep = jax.jit(jstep)

    model, init_fn, step_fn, _ = tvjepa.make_vjepa_workload(
        VJEPA2Config(**geometry), tx=functools.partial(toptim.make_optimizer,
                                                       **OPT))
    state = init_fn(0)
    model.load_state_dict(convert.params_from_flax(
        flatten_params(jstate["params"]), vjepa=True))
    state["teacher"].load_state_dict(convert.params_from_flax(
        flatten_params(jstate["teacher"]), vjepa=True))
    for i in range(3):
        px = _pixels(10 + i)
        key = jax.random.PRNGKey(100 + i)
        mask = np.asarray(jtarget_mask(jax.random.split(key)[0], 2,
                                       grid=jcfg.grid))
        jstate, jm = jstep(jstate, {"pixel_values": px}, key)
        m = step_fn(state, {"pixel_values": torch.from_numpy(px)},
                    mask=mask)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
            float(jm["loss"])), i
    assert state["step"] == 3 and state["optimizer"].updates == 3
    for tree, module, tol in ((jstate["params"], model, 1e-4),
                              (jstate["teacher"], state["teacher"], 1e-5)):
        got = convert.params_to_flax(module.state_dict())
        want = flatten_params(tree)
        assert set(got) == set(want)
        err = max(float(np.abs(got[k] - np.asarray(v)).max())
                  for k, v in want.items())
        assert err < tol


class _Volumes:
    """An in-memory dataset of seeded volumes."""

    def __init__(self, n):
        self.ds = self
        self.items = list(range(n))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return {"image": _pixels(100 + i, b=1)[0]}


def _trainer(tmp_path, steps, **kw):
    args = TrainingArguments(output_dir=str(tmp_path), num_train_steps=steps,
                             save_steps=2, logging_steps=1, device="cpu",
                             learning_rate=1e-3, warmup_ratio=0.2, seed=7,
                             **kw)
    _, init_fn, step_fn, eval_fn = tvjepa.make_vjepa_workload(
        VJEPA2Config(**TINY, drop_path_rate=0.3, gradient_checkpointing=True),
        tx=functools.partial(toptim.make_optimizer, learning_rate=1e-3,
                             total_steps=4, warmup_ratio=0.2), num_blocks=2)
    return Trainer(args=args, state=init_fn(0), step_fn=step_fn,
                   train_loader=BatchLoader(_Volumes(3), 1, shuffle=True,
                                            seed=7, num_workers=1),
                   eval_loader=BatchLoader(_Volumes(3), 2, drop_last=False,
                                           num_workers=1),
                   eval_fn=eval_fn)


def test_resume_with_the_teacher_is_bitwise(tmp_path):
    """4 steps straight against 2 steps + resume + 2, with DropPath and
    remat on: bitwise equal student, teacher and optimizer state, the same
    logged losses, and a padded eval."""
    straight = _trainer(tmp_path / "a", 4)
    assert straight.train() == {"train_steps": 4}
    _trainer(tmp_path / "b", 2).train()
    resumed = _trainer(tmp_path / "b", 4)
    assert resumed.train() == {"train_steps": 4}
    a, b = straight.state, resumed.state
    for key in ("model", "teacher"):
        for (name, x), y in zip(a[key].state_dict().items(),
                                b[key].state_dict().values()):
            assert torch.equal(x, y), (key, name)
    assert not torch.equal(a["model"].state_dict()["predictor.proj.weight"],
                           a["teacher"].state_dict()["predictor.proj.weight"])
    sa, sb = a["optimizer"].state_dict(), b["optimizer"].state_dict()
    for pa, pb in zip(sa["adamw"]["state"].values(),
                      sb["adamw"]["state"].values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k

    def losses(d):
        return [json.loads(line)["loss"]
                for line in (d / "metrics.jsonl").read_text().splitlines()]

    assert losses(tmp_path / "a") == losses(tmp_path / "b")
    rec = resumed.evaluate(step=4)
    assert np.isfinite(rec["eval_loss"])
    assert rec["eval_loss"] == resumed.evaluate()["eval_loss"]


def test_sigterm_checkpoint_holds_the_teacher(tmp_path):
    trainer = _trainer(tmp_path, 4)
    inner = trainer.step_fn

    def step_fn(state, batch, generator):
        if state["step"] == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(state, batch, generator)

    trainer.step_fn = step_fn
    assert trainer.train() == {"train_steps": 1}
    blob = torch.load(tmp_path / "checkpoints" / "1" / "state.pt",
                      weights_only=True)
    teacher = trainer.state["teacher"].state_dict()
    assert blob["teacher"].keys() == teacher.keys()
    for k, v in teacher.items():
        assert torch.equal(blob["teacher"][k], v), k
    # a checkpoint without a teacher does not resume a V-JEPA run
    del blob["teacher"]
    torch.save(blob, tmp_path / "checkpoints" / "1" / "state.pt")
    with pytest.raises(ValueError, match="teacher"):
        _trainer(tmp_path, 4).train()


@pytest.fixture
def volumes(tmp_path):
    rng = np.random.default_rng(0)
    items = []
    for i in range(4):
        hu = rng.normal(-200, 400, (32, 32, 32)).clip(-1024, 3000)
        path = tmp_path / f"ct_{i}.nii"
        save_nifti(path, hu.astype(np.int16), np.diag([3.0, 3.0, 6.0, 1.0]))
        items.append({"image": str(path)})
    spec = tmp_path / "data.json"
    spec.write_text(json.dumps({"train": items[:3], "validation": items[3:]}))
    return spec


def _cli_args(spec, out, steps):
    return ["--data_path", str(spec), "--output_dir", str(out),
            "--image_size", "64", "--depth", "32", "--patch_size", "16",
            "--hidden_size", "64", "--num_hidden_layers", "2",
            "--num_attention_heads", "2", "--pred_hidden_size", "32",
            "--pred_num_hidden_layers", "1", "--pred_num_attention_heads",
            "2", "--dtype", "float32", "--attn_impl", "xla",
            "--mlp_impl", "xla", "--teacher_attn_impl", "xla",
            "--num_mask_blocks", "2", "--gradient_checkpointing", "true",
            "--config_overrides", "drop_path_rate=0.1",
            "--num_train_steps", str(steps), "--save_steps", "2",
            "--logging_steps", "1", "--do_eval", "true", "--device", "cpu",
            "--num_workers", "2"]


def test_run_vjepa_trains_resumes_and_exports_for_jax(volumes, tmp_path):
    out = tmp_path / "out"
    res = run_vjepa.main(_cli_args(volumes, out, 4))
    assert res["train_steps"] == 4 and np.isfinite(res["eval_loss"])
    res = run_vjepa.main(_cli_args(volumes, out, 6))
    assert res["train_steps"] == 6
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert Trainer.checkpoint_steps(out / "checkpoints") == [2, 4, 6]
    assert "teacher" in torch.load(out / "checkpoints" / "6" / "state.pt",
                                   weights_only=True)
    cfg = json.loads((out / "config.json").read_text())
    assert (cfg["model_type"], cfg["drop_path_rate"], cfg["in_chans"],
            cfg["crop_size"], cfg["frames_per_clip"]) == (
        "vjepa2", 0.1, 1, 64, 32)

    # the export loads into the JAX model's tree, every tensor matched
    jcfg = JConfig(**TINY)
    tb = np.asarray(jtarget_mask(jax.random.PRNGKey(0), 1, grid=jcfg.grid))
    jparams = jax.jit(lambda k, x, t: JModel(jcfg).init(
        k, x, target_bool=t))(jax.random.PRNGKey(1), _pixels(0, b=1), tb)
    new, loaded, skipped = load_params_into(jparams,
                                            out / "model.safetensors")
    assert skipped == [] and len(loaded) == len(flatten_params(jparams))
    flat = flatten_params(new)
    ours = convert.read_safetensors(out / "model.safetensors")
    for k in loaded:
        np.testing.assert_array_equal(np.asarray(flat[k]), ours[k])


@pytest.mark.parametrize("flags,item", [
    (["--pipeline_stages", "2"], "item 9, Multi-GPU"),
    (["--sequence_parallel", "true"], "item 9, Multi-GPU"),
    (["--model_parallel", "2"], "item 9, Multi-GPU"),
])
def test_run_vjepa_unported_flags_raise(volumes, tmp_path, flags, item):
    """Step 2 of item 9 is ported: --pipeline_stages 2 and --model_parallel
    2 on one process raise the mesh's own error (the stages ride the model
    axis), and --sequence_parallel trains (over a model axis of 1)."""
    args = _cli_args(volumes, tmp_path / "o", 1) + flags
    if flags[0] in ("--pipeline_stages", "--model_parallel"):
        with pytest.raises(ValueError, match="not divisible by model=2"):
            run_vjepa.main(args)
    else:
        assert run_vjepa.main(args)["train_steps"] == 1


@pytest.mark.parametrize("flag", ["cache_data_dir", "device_cache",
                                  "export_hf", "model_name_or_path"])
def test_run_vjepa_ported_flags_run(volumes, tmp_path, flag):
    """The flags the port once refused: a filled cache, a device cache
    read once, the HF export, and continued pretraining from an HF-layout
    export, the whole student loaded and the EMA teacher its copy."""
    from smb_vision_tpu_torch.models.configs import VJEPA2Config
    from smb_vision_tpu_torch.models.vjepa import VJEPA2Model

    out = tmp_path / "o"
    args = _cli_args(volumes, out, 2)
    starts = []
    if flag == "model_name_or_path":
        cfg = VJEPA2Config(**TINY)
        src = VJEPA2Model(cfg).init_weights(
            torch.Generator().manual_seed(5))
        hf = convert.export_hf_vjepa2(src.state_dict())
        convert.write_safetensors(tmp_path / "hf.safetensors", hf)
        args += ["--model_name_or_path", str(tmp_path / "hf.safetensors")]
        real = Trainer.__init__

        def init(self, *a, **kw):
            real(self, *a, **kw)
            starts.append({k: (v.clone(), self.state["teacher"]
                               .state_dict()[k].clone())
                           for k, v in self.state["model"]
                           .state_dict().items()})
    else:
        value = {"cache_data_dir": str(tmp_path / "cache"),
                 "device_cache": "true", "export_hf": "true"}[flag]
        args += [f"--{flag}", value]
    with pytest.MonkeyPatch.context() as mp:
        if flag == "model_name_or_path":
            mp.setattr(Trainer, "__init__", init)
        assert run_vjepa.main(args)["train_steps"] == 2
    if flag == "cache_data_dir":
        assert len(list((tmp_path / "cache").glob("*.npy"))) == 4
    elif flag == "export_hf":
        hf = convert.read_safetensors(out / "hf_model.safetensors")
        assert "encoder.layer.0.attention.query.weight" in hf
        assert "predictor.layer.0.mlp.fc2.weight" in hf
    elif flag == "model_name_or_path":
        (start,) = starts
        want = src.state_dict()
        assert set(start) == set(want)
        for k, (student, teacher) in start.items():
            assert torch.equal(student, want[k]), k
            assert torch.equal(teacher, student), k


def test_run_vjepa_cuda_without_cuda_raises(volumes, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(volumes, tmp_path / "o", 1)
    args[args.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_vjepa.main(args)


def test_build_config_matches_jax_on_the_preset(tmp_path):
    """The shipped preset's model flags, and a config file with flags on
    top, give the JAX run_vjepa's config; its FLOP count is the JAX
    package's (61.5 TFLOP a sample)."""
    preset = json.loads(open(PRESET).read())

    def both(**kw):
        names = {f for f in run_vjepa.ModelArguments.__dataclass_fields__}
        kw = {k: v for k, v in kw.items() if k in names}
        got = run_vjepa.build_config(run_vjepa.ModelArguments(**kw))
        want = jrun_vjepa.build_config(jrun_vjepa.ModelArguments(**kw))
        for name in VJEPA2Config.__dataclass_fields__:
            assert getattr(got, name) == getattr(want, name), name
        return got

    cfg = both(**preset)
    assert (cfg.grid, cfg.seq_len, cfg.head_dim, cfg.pred_head_dim) == (
        (16, 24, 24), 9216, 128, 128)
    assert (cfg.attn_impl, cfg.mlp_impl, cfg.gradient_checkpointing) == (
        "pallas_i8bwd", "pallas_bwd", True)
    path = tmp_path / "cfg.json"
    cfg.save_json(str(path))
    both(config_name_or_path=str(path), mlp_impl="xla",
         config_overrides="gradient_checkpointing=false,drop_path_rate=0.1")
    flops = profiling.vjepa_flops_per_sample(cfg)
    assert flops == jvjepa_flops(JConfig(**{
        k: getattr(cfg, k) for k in JConfig.__dataclass_fields__
        if hasattr(cfg, k)}))
    assert round(flops / 1e12, 1) == 61.5
