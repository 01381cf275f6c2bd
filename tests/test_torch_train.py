"""The port's MIM training against the JAX package on the CPU: the
schedule, the optimizer trajectory of both `make_mim_workload`s on the same
weights, batches and masks, gradient accumulation, bitwise resume, and
`run_mim` end to end (its export loads into the JAX model's tree)."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JPre
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.train import mim as jmim
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.utils.serialization import (
    flatten_params,
    load_params_into,
)
from smb_vision_tpu_torch.cli import run_mim
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.ops.masking import mim_mask, num_masked_tokens
from smb_vision_tpu_torch.train import mim as tmim
from smb_vision_tpu_torch.train import optim as toptim
from smb_vision_tpu_torch.train.trainer import (
    Trainer,
    TrainingArguments,
    accumulate_gradients,
)
from smb_vision_tpu_torch.utils import profiling

torch.set_num_threads(1)

GEOM = dict(image_size=64, num_frames=64, patch_size=16, tubelet_size=16)
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, decoder_hidden_size=64,
            decoder_num_hidden_layers=1, decoder_num_attention_heads=2,
            decoder_intermediate_size=128, dtype="float32",
            attn_impl="xla", mlp_impl="xla")
MASK = dict(mask_patch_size=32, mask_ratio=0.5)
OPT = dict(learning_rate=1e-3, total_steps=3, weight_decay=0.05,
           warmup_ratio=0.34)


def _pixels(seed, b=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 64, 1, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0.0, 0.15])
def test_schedule_matches_optax(schedule, warmup):
    kw = dict(total_steps=20, warmup_ratio=warmup, schedule=schedule,
              min_lr=1e-5)
    want = joptim.make_schedule(1e-3, **kw)
    got = toptim.make_schedule(1e-3, **kw)
    for s in range(25):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=1e-12)
    assert got(0) == 0.0 if warmup else got(0) == 1e-3


def test_weight_decay_names():
    assert toptim.is_decayed("mask_token")
    assert toptim.is_decayed("videomae.patch_embed_kernel")
    assert toptim.is_decayed("decoder.layer_0.mlp.fc1.weight")
    for name in ("videomae.patch_embed_bias", "decoder_norm.weight",
                 "videomae.encoder.layer_1.norm2.bias",
                 "encoder.layer_0.attention.query.bias"):
        assert not toptim.is_decayed(name)
    # a frozen BatchNorm's tensors (ResNet3D) are not decayed either
    assert not toptim.is_decayed("layer1_0.cb1.bn.weight")
    assert not toptim.is_decayed("params/stem/bn/mean")
    # optim "adamw8bit" keeps the moments in int8 blocks
    from smb_vision_tpu_torch.train.quantized import AdamW8bit

    w = torch.nn.Parameter(torch.ones(3))
    assert isinstance(toptim.make_optimizer(
        [("w", w)], learning_rate=1e-3, total_steps=3,
        optim="adamw8bit").opt, AdamW8bit)
    with pytest.raises(ValueError, match="unknown optim"):
        toptim.make_optimizer([("w", w)], learning_rate=1e-3,
                              total_steps=3, optim="sgd")
    # two tiers: the head at merger_lr, the backbone at vision_lr, the
    # rest (fc_norm) at learning_rate; each split by weight decay
    names = ("videomae.encoder.layer_0.mlp.fc1.weight", "fc_norm.weight",
             "classifier.weight", "classifier.bias")
    params = [(n, torch.nn.Parameter(torch.zeros(2))) for n in names]
    for _, q in params:
        q.grad = torch.ones(2)
    opt = toptim.make_optimizer(
        params,
        learning_rate=1e-3, total_steps=3, vision_lr=1e-5, merger_lr=3e-4,
        schedule="constant")
    opt.step()
    got = sorted((g["tier"], g["lr"], g["weight_decay"], len(g["params"]))
                 for g in opt.opt.param_groups)
    assert got == [("default", 1e-3, 0.0, 1), ("head", 3e-4, 0.0, 1),
                   ("head", 3e-4, 0.01, 1), ("vision", 1e-5, 0.01, 1)]


def test_mim_trajectory_matches_jax():
    """Three optimizer steps of both make_mim_workloads from the same
    weights on the same batches and masks: the loss within 1e-3 relative
    at each step, and the lr of each update equal to optax's schedule."""
    jcfg = JConfig(**GEOM, **TINY)
    jtx = joptim.make_optimizer(**OPT)
    _, jinit, jstep, _ = jmim.make_mim_workload(jcfg, tx=jtx, **MASK)
    jstate = jinit(jax.random.PRNGKey(0))
    jstep = jax.jit(jstep)

    model, init_fn, step_fn, _ = tmim.make_mim_workload(
        VideoMAEConfig(**GEOM, **TINY), tx=functools.partial(
            toptim.make_optimizer, **OPT), **MASK)
    state = init_fn(0)
    model.load_state_dict(convert.params_from_flax(
        flatten_params(jstate["params"]), pretraining=True))
    sched = joptim.make_schedule(OPT["learning_rate"], 3,
                                 OPT["warmup_ratio"])
    for i in range(3):
        px = _pixels(10 + i)
        key = jax.random.PRNGKey(100 + i)
        mask = np.asarray(jmim_mask(key, 2, input_size=64, depth=64,
                                    model_patch_size=16, **MASK))
        jstate, jm = jstep(jstate, {"pixel_values": px}, key)
        assert state["optimizer"].lr == pytest.approx(float(sched(i)),
                                                      rel=1e-6, abs=1e-12)
        m = step_fn(state, {"pixel_values": torch.from_numpy(px)},
                    mask=mask)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
            float(jm["loss"])), i
    assert state["step"] == 3 and state["optimizer"].updates == 3
    # the update moved the weights as optax did
    got = convert.params_to_flax(model.state_dict())
    want = flatten_params(jstate["params"])
    err = max(float(np.abs(got[k] - np.asarray(v)).max())
              for k, v in want.items())
    assert err < 1e-4


@pytest.mark.parametrize("accum_dtype,tol", [(None, 1e-6),
                                             (torch.bfloat16, 1e-2)])
def test_accumulate_gradients_matches_one_batch(accum_dtype, tol):
    model, init_fn, *_ = tmim.make_mim_workload(
        VideoMAEConfig(**GEOM, **TINY), tx=functools.partial(
            toptim.make_optimizer, **OPT), **MASK)
    init_fn(0)
    nm = num_masked_tokens(64, 64, 32, 16, 0.5)
    gen = torch.Generator().manual_seed(0)
    batch = {"pixel_values": torch.from_numpy(_pixels(5, b=4)),
             "mask": mim_mask(gen, 4, input_size=64, depth=64,
                              model_patch_size=16, **MASK)}
    params = list(model.parameters())

    def loss_fn(b):
        return model(b["pixel_values"], b["mask"], nm)["loss"]

    whole = accumulate_gradients(loss_fn, params, batch)
    want = [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    split = accumulate_gradients(loss_fn, params, batch, 2, accum_dtype)
    assert abs(float(split) - float(whole)) < 1e-6
    for p, w in zip(params, want):
        assert p.grad.dtype == torch.float32
        assert float((p.grad - w).abs().max()) <= tol * float(
            w.abs().max()) + 1e-12


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
    from smb_vision_tpu_torch.data.dataset import BatchLoader

    args = TrainingArguments(output_dir=str(tmp_path), num_train_steps=steps,
                             save_steps=2, logging_steps=1, device="cpu",
                             learning_rate=1e-3, warmup_ratio=0.2, seed=7,
                             **kw)
    _, init_fn, step_fn, eval_fn = tmim.make_mim_workload(
        VideoMAEConfig(**GEOM, **TINY), tx=functools.partial(
            toptim.make_optimizer, learning_rate=1e-3, total_steps=4,
            warmup_ratio=0.2), **MASK)
    loader = BatchLoader(_Volumes(3), 1, shuffle=True, seed=7,
                         num_workers=1)
    return Trainer(args=args, state=init_fn(0), step_fn=step_fn,
                   train_loader=loader, eval_loader=BatchLoader(
                       _Volumes(3), 2, drop_last=False, num_workers=1),
                   eval_fn=eval_fn)


def test_resume_is_bitwise(tmp_path):
    """4 steps straight against 2 steps + resume + 2 (across an epoch
    boundary of 3 batches): bitwise equal parameters and optimizer
    state, the same logged losses, and a padded eval."""
    straight = _trainer(tmp_path / "a", 4)
    assert straight.train() == {"train_steps": 4}
    first = _trainer(tmp_path / "b", 2)
    first.train()
    resumed = _trainer(tmp_path / "b", 4)
    assert resumed.train() == {"train_steps": 4}
    a, b = straight.state, resumed.state
    for (name, x), y in zip(a["model"].state_dict().items(),
                            b["model"].state_dict().values()):
        assert torch.equal(x, y), name
    sa = a["optimizer"].state_dict()
    sb = b["optimizer"].state_dict()
    assert sa["updates"] == sb["updates"] == 4
    for pa, pb in zip(sa["adamw"]["state"].values(),
                      sb["adamw"]["state"].values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k

    def losses(d):
        return [json.loads(line)["loss"]
                for line in (d / "metrics.jsonl").read_text().splitlines()]

    assert losses(tmp_path / "a") == losses(tmp_path / "b")
    assert Trainer.checkpoint_steps(tmp_path / "b" / "checkpoints") == [
        2, 4]
    rec = resumed.evaluate(step=4)
    assert np.isfinite(rec["eval_loss"]) and rec["step"] == 4
    fresh = _trainer(tmp_path / "b", 4, overwrite_output_dir=True)
    assert fresh.maybe_restore() == 0
    assert not (tmp_path / "b" / "checkpoints").exists()


def test_sigterm_checkpoints_at_the_step_boundary(tmp_path):
    """A SIGTERM during step 3 stops the run after that step with a
    checkpoint of it; save_total_limit=1 keeps only the newest."""
    import os
    import signal

    trainer = _trainer(tmp_path, 4, save_total_limit=1)
    inner = trainer.step_fn

    def step_fn(state, batch, generator):
        if state["step"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(state, batch, generator)

    trainer.step_fn = step_fn
    before = signal.getsignal(signal.SIGTERM)
    assert trainer.train() == {"train_steps": 3}
    assert Trainer.checkpoint_steps(tmp_path / "checkpoints") == [3]
    assert signal.getsignal(signal.SIGTERM) == before
    resumed = _trainer(tmp_path, 4, save_total_limit=1)
    assert resumed.train() == {"train_steps": 4}


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
    spec.write_text(json.dumps({"train": items}))
    return spec


def _cli_args(spec, out, steps):
    return ["--json_path", str(spec), "--output_dir", str(out),
            "--image_size", "64", "--depth", "64", "--patch_size", "16",
            "--mask_patch_size", "32", "--mask_ratio", "0.5",
            "--hidden_size", "64", "--num_hidden_layers", "2",
            "--num_attention_heads", "2", "--intermediate_size", "128",
            "--dtype", "float32", "--config_overrides",
            "decoder_hidden_size=64,decoder_num_hidden_layers=1,"
            "decoder_intermediate_size=128,decoder_num_attention_heads=2",
            "--gradient_checkpointing", "true", "--num_train_steps",
            str(steps), "--save_steps", "2", "--logging_steps", "1",
            "--do_eval", "true", "--device", "cpu", "--num_workers", "2"]


def test_run_mim_trains_resumes_and_exports_for_jax(volumes, tmp_path):
    out = tmp_path / "out"
    res = run_mim.main(_cli_args(volumes, out, 4))
    assert res["train_steps"] == 4 and np.isfinite(res["eval_loss"])
    res = run_mim.main(_cli_args(volumes, out, 6))
    assert res["train_steps"] == 6
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in recs if "loss" in r]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) and r["samples_per_sec"] > 0
               for r in recs if "loss" in r)
    assert Trainer.checkpoint_steps(out / "checkpoints") == [2, 4, 6]
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["gradient_checkpointing"] and cfg["decoder_hidden_size"] == 64

    # the export loads into the JAX model's tree, every tensor matched
    jcfg = JConfig(**GEOM, **TINY)
    nm = num_masked_tokens(64, 64, 32, 16, 0.5)
    mask = np.asarray(jmim_mask(jax.random.PRNGKey(0), 1, input_size=64,
                                depth=64, model_patch_size=16, **MASK))
    jparams = jax.jit(JPre(jcfg).init, static_argnums=(3,))(
        jax.random.PRNGKey(1), _pixels(0, b=1), mask, nm)
    new, loaded, skipped = load_params_into(jparams,
                                            out / "model.safetensors")
    assert skipped == [] and len(loaded) == len(flatten_params(jparams))
    flat = flatten_params(new)
    ours = convert.read_safetensors(out / "model.safetensors")
    for k in loaded:
        np.testing.assert_array_equal(np.asarray(flat[k]), ours[k])

    # and it initialises a new run; a checkpoint of another tree does not
    again = tmp_path / "again"
    args = _cli_args(volumes, again, 1) + [
        "--model_name_or_path", str(out / "model.safetensors")]
    assert run_mim.main(args)["train_steps"] == 1
    convert.write_safetensors(tmp_path / "other.safetensors",
                              {"params.head.kernel": np.ones((2, 2),
                                                             np.float32)})
    args[-1] = str(tmp_path / "other.safetensors")
    args[args.index("--output_dir") + 1] = str(tmp_path / "other")
    with pytest.raises(ValueError, match="no tensor"):
        run_mim.main(args)


@pytest.mark.parametrize("flags,item", [
    (["--pipeline_stages", "2"], "item 9, Multi-GPU"),
    (["--model_parallel", "2"], "item 9, Multi-GPU"),
    (["--sharding_policy", "tp"], "item 9, Multi-GPU"),
])
def test_run_mim_unported_flags_raise(volumes, tmp_path, flags, item):
    """The mesh, the policies and the pipeline are ported: --pipeline_stages
    2 and --model_parallel 2 on one process raise the mesh's own error
    (the stages ride the model axis), as `create_mesh` does in the JAX
    package, and --sharding_policy tp trains (the model axis is 1)."""
    args = _cli_args(volumes, tmp_path / "o", 1) + flags
    if flags[0] in ("--pipeline_stages", "--model_parallel"):
        with pytest.raises(ValueError, match="not divisible by model=2"):
            run_mim.main(args)
    else:
        assert run_mim.main(args)["train_steps"] == 1


@pytest.mark.parametrize("flag", ["cache_data_dir", "device_cache",
                                  "input_dtype", "export_hf",
                                  "profile_steps", "report_to"])
def test_run_mim_ported_flags_run(volumes, tmp_path, flag):
    """The flags the port once refused run a short training and leave
    what they promise: a filled cache, a device cache read once, uint8
    batches decoded to bfloat16 in the step, the HF export, a trace, and
    metrics.jsonl under report_to wandb without the package."""
    from smb_vision_tpu_torch.data import dataset, quantization

    out, cache = tmp_path / "o", tmp_path / "cache"
    value = {"cache_data_dir": str(cache), "device_cache": "true",
             "input_dtype": "uint8", "export_hf": "true",
             "profile_steps": "1-2", "report_to": "wandb"}[flag]
    args = _cli_args(volumes, out, 4) + [f"--{flag}", value]
    seen = []
    loaders = []
    real_decode = quantization.dequantize_batch
    real_init = dataset.DeviceCachedBatchLoader.__init__

    def decode(batch, dtype=torch.float32):
        seen.append((batch["pixel_values"].dtype, dtype))
        return real_decode(batch, dtype)

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        loaders.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantization, "dequantize_batch", decode)
        mp.setattr(dataset.DeviceCachedBatchLoader, "__init__", init)
        assert run_mim.main(args)["train_steps"] == 4
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    if flag == "cache_data_dir":
        assert len(list(cache.glob("*.npy"))) == 4
    elif flag == "device_cache":
        # 3 training volumes (the 4th is the auto-split's eval): one host
        # load each, all in epoch 0
        assert loaders and loaders[0].host_loads == {0: 3, 1: 0}
    elif flag == "input_dtype":
        assert seen and all(s == (torch.uint8, torch.bfloat16)
                            for s in seen)
    elif flag == "export_hf":
        hf = convert.read_safetensors(out / "hf_model.safetensors")
        assert "videomae.encoder.layer.0.attention.attention.q_bias" in hf
        assert "decoder.decoder_layers.0.output.dense.weight" in hf
    elif flag == "profile_steps":
        assert list((out / "profile").glob("trace_*.json"))


def test_run_mim_cuda_without_cuda_raises(volumes, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(volumes, tmp_path / "o", 1)
    args[args.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_mim.main(args)


def test_build_config_keeps_a_config_files_pins(tmp_path):
    path = tmp_path / "cfg.json"
    VideoMAEConfig(image_size=512, num_frames=320, mlp_impl="pallas_bwd",
                   gradient_checkpointing=True).save_json(str(path))
    cfg = run_mim.build_config(run_mim.ModelArguments(
        config_name_or_path=str(path)))
    assert (cfg.image_size, cfg.num_frames, cfg.mlp_impl,
            cfg.gradient_checkpointing) == (512, 320, "pallas_bwd", True)
    cfg = run_mim.build_config(run_mim.ModelArguments(
        config_name_or_path=str(path), mlp_impl="xla",
        config_overrides="gradient_checkpointing=false"))
    assert cfg.mlp_impl == "xla" and not cfg.gradient_checkpointing
    cfg = run_mim.build_config(run_mim.ModelArguments(image_size=64,
                                                      depth=32))
    assert (cfg.image_size, cfg.num_frames, cfg.num_channels) == (64, 32, 1)


def test_flops_and_peaks(monkeypatch):
    from smb_vision_tpu.utils.profiling import mim_flops_per_sample

    cfg = VideoMAEConfig(image_size=512, num_frames=320)
    jcfg = JConfig(image_size=512, num_frames=320)
    assert profiling.mim_flops_per_sample(cfg, 0.65) == \
        mim_flops_per_sample(jcfg, 0.65)
    assert profiling.device_peak_flops("cpu") is None
    for name, peak in [("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA H100 NVL", 835e12),
                       ("NVIDIA A100-SXM4-80GB", None)]:
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=name: n)
        assert profiling.device_peak_flops("cuda") == peak
