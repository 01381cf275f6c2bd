"""The port's Trainer options against the JAX package's on the CPU: uint8
pixel shipping (decoded to bfloat16 in the step; per-step loss within the
learning-equivalence bound, 1e-3 relative, of the JAX Trainer on the same
batches and masks), the host-side cast rules, --profile_steps (a
torch.profiler trace), --report_to wandb without wandb, and run_mim /
run_vjepa end to end with --input_dtype uint8 --device_cache --export_hf
at a few layers."""

import functools
import json
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smb_vision_tpu.data.quantization import SCALE_KEY as JSCALE_KEY
from smb_vision_tpu.data.quantization import quantize_batch as jquantize
from smb_vision_tpu.ops.masking import mim_mask as jmim_mask
from smb_vision_tpu.train.trainer import Trainer as JTrainer
from smb_vision_tpu.train.trainer import TrainingArguments as JArgs
from smb_vision_tpu_torch.data import quantization
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.train.trainer import (
    Trainer,
    TrainingArguments,
    profile_range,
)

torch.set_num_threads(1)

TOL_LEARNING = 1e-3      # tests/test_learning_equivalence.py


class ListLoader:
    """A loader over fixed batches (one epoch)."""

    def __init__(self, batches):
        self.batches = batches
        self.ds = list(range(sum(len(b["pixel_values"]) for b in batches)))

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, e):
        pass


def _state():
    """A state the port's Trainer can checkpoint: a one-weight model."""
    model = torch.nn.Linear(1, 1)
    return {"model": model, "step": 0,
            "optimizer": torch.optim.SGD(model.parameters(), lr=0.0)}


def _losses(out_dir):
    return [r["loss"] for r in map(json.loads, (out_dir / "metrics.jsonl")
                                   .read_text().splitlines()) if "loss" in r]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-9)


MIM_CFG = dict(image_size=16, num_frames=16, num_channels=1, patch_size=8,
               tubelet_size=8, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=64,
               decoder_hidden_size=32, decoder_num_hidden_layers=1,
               decoder_num_attention_heads=2, decoder_intermediate_size=64,
               dtype="float32", attn_impl="xla")
MIM_MASK = dict(mask_patch_size=8, mask_ratio=0.5)


def test_trainer_uint8_shipping_end_to_end(tmp_path):
    """input_dtype 'uint8' on both Trainers, on the same uint8-cached
    volumes, weights and masks (the JAX Trainer's key of each step): the
    workload sees decoded bfloat16 pixels and no affine keys, the loss of
    each step within 1e-3 relative of the JAX Trainer's, and within
    quantisation noise (5 %) of the float32 run."""
    from smb_vision_tpu.data.dataset import BatchLoader as JLoader
    from smb_vision_tpu.data.dataset import CTDataset as JDataset
    from smb_vision_tpu.data.preprocess import PreprocessConfig as JPipe
    from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
    from smb_vision_tpu.train.mim import make_mim_workload as jworkload
    from smb_vision_tpu.utils.serialization import flatten_params
    from smb_vision_tpu_torch.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu_torch.data.preprocess import PreprocessConfig
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.convert import params_from_flax
    from smb_vision_tpu_torch.train import optim as toptim
    from smb_vision_tpu_torch.train.mim import make_mim_workload

    rng = np.random.default_rng(4)
    for i in range(8):
        save_nifti(tmp_path / f"v{i}.nii.gz",
                   rng.uniform(-700, 700, (16, 16, 16)).astype(np.float32))
    items = [{"image": str(tmp_path / f"v{i}.nii.gz")} for i in range(8)]
    geo = ((1., 1., 1.), (16, 16, 16))
    _, jinit, jstep, _ = jworkload(JConfig(**MIM_CFG), tx=optax.sgd(0.0),
                                   **MIM_MASK)
    jstate = jinit(jax.random.PRNGKey(0))
    init_params = flatten_params(jstate["params"])
    seen = {}

    def jax_run():
        ds = JDataset(items=items, pipeline=JPipe(*geo),
                      cache_dir=str(tmp_path / "jc"), cache_dtype="uint8",
                      out_dtype="uint8")
        args = JArgs(output_dir=str(tmp_path / "jax"), num_train_steps=2,
                     logging_steps=1, save_steps=100, input_dtype="uint8")
        JTrainer(args=args, state=jinit(jax.random.PRNGKey(0)),
                 step_fn=jstep,
                 train_loader=JLoader(ds, 8, shuffle=False)).train()
        return _losses(tmp_path / "jax")

    def port_run(dtype):
        model, init_fn, step_fn, _ = make_mim_workload(
            VideoMAEConfig(**MIM_CFG), tx=functools.partial(
                toptim.make_optimizer, learning_rate=0.0, total_steps=2,
                weight_decay=0.0), **MIM_MASK)
        state = init_fn(0)
        model.load_state_dict(params_from_flax(init_params,
                                               pretraining=True))

        def spy(state, batch, gen):
            seen[dtype] = (batch["pixel_values"].dtype,
                           quantization.SCALE_KEY in batch)
            key = jax.random.fold_in(jax.random.PRNGKey(42), state["step"])
            mask = np.asarray(jmim_mask(key, 8, input_size=16, depth=16,
                                        model_patch_size=8, **MIM_MASK))
            return step_fn(state, batch, mask=mask)

        ds = CTDataset(items=items, pipeline=PreprocessConfig(*geo),
                       cache_dir=str(tmp_path / f"c_{dtype}"),
                       cache_dtype=dtype, out_dtype=dtype)
        args = TrainingArguments(output_dir=str(tmp_path / dtype),
                                 num_train_steps=2, logging_steps=1,
                                 save_steps=100, input_dtype=dtype,
                                 device="cpu")
        Trainer(args=args, state=state, step_fn=spy,
                train_loader=BatchLoader(ds, 8, shuffle=False,
                                         num_workers=2)).train()
        return _losses(tmp_path / dtype)

    want = jax_run()
    got = port_run("uint8")
    f32 = port_run("float32")
    assert seen["uint8"] == (torch.bfloat16, False)
    assert seen["float32"] == (torch.float32, False)
    assert len(got) == len(want) == 2
    for g, w, f in zip(got, want, f32):
        assert _rel(g, w) <= TOL_LEARNING, (got, want)
        assert _rel(g, f) < 0.05, (got, f32)


def test_trainer_uint8_accum_presplit(tmp_path):
    """uint8 with gradient accumulation 2: the per-sample affine reaches
    the decode with the batch and every row decodes with its own (the
    port splits the microbatches on the device, in the step: it sees the
    whole (16, 4) batch in bfloat16, without affine keys); the loss within
    1e-3 relative of the JAX Trainer's, whose host pre-split gives its
    step (2, 8, 4)."""
    base = np.random.default_rng(5).uniform(0, 1, (16, 4)).astype(
        np.float32)
    seen = {}

    def step_fn(state, batch, gen):
        px = batch["pixel_values"]
        seen["port"] = (px.dtype, tuple(px.shape),
                        quantization.SCALE_KEY in batch)
        state["step"] += 1
        return {"loss": px.float().mean()}

    def jstep(state, batch, key):
        px = batch["pixel_values"]
        seen["jax"] = tuple(px.shape)
        return {**state, "step": state["step"] + 1}, {
            "loss": jnp.mean(px.astype(jnp.float32))}

    args = dict(num_train_steps=1, gradient_accumulation_steps=2,
                input_dtype="uint8", logging_steps=1, save_steps=100)
    Trainer(args=TrainingArguments(output_dir=str(tmp_path / "p"),
                                   device="cpu", **args),
            state=_state(), step_fn=step_fn,
            train_loader=ListLoader([{"pixel_values": base}])).train()
    JTrainer(args=JArgs(output_dir=str(tmp_path / "j"), **args),
             state={"params": {}, "opt_state": (), "step": jnp.asarray(0)},
             step_fn=jstep,
             train_loader=ListLoader([{"pixel_values": base}])).train()
    assert seen["port"] == (torch.bfloat16, (16, 4), False)
    assert seen["jax"] == (2, 8, 4)
    (got,), (want,) = _losses(tmp_path / "p"), _losses(tmp_path / "j")
    assert _rel(got, want) <= TOL_LEARNING
    assert abs(got - base.mean()) < 1e-2


def test_trainer_uint8_eval_supports_host_eval_fn(tmp_path):
    """input_dtype uint8 with an eval_fn that is host code (labels to
    numpy): it gets decoded bfloat16 tensors, and the eval loss over
    quantize_batch's batches (rows weighted by the Trainers' valid_mask)
    equals the JAX Trainer's within 1e-3."""
    def batches(n, quant):
        return [quant({"pixel_values": np.full((4, 2), float(i + 1),
                                               np.float32)
                       * np.linspace(0.5, 1.0, 8, dtype=np.float32)
                       .reshape(4, 2),
                       "labels": np.arange(4, dtype=np.int32)})
                for i in range(n)]

    def host_eval_fn(state, batch):
        px = batch["pixel_values"]
        assert px.dtype == torch.bfloat16
        labels = batch["labels"].numpy()          # host op
        valid = batch["valid_mask"]
        return {"loss": (px.float().mean(-1) * valid).sum() / valid.sum(),
                "logits": np.zeros((labels.shape[0], 2)), "labels": labels}

    def jeval(state, batch):
        px = batch["pixel_values"]
        assert px.dtype == jnp.bfloat16
        labels = np.asarray(batch["labels"])
        valid = batch["valid_mask"]            # the JAX Trainer pads rows
        return {"loss": jnp.sum(px.astype(jnp.float32).mean(-1) * valid)
                / jnp.sum(valid),
                "logits": jnp.zeros((labels.shape[0], 2)), "labels": labels}

    def step_fn(state, batch, gen):
        state["step"] += 1
        return {"loss": batch["pixel_values"].float().mean()}

    tr = Trainer(args=TrainingArguments(output_dir=str(tmp_path / "p"),
                                        input_dtype="uint8", device="cpu",
                                        num_train_steps=1, save_steps=100),
                 state=_state(), step_fn=step_fn,
                 train_loader=ListLoader(batches(1, quantization
                                                 .quantize_batch)),
                 eval_loader=ListLoader(batches(2, quantization
                                                .quantize_batch)),
                 eval_fn=host_eval_fn)
    tr.train()
    got = tr.evaluate()["eval_loss"]
    jtr = JTrainer(args=JArgs(output_dir=str(tmp_path / "j"),
                              input_dtype="uint8", num_train_steps=1,
                              save_steps=100),
                   state={"params": {}, "opt_state": (),
                          "step": jnp.asarray(0)},
                   step_fn=lambda s, b, k: ({**s, "step": s["step"] + 1},
                                            {"loss": jnp.float32(0)}),
                   train_loader=ListLoader(batches(1, jquantize)),
                   eval_loader=ListLoader(batches(2, jquantize)),
                   eval_fn=jeval)
    want = jtr.evaluate()["eval_loss"]
    assert np.isfinite(got) and _rel(got, want) <= TOL_LEARNING
    assert JSCALE_KEY == quantization.SCALE_KEY


@pytest.mark.parametrize("input_dtype,pixels", [
    ("bfloat16", torch.bfloat16), ("float16", torch.float16),
    ("float32", torch.float32)])
def test_host_cast_only_touches_pixels(tmp_path, input_dtype, pixels):
    """The host cast: only the pixel columns take input_dtype (from float32
    and from float16 sources); labels, survival durations (2048 + j: bf16
    would tie them) and tabular features keep theirs."""
    batches = [{"pixel_values": np.ones((8, 4), src) * i,
                "labels": np.arange(8, dtype=np.int32),
                "duration": np.asarray([2048.0 + j for j in range(8)],
                                       np.float32),
                "additional_features": np.ones((8, 3), np.float32)}
               for i, src in enumerate((np.float32, np.float16))]
    seen = []

    def step_fn(state, batch, gen):
        seen.append({k: v.dtype for k, v in batch.items()})
        state["step"] += 1
        return {"loss": batch["pixel_values"].float().mean()}

    Trainer(args=TrainingArguments(output_dir=str(tmp_path), device="cpu",
                                   num_train_steps=2, input_dtype=input_dtype,
                                   save_steps=100),
            state=_state(), step_fn=step_fn,
            train_loader=ListLoader(batches)).train()
    want_f16 = torch.float16 if input_dtype == "float32" else pixels
    assert [s["pixel_values"] for s in seen] == [pixels, want_f16]
    for s in seen:
        assert (s["labels"], s["duration"], s["additional_features"]) == (
            torch.int32, torch.float32, torch.float32)


def test_trainer_profile_steps_writes_trace(tmp_path):
    """--profile_steps 2-3 writes a torch.profiler Chrome trace of those
    steps under output_dir/profile (the JAX Trainer writes its own
    profiler's files there)."""
    calls = []

    def step_fn(state, batch, gen):
        calls.append(torch.autograd.profiler.record_function("step"))
        state["step"] += 1
        return {"loss": batch["pixel_values"].float().mean()}

    batches = [{"pixel_values": np.ones((8, 4), np.float32) * i}
               for i in range(4)]
    Trainer(args=TrainingArguments(output_dir=str(tmp_path), device="cpu",
                                   num_train_steps=4, logging_steps=1,
                                   save_steps=100, profile_steps="2-3"),
            state=_state(), step_fn=step_fn,
            train_loader=ListLoader(batches)).train()
    traces = list((tmp_path / "profile").glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    assert len(_losses(tmp_path)) == 4


@pytest.mark.parametrize("spec,want", [
    (None, None), ("2-3", (2, 3)), ("5", (5, 5)), ("0-2", ValueError),
    ("3-2", ValueError), ("a-b", ValueError)])
def test_profile_range(spec, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="profile_steps"):
            profile_range(spec)
    else:
        assert profile_range(spec) == want


def test_report_to_wandb_without_wandb_keeps_metrics_jsonl(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """report_to wandb without the wandb package warns, as the JAX
    package's MetricLogger does, and every record still goes to
    metrics.jsonl; with a wandb module present each record is logged to
    it at its step."""
    from smb_vision_tpu.utils.logging import MetricLogger as JLogger
    from smb_vision_tpu_torch.utils.logging import MetricLogger

    monkeypatch.setitem(sys.modules, "wandb", None)     # not installed
    with caplog.at_level(logging.WARNING):
        logger = MetricLogger(tmp_path / "p", report_to="wandb")
        JLogger(tmp_path / "j", report_to="wandb")
    warned = [r.getMessage() for r in caplog.records if "wandb" in
              r.getMessage()]
    assert len(warned) == 2 and warned[0] == warned[1]
    logger.log({"step": 1, "loss": 0.5})
    (rec,) = [json.loads(x) for x in (tmp_path / "p" / "metrics.jsonl")
              .read_text().splitlines()]
    assert rec["loss"] == 0.5 and rec["step"] == 1

    logged = []
    fake = type(sys)("wandb")
    fake.run = None
    fake.init = lambda **kw: logged.append(("init", kw))
    fake.log = lambda rec, step=None: logged.append((step, rec["loss"]))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    MetricLogger(tmp_path / "w", report_to="wandb", run_name="r").log(
        {"step": 3, "loss": 0.25})
    assert logged[0][0] == "init" and logged[0][1]["name"] == "r"
    assert logged[1] == (3, 0.25)
    with pytest.raises(ValueError, match="report_to"):
        MetricLogger(tmp_path / "x", report_to="tensorboard")


@pytest.fixture
def volumes(tmp_path):
    rng = np.random.default_rng(0)
    vols = tmp_path / "vols"
    vols.mkdir()
    for i in range(4):
        hu = rng.normal(-200, 400, (32, 32, 32)).clip(-1024, 3000)
        save_nifti(vols / f"ct_{i}.nii", hu.astype(np.int16),
                   np.diag([3.0, 3.0, 6.0, 1.0]))
    return vols


@pytest.fixture
def watched(monkeypatch):
    """(the DeviceCachedBatchLoaders made, the step decodes as (codes'
    dtype, decoded dtype)) of the block."""
    from smb_vision_tpu_torch.data import dataset

    loaders, decodes = [], []
    init = dataset.DeviceCachedBatchLoader.__init__
    decode = quantization.dequantize_batch

    def kept(self, *args, **kw):
        init(self, *args, **kw)
        loaders.append(self)

    def watched_decode(batch, dtype=torch.float32):
        decodes.append((batch["pixel_values"].dtype, dtype))
        return decode(batch, dtype)

    monkeypatch.setattr(dataset.DeviceCachedBatchLoader, "__init__", kept)
    monkeypatch.setattr(quantization, "dequantize_batch", watched_decode)
    return loaders, decodes


DATA_FLAGS = ["--input_dtype", "uint8", "--device_cache", "true",
              "--export_hf", "true", "--num_workers", "2", "--device", "cpu",
              "--dtype", "float32", "--logging_steps", "1"]


def test_run_mim_data_path_and_hf_round_trip(volumes, tmp_path, watched):
    """chip_smoke's leg J at a few layers: run_mim for two epochs of the 4
    volumes with uint8 shipping, the device cache, a uint8 volume cache,
    the HF export and a profile window. The native backend ran, epoch 1
    read nothing from the host, every batch reached the step as codes
    decoded to bfloat16; run_inference from model.safetensors and from
    hf_model.safetensors gives the same embeddings bit for bit."""
    from smb_vision_tpu_torch.cli import run_inference, run_mim

    loaders, decodes = watched
    spec = tmp_path / "data.json"
    spec.write_text(json.dumps({"train": [
        {"image": str(p)} for p in sorted(volumes.glob("*.nii"))]}))
    out, cache = tmp_path / "out", tmp_path / "cache"
    res = run_mim.main([
        "--json_path", str(spec), "--output_dir", str(out),
        "--image_size", "64", "--depth", "64", "--patch_size", "16",
        "--mask_patch_size", "32", "--mask_ratio", "0.5",
        "--hidden_size", "64", "--num_hidden_layers", "2",
        "--num_attention_heads", "2", "--intermediate_size", "128",
        "--config_overrides",
        "decoder_hidden_size=64,decoder_num_hidden_layers=1,"
        "decoder_intermediate_size=128,decoder_num_attention_heads=2",
        "--num_train_steps", "8", "--save_steps", "8",
        "--train_val_split", "0", "--cache_data_dir", str(cache),
        "--cache_dtype", "uint8", "--profile_steps", "6-7", *DATA_FLAGS])
    assert res["train_steps"] == 8
    (loader,) = loaders
    assert loader.ds.backend == "native"
    assert loader.host_loads == {0: 4, 1: 0}
    assert all(e[0].dtype == torch.uint8 for e in loader._dev.values())
    assert decodes == [(torch.uint8, torch.bfloat16)] * 8
    assert len(list(cache.glob("*.npy"))) == 4       # npz codes
    assert list((out / "profile").glob("trace_*.json"))
    assert len(_losses(out)) == 8 and np.isfinite(_losses(out)).all()
    embs = []
    for name in ("model.safetensors", "hf_model.safetensors"):
        emb = tmp_path / f"emb_{name.split('.')[0]}"
        stats = run_inference.main([
            "--data_dir", str(volumes), "--output_dir", str(emb),
            "--config_path", str(out / "config.json"),
            "--model_name_or_path", str(out / name), "--batch_size", "2",
            "--device", "cpu", "--num_workers", "2",
            "--cache_data_dir", str(cache), "--cache_dtype", "uint8"])
        assert stats["embedded"] == 4
        embs.append({f.name: np.load(f) for f in sorted(emb.glob("*.npy"))})
    assert embs[0].keys() == embs[1].keys() and len(embs[0]) == 4
    for k in embs[0]:
        np.testing.assert_array_equal(embs[0][k], embs[1][k])


def test_run_vjepa_data_path_and_continued_pretraining(volumes, tmp_path,
                                                       watched,
                                                       monkeypatch):
    """chip_smoke's legs D and K at a few layers: run_vjepa with uint8
    shipping, the device cache and the HF export, then continued
    pretraining from that hf_model.safetensors: every student tensor is
    loaded (the trained student, bit for bit), none skipped, and the EMA
    teacher starts as its copy."""
    from smb_vision_tpu_torch.cli import run_vjepa
    from smb_vision_tpu_torch.models import convert

    loaders, decodes = watched
    nii = [{"image": str(p)} for p in sorted(volumes.glob("*.nii"))]
    spec = tmp_path / "data.json"
    spec.write_text(json.dumps({"train": nii[:3], "validation": nii[3:]}))

    def args(out, steps):
        return ["--data_path", str(spec), "--output_dir", str(out),
                "--image_size", "64", "--depth", "32", "--patch_size", "16",
                "--hidden_size", "64", "--num_hidden_layers", "2",
                "--num_attention_heads", "2", "--pred_hidden_size", "32",
                "--pred_num_hidden_layers", "1",
                "--pred_num_attention_heads", "2", "--attn_impl", "xla",
                "--mlp_impl", "xla", "--num_mask_blocks", "2",
                "--gradient_accumulation_steps", "2",
                "--num_train_steps", str(steps), "--save_steps", "10",
                *DATA_FLAGS]

    first = tmp_path / "first"
    assert run_vjepa.main(args(first, 2))["train_steps"] == 2
    assert decodes and set(decodes) == {(torch.uint8, torch.bfloat16)}
    assert loaders[0].ds.backend == "native"
    hf = convert.read_safetensors(first / "hf_model.safetensors")
    assert any(k.startswith("predictor.layer.") for k in hf)
    trained = convert.params_from_flax(convert.read_safetensors(
        first / "model.safetensors"), vjepa=True)

    grafts, starts = [], []
    graft, init = convert.load_params_into, Trainer.__init__

    def watched_graft(model, src, **kw):
        loaded, skipped = graft(model, src, **kw)
        grafts.append((set(model.state_dict()), set(loaded), skipped))
        return loaded, skipped

    def watched_init(self, *a, **kw):
        init(self, *a, **kw)
        starts.append(tuple(
            {k: v.clone() for k, v in self.state[m].state_dict().items()}
            for m in ("model", "teacher")))

    monkeypatch.setattr(convert, "load_params_into", watched_graft)
    monkeypatch.setattr(Trainer, "__init__", watched_init)
    res = run_vjepa.main(args(tmp_path / "again", 1) + [
        "--model_name_or_path", str(first / "hf_model.safetensors")])
    assert res["train_steps"] == 1
    ((names, loaded, skipped),) = grafts
    assert loaded == names == set(trained) and skipped == []
    ((student, teacher),) = starts
    for k, v in trained.items():
        assert torch.equal(student[k], v), k
        assert torch.equal(teacher[k], v), k
