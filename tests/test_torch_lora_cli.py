"""LoRA and the 8-bit AdamW through the port's CLIs on the CPU:
`run_classification --lora_enable --optim adamw8bit` (the three files,
the frozen base, a resume equal bit for bit to a straight run, a
SIGTERM'd run resumed bit for bit, `lora.safetensors` merged by the JAX
package into `model_merged.safetensors`), and `--optim adamw8bit` in
`run_mim` and `run_vjepa` (`grad_accum_dtype bfloat16`, as the V-JEPA
preset's own note asks), each trained, checkpointed and resumed."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from smb_vision_tpu_torch.cli import run_classification, run_mim, run_vjepa
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


@pytest.fixture
def volumes(tmp_path):
    rng = np.random.default_rng(0)
    items = []
    for i in range(4):
        hu = rng.normal(-200, 400, (32, 32, 32)).clip(-1024, 3000)
        path = tmp_path / f"ct_{i}.nii"
        save_nifti(path, hu.astype(np.int16), np.diag([3.0, 3.0, 6.0, 1.0]))
        items.append({"image": str(path), "os": float(3 + 2 * i),
                      "os_event": float(i % 3 != 1), "age": 40.0 + 5 * i})
    spec = tmp_path / "data.json"
    spec.write_text(json.dumps({"train": items[:3], "validation": items[3:]}))
    return spec


def _cls_args(spec, out, steps):
    return ["--train_data_path", str(spec), "--val_data_path", str(spec),
            "--output_dir", str(out), "--task_type", "survival",
            "--additional_feature_columns", "age", "--model_type",
            "videomae", "--image_size", "32", "--depth", "32",
            "--patch_size", "16", "--hidden_size", "64",
            "--num_hidden_layers", "2", "--num_attention_heads", "2",
            "--intermediate_size", "128", "--dtype", "float32",
            "--attn_impl", "xla", "--mlp_impl", "xla", "--vision_lr",
            "1e-3", "--merger_lr", "1e-2", "--learning_rate", "5e-3",
            "--per_device_train_batch_size", "2", "--num_train_steps",
            str(steps), "--save_steps", "2", "--logging_steps", "1",
            "--do_eval", "true", "--device", "cpu", "--num_workers", "2",
            "--lora_enable", "true", "--lora_rank", "4", "--optim",
            "adamw8bit", "--lr_scheduler_type", "constant"]


def _ckpt(out, step):
    return torch.load(out / "checkpoints" / str(step) / "state.pt",
                      map_location="cpu", weights_only=True)


def _equal_states(a, b):
    """The model (base and adapters), the 8-bit moments and the LoRA
    state of two checkpoints, byte for byte."""
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k in ("mu", "mu_scale", "nu", "nu_scale", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["lora_meta"] == b["lora_meta"]


def test_run_classification_lora_adamw8bit(volumes, tmp_path):
    """4 steps with checkpoints, then a resume to 6, beside a straight
    6-step run (a constant learning rate: the schedule's length is the
    run's step count): the resumed checkpoint equals the straight one
    byte for byte; model.safetensors is the frozen base of either run (equal
    bytes); only adapters and the head are in the optimizer, whose
    moments are int8; the JAX package merges lora.safetensors into the
    base to model_merged.safetensors (1e-6)."""
    from smb_vision_tpu.train.lora import merge_lora
    from smb_vision_tpu.utils.serialization import (
        flatten_params,
        load_params_safetensors,
    )

    out, straight = tmp_path / "out", tmp_path / "straight"
    res = run_classification.main(_cls_args(volumes, out, 4))
    assert res["train_steps"] == 4 and np.isfinite(res["eval_c_index"])
    base4 = (out / "model.safetensors").read_bytes()
    res = run_classification.main(_cls_args(volumes, out, 6))
    assert res["train_steps"] == 6
    run_classification.main(_cls_args(volumes, straight, 6))
    assert Trainer.checkpoint_steps(out / "checkpoints") == [2, 4, 6]
    _equal_states(_ckpt(out, 6), _ckpt(straight, 6))
    assert (out / "model.safetensors").read_bytes() == base4 == (
        straight / "model.safetensors").read_bytes()
    blob = _ckpt(out, 6)
    codes = [s["mu"] for s in blob["optimizer"]["adamw"]["state"].values()]
    assert codes and all(c.dtype == torch.int8 for c in codes)
    n_adapters = 2 * 6 * 2          # a, b x 6 targets x 2 layers
    n_head = 4                      # fc_norm scale, bias; classifier
    assert len(blob["optimizer"]["adamw"]["state"]) == n_adapters + n_head
    lora = load_params_safetensors(out / "lora.safetensors")
    assert set(lora) == {"adapters", "head", "meta"}
    assert float(lora["meta"]["rank"]) == 4.0
    base = load_params_safetensors(out / "model.safetensors")
    merged = flatten_params(merge_lora(base, lora, train=False))
    ours = convert.read_safetensors(out / "model_merged.safetensors")
    assert set(merged) == set(ours)
    for k in merged:
        np.testing.assert_allclose(ours[k], np.asarray(merged[k]),
                                   atol=1e-6, err_msg=k)
    moved = [k for k in ours if not np.array_equal(
        ours[k], convert.read_safetensors(out / "model.safetensors")[k])]
    assert moved and all("/" not in k for k in moved)
    assert any("classifier" in k for k in moved)


def test_lora_sigterm_resumes_bitwise(volumes, tmp_path, monkeypatch):
    """A SIGTERM after step 3 checkpoints that step and stops; the run
    started again finishes at 6 equal to a straight run, byte for byte."""
    from smb_vision_tpu_torch.train import trainer as T

    out, straight = tmp_path / "out", tmp_path / "straight"
    sent = {"n": 0}
    inner = T.step_generator

    def gen(seed, step):
        if step == 2 and not sent["n"]:       # during the third step
            sent["n"] += 1
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(seed, step)

    monkeypatch.setattr(T, "step_generator", gen)
    res = run_classification.main(_cls_args(volumes, out, 6))
    assert res["train_steps"] == 3 and sent["n"] == 1
    monkeypatch.setattr(T, "step_generator", inner)
    assert run_classification.main(_cls_args(volumes, out, 6))[
        "train_steps"] == 6
    run_classification.main(_cls_args(volumes, straight, 6))
    _equal_states(_ckpt(out, 6), _ckpt(straight, 6))


def _mim_args(spec, out, steps):
    return ["--json_path", str(spec), "--output_dir", str(out),
            "--image_size", "64", "--depth", "64", "--patch_size", "16",
            "--mask_patch_size", "32", "--mask_ratio", "0.5",
            "--hidden_size", "64", "--num_hidden_layers", "2",
            "--num_attention_heads", "2", "--intermediate_size", "128",
            "--dtype", "float32", "--config_overrides",
            "decoder_hidden_size=64,decoder_num_hidden_layers=1,"
            "decoder_intermediate_size=128,decoder_num_attention_heads=2",
            "--num_train_steps", str(steps), "--save_steps", "2",
            "--logging_steps", "1", "--device", "cpu", "--num_workers", "2",
            "--optim", "adamw8bit", "--lr_scheduler_type", "constant"]


def _vjepa_args(spec, out, steps):
    return ["--data_path", str(spec), "--output_dir", str(out),
            "--image_size", "64", "--depth", "32", "--patch_size", "16",
            "--hidden_size", "64", "--num_hidden_layers", "2",
            "--num_attention_heads", "2", "--pred_hidden_size", "32",
            "--pred_num_hidden_layers", "1", "--pred_num_attention_heads",
            "2", "--dtype", "float32", "--attn_impl", "xla",
            "--mlp_impl", "xla", "--teacher_attn_impl", "xla",
            "--num_train_steps", str(steps), "--save_steps", "2",
            "--logging_steps", "1", "--device", "cpu", "--num_workers", "2",
            "--optim", "adamw8bit", "--grad_accum_dtype", "bfloat16",
            "--gradient_accumulation_steps", "2", "--lr_scheduler_type",
            "constant"]


@pytest.mark.parametrize("cli", ["run_mim", "run_vjepa"])
def test_pretraining_adamw8bit_resumes_bitwise(volumes, tmp_path, cli):
    """2 steps, then a resume to 4, beside a straight 4-step run (a
    constant learning rate): finite
    losses, int8 moments, and the resumed checkpoint equal to the
    straight one byte for byte (model, moments and, for V-JEPA, the EMA
    teacher)."""
    main, args = ((run_mim.main, _mim_args) if cli == "run_mim"
                  else (run_vjepa.main, _vjepa_args))
    if cli == "run_mim":
        spec = json.loads(volumes.read_text())
        volumes = volumes.with_name("train.json")
        volumes.write_text(json.dumps({"train": spec["train"]
                                       + spec["validation"]}))
    out, straight = tmp_path / "out", tmp_path / "straight"
    assert main(args(volumes, out, 2))["train_steps"] == 2
    assert main(args(volumes, out, 4))["train_steps"] == 4
    main(args(volumes, straight, 4))
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    a, b = _ckpt(out, 4), _ckpt(straight, 4)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    if cli == "run_vjepa":
        for k in a["teacher"]:
            assert torch.equal(a["teacher"][k], b["teacher"][k]), k
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        assert sa[i]["mu"].dtype == torch.int8
        for k in ("mu", "mu_scale", "nu", "nu_scale", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
