"""The PyTorch port's run_inference CLI against the JAX package's, on the
CPU: the same NIfTI files and the same checkpoint (the JAX package's own
safetensors export) give the same embeddings and the same metadata."""

import json

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.data.nifti import save_nifti
from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.utils.serialization import save_params_safetensors
from smb_vision_tpu_torch.cli.run_inference import main as run_inference

torch.set_num_threads(1)

TINY = dict(image_size=32, num_frames=32, patch_size=16, tubelet_size=16,
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, dtype="float32")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """2 tiny NIfTI volumes, a config.json and the JAX export of random
    weights (biases and norms perturbed off their init)."""
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    vols = root / "vols"
    vols.mkdir()
    for i in range(2):
        save_nifti(vols / f"case_{i}.nii.gz",
                   rng.normal(0, 300, (32, 32, 32)).astype(np.int16),
                   np.diag([1.5, 1.5, 3.0, 1.0]))
    cfg = JConfig(**TINY)
    cfg.save_json(str(root / "config.json"))
    params = jax.jit(JModel(cfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 32, 1, 32, 32), np.float32))
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)
    save_params_safetensors(params, root / "model.safetensors")
    return root


def _common(root):
    return ["--data_dir", str(root / "vols"),
            "--model_name_or_path", str(root / "model.safetensors"),
            "--config_path", str(root / "config.json"),
            "--dtype", "float32", "--batch_size", "2", "--num_workers", "2"]


def test_embeddings_match_jax_cli(workdir, tmp_path):
    from smb_vision_tpu.cli.run_inference import main as jax_run_inference

    jax_run_inference(_common(workdir) + ["--attn_impl", "xla",
                                          "--output_dir", str(tmp_path / "j")])
    stats = run_inference(_common(workdir) + [
        "--device", "cpu", "--output_dir", str(tmp_path / "t")])
    assert stats == {"embedded": 2, "failed": 0, "skipped": 0}
    for i in range(2):
        ref = np.load(tmp_path / "j" / f"case_{i}.npy")
        out = np.load(tmp_path / "t" / f"case_{i}.npy")
        assert out.shape == ref.shape == (8, 32) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-4)
    meta_j = json.loads((tmp_path / "j" / "metadata.json").read_text())
    meta_t = json.loads((tmp_path / "t" / "metadata.json").read_text())
    assert meta_t.keys() == meta_j.keys()
    for uid in meta_j:
        assert meta_t[uid].keys() == meta_j[uid].keys()
        assert meta_t[uid]["shape"] == meta_j[uid]["shape"]
    # resume: everything is already written
    again = run_inference(_common(workdir) + [
        "--device", "cpu", "--output_dir", str(tmp_path / "t")])
    assert again == {"embedded": 0, "failed": 0, "skipped": 2}


def test_random_init_is_seeded(workdir, tmp_path):
    args = ["--data_dir", str(workdir / "vols"), "--config_path",
            str(workdir / "config.json"), "--dtype", "float32",
            "--device", "cpu", "--num_workers", "1"]
    for name, seed in (("a", "3"), ("b", "3"), ("c", "4")):
        run_inference(args + ["--seed", seed, "--output_dir",
                              str(tmp_path / name)])
    a, b, c = (np.load(tmp_path / n / "case_0.npy") for n in "abc")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_cuda_device_without_cuda_raises(workdir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_inference(_common(workdir) + ["--output_dir", str(tmp_path)])


@pytest.mark.parametrize("flags,item", [
    (["--sliding_window"], "sliding window"),
    (["--pipeline_parallel", "2"], "multi-GPU"),
    (["--quant8"], "W8A8"),
    (["--input_dtype", "uint8"], "uint8"),
    (["--cache_data_dir", "cache"], "dataset cache"),
])
def test_unported_flags_raise(workdir, tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        run_inference(_common(workdir) + ["--device", "cpu", "--output_dir",
                                          str(tmp_path), *flags])


def test_single_json_args_and_hf_flags(tmp_path):
    """The port's argument parser: one .json path as argv fills the
    dataclass, and HF TrainingArguments flags map to their equivalents."""
    from smb_vision_tpu.cli.run_inference import (
        InferenceArguments as JArgs,
    )
    from smb_vision_tpu.utils.args import (
        parse_args_into_dataclasses as jparse,
    )
    from smb_vision_tpu_torch.cli.run_inference import InferenceArguments
    from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses

    blob = {"data_dir": "vols", "batch_size": 3, "device": "cpu",
            "dataloader_num_workers": 5, "bf16": True, "resume": False}
    path = tmp_path / "args.json"
    path.write_text(json.dumps(blob))
    (args,) = parse_args_into_dataclasses((InferenceArguments,), [str(path)])
    assert (args.data_dir, args.batch_size, args.device) == ("vols", 3, "cpu")
    assert (args.num_workers, args.dtype, args.resume) == (5, "bfloat16",
                                                          False)
    argv = ["--data_dir", "v", "--dataloader_num_workers", "4", "--resume",
            "false", "--max_samples", "7"]
    (t,) = parse_args_into_dataclasses((InferenceArguments,), argv)
    (j,) = jparse((JArgs,), argv)
    for name in ("data_dir", "num_workers", "resume", "max_samples"):
        assert getattr(t, name) == getattr(j, name), name
    with pytest.raises(SystemExit):
        parse_args_into_dataclasses((InferenceArguments,), ["--fp16"])


_CLI_ARG_CLASSES = {
    "run_inference": ("InferenceArguments",),
    "run_mim": ("ModelArguments", "DataTrainingArguments"),
    "run_vjepa": ("ModelArguments", "DataTrainingArguments"),
    "run_classification": ("ModelArguments", "DataTrainingArguments"),
}
# fields the port may have beyond the reference's
_PORT_ONLY = {"device", "seed", "config_overrides"}
_NEW_FLAGS = {"cache_dtype": ("float16", "float16"),
              "run_name": ("r1", "r1"),
              "pipeline_microbatches": ("4", 4)}


@pytest.mark.parametrize("cli", sorted(_CLI_ARG_CLASSES))
def test_cli_fields_match_reference(cli):
    """Every dataclass field of the reference CLI's argument classes (and
    of the trainers' TrainingArguments) is a field of the port's, and the
    reference's flags of this kind parse in flag mode."""
    import dataclasses
    import importlib

    from smb_vision_tpu.train.trainer import TrainingArguments as JTrain
    from smb_vision_tpu_torch.train.trainer import TrainingArguments
    from smb_vision_tpu_torch.utils.args import parse_args_into_dataclasses

    jmod = importlib.import_module(f"smb_vision_tpu.cli.{cli}")
    tmod = importlib.import_module(f"smb_vision_tpu_torch.cli.{cli}")
    pairs = [(getattr(jmod, n), getattr(tmod, n))
             for n in _CLI_ARG_CLASSES[cli]]
    if cli != "run_inference":
        pairs.append((JTrain, TrainingArguments))
    for jcls, tcls in pairs:
        jf = {f.name for f in dataclasses.fields(jcls)}
        tf = {f.name for f in dataclasses.fields(tcls)}
        assert jf - tf == set(), (cli, tcls.__name__, jf - tf)
        assert tf - jf <= _PORT_ONLY, (cli, tcls.__name__, tf - jf)
    classes = tuple(t for _, t in pairs)
    names = {f.name for c in classes for f in dataclasses.fields(c)}
    flags = {k: v for k, v in _NEW_FLAGS.items() if k in names}
    if cli == "run_mim":
        assert set(flags) == set(_NEW_FLAGS)
    argv = [s for k, (text, _) in flags.items() for s in (f"--{k}", text)]
    parsed = parse_args_into_dataclasses(classes, argv)
    for k, (_, want) in flags.items():
        got = [getattr(a, k) for a in parsed if hasattr(a, k)]
        assert got == [want], (k, got)


def test_run_name_is_in_every_metrics_record(tmp_path):
    from smb_vision_tpu_torch.utils.logging import MetricLogger

    MetricLogger(tmp_path / "a", run_name="r1").log({"step": 1})
    MetricLogger(tmp_path / "b").log({"step": 1})
    rec_a = json.loads((tmp_path / "a" / "metrics.jsonl").read_text())
    rec_b = json.loads((tmp_path / "b" / "metrics.jsonl").read_text())
    assert rec_a["run_name"] == "r1" and "run_name" not in rec_b
