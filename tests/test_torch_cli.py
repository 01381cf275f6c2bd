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
    (["--pipeline_parallel", "2", "--sliding_window", "true"],
     "item 9, Multi-GPU"),
])
def test_unported_flags_raise(workdir, tmp_path, flags, item):
    """--pipeline_parallel runs (tests/test_torch_pipelined_models.py); its
    composition with --sliding_window stays refused, as in the JAX CLI.
    --quant8 runs (test_quant8_matches_jax_cli)."""
    with pytest.raises(NotImplementedError, match=item):
        run_inference(_common(workdir) + ["--device", "cpu", "--output_dir",
                                          str(tmp_path), *flags])


def _big_volumes(root):
    """2 NIfTI volumes past the 32^3 grid: 40 x 32 x 24 voxels at the
    pipeline's spacing, padded to 64 x 32 x 32, give 3 windows each."""
    vols = root / "big"
    vols.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        save_nifti(vols / f"big_{i}.nii.gz",
                   rng.normal(0, 300, (40, 32, 24)).astype(np.int16),
                   np.diag([1.5, 1.5, 3.0, 1.0]))
    return vols


@pytest.mark.parametrize("extra,port_only,tol", [
    ([], [], 1e-4),
    (["--input_dtype", "uint8"], [], 5e-3),
    (["--sliding_window"], [], 1e-4),
    ([], ["--attn_impl", "pallas_int8"], 2e-2),
], ids=["float32", "uint8", "sliding_window", "pallas_int8"])
def test_quant8_matches_jax_cli(workdir, tmp_path, extra, port_only, tol):
    """run_inference --quant8 --device cpu (the W8A8 plain versions)
    against the JAX CLI's --quant8 on the same export, alone and with
    --input_dtype uint8 (the uint8 routes' bound, TOL_UINT8_VS_JAX),
    --sliding_window (3 windows a volume) and, on the port, --attn_impl
    pallas_int8 (the plain version of K3; the JAX CLI's int8 kernel does
    not run on the CPU, so its quant8 run on the plain attention is the
    reference, at the int8 scores' bound against float32 attention):
    within tol of max. --quant8 composes with --pipeline_parallel in
    test_run_inference_pipeline_parallel_quant8_matches_jax_cli."""
    from smb_vision_tpu.cli.run_inference import main as jax_run_inference

    flags = ["--quant8", *extra]
    names = [f"case_{i}" for i in range(2)]
    if "--sliding_window" in extra:
        flags += ["--data_dir", str(_big_volumes(tmp_path))]
        names = [f"big_{i}" for i in range(2)]
    jax_run_inference(_common(workdir) + ["--attn_impl", "xla",
                                          "--output_dir", str(tmp_path / "j"),
                                          *flags])
    stats = run_inference(_common(workdir) + [
        "--device", "cpu", "--output_dir", str(tmp_path / "t"), *flags,
        *port_only])
    assert stats == {"embedded": 2, "failed": 0, "skipped": 0}
    for name in names:
        ref = np.load(tmp_path / "j" / f"{name}.npy")
        out = np.load(tmp_path / "t" / f"{name}.npy")
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() / np.abs(ref).max() <= tol


def _run_both(root, tmp_path, flags, jax_flags=()):
    """The JAX CLI and the port's on the same flags; -> (jax dir, port dir,
    the port's stats)."""
    from smb_vision_tpu.cli.run_inference import main as jax_run_inference

    jax_run_inference(_common(root) + ["--attn_impl", "xla", "--output_dir",
                                       str(tmp_path / "j"), *flags,
                                       *jax_flags])
    stats = run_inference(_common(root) + [
        "--device", "cpu", "--output_dir", str(tmp_path / "t"), *flags])
    return tmp_path / "j", tmp_path / "t", stats


def test_sliding_window_matches_jax_cli(workdir, tmp_path):
    """Volumes past the 32^3 grid: 40 x 32 x 24 voxels at the pipeline's
    spacing, padded to 64 x 32 x 32, give 3 windows each (starts 0, 24 and
    32 along H), in chunks of 2: a ragged last chunk."""
    vols = tmp_path / "big"
    vols.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        save_nifti(vols / f"big_{i}.nii.gz",
                   rng.normal(0, 300, (40, 32, 24)).astype(np.int16),
                   np.diag([1.5, 1.5, 3.0, 1.0]))
    flags = ["--data_dir", str(vols), "--sliding_window", "--sw_overlap",
             "0.25"]
    jdir, tdir, stats = _run_both(workdir, tmp_path, flags)
    assert stats == {"embedded": 2, "failed": 0, "skipped": 0}
    for i in range(2):
        ref = np.load(jdir / f"big_{i}.npy")
        out = np.load(tdir / f"big_{i}.npy")
        assert out.shape == ref.shape == (3, 8, 32)
        np.testing.assert_allclose(out, ref, atol=1e-4)
    again = run_inference(_common(workdir) + flags + [
        "--device", "cpu", "--output_dir", str(tdir)])
    assert again == {"embedded": 0, "failed": 0, "skipped": 2}


# The two packages' preprocessors agree to 1e-5, not bit for bit, and the
# window of int16 HU lands many voxels on a rounding tie of the uint8 codes:
# there a one-ulp difference moves the code by one step (1/255 of the
# volume's range). The uint8 routes are therefore compared at 5e-3 of the
# largest value, after checking that the codes differ by at most one step
# in under 1 % of the voxels; the decode itself is held bit for bit in
# tests/test_torch_quantization.py.
TOL_UINT8_VS_JAX = 5e-3


def _codes_one_step_apart(root):
    from smb_vision_tpu.data.dataset import CTDataset as JDataset
    from smb_vision_tpu.data.preprocess import PreprocessConfig as JPipe
    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import PreprocessConfig

    items = [{"image": str(root / "vols" / f"case_{i}.nii.gz")}
             for i in range(2)]
    geo = ((1.5, 1.5, 3.0), (32, 32, 32))
    for i in range(2):
        a = JDataset(items=items, pipeline=JPipe(*geo), out_dtype="uint8",
                     backend="python")[i]["image"].astype(int)
        b = CTDataset(items=items, pipeline=PreprocessConfig(*geo),
                      out_dtype="uint8")[i]["image"].astype(int)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-2


def _assert_close_to_jax(out, ref, uint8):
    if uint8:
        assert np.abs(out - ref).max() / np.abs(ref).max() < TOL_UINT8_VS_JAX
    else:
        np.testing.assert_allclose(out, ref, atol=1e-4)


def test_uint8_input_matches_jax_cli(workdir, tmp_path):
    """--input_dtype uint8: codes from either package, decoded to bfloat16
    alike, then the float32 model; and within the quantisation's reach of
    the float32 route."""
    _codes_one_step_apart(workdir)
    jdir, tdir, stats = _run_both(workdir, tmp_path,
                                  ["--input_dtype", "uint8"])
    assert stats == {"embedded": 2, "failed": 0, "skipped": 0}
    run_inference(_common(workdir) + ["--device", "cpu", "--output_dir",
                                      str(tmp_path / "f")])
    for i in range(2):
        out = np.load(tdir / f"case_{i}.npy")
        _assert_close_to_jax(out, np.load(jdir / f"case_{i}.npy"), True)
        ref = np.load(tmp_path / "f" / f"case_{i}.npy")
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.05


@pytest.mark.parametrize("cache_dtype,input_dtype", [
    ("float16", "float32"), ("uint8", "uint8")])
def test_cache_matches_jax_cli_and_is_read_back(workdir, tmp_path,
                                                monkeypatch, cache_dtype,
                                                input_dtype):
    """--cache_data_dir: the embeddings match the JAX CLI's with its own
    cache; a second run with --resume false reads every volume from the
    port's cache and writes the same embeddings."""
    flags = ["--cache_dtype", cache_dtype, "--input_dtype", input_dtype]
    jdir, tdir, _ = _run_both(
        workdir, tmp_path, flags + ["--cache_data_dir", str(tmp_path / "c")],
        ["--cache_data_dir", str(tmp_path / "jc")])
    for i in range(2):
        _assert_close_to_jax(np.load(tdir / f"case_{i}.npy"),
                             np.load(jdir / f"case_{i}.npy"),
                             input_dtype == "uint8")
    assert len(list((tmp_path / "c").iterdir())) == 2
    import smb_vision_tpu_torch.data.dataset as D

    def no_decode(path):
        raise AssertionError(f"decoded {path} despite the cache")

    monkeypatch.setattr(D, "load_nifti", no_decode)
    again = run_inference(_common(workdir) + flags + [
        "--cache_data_dir", str(tmp_path / "c"), "--resume", "false",
        "--device", "cpu", "--output_dir", str(tmp_path / "t2")])
    assert again == {"embedded": 2, "failed": 0, "skipped": 0}
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / "t2" /
                                              f"case_{i}.npy"),
                                      np.load(tdir / f"case_{i}.npy"))


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
    "serve": ("ServeArguments",),
    "run_mim": ("ModelArguments", "DataTrainingArguments"),
    "run_vjepa": ("ModelArguments", "DataTrainingArguments"),
    "run_classification": ("ModelArguments", "DataTrainingArguments"),
    "run_encoders": ("EncoderArguments",),
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
    if cli not in ("run_inference", "serve", "run_encoders"):
        pairs.append((JTrain, TrainingArguments))
    for jcls, tcls in pairs:
        jf = {f.name for f in dataclasses.fields(jcls)}
        tf = {f.name for f in dataclasses.fields(tcls)}
        assert jf - tf == set(), (cli, tcls.__name__, jf - tf)
        assert tf - jf <= _PORT_ONLY, (cli, tcls.__name__, tf - jf)
    if cli == "run_encoders":
        # the zoo CLI's flags keep the JAX CLI's defaults and help (the
        # backend flags' help says more: "jax" is the PyTorch tower here)
        (jcls, tcls), = pairs
        tfields = {f.name: f for f in dataclasses.fields(tcls)}
        for f in dataclasses.fields(jcls):
            t = tfields[f.name]
            assert t.default == f.default, f.name
            assert t.metadata.get("help", "").startswith(
                f.metadata.get("help", "")), f.name
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


def _roadmap_headings():
    """{(queue, item number): the item's bold heading} of ROADMAP.md."""
    import re
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    out = {}
    for part in re.split(r"^### Queue ", text, flags=re.M)[1:]:
        queue = int(part.split(":", 1)[0])
        for m in re.finditer(r"^(\d+)\. \*\*(.+?)\*\*", part, re.M):
            out.setdefault((queue, int(m.group(1))), m.group(2))
    return out


def test_refusals_cite_roadmap_items():
    """Every refusal of the port's CLIs and modules names an item of
    ROADMAP.md by queue, number and the item's heading, in the heading's
    words; so does every other citation of ROADMAP.md in the package."""
    import re
    from pathlib import Path

    from smb_vision_tpu_torch.cli import run_classification, run_mim
    from smb_vision_tpu_torch.cli import run_inference as tinfer
    from smb_vision_tpu_torch.cli import run_vjepa
    from smb_vision_tpu_torch.cli.serve import ServeArguments, make_server
    from smb_vision_tpu_torch.models import convert
    from smb_vision_tpu_torch.models.layers import Block, QuantLinear
    from smb_vision_tpu_torch.ops.attention import attention
    from smb_vision_tpu_torch.ops.mlp import mlp_forward
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.utils.args import ROADMAP_ITEMS

    headings = _roadmap_headings()
    for queue, n, heading in ROADMAP_ITEMS.values():
        assert headings.get((queue, n), "").rstrip(".") == heading, (
            queue, n, heading)
    cite = re.compile(r"ROADMAP\.md queue (\d+) item (\d+), ([^)]+)\)")
    # context, sequence and pipeline parallelism are ported (steps 2 and 3
    # of queue 1 item 9): what stays refused is the pipeline with the
    # sliding window
    refusals = [
        lambda: tinfer.main(["--device", "cpu", "--pipeline_parallel", "2",
                             "--sliding_window", "true"]),
    ]
    # sequence parallelism under the "tp" policies runs past the refusals
    # (the CLIs stop only for want of data)
    for main, policy, data in ((run_mim.main, "tp", "--json_path"),
                               (run_vjepa.main, "fsdp+tp", "--data_path")):
        with pytest.raises(FileNotFoundError, match="spec does not exist"):
            main(["--device", "cpu", "--sequence_parallel", "true",
                  "--sharding_policy", policy, data,
                  "/nonexistent/spec.json"])
    # the kernels take head widths up to 128 and MLP widths past 1,024
    # (queue 2 items 2 and 3), under autograd too (item 5): a forced kernel
    # impl trains there (its plain versions on the CPU)
    q = torch.zeros(1, 8, 2, 72, requires_grad=True)
    attention(q, torch.zeros(1, 8, 2, 72), torch.zeros(1, 8, 2, 72),
              impl="pallas").sum().backward()
    x = torch.zeros(2, 1280, requires_grad=True)
    mlp_forward(x, torch.zeros(1280, 64), torch.zeros(64),
                torch.zeros(64, 1280), torch.zeros(1280),
                impl="pallas_bwd").sum().backward()
    assert q.grad is not None and x.grad is not None
    # W8A8 (queue 1 item 10) and head width 32 in K3 and K8 (queue 2 item
    # 1) are ported: --quant8 runs past the refusals (the CLI stops only
    # for want of data), quant8 Blocks build and K3 and K8 take d 32 (on
    # the card; test_torch_kernels.py)
    with pytest.raises(SystemExit, match="--data_dir"):
        tinfer.main(["--device", "cpu", "--quant8"])
    block = Block(8, 2, 16, quant8=True)
    assert isinstance(block.mlp.fc1, QuantLinear)
    assert isinstance(block.attention.proj, QuantLinear)
    # LoRA, the 8-bit optimizer and the zoo (queue 1 items 6 to 8) are
    # ported: their calls run past the refusals (the CLIs stop only for
    # want of data) or convert
    with pytest.raises(FileNotFoundError, match="spec does not exist"):
        run_vjepa.main(["--device", "cpu", "--optim", "adamw8bit",
                        "--data_path", "/nonexistent/spec.json"])
    with pytest.raises(SystemExit, match="train_data_path"):
        run_classification.main(["--device", "cpu", "--lora_enable",
                                 "true"])
    # and under every sharding policy (step 3 of queue 1 item 9)
    with pytest.raises(SystemExit, match="train_data_path"):
        run_classification.main(["--device", "cpu", "--lora_enable",
                                 "true", "--sharding_policy", "fsdp+tp"])
    with pytest.raises(ValueError, match="model_name_or_path"):
        make_server(ServeArguments(encoder="merlin", port=0, device="cpu"))
    assert set(convert.convert_hf_auto(
        {"vision_model.post_layernorm.weight": np.ones(4)})) == {
        "params.post_layernorm.scale"}
    assert type(make_optimizer(
        [("w", torch.nn.Parameter(torch.ones(2)))], learning_rate=1e-3,
        total_steps=1, optim="adamw8bit").opt).__name__ == "AdamW8bit"
    seen = set()
    for refuse in refusals:
        with pytest.raises(NotImplementedError) as err:
            refuse()
        m = cite.search(str(err.value))
        assert m, str(err.value)
        key = (int(m.group(1)), int(m.group(2)))
        assert headings[key].rstrip(".") == m.group(3), str(err.value)
        seen.add(key)
    assert seen == {(q, n) for q, n, h in ROADMAP_ITEMS.values()}
    # the citations in the package's sources and docstrings
    root = Path(run_mim.__file__).resolve().parents[1]
    for path in sorted(root.rglob("*.py")):
        text = re.sub(r"\s*\n\s*(#\s*)?", " ", path.read_text())
        for at in re.finditer(r"ROADMAP\.md", text):
            rest = text[at.start():at.start() + 160]
            if path.name == "args.py":
                continue                 # roadmap_ref's own f-string
            m = cite.match(rest)
            assert m, (path.name, rest[:80])
            key = (int(m.group(1)), int(m.group(2)))
            assert headings[key].rstrip(".") == m.group(3), (path.name,
                                                              rest[:80])


# -- context and pipeline parallelism through the CLIs (2 gloo ranks) --------

TRAIN_COMMON = ["--image_size", "32", "--depth", "32", "--patch_size", "16",
                "--hidden_size", "32", "--num_hidden_layers", "2",
                "--num_attention_heads", "2", "--dtype", "float32",
                "--attn_impl", "xla", "--mlp_impl", "xla",
                "--logging_steps", "1", "--device", "cpu",
                "--num_workers", "1", "--per_device_train_batch_size", "2",
                "--per_device_eval_batch_size", "2", "--seed", "3",
                "--save_steps", "2", "--lr_scheduler_type", "constant",
                "--learning_rate", "1e-3"]
TRAIN_CLIS = {
    "run_mim": lambda spec: [
        "--json_path", str(spec), "--mask_patch_size", "16",
        "--mask_ratio", "0.5", "--intermediate_size", "64",
        "--config_overrides",
        "decoder_hidden_size=32,decoder_num_hidden_layers=2,"
        "decoder_intermediate_size=64,decoder_num_attention_heads=2"],
    "run_vjepa": lambda spec: [
        "--data_path", str(spec), "--pred_hidden_size", "16",
        "--pred_num_hidden_layers", "2", "--pred_num_attention_heads", "2",
        "--teacher_attn_impl", "xla", "--num_mask_blocks", "2"],
}


@pytest.fixture(scope="module")
def train_spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_vols")
    rng = np.random.default_rng(2)
    items = []
    for i in range(6):
        path = root / f"ct_{i}.nii"
        save_nifti(path, rng.normal(-200, 400, (16, 16, 16)).clip(
            -1024, 3000).astype(np.int16), np.diag([6.0, 6.0, 6.0, 1.0]))
        items.append({"image": str(path)})
    spec = root / "data.json"
    spec.write_text(json.dumps({"train": items[:4],
                                "validation": items[4:]}))
    return spec


def _losses(out):
    return {r["step"]: r["loss"] for r in map(
        json.loads, (out / "metrics.jsonl").read_text().splitlines())
        if "loss" in r}


@pytest.fixture(scope="module")
def dense_runs(train_spec, tmp_path_factory):
    """Each training CLI in this process, one device, 4 steps: the
    reference of the sequence-parallel and pipelined runs (same seed,
    data order and masks)."""
    from smb_vision_tpu_torch.cli import run_mim, run_vjepa

    out = {}
    for cli, main in (("run_mim", run_mim.main),
                      ("run_vjepa", run_vjepa.main)):
        d = tmp_path_factory.mktemp(f"dense_{cli}")
        main(TRAIN_COMMON + TRAIN_CLIS[cli](train_spec)
             + ["--num_train_steps", "4", "--output_dir", str(d)])
        out[cli] = d
    return out


def _same_losses(got, want, steps):
    for s in steps:
        assert abs(got[s] - want[s]) <= 1e-5 * abs(want[s]), (s, got, want)


@pytest.mark.parametrize("cli", sorted(TRAIN_CLIS))
def test_pipelined_cli_trains_evals_exports_and_resumes(
        train_spec, dense_runs, tmp_path, cli):
    """--pipeline_stages 2 on 2 gloo ranks (torch.distributed.run): each
    step's loss that of the one-device run (the stages' initialisation is
    the dense model's, the draws the same), the eval logged, a sharded
    checkpoint, and a dense-layout export (no stacked name) that the JAX
    package's model takes whole; then one process without the pipeline (a
    stage count of 1) resumes the pipelined checkpoint to 4 steps on the
    one-device run's losses."""
    from test_torch_parallel import _torchrun

    from smb_vision_tpu.models.configs import VideoMAEConfig as JV
    from smb_vision_tpu.models.configs import VJEPA2Config as JJ
    from smb_vision_tpu.utils.serialization import load_params_into
    from smb_vision_tpu.models.videomae import VideoMAEForPreTraining as JM
    from smb_vision_tpu.models.vjepa import VJEPA2Model as JVJ
    from smb_vision_tpu_torch.cli import run_mim, run_vjepa
    from smb_vision_tpu_torch.models import convert

    out = tmp_path / "pipe"
    args = TRAIN_COMMON + TRAIN_CLIS[cli](train_spec)
    extra = ["--export_hf", "true"] if cli == "run_mim" else []
    _torchrun(["-m", f"smb_vision_tpu_torch.cli.{cli}", *args, *extra,
               "--pipeline_stages", "2", "--num_train_steps", "2",
               "--do_eval", "true", "--output_dir", str(out)], tmp_path,
              nproc=2)
    want = _losses(dense_runs[cli])
    _same_losses(_losses(out), want, (1, 2))
    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert any(np.isfinite(r.get("eval_loss", np.nan)) for r in recs)
    assert (out / "checkpoints" / "2" / "meta.pt").exists()
    export = convert.read_safetensors(out / "model.safetensors")
    dense = convert.read_safetensors(dense_runs[cli] / "model.safetensors")
    assert set(export) == set(dense)
    assert not any("stacked" in k for k in export)
    if cli == "run_mim":
        cfg = JV.from_json(str(out / "config.json"))
        jparams = jax.eval_shape(lambda k, x, m: JM(cfg).init(k, x, m, 4),
                                 jax.random.PRNGKey(0),
                                 np.zeros((1, 32, 1, 32, 32), np.float32),
                                 np.zeros((1, 8), bool))
        hf = convert.read_safetensors(out / "hf_model.safetensors")
        assert not any("stacked" in k for k in hf)
    else:
        cfg = JJ.from_json(str(out / "config.json"))
        jparams = jax.eval_shape(lambda k, x: JVJ(cfg).init(
            k, x, target_bool=np.zeros((1, 8), bool)),
            jax.random.PRNGKey(0), np.zeros((1, 32, 1, 32, 32), np.float32))
    _, loaded, skipped = load_params_into(jparams, out / "model.safetensors")
    assert skipped == [] and len(loaded) == len(export)
    main = run_mim.main if cli == "run_mim" else run_vjepa.main
    main(args + ["--num_train_steps", "4", "--output_dir", str(out)])
    _same_losses(_losses(out), want, (1, 2, 3, 4))


@pytest.mark.parametrize("cli,variant", [("run_mim", "gather"),
                                         ("run_vjepa", "ring")])
def test_sequence_parallel_cli_matches_one_device(
        train_spec, dense_runs, tmp_path, cli, variant):
    """--sequence_parallel over a model axis of 2 gloo ranks, each
    sp_variant: the tokens split, every step's loss that of the one-device
    run."""
    from test_torch_parallel import _torchrun

    out = tmp_path / "sp"
    args = TRAIN_COMMON + TRAIN_CLIS[cli](train_spec)
    i = args.index("--config_overrides") if "--config_overrides" in args \
        else None
    if i is None:
        args += ["--config_overrides", f"sp_variant={variant}"]
    else:
        args[i + 1] += f",sp_variant={variant}"
    _torchrun(["-m", f"smb_vision_tpu_torch.cli.{cli}", *args,
               "--sequence_parallel", "true", "--model_parallel", "2",
               "--num_train_steps", "2", "--output_dir", str(out)],
              tmp_path, nproc=2)
    _same_losses(_losses(out), _losses(dense_runs[cli]), (1, 2))


def test_run_inference_pipeline_parallel_matches_jax_cli(workdir, tmp_path):
    """run_inference --pipeline_parallel 2 on 2 gloo ranks (each builds its
    layer of the 2-layer encoder, rank 0 writes) against the JAX CLI on
    the same export."""
    from test_torch_parallel import _torchrun

    from smb_vision_tpu.cli.run_inference import main as jax_run_inference

    jax_run_inference(_common(workdir) + ["--attn_impl", "xla",
                                          "--output_dir", str(tmp_path / "j")])
    log = _torchrun(["-m", "smb_vision_tpu_torch.cli.run_inference",
                     *_common(workdir), "--device", "cpu",
                     "--pipeline_parallel", "2", "--output_dir",
                     str(tmp_path / "t")], tmp_path, nproc=2)
    assert '"embedded": 2' in log
    for i in range(2):
        ref = np.load(tmp_path / "j" / f"case_{i}.npy")
        out = np.load(tmp_path / "t" / f"case_{i}.npy")
        assert out.shape == ref.shape == (8, 32)
        np.testing.assert_allclose(out, ref, atol=1e-4)


def test_run_inference_pipeline_parallel_quant8_matches_jax_cli(workdir,
                                                                tmp_path):
    """run_inference --quant8 --pipeline_parallel 2 on 2 gloo ranks (each
    stage's layer on W8A8) against the JAX CLI's --quant8 on the same
    export, within 1e-4 of max (as the one-device quant8 run)."""
    from test_torch_parallel import _torchrun

    from smb_vision_tpu.cli.run_inference import main as jax_run_inference

    jax_run_inference(_common(workdir) + ["--attn_impl", "xla", "--quant8",
                                          "--output_dir", str(tmp_path / "j")])
    log = _torchrun(["-m", "smb_vision_tpu_torch.cli.run_inference",
                     *_common(workdir), "--device", "cpu", "--quant8",
                     "--pipeline_parallel", "2", "--output_dir",
                     str(tmp_path / "t")], tmp_path, nproc=2)
    assert '"embedded": 2' in log
    for i in range(2):
        ref = np.load(tmp_path / "j" / f"case_{i}.npy")
        out = np.load(tmp_path / "t" / f"case_{i}.npy")
        assert out.shape == ref.shape == (8, 32)
        assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-4


def test_pipeline_flags_refuse_as_the_jax_cli(train_spec, tmp_path):
    """The JAX CLI's refusals: gradient accumulation with stages (the
    microbatches replace it), the pipeline with sequence parallelism."""
    from smb_vision_tpu_torch.cli import run_mim

    args = TRAIN_COMMON + TRAIN_CLIS["run_mim"](train_spec) + [
        "--output_dir", str(tmp_path), "--pipeline_stages", "2"]
    with pytest.raises(SystemExit, match="gradient accumulation"):
        run_mim.main(args + ["--gradient_accumulation_steps", "2"])
    with pytest.raises(ValueError, match="sequence parallelism"):
        run_mim.main(args + ["--sequence_parallel", "true"])
