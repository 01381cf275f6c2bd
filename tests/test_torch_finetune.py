"""The port's fine-tuning path against the JAX package on the CPU: the
VideoMAE and V-JEPA2 classification models, the losses and metrics, the
two-tier learning-rate trajectory of `make_classification_workload`, and
`run_classification` end to end on its three routes."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import Dinov2Config as JDinoConfig
from smb_vision_tpu.models.configs import VideoMAEConfig as JVConfig
from smb_vision_tpu.models.configs import VJEPA2Config as JJConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification as JDino
from smb_vision_tpu.models.videomae import VideoMAEForVideoClassification \
    as JVideo
from smb_vision_tpu.models.videomae import \
    classification_loss as jclassification_loss
from smb_vision_tpu.models.vjepa import VJEPA2ForVideoClassification as JJepa
from smb_vision_tpu.train import classification as jcls
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.train.losses import cox_loss as jcox_loss
from smb_vision_tpu.train.metrics import compute_metrics as jmetrics
from smb_vision_tpu.utils.profiling import encoder_flops_per_sample
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.cli import run_classification
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import (
    Dinov2Config,
    VideoMAEConfig,
    VJEPA2Config,
)
from smb_vision_tpu_torch.models.videomae import (
    VideoMAEForVideoClassification,
    classification_loss,
)
from smb_vision_tpu_torch.models.vjepa import VJEPA2ForVideoClassification
from smb_vision_tpu_torch.train import classification as tcls
from smb_vision_tpu_torch.train import optim as toptim
from smb_vision_tpu_torch.train.losses import cox_loss
from smb_vision_tpu_torch.train.metrics import compute_metrics
from smb_vision_tpu_torch.train.trainer import Trainer
from smb_vision_tpu_torch.utils.profiling import (
    classification_flops_per_sample,
)

torch.set_num_threads(1)

VIDEO = dict(image_size=32, num_frames=32, patch_size=16, tubelet_size=16,
             num_channels=1, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128, dtype="float32",
             attn_impl="xla", mlp_impl="xla")
JEPA = dict(crop_size=32, frames_per_clip=32, patch_size=16, tubelet_size=16,
            in_chans=1, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_pooler_layers=2, dtype="float32",
            attn_impl="xla", mlp_impl="xla")
DINO = dict(image_size=32, depth=32, patch_size=16, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4, use_swiglu_ffn=True,
            layerscale_value=0.7, dtype="float32", attn_impl="xla",
            mlp_impl="xla")
ROUTES = {"videomae": (VideoMAEConfig, JVConfig, JVideo, VIDEO,
                       (32, 1, 32, 32)),
          "vjepa2": (VJEPA2Config, JJConfig, JJepa, JEPA, (32, 1, 32, 32)),
          "dinov2": (Dinov2Config, JDinoConfig, JDino, DINO, (1, 32, 32, 32))}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pixels(shape, b=2, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (b, *shape)).astype(
        np.float32)


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 or p.shape[0] == 1 else p, params)


def test_videomae_classification_matches_jax():
    """Mean-pool, fc_norm, two tabular columns fused at the head: logits
    within 1e-4 of max, the loss within 1e-5 relative."""
    kw = dict(VIDEO, num_labels=3, additional_features_size=2,
              problem_type="single_label_classification")
    jcfg = JVConfig(**kw)
    px = _pixels((32, 1, 32, 32))
    feats = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
    labels = np.array([2, 0], np.int32)
    params = _perturbed(jax.jit(JVideo(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), px[:1], feats[:1]))
    want = JVideo(jcfg).apply(params, px, feats, labels=labels)
    model = VideoMAEForVideoClassification(VideoMAEConfig(**kw))
    model.load_state_dict(convert.params_from_flax(flatten_params(params),
                                                   classification=True))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(px), torch.from_numpy(feats),
                           labels=torch.from_numpy(labels))
    assert _rel(got["logits"], want["logits"]) <= 1e-4
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))
    with pytest.raises(ValueError, match="additional_features of size 2"):
        model(torch.from_numpy(px), torch.from_numpy(feats[:, :1]))


def test_vjepa_classification_matches_jax():
    """The encoder, the attentive pooler (self-attention layers, then the
    one-query cross-attention without an output projection) and the f32
    head: logits within 1e-4 of max, the loss within 1e-5 relative."""
    kw = dict(JEPA, num_labels=3)
    jcfg = JJConfig(**kw)
    px = _pixels((32, 1, 32, 32), seed=2)
    labels = np.array([1, 2], np.int32)
    params = _perturbed(jax.jit(JJepa(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), px[:1]))
    want = JJepa(jcfg).apply(params, px, labels=labels)
    model = VJEPA2ForVideoClassification(VJEPA2Config(**kw))
    model.load_state_dict(convert.params_from_flax(flatten_params(params),
                                                   classification=True))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(px),
                           labels=torch.from_numpy(labels))
    assert got["logits"].dtype == torch.float32
    assert _rel(got["logits"], want["logits"]) <= 1e-4
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))
    # the export of the whole tree goes back to the JAX names
    flat = convert.params_to_flax(model.state_dict())
    assert sorted(flat) == sorted(flatten_params(params))


def test_load_backbone_into_the_vjepa2_head(tmp_path):
    """A head model's export (`params.vjepa2.encoder.*`) and a pretraining
    export (`params.encoder.*` beside the predictor) both load into the
    head model's `vjepa2.` backbone; the pooler and head stay as they
    were."""
    from smb_vision_tpu.models.vjepa import VJEPA2Model as JPre
    from smb_vision_tpu.utils.serialization import save_params_safetensors

    kw = dict(JEPA, num_labels=3)
    jcfg = JJConfig(**kw)
    px = _pixels((32, 1, 32, 32), b=1)
    head = jax.jit(JJepa(impl_neutral(jcfg)).init)(jax.random.PRNGKey(0), px)
    pre = jax.jit(JPre(impl_neutral(jcfg)).init)(jax.random.PRNGKey(1), px)
    save_params_safetensors(head, str(tmp_path / "head.safetensors"))
    save_params_safetensors(pre, str(tmp_path / "pre.safetensors"))
    for name, params, prefix in (("head", head, "params.vjepa2."),
                                 ("pre", pre, "params.")):
        model = VJEPA2ForVideoClassification(VJEPA2Config(**kw))
        model.init_weights(torch.Generator().manual_seed(2))
        pooler = {k: v.clone() for k, v in model.pooler.state_dict().items()}
        convert.load_backbone_into(model, tmp_path / f"{name}.safetensors")
        flat = flatten_params(params)
        got = convert.params_to_flax(model.vjepa2.state_dict())
        for k, v in got.items():
            np.testing.assert_array_equal(
                v, np.asarray(flat[prefix + k[len("params."):]]))
        for k, v in model.pooler.state_dict().items():
            assert torch.equal(v, pooler[k]), k


@pytest.mark.parametrize("valid", [None, [1, 1, 0, 1, 0, 1]])
def test_cox_loss_matches_jax(valid):
    rng = np.random.default_rng(3)
    risk = rng.standard_normal(6).astype(np.float32)
    dur = np.array([5.0, 1.0, 3.0, 3.0, 8.0, 2.0], np.float32)
    ev = np.array([1, 0, 1, 1, 0, 1], np.float32)
    v = None if valid is None else np.asarray(valid, np.float32)
    want = float(jcox_loss(risk, dur, ev,
                           valid=None if v is None else np.asarray(v)))
    got = float(cox_loss(*map(torch.from_numpy, (risk, dur, ev)),
                         valid=None if v is None else torch.from_numpy(v)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("problem_type,with_valid", [
    ("single_label_classification", False),
    ("single_label_classification", True),
    ("multi_label_classification", True), ("regression", True),
    (None, False)])
def test_classification_loss_matches_jax(problem_type, with_valid):
    rng = np.random.default_rng(4)
    n_labels = 1 if problem_type == "regression" else 3
    logits = rng.standard_normal((5, n_labels)).astype(np.float32)
    if problem_type == "multi_label_classification":
        labels = (rng.uniform(size=(5, 3)) < 0.5).astype(np.float32)
    elif problem_type == "regression":
        labels = rng.standard_normal(5).astype(np.float32)
    else:
        labels = rng.integers(0, 3, 5).astype(np.int32)
    valid = np.array([1, 0, 1, 1, 0], np.float32) if with_valid else None
    want = float(jclassification_loss(logits, labels, n_labels,
                                      problem_type, valid=valid))
    got = float(classification_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), n_labels,
        problem_type, valid=None if valid is None else torch.from_numpy(
            valid)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("task", ["survival", "cox_regression",
                                  "multilabel_classification",
                                  "classification", "classification3",
                                  "regression"])
def test_compute_metrics_matches_jax(task):
    rng = np.random.default_rng(5)
    n = 40
    if task in ("survival", "cox_regression"):
        preds = rng.standard_normal((n, 1))
        labels = {"duration": rng.integers(1, 20, n).astype(np.float32),
                  "event": (rng.uniform(size=n) < 0.6).astype(np.float32)}
    elif task == "multilabel_classification":
        preds = rng.standard_normal((n, 4))
        labels = (rng.uniform(size=(n, 4)) < 0.4).astype(np.float32)
    elif task == "regression":
        preds, labels = rng.standard_normal((n, 1)), rng.standard_normal(n)
    else:
        k = 3 if task == "classification3" else 2
        preds = np.round(rng.standard_normal((n, k)), 1)    # with ties
        labels = rng.integers(0, k, n)
    name = "classification" if task == "classification3" else task
    got = compute_metrics(name, preds, labels)
    assert got == jmetrics(name, preds, labels)
    assert got and all(np.isfinite(v) for v in got.values())


def _batches(route, task, n=3):
    shape = ROUTES[route][4]
    out = []
    for i in range(n):
        b = {"pixel_values": _pixels(shape, seed=20 + i)}
        if task == "survival":
            b["duration"] = np.array([3.0 + i, 1.0], np.float32)
            b["event"] = np.array([1.0, 1.0 if i else 0.0], np.float32)
            b["additional_features"] = np.array([[0.5 * i], [-1.0]],
                                                np.float32)
        else:
            b["labels"] = np.array([i % 3, 2 - i % 3], np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("route,task", [("dinov2", "classification"),
                                        ("videomae", "survival")])
def test_two_tier_trajectory_matches_jax(route, task):
    """Three optimizer steps of both make_classification_workloads from
    the same weights on the same batches, with vision_lr, merger_lr and
    learning_rate all different (the VideoMAE fc_norm neck stays at
    learning_rate): the loss within 1e-3 relative at every step."""
    cfgcls, jcfgcls, jmodel, kw, _ = ROUTES[route]
    n_labels = 1 if task == "survival" else 3
    extra = dict(num_labels=n_labels,
                 problem_type=tcls.problem_type_for(task, n_labels))
    if route == "videomae":
        extra["additional_features_size"] = 1
    opt = dict(learning_rate=1e-3, total_steps=3, warmup_ratio=0.34,
               weight_decay=0.05, vision_lr=2e-4, merger_lr=5e-3)
    batches = _batches(route, task)
    jcfg = jcfgcls(**kw, **extra)
    jinit, jstep, _ = jcls.make_classification_workload(
        jmodel(jcfg), jcfg, task_type=task,
        tx=joptim.make_optimizer(**opt))
    jstate = jinit(jax.random.PRNGKey(0), batches[0])
    jstep = jax.jit(jstep)
    model, init_fn, step_fn, _ = tcls.make_classification_workload(
        cfgcls(**kw, **extra), task_type=task,
        tx=functools.partial(toptim.make_optimizer, **opt))
    state = init_fn(0)
    model.load_state_dict(convert.params_from_flax(
        flatten_params(jstate["params"]), classification=True))
    tiers = {g["tier"] for g in state["optimizer"].opt.param_groups}
    assert tiers == {"default", "vision", "head"} if route == "videomae" \
        else {"vision", "head"} <= tiers
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(i))
        m = step_fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
            float(jm["loss"])), i
    assert state["step"] == 3


def test_finetune_flops_count_swiglus_three_products():
    """DINOv2-giant at 224^2 x 160: 16.2 TFLOP a training sample, 2.75
    GFLOP a token forward; a gelu VideoMAE counts as the JAX package's
    encoder count (x3 for training, plus the patch embedding)."""
    giant = Dinov2Config(hidden_size=1536, num_hidden_layers=40,
                         num_attention_heads=24, use_swiglu_ffn=True)
    flops = classification_flops_per_sample(giant)
    assert flops == pytest.approx(16.23e12, rel=1e-3)
    n, d, i = 1961, 1536, 4096
    assert (flops - 3 * 2 * n * 4096 * d) / 3 / 40 / n == pytest.approx(
        2.746e9 / 40, rel=1e-3)
    vcfg = VideoMAEConfig()
    embed = 3 * 2 * vcfg.seq_len * vcfg.patch_dim * vcfg.hidden_size
    assert classification_flops_per_sample(vcfg) == pytest.approx(
        3 * encoder_flops_per_sample(JVConfig()) + embed, rel=1e-9)
    # the gate product on top of the two the JAX count has
    jflops = 3 * encoder_flops_per_sample(JDinoConfig(
        hidden_size=1536, num_hidden_layers=40, num_attention_heads=24,
        use_swiglu_ffn=True))
    assert flops > jflops + 3 * 2 * 1960 * d * i * 40


@pytest.fixture
def survival_data(tmp_path):
    rng = np.random.default_rng(0)
    items = []
    for i in range(6):
        hu = rng.normal(-200, 400, (16, 16, 16)).clip(-1024, 3000)
        path = tmp_path / f"ct_{i}.nii"
        save_nifti(path, hu.astype(np.int16), np.diag([6.0, 6.0, 6.0, 1.0]))
        items.append({"image": str(path), "os": float(3 + 2 * i % 7),
                      "os_event": float(i % 3 != 1), "age": 40.0 + 5 * i,
                      "label": i % 2})
    spec = tmp_path / "data.json"
    spec.write_text(json.dumps({"train": items[:3], "validation": items[3:]}))
    return spec


def _cls_args(spec, out, route, steps, tmp_path):
    args = ["--train_data_path", str(spec), "--val_data_path", str(spec),
            "--output_dir", str(out), "--task_type", "survival",
            "--additional_feature_columns", "age",
            "--image_size", "32", "--depth", "32", "--patch_size", "16",
            "--hidden_size", "64", "--num_hidden_layers", "2",
            "--num_attention_heads", "2", "--intermediate_size", "128",
            "--dtype", "float32", "--attn_impl", "xla",
            "--vision_lr", "1e-4", "--merger_lr", "1e-3",
            "--learning_rate", "5e-4", "--per_device_train_batch_size", "2",
            "--per_device_eval_batch_size", "2", "--num_train_steps",
            str(steps), "--save_steps", "2", "--logging_steps", "1",
            "--do_eval", "true", "--device", "cpu", "--num_workers", "2"]
    if route == "dinov2":
        # a SwiGLU DINOv2 from a config file, mlp_impl "pallas": K9's
        # plain version on the CPU (hidden 384: a SwiGLU width of 1,024,
        # which K9 takes)
        path = tmp_path / "dinov2.json"
        Dinov2Config(image_size=32, depth=32, patch_size=16, hidden_size=384,
                     num_hidden_layers=2, num_attention_heads=6,
                     use_swiglu_ffn=True, mlp_impl="pallas").save_json(
            str(path))
        return args + ["--config_name_or_path", str(path)]
    return args + ["--model_type", route, "--mlp_impl", "xla"]


@pytest.mark.parametrize("route", ["videomae", "dinov2", "vjepa2"])
def test_run_classification_trains_resumes_and_evaluates(survival_data,
                                                         tmp_path, route):
    """A survival task with one tabular column: 4 steps with checkpoints,
    then a resume to 6; the eval loss and the C-index over the (padded)
    eval set are written."""
    out = tmp_path / "out"
    res = run_classification.main(_cls_args(survival_data, out, route, 4,
                                             tmp_path))
    assert res["train_steps"] == 4 and np.isfinite(res["eval_loss"])
    res = run_classification.main(_cls_args(survival_data, out, route, 6,
                                            tmp_path))
    assert res["train_steps"] == 6
    assert 0.0 <= res["eval_c_index"] <= 1.0
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert sum("eval_c_index" in r for r in recs) == 2
    assert Trainer.checkpoint_steps(out / "checkpoints") == [2, 4, 6]
    cfg = json.loads((out / "config.json").read_text())
    assert (cfg["model_type"], cfg["num_labels"]) == (route, 1)
    names = convert.read_safetensors(out / "model.safetensors")
    assert any(k.startswith(f"params.{route}.") for k in names)
    assert "params.classifier.kernel" in names
    if route == "videomae":      # the tabular column widens the head
        assert names["params.classifier.kernel"].shape == (65, 1)
    if route == "dinov2":
        assert cfg["mlp_impl"] == "pallas" and cfg["use_swiglu_ffn"]


@pytest.mark.parametrize("flags,item", [
    (["--model_parallel", "2"], "item 9, Multi-GPU"),
    (["--sharding_policy", "tp"], "item 9, Multi-GPU"),
    (["--multihost", "true"], "item 9, Multi-GPU"),
])
def test_run_classification_unported_flags_raise(flags, item):
    """The multi-GPU flags are ported: --model_parallel 2 on one process
    raises the mesh's own error, --sharding_policy tp runs past the
    flags (and stops for want of data), and --multihost true without a
    launcher's rendezvous variables raises instead of training alone."""
    args = ["--device", "cpu"] + flags
    if flags[0] == "--model_parallel":
        with pytest.raises(ValueError, match="not divisible by model=2"):
            run_classification.main(args)
    elif flags[0] == "--sharding_policy":
        with pytest.raises(SystemExit, match="train_data_path is required"):
            run_classification.main(args)
    else:
        with pytest.raises(RuntimeError, match="MASTER_ADDR"):
            run_classification.main(args)


@pytest.mark.parametrize("flags", [
    ["--cache_data_dir", "CACHE", "--cache_dtype", "float16"],
    ["--input_dtype", "uint8"]], ids=["cache", "uint8"])
def test_run_classification_ported_flags_run(survival_data, tmp_path, flags):
    """--cache_data_dir fills the cache with the volumes read, and
    --input_dtype uint8 trains and evaluates (the C-index) on codes
    decoded on the device, the labels and tabular column untouched."""
    from smb_vision_tpu_torch.data import quantization

    flags = [str(tmp_path / "cache") if f == "CACHE" else f for f in flags]
    seen = []
    real = quantization.dequantize_batch

    def decode(batch, dtype=torch.float32):
        seen.append((batch["pixel_values"].dtype, batch["duration"].dtype,
                     batch["additional_features"].dtype))
        return real(batch, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantization, "dequantize_batch", decode)
        res = run_classification.main(_cls_args(
            survival_data, tmp_path / "out", "videomae", 2, tmp_path)
            + flags)
    assert res["train_steps"] == 2 and np.isfinite(res["eval_loss"])
    assert 0.0 <= res["eval_c_index"] <= 1.0
    if "--input_dtype" in flags:
        assert seen and all(s == (torch.uint8, torch.float32, torch.float32)
                            for s in seen)
    else:
        # the 3 evaluation volumes and the 2 that both training batches
        # drew (batch 2 of 3 volumes, drop_last, the seeded shuffle)
        assert len(list((tmp_path / "cache").glob("*.npy"))) == 5


def test_run_classification_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_classification.main(["--device", "cuda"])


def test_run_classification_config_file_impls_stand(tmp_path):
    """A config file's impls stand against the flags' defaults; a flag
    given another value overrides them."""
    path = tmp_path / "cfg.json"
    Dinov2Config(use_swiglu_ffn=True, mlp_impl="pallas",
                 gradient_checkpointing=True).save_json(str(path))
    data = run_classification.DataTrainingArguments(task_type="regression")
    cfg, pipe = run_classification.build_config(
        run_classification.ModelArguments(config_name_or_path=str(path)),
        data)
    assert (cfg.model_type, pipe, cfg.mlp_impl, cfg.gradient_checkpointing,
            cfg.num_labels, cfg.problem_type) == (
        "dinov2", "dinov2", "pallas", True, 1, "regression")
    cfg, _ = run_classification.build_config(
        run_classification.ModelArguments(
            config_name_or_path=str(path), mlp_impl="xla",
            config_overrides="drop_path_rate=0.1,num_hidden_layers=3"), data)
    assert (cfg.mlp_impl, cfg.drop_path_rate, cfg.num_hidden_layers) == (
        "xla", 0.1, 3)
    cfg, pipe = run_classification.build_config(
        run_classification.ModelArguments(
            model_name_or_path="hub/vjepa2-vitl"), data)
    assert (cfg.model_type, pipe, cfg.in_chans) == ("vjepa2", "smb-vision",
                                                    1)
