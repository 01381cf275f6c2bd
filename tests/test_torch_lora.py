"""The port's LoRA fine-tuning (`train/lora.py`) against the JAX package's
on the CPU: the six cases of tests/test_lora.py, a tiny VideoMAE and a
tiny DINOv2 with the JAX adapters carried across (merged forward within
1e-5 of max, adapter gradients within 1e-4 relative), the hand-kernel
routes' adapter gradients against the plain route's, `lora.safetensors`
written by either package loaded into the other, and a 3-step
`make_lora_classification_workload` trajectory within 1e-3 relative a
step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils import parametrize

from smb_vision_tpu.models.configs import Dinov2Config as JDinoConfig
from smb_vision_tpu.models.configs import VideoMAEConfig as JVConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification as JDino
from smb_vision_tpu.models.videomae import VideoMAEForVideoClassification \
    as JVideo
from smb_vision_tpu.train import lora as jlora
from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.utils.serialization import (
    flatten_params,
    load_params_safetensors,
    save_params_safetensors,
)
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import Dinov2Config, VideoMAEConfig
from smb_vision_tpu_torch.models.dinov2 import Dinov2ForImageClassification
from smb_vision_tpu_torch.models.videomae import (
    VideoMAEForVideoClassification,
)
from smb_vision_tpu_torch.train import lora
from smb_vision_tpu_torch.train import optim as toptim

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
VIDEO = dict(image_size=16, num_frames=16, patch_size=8, tubelet_size=8,
             num_channels=1, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=64, num_labels=2,
             problem_type="single_label_classification", dtype="float32",
             attn_impl="xla", mlp_impl="xla")
# hidden 128, SwiGLU width 256: widths the K9 route (mlp_impl "pallas")
# and the flash route (head width 32) take
DINO = dict(image_size=32, depth=32, patch_size=16, hidden_size=128,
            num_hidden_layers=2, num_attention_heads=4, mlp_ratio=3,
            use_swiglu_ffn=True, layerscale_value=0.7, num_labels=2,
            problem_type="single_label_classification", dtype="float32",
            attn_impl="xla", mlp_impl="xla")
FAMILIES = {"videomae": (VideoMAEConfig, JVConfig, JVideo,
                         VideoMAEForVideoClassification, VIDEO,
                         (16, 1, 16, 16)),
            "dinov2": (Dinov2Config, JDinoConfig, JDino,
                       Dinov2ForImageClassification, DINO, (1, 32, 32, 32))}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(family="videomae", **kw):
    """(JAX model, its params, port model with the same weights, pixels,
    labels)."""
    tcfg, jcfg, jcls, tcls, geom, shape = FAMILIES[family]
    cfg = dict(geom, **kw)
    px = np.random.default_rng(1).uniform(0, 1, (2, *shape)).astype(
        np.float32)
    jc = jcfg(**cfg)
    params = jax.jit(jcls(impl_neutral(jc)).init)(KEY, px[:1])
    model = tcls(tcfg(**cfg))
    model.load_state_dict(convert.params_from_flax(
        flatten_params(params), classification=True, backbone=family))
    return jcls(jc), params, model, px, np.array([0, 1], np.int32)


def _carry(model, adapters):
    """Copy JAX adapters {path: {a, b}} into the port's."""
    got = lora.adapted(model)
    assert set(got) == set(adapters)
    with torch.no_grad():
        for path, (_, d) in got.items():
            d.a.copy_(torch.from_numpy(np.asarray(adapters[path]["a"])))
            d.b.copy_(torch.from_numpy(np.asarray(adapters[path]["b"])))


def _active(adapters, seed=3):
    """Adapters with B perturbed, so the merge does something."""
    rng = np.random.default_rng(seed)
    return {k: {"a": v["a"], "b": v["b"] + rng.normal(
        0, 0.05, v["b"].shape).astype(np.float32)}
        for k, v in adapters.items()}


def _logits(model, px, labels=None):
    out = model(torch.from_numpy(px), labels=None if labels is None
                else torch.from_numpy(labels))
    return out


def test_lora_identity_at_init():
    _, _, model, px, _ = _setup()
    model.eval()
    with torch.no_grad():
        base = _logits(model, px)["logits"]
        lora.init_lora(model, torch.Generator().manual_seed(0), rank=4)
        adapted = _logits(model, px)["logits"]
    np.testing.assert_allclose(adapted.numpy(), base.numpy(), atol=1e-6)


def test_lora_gradients_flow_only_to_adapters_and_head():
    _, _, model, px, labels = _setup()
    lora.init_lora(model, torch.Generator().manual_seed(0), rank=4)
    model.train()
    _logits(model, px, labels)["loss"].backward()
    named = dict(lora.lora_named_parameters(model))
    trainable = {id(p) for p in named.values()}
    for name, p in model.named_parameters():
        if id(p) not in trainable:
            assert not p.requires_grad and p.grad is None, name
    assert sum(float(p.grad.abs().sum()) for n, p in named.items()
               if n.endswith("/b")) > 0, "no gradient reached adapter B"
    assert sum(float(p.grad.abs().sum()) for n, p in named.items()
               if n.startswith("head/")) > 0, "no gradient reached the head"


def test_lora_merge_changes_output():
    _, _, model, px, _ = _setup()
    model.eval()
    with torch.no_grad():
        base = _logits(model, px)["logits"]
        lora.init_lora(model, torch.Generator().manual_seed(0), rank=4)
        for _, d in lora.adapted(model).values():
            d.b.add_(0.1)
        out = _logits(model, px)["logits"]
    assert float((out - base).abs().max()) > 1e-4
    assert lora.lora_size(model) > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lora_targets_cover_attention_and_mlp(family):
    """The port's adapters sit on exactly the JAX package's paths: q, k,
    v, proj and fc1/fc2, or SwiGLU's weights_in/weights_out."""
    _, params, model, _, _ = _setup(family)
    lora.init_lora(model, rank=2)
    names = set(lora.adapted(model))
    assert names == set(jlora.init_lora(params, KEY, rank=2))
    frags = (("query", "key", "value", "proj")
             + (("weights_in", "weights_out") if family == "dinov2"
                else ("fc1", "fc2")))
    for frag in frags:
        assert any(f"/{frag}/" in n for n in names), frag
    assert set(lora.head_parameters(model)) == set(jlora.split_head(params))


def _workload(cfg_kw, tx, family="videomae", **kw):
    tcfg = FAMILIES[family][0]
    return lora.make_lora_classification_workload(
        tcfg(**cfg_kw), task_type="classification", tx=tx, **kw)


def _load_base(model, flat):
    """The JAX parameters into a model that carries adapters: an adapted
    weight goes to its parametrization's original."""
    state = {}
    for k, v in convert.params_from_flax(flat, classification=True,
                                         backbone="videomae").items():
        mod = k.rsplit(".", 1)[0]
        if k.endswith(".weight") and parametrize.is_parametrized(
                model.get_submodule(mod), "weight"):
            k = mod + ".parametrizations.weight.original"
        state[k] = v
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all(".parametrizations.weight.0." in k
                                  for k in missing)


def test_lora_workload_steps_without_meta_drift():
    """alpha and rank live in state["lora_meta"], outside the optimizer:
    aggressive decay leaves them alone and trains the adapters."""
    model, init_fn, step_fn, _ = _workload(VIDEO, functools.partial(
        toptim.make_optimizer, learning_rate=1e-2, total_steps=3,
        weight_decay=0.1), rank=4, alpha=16.0)
    state = init_fn(0)
    assert state["lora_meta"] == {"alpha": 16.0, "rank": 4.0}
    opt_params = {id(p) for g in state["optimizer"].opt.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for _, p in
                          lora.lora_named_parameters(model)}
    b0 = {k: d.b.detach().clone() for k, (_, d)
          in lora.adapted(model).items()}
    _, _, _, px, labels = _setup()
    batch = {"pixel_values": torch.from_numpy(px),
             "labels": torch.from_numpy(labels)}
    for _ in range(3):
        assert np.isfinite(float(step_fn(state, batch)["loss"]))
    assert state["lora_meta"] == {"alpha": 16.0, "rank": 4.0}
    assert all(d.scale == 4.0 for _, d in lora.adapted(model).values())
    moved = sum(float((d.b - b0[k]).abs().sum())
                for k, (_, d) in lora.adapted(model).items())
    assert moved > 0, "adapters did not train"


def test_lora_eval():
    """eval_fn runs in eval mode on the merged weights and drops padded
    rows from the loss (valid_mask)."""
    model, init_fn, _, eval_fn = _workload(VIDEO, functools.partial(
        toptim.make_optimizer, learning_rate=1e-3, total_steps=1), rank=4)
    state = init_fn(0)
    _, _, _, px, labels = _setup()
    batch = {"pixel_values": torch.from_numpy(px),
             "labels": torch.from_numpy(labels),
             "valid_mask": torch.tensor([1.0, 0.0])}
    out = eval_fn(state, batch)
    assert not model.training and np.isfinite(float(out["loss"]))
    one = eval_fn(state, {k: v[:1] for k, v in batch.items()
                          if k != "valid_mask"})
    np.testing.assert_allclose(float(out["loss"]), float(one["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lora_merged_forward_and_gradients_match_jax(family):
    """JAX adapters carried across: the merged logits within 1e-5 of max
    and the adapters' gradients (a and b) within 1e-4 relative."""
    jmodel, params, model, px, labels = _setup(family)
    adapters = _active(jlora.init_lora(params, KEY, rank=4))
    trainable = {"adapters": adapters, "head": jlora.split_head(params)}
    lora.init_lora(model, rank=4)
    _carry(model, adapters)
    model.eval()

    def jloss(tr):
        eff = jlora.merge_lora(params, tr, rank=4)
        return jmodel.apply(eff, px, labels=labels)["loss"]

    jl, jg = jax.value_and_grad(jloss)(trainable)
    out = _logits(model, px, labels)
    want = jmodel.apply(jlora.merge_lora(params, trainable, rank=4,
                                         train=False), px)["logits"]
    assert _rel(out["logits"].detach(), want) <= 1e-5
    out["loss"].backward()
    for path, (_, d) in lora.adapted(model).items():
        for ab in ("a", "b"):
            assert _rel(getattr(d, ab).grad, jg["adapters"][path][ab]) \
                <= 1e-4, (path, ab)
    for path, p in lora.head_parameters(model).items():
        g = np.asarray(jg["head"][path])
        got = p.grad.numpy().T if p.ndim == 2 else p.grad.numpy()
        assert _rel(got, g) <= 1e-4, path


@pytest.mark.parametrize("family,route", [
    ("videomae", dict(mlp_impl="pallas_bwd", attn_impl="pallas",
                      hidden_size=128, intermediate_size=256)),
    ("videomae", dict(mlp_impl="pallas", attn_impl="auto",
                      hidden_size=128, intermediate_size=256,
                      dtype="bfloat16")),
    ("dinov2", dict(mlp_impl="pallas", attn_impl="pallas"))])
def test_lora_reaches_the_kernel_routes(family, route):
    """The merged weight reaches the hand kernels' routes through their
    autograd Functions (their plain versions on these CPU tensors, which
    take bf16 operands as the kernels do): every adapter's a and b get a
    non-zero gradient there, pointing the plain route's way (cosine at
    least 0.95; the bf16 operands put ~8e-2 relative between them), so no
    route reads the base weight alone or a copy made before the merge."""
    kw = {k: v for k, v in route.items()
          if k not in ("mlp_impl", "attn_impl", "dtype")}
    grads = {}
    for impls in ({"mlp_impl": "xla", "attn_impl": "xla"},
                  {k: route[k] for k in ("mlp_impl", "attn_impl")}):
        _, params, model, px, labels = _setup(
            family, **kw, **impls, dtype=route.get("dtype", "float32"))
        model.train()
        lora.init_lora(model, torch.Generator().manual_seed(0), rank=4)
        with torch.no_grad():
            for _, d in lora.adapted(model).values():
                d.b.normal_(0, 0.05, generator=torch.Generator()
                            .manual_seed(1))
        _logits(model, px, labels)["loss"].backward()
        grads[impls["mlp_impl"]] = {
            k: (d.a.grad.clone(), d.b.grad.clone())
            for k, (_, d) in lora.adapted(model).items()}
    plain, kern = grads["xla"], grads[route["mlp_impl"]]
    for k in plain:
        for i in (0, 1):
            cos = float(torch.nn.functional.cosine_similarity(
                kern[k][i].flatten(), plain[k][i].flatten(), dim=0))
            assert float(kern[k][i].abs().max()) > 0 and cos >= 0.95, (
                k, i, cos)


def test_lora_safetensors_interchange(tmp_path):
    """A lora.safetensors written by the port loads into the JAX package
    (load_params_safetensors + merge_lora), and one written by the JAX
    package loads into the port (load_lora): the merged logits agree
    within 1e-5 of max both ways."""
    from smb_vision_tpu_torch.models.convert import write_safetensors

    jmodel, params, model, px, _ = _setup()
    lora.init_lora(model, rank=4)
    model.eval()
    jad = _active(jlora.init_lora(params, KEY, rank=4))
    _carry(model, jad)
    with torch.no_grad():
        for p in lora.head_parameters(model).values():
            p.add_(0.01)
        want = _logits(model, px)["logits"]
    meta = {"alpha": 16.0, "rank": 4.0}
    write_safetensors(tmp_path / "port.safetensors",
                      lora.lora_tensors(model, meta))
    tree = load_params_safetensors(tmp_path / "port.safetensors")
    assert set(tree) == {"adapters", "head", "meta"}
    got = jmodel.apply(jlora.merge_lora(params, tree, train=False),
                       px)["logits"]
    assert _rel(got, want) <= 1e-5
    # the JAX package's file into a fresh port model
    jtree = {"adapters": _active(jad, seed=9),
             "head": jlora.split_head(params),
             "meta": {"alpha": jnp.float32(16.0), "rank": jnp.float32(4.0)}}
    save_params_safetensors(jtree, tmp_path / "jax.safetensors")
    _, _, fresh, _, _ = _setup()
    lora.init_lora(fresh, rank=4)
    assert lora.load_lora(fresh, tmp_path / "jax.safetensors") == meta
    with torch.no_grad():
        got = _logits(fresh.eval(), px)["logits"]
    want = jmodel.apply(jlora.merge_lora(params, jtree, train=False),
                        px)["logits"]
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("optim", ["adamw", "adamw8bit"])
def test_lora_workload_trajectory_matches_jax(optim):
    """3 steps of make_lora_classification_workload from the same base,
    adapters and batch, two-tier rates (adapters of the backbone at
    vision_lr, the classifier at merger_lr) and decay: each step's loss
    within 1e-3 relative of the JAX workload's."""
    kw = dict(learning_rate=1e-3, total_steps=3, vision_lr=2e-3,
              merger_lr=1e-2, weight_decay=0.1, optim=optim)
    jmodel, params, _, px, labels = _setup()
    jinit, jstep, _ = jlora.make_lora_classification_workload(
        jmodel, jmodel.config, task_type="classification",
        tx=joptim.make_optimizer(**kw), rank=4)
    batch = {"pixel_values": jnp.asarray(px), "labels": jnp.asarray(labels)}
    jstate = jinit(KEY, batch, params)
    adapters = jax.tree_util.tree_map(np.asarray, jstate["lora"]["adapters"])
    model, init_fn, step_fn, _ = _workload(
        VIDEO, functools.partial(toptim.make_optimizer, **kw), rank=4)
    state = init_fn(0)
    _load_base(model, flatten_params(params))
    _carry(model, adapters)
    tiers = {n: g["tier"] for g in state["optimizer"].opt.param_groups
             for n, p in lora.lora_named_parameters(model)
             if any(p is q for q in g["params"])}
    assert {t for n, t in tiers.items() if n.startswith("adapters/")} == \
        {"vision"} and tiers["head/params/classifier/kernel"] == "head"
    tbatch = {"pixel_values": torch.from_numpy(px),
              "labels": torch.from_numpy(labels)}
    jit_step = jax.jit(jstep)
    for _ in range(3):
        jstate, jm = jit_step(jstate, batch, KEY)
        loss = float(step_fn(state, tbatch)["loss"])
        assert abs(loss - float(jm["loss"])) <= 1e-3 * abs(float(jm["loss"]))


def test_lora_refuses_quant8():
    with pytest.raises(ValueError, match="quant8 is an inference-only"):
        lora.make_lora_classification_workload(
            VideoMAEConfig(**VIDEO, quant8=True), task_type="classification",
            tx=toptim.make_optimizer)
