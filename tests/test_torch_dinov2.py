"""The port's DINOv2 path against the JAX package on the CPU: the SwiGLU
half-block K9 at op and Block level (the JAX kernel in interpret mode),
the 3D DINOv2 backbone (with and without the mask token) and its
classification head, the trilinear position-table resize, and the HF
DINOv2 layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import Dinov2Config as JConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.convert import convert_hf_dinov2 as jconvert_hf
from smb_vision_tpu.models.convert import export_hf_dinov2 as jexport_hf
from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification as JCls
from smb_vision_tpu.models.dinov2 import Dinov2Model as JModel
from smb_vision_tpu.models.dinov2 import _patchify_chw as jpatchify
from smb_vision_tpu.models.dinov2 import \
    resize_position_embeddings_3d as jresize
from smb_vision_tpu.models.layers import Block as JBlock
from smb_vision_tpu.ops.mlp import swiglu_block_forward as jswiglu
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import Dinov2Config
from smb_vision_tpu_torch.models.dinov2 import (
    Dinov2ForImageClassification,
    Dinov2Model,
    _patchify_chw,
    resize_position_embeddings_3d,
)
from smb_vision_tpu_torch.models.layers import Block
from smb_vision_tpu_torch.ops import mlp as M

torch.set_num_threads(1)

GEOM = dict(image_size=32, depth=48, patch_size=16)      # grid (2, 2, 3)
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            layerscale_value=0.7, dtype="float32", attn_impl="xla",
            num_labels=3, problem_type="single_label_classification")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _perturbed(params, seed=0):
    """Norms, biases, LayerScale, CLS, mask token and positions moved off
    their init, so the comparison sees every parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 or p.shape[0] == 1 else p, params)


def _pixels(b=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, 1, 32, 32, 48)).astype(np.float32)


def _swiglu_args(dt=np.float32):
    rng = np.random.default_rng(3)
    m, k, f = 256, 128, 256

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = r(m, k).astype(jnp.bfloat16)
    return [np.asarray(x).astype(np.float32), 1.0 + r(k, s=0.1),
            r(k, s=0.1), r(k, 2 * f, s=k ** -0.5), r(2 * f, s=0.1),
            r(f, k, s=f ** -0.5), r(k, s=0.1)]


def test_swiglu_op_matches_jax_kernel():
    """K9's wrapper on the CPU (its plain version in bf16) against the JAX
    kernel in interpret mode at M 256, K 128, F 256: forward within 5e-3
    of max, all seven gradients within 3e-2 of max."""
    args = _swiglu_args()
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    g = np.random.default_rng(4).standard_normal((256, 128)).astype(
        np.float32)

    def jloss(*a):
        y = jswiglu(*a, eps=1e-6, impl="pallas", interpret=True)
        return jnp.sum(y.astype(jnp.float32) * g)

    want_y = jswiglu(*jargs, eps=1e-6, impl="pallas", interpret=True)
    want_g = jax.grad(jloss, argnums=tuple(range(7)))(*jargs)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    leaves[0] = torch.tensor(args[0]).to(torch.bfloat16).requires_grad_()
    before = M.swiglu_block_fused.launches
    y = M.swiglu_block_forward(*leaves, eps=1e-6, impl="pallas")
    assert M.swiglu_block_fused.launches == before      # CPU: no launch
    assert y.dtype == torch.bfloat16 and y.shape == (256, 128)
    assert _rel(y.float().detach(), want_y.astype(jnp.float32)) <= 5e-3
    (y.float() * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want_g):
        assert t.grad.shape == w.shape
        assert _rel(t.grad.float(), w.astype(jnp.float32)) <= 3e-2


def test_swiglu_impls_and_refusal():
    """"auto" is the plain version (the JAX package resolves it so);
    "pallas" refuses a shape K9 does not take, as the JAX wrapper does."""
    a = [torch.from_numpy(v) for v in _swiglu_args()]
    want = M._swiglu_block_xla(*a, 1e-6)
    assert torch.equal(M.swiglu_block_forward(*a, impl="auto"), want)
    assert torch.equal(M.swiglu_block_forward(*a, impl="xla"), want)
    with pytest.raises(ValueError, match="cannot map"):
        M.swiglu_block_forward(a[0][:, :96], a[1][:96], a[2][:96],
                               a[3][:96], a[4], a[5][:, :96], a[6][:96],
                               impl="pallas")
    with pytest.raises(ValueError, match="unknown mlp impl"):
        M.swiglu_block_forward(*a, impl="pallas_bwd")
    assert M.swiglu_kernel_maps(1536, 4096)
    assert not M.swiglu_kernel_maps(1024, 2736)     # ViT-L's SwiGLU width


@pytest.mark.parametrize("mlp_impl", ["pallas", "xla"])
def test_swiglu_block_matches_jax(mlp_impl):
    """One DINOv2 SwiGLU Block (LayerScale 0.9, q/k/v biases) at (2, 128,
    128) in float32: the JAX Block (its K9 in interpret mode under
    "pallas") against the port's, within 5e-3 of max."""
    kw = dict(layerscale_value=0.9, use_swiglu=True, layer_norm_eps=1e-6)
    x = np.random.default_rng(5).standard_normal((2, 128, 128)).astype(
        np.float32)
    jblock = JBlock(128, 4, 256, dtype=jnp.float32, mlp_impl=mlp_impl,
                    attn_impl="xla", **kw)
    params = _perturbed(jax.jit(JBlock(128, 4, 256, dtype=jnp.float32,
                                       mlp_impl="xla", attn_impl="xla",
                                       **kw).init)(jax.random.PRNGKey(0), x))
    want = jblock.apply(params, x)
    block = Block(128, 4, 256, dtype=torch.float32, mlp_impl=mlp_impl,
                  attn_impl="xla", **kw)
    # one Block's tree, carried across as layer 0 of an encoder
    state = convert.params_from_flax(
        {"params.encoder.layer_0." + k[len("params."):]: v
         for k, v in flatten_params(params).items()})
    block.load_state_dict({k[len("encoder.layer_0."):]: v
                           for k, v in state.items()})
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert _rel(got, want) <= 5e-3


def _dinov2_pair(model_cls, jmodel_cls, **kw):
    jcfg = JConfig(**GEOM, **TINY, **kw)
    px0 = np.zeros((1, 1, 32, 32, 48), np.float32)
    params = _perturbed(jax.jit(jmodel_cls(impl_neutral(jcfg)).init)(
        jax.random.PRNGKey(0), px0))
    model = model_cls(Dinov2Config(**GEOM, **TINY, **kw))
    backbone = model_cls is Dinov2Model
    model.load_state_dict(convert.params_from_flax(
        flatten_params(params), classification=not backbone,
        backbone="dinov2"))
    return jmodel_cls(jcfg), params, model.eval()


@pytest.mark.parametrize("swiglu", [True, False])
def test_dinov2_classification_matches_jax(swiglu):
    """Dinov2ForImageClassification in float32 against the JAX model:
    logits within 1e-4 of max, the loss within 1e-5 relative."""
    jmodel, params, model = _dinov2_pair(
        Dinov2ForImageClassification, JCls, use_swiglu_ffn=swiglu)
    px = _pixels()
    labels = np.array([0, 2], np.int32)
    want = jmodel.apply(params, px, labels=labels)
    with torch.no_grad():
        got = model(torch.from_numpy(px), labels=torch.from_numpy(labels))
    assert got["logits"].shape == (2, 3)
    assert _rel(got["logits"], want["logits"]) <= 1e-4
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))


def test_dinov2_mask_token_path_matches_jax():
    """The backbone with bool_masked_pos: masked patch embeddings become
    the mask token before the CLS token and the positions are added."""
    jmodel, params, model = _dinov2_pair(Dinov2Model, JModel,
                                         use_swiglu_ffn=True)
    px = _pixels()
    mask = np.random.default_rng(6).uniform(size=(2, 12)) < 0.5
    want = jmodel.apply(params, px, bool_masked_pos=mask)
    with torch.no_grad():
        got = model(torch.from_numpy(px),
                    bool_masked_pos=torch.from_numpy(mask))
        unmasked = model(torch.from_numpy(px))
    assert got.shape == (2, 13, 64)
    assert _rel(got, want) <= 1e-4
    assert not torch.allclose(got, unmasked)
    with pytest.raises(ValueError, match="use_mask_token"):
        Dinov2Model(Dinov2Config(**GEOM, **TINY, use_mask_token=False))(
            torch.from_numpy(px), bool_masked_pos=torch.from_numpy(mask))


def test_patchify_and_position_resize_match_jax():
    """(h, w, d) token order, depth fastest; the trilinear resize of the
    position table, up and down, with the CLS row passed through."""
    px = _pixels(b=1)
    np.testing.assert_array_equal(
        _patchify_chw(torch.from_numpy(px), 16).numpy(),
        np.asarray(jpatchify(px, 16)))
    pos = np.random.default_rng(7).standard_normal((1, 1 + 2 * 3 * 4, 8)) \
        .astype(np.float32)
    for new in ((4, 5, 3), (1, 2, 2), (2, 3, 4)):
        got = resize_position_embeddings_3d(torch.from_numpy(pos), (2, 3, 4),
                                            new)
        want = jresize(jnp.asarray(pos), (2, 3, 4), new)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(got[:, 0].numpy(), pos[:, 0])


def test_hf_dinov2_layout_round_trip_is_bit_exact():
    """JAX params -> the JAX package's export_hf_dinov2 -> the port's
    convert_hf_dinov2 gives the port's weights bit for bit, and the port's
    export_hf_dinov2 gives the JAX export bit for bit; a 2D checkpoint
    inflates as the JAX package's convert_hf_dinov2 does."""
    _, params, model = _dinov2_pair(Dinov2ForImageClassification, JCls,
                                    use_swiglu_ffn=True)
    hf = jexport_hf(params, TINY["num_hidden_layers"])
    state = convert.params_from_flax(convert.convert_hf_dinov2(hf),
                                     classification=True)
    ref = model.state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(state[k], v), k
    back = convert.export_hf_dinov2(ref)
    assert sorted(back) == sorted(hf)
    for k, v in hf.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
        assert back[k].dtype == np.asarray(v).dtype, k

    # a 2D checkpoint: Conv2d kernel and a 2D position table
    hf2 = {k: np.asarray(v) for k, v in hf.items()
           if "position_embeddings_3d" not in k}
    kern = "dinov2.embeddings.patch_embeddings.projection.weight"
    hf2[kern] = hf2[kern][..., 0]
    hf2["dinov2.embeddings.position_embeddings"] = np.random.default_rng(
        8).standard_normal((1, 5, 64)).astype(np.float32)
    got = convert.convert_hf_dinov2(hf2, depth_patch=16, depth_grid=3)
    want = flatten_params(jconvert_hf(hf2, 2, depth_patch=16, depth_grid=3))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    with pytest.raises(ValueError, match="depth_patch"):
        convert.convert_hf_dinov2(hf2)


def test_load_backbone_into_the_dinov2_head(tmp_path):
    """A bare-backbone HF file and the JAX package's export both load into
    the head model's `dinov2.` backbone; the head stays as it was."""
    from safetensors.numpy import save_file

    _, params, model = _dinov2_pair(Dinov2ForImageClassification, JCls,
                                    use_swiglu_ffn=True)
    hf = {k[len("dinov2."):]: np.asarray(v) for k, v in
          jexport_hf(params, 2).items() if k.startswith("dinov2.")}
    save_file(hf, str(tmp_path / "hf.safetensors"))
    save_file({k: np.asarray(v) for k, v in flatten_params(params).items()},
              str(tmp_path / "ours.safetensors"))
    for name in ("hf.safetensors", "ours.safetensors"):
        fresh = Dinov2ForImageClassification(
            Dinov2Config(**GEOM, **TINY, use_swiglu_ffn=True)).init_weights(
            torch.Generator().manual_seed(1))
        head = fresh.classifier.weight.detach().clone()
        convert.load_backbone_into(fresh, tmp_path / name)
        for k, v in model.dinov2.state_dict().items():
            assert torch.equal(fresh.dinov2.state_dict()[k], v), (name, k)
        assert torch.equal(fresh.classifier.weight, head)
