"""The port's V-JEPA2 modules against the JAX package on the CPU: the RoPE
tables, the multi-block target mask, the int8-score attention backward K7
(its plain version against the JAX kernels in interpret mode), DropPath in
training, and VJEPA2Model with the same weights (dense and index-list
predictor paths, with and without remat), forward and gradients. Inputs
come from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.models.configs import VJEPA2Config as JConfig
from smb_vision_tpu.models.configs import impl_neutral
from smb_vision_tpu.models.vjepa import VJEPA2Model as JModel
from smb_vision_tpu.models.vjepa import vjepa_loss as jvjepa_loss
from smb_vision_tpu.ops import attention as jattn
from smb_vision_tpu.ops import masking as jmasking
from smb_vision_tpu.ops import rope3d as jrope
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.configs import VJEPA2Config
from smb_vision_tpu_torch.models.layers import DropPath, Encoder
from smb_vision_tpu_torch.models.vjepa import VJEPA2Model, vjepa_loss
from smb_vision_tpu_torch.ops import attention as tattn
from smb_vision_tpu_torch.ops import masking as tmasking
from smb_vision_tpu_torch.ops import rope3d as trope

torch.set_num_threads(1)

TINY = dict(crop_size=64, frames_per_clip=32, patch_size=16, tubelet_size=16,
            in_chans=1, hidden_size=64, num_attention_heads=2,
            num_hidden_layers=2, pred_hidden_size=32,
            pred_num_attention_heads=2, pred_num_hidden_layers=1,
            pred_zero_init_mask_tokens=False, dtype="float32",
            attn_impl="xla", mlp_impl="xla")
GRID = (2, 4, 4)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_rope_matches_jax(head_dim):
    assert trope.rope_axis_dims(head_dim) == jrope.rope_axis_dims(head_dim)
    ids = np.array([[0, 5, 17, 31, 200, 4095], [3, 1, 40, 7, 9, 64]])
    cos, sin = trope.rope3d_cos_sin(torch.from_numpy(ids), 16, head_dim)
    jcos, jsin = jrope.rope3d_cos_sin(jnp.asarray(ids), 16, head_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    x = _rand(1, (2, 6, 3, head_dim))
    for c, s, jc, js in ((cos, sin, jcos, jsin),
                         (cos[0], sin[0], jcos[0], jsin[0])):
        got = trope.apply_rope3d(torch.from_numpy(x), c, s)
        want = jrope.apply_rope3d(jnp.asarray(x), jc, js)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rem = head_dim - 3 * trope.rope_axis_dims(head_dim)[0]
    if rem:   # the remainder lanes pass through unrotated
        np.testing.assert_array_equal(got.numpy()[..., -rem:],
                                      x[..., -rem:])


@pytest.mark.parametrize("inv_block", [False, True])
def test_vjepa_target_mask_properties(inv_block):
    """Shape and dtype; inv_block is the exact complement; block dims by
    the JAX rule d = round(cbrt(floor(n*scale))), h = round(d*ar),
    w = round(d/ar), clamped; max_keep raises, the complement flags are
    no-ops."""
    grid, n = (4, 6, 6), 4 * 6 * 6
    kw = dict(grid=grid, pred_mask_scale=(0.2, 0.8),
              aspect_ratio=(0.3, 3.0), num_blocks=3)
    m = tmasking.vjepa_target_mask(torch.Generator().manual_seed(0), 16,
                                   inv_block=inv_block, **kw)
    plain = tmasking.vjepa_target_mask(torch.Generator().manual_seed(0), 16,
                                       **kw)
    assert m.shape == (16, n) and m.dtype == torch.bool
    assert torch.equal(m, ~plain if inv_block else plain)
    assert bool(plain.any(1).all()) and not bool(plain.all(1).any())
    dims = tmasking._block_dims(torch.Generator().manual_seed(5), 64, grid,
                                (0.2, 0.8), (0.3, 3.0))
    u = torch.rand((64, 2), generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64).numpy()
    for (d, h, w), (us, ua) in zip(dims.tolist(), u):
        scale, ar = 0.2 + us * 0.6, 0.3 + ua * 2.7
        dd = round(float(np.cbrt(np.floor(n * scale))))
        assert (d, h, w) == (min(max(dd, 1), 4),
                             min(max(round(dd * ar), 1), 6),
                             min(max(round(dd / ar), 1), 6))
    with pytest.raises(ValueError, match="max_keep"):
        tmasking.vjepa_target_mask(torch.Generator(), 2, max_keep=5, **kw)
    with pytest.raises(ValueError, match="max_keep"):
        jmasking.vjepa_target_mask(jax.random.PRNGKey(0), 2, max_keep=5,
                                   **kw)
    again = tmasking.vjepa_target_mask(
        torch.Generator().manual_seed(0), 16, full_complement=True,
        pred_full_complement=True, **kw)
    assert torch.equal(again, plain)


def test_mask_boxes_are_one_size_per_sample():
    """Each sample's target is exactly a union of num_blocks boxes of its
    drawn size at its drawn corners."""
    grid = (3, 5, 5)
    gen = torch.Generator().manual_seed(2)
    dims = tmasking._block_dims(gen, 8, grid, (0.2, 0.8), (0.3, 3.0))
    u = torch.rand((8, 2, 3), generator=gen, dtype=torch.float64)
    m = tmasking.vjepa_target_mask(torch.Generator().manual_seed(2), 8,
                                   grid=grid, num_blocks=2)
    for b in range(8):
        want = np.zeros(grid, bool)
        for i in range(2):
            room = np.array(grid) - dims[b].numpy() + 1
            s = np.floor(u[b, i].numpy() * room).astype(int)
            e = s + dims[b].numpy()
            want[s[0]:e[0], s[1]:e[1], s[2]:e[2]] = True
        np.testing.assert_array_equal(m[b].reshape(grid).numpy(), want)


def test_mask_to_indices_matches_jax():
    row = np.random.default_rng(0).random(40) < 0.4
    for kw in ({}, {"max_keep": 7}, {"max_len": 5}):
        got = tmasking.mask_to_indices(torch.from_numpy(row), **kw)
        want = jmasking.mask_to_indices(row, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,d", [(128, 64), (100, 64), (128, 128),
                                 (100, 128)])
def test_i8bwd_plain_matches_jax(n, d):
    """attn_impl "pallas_i8bwd" under autograd (the plain version of K7 on
    the CPU) against jax.grad through the JAX int8-score backward kernels
    in interpret mode (the same quantised method, 1e-2 of max) and the
    f32 xla gradients (5e-2, the JAX package's own bound)."""
    q, k, v = (_rand(30 + i, (1, n, 2, d), 0.4) for i in range(3))
    w = _rand(33, (1, n, 2, d))

    def jgrads(impl):
        def loss(q, k, v):
            return jnp.sum(jattn.attention(q, k, v, impl=impl,
                                           interpret=True, block_q=64,
                                           block_k=64) * w)
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    want_i8, want_f32 = jgrads("pallas_i8bwd"), jgrads("xla")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = tattn.flash_attention_bwd_i8.launches
    (tattn.attention(*leaves, impl="pallas_i8bwd")
     * torch.from_numpy(w)).sum().backward()
    assert tattn.flash_attention_bwd_i8.launches == before   # cpu: plain
    for t, a, b in zip(leaves, want_i8, want_f32):
        assert _rel(t.grad, a) <= 1e-2
        assert _rel(t.grad, b) <= 5e-2


def test_i8bwd_through_attention_with_lse():
    """A loss on out and lse2 with "pallas_i8bwd": the lse2 cotangent folds
    into K7's delta as into K4's (the JAX _flash_lse with i8=True)."""
    q, k, v = (_rand(40 + i, (1, 128, 2, 64), 0.4) for i in range(3))

    def jloss(q, k, v):
        out, lse = jattn.attention_with_lse(q, k, v, impl="pallas_i8bwd",
                                            interpret=True, block_q=64,
                                            block_k=64)
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(lse) * lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = tattn.attention_with_lse(*leaves, impl="pallas_i8bwd")
    ((out ** 2).sum() + (torch.sin(lse) * lse).sum()).backward()
    for t, w in zip(leaves, want):
        assert _rel(t.grad, w) <= 1e-2


def test_droppath_trains():
    """In training each sample's output is 0 or x/keep, and both occur;
    the identity at eval and at rate 0."""
    x = torch.from_numpy(_rand(50, (64, 3, 4))) + 2.0
    dp = DropPath(0.5).train()
    y = dp(x)
    kept = [bool(torch.allclose(yi, xi / 0.5)) for yi, xi in zip(y, x)]
    dropped = [bool((yi == 0).all()) for yi in y]
    assert all(a != b for a, b in zip(kept, dropped))
    assert 0 < sum(kept) < 64
    mask = torch.zeros(64)
    mask[::3] = 1
    assert torch.equal(dp(x, mask)[::3], x[::3] / 0.5)
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(DropPath(0.0).train()(x), x)


def test_droppath_gradient_is_the_same_under_remat():
    """One generator seed, one draw of keep masks: an Encoder with remat
    gives the gradients of the same Encoder without it (the masks are
    drawn before the checkpointed blocks, not inside them)."""
    torch.manual_seed(0)
    enc = Encoder(3, 32, 2, 64, drop_path_rate=0.6, dtype=torch.float32,
                  attn_impl="xla", mlp_impl="xla").train()
    x = torch.from_numpy(_rand(51, (6, 8, 32)))

    def grads(remat):
        enc.remat = remat
        enc.zero_grad()
        enc(x, generator=torch.Generator().manual_seed(4)).square().sum() \
            .backward()
        return [p.grad.clone() for p in enc.parameters()]

    plain, remat = grads(False), grads(True)
    for a, b in zip(plain, remat):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # another seed draws other masks, hence other gradients
    enc.remat = False
    enc.zero_grad()
    enc(x, generator=torch.Generator().manual_seed(5)).square().sum() \
        .backward()
    assert any(not torch.allclose(a, p.grad)
               for a, p in zip(plain, enc.parameters()))


def _pixels(b=2):
    return np.random.default_rng(1).uniform(
        0, 1, (b, 32, 1, 64, 64)).astype(np.float32)


def _target(b):
    return np.array(jmasking.vjepa_target_mask(
        jax.random.PRNGKey(3), b, grid=GRID))


def _index_masks():
    """Two context/target index-list sets cut to 12 tokens each."""
    ctx, tgt = [], []
    for rows in (_target(2), ~_target(2)):
        pairs = [jmasking.mask_to_indices(r, max_keep=12) for r in rows]
        ctx.append(np.stack([c for c, _ in pairs]))
        tgt.append(np.stack([t for _, t in pairs]))
    return ctx, tgt


@functools.lru_cache(maxsize=None)
def _reference(path: str):
    """Random JAX params (norms and biases perturbed off their init) and
    the JAX model's outputs, loss and parameter gradients on the dense or
    the index-list path, computed once (remat changes no value in JAX)."""
    jcfg = JConfig(**TINY)
    px, tb = _pixels(), _target(2)
    params = jax.jit(lambda k, x, t: JModel(impl_neutral(jcfg)).init(
        k, x, target_bool=t))(jax.random.PRNGKey(0), px, tb)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)
    jmodel = JModel(jcfg)
    if path == "dense":
        teacher = _rand(60, (2, 32, 64))

        def loss(p):
            out = jmodel.apply(p, px, target_bool=tb)
            return jvjepa_loss(out["predictor_output"], teacher, tb), out
    else:
        ctx, tgt = _index_masks()
        w = _rand(61, (4, 12, 64))

        def loss(p):
            out = jmodel.apply(p, px, context_mask=ctx, target_mask=tgt)
            return jnp.sum(out["predictor_output"] * w), out
    (val, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    full = jax.jit(lambda p: jmodel.apply(p, px, skip_predictor=True))(
        params)
    return (params, float(val), jax.tree_util.tree_map(np.asarray, out),
            convert.params_from_flax(flatten_params(grads), vjepa=True),
            np.asarray(full["target_hidden_state"]))


def _port(path, remat):
    params = _reference(path)[0]
    model = VJEPA2Model(VJEPA2Config(**TINY, gradient_checkpointing=remat))
    state = convert.params_from_flax(flatten_params(params), vjepa=True)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


@pytest.mark.parametrize("remat", [False, True])
def test_vjepa_dense_path_matches_jax(remat):
    """f32, xla impls: last_hidden_state and predictor_output within 1e-4
    of max|ref|; the masked-L1 loss against a fixed teacher within 1e-5
    relative and every parameter's gradient within 1e-4 of its max."""
    _, want_loss, ref, want, _ = _reference("dense")
    model = _port("dense", remat)
    tb = torch.from_numpy(_target(2))
    out = model(torch.from_numpy(_pixels()), target_bool=tb)
    assert _rel(out["last_hidden_state"], ref["last_hidden_state"]) <= 1e-4
    assert _rel(out["predictor_output"], ref["predictor_output"]) <= 1e-4
    loss = vjepa_loss(out["predictor_output"],
                      torch.from_numpy(_rand(60, (2, 32, 64))), tb)
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    loss.backward()
    for name, p in model.named_parameters():
        assert _rel(p.grad, want[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("remat", [False, True])
def test_vjepa_index_path_matches_jax(remat):
    """The index-list predictor path (two mask sets, stacked rows, RoPE
    ids from the lists) and the no-mask default: every output within 1e-4
    of max|ref|, and the gradients through predictor_output."""
    _, _, ref, want, ref_full = _reference("index")
    model = _port("index", remat)
    ctx, tgt = _index_masks()
    px = torch.from_numpy(_pixels())
    out = model(px, context_mask=[torch.from_numpy(c) for c in ctx],
                target_mask=[torch.from_numpy(t) for t in tgt])
    for key in ("last_hidden_state", "masked_hidden_state",
                "target_hidden_state", "predictor_output"):
        assert _rel(out[key], ref[key]) <= 1e-4, key
    (out["predictor_output"]
     * torch.from_numpy(_rand(61, (4, 12, 64)))).sum().backward()
    for name, p in model.named_parameters():
        assert _rel(p.grad, want[name].numpy()) <= 1e-4, name
    with torch.no_grad():
        full = model(px, skip_predictor=True)
    assert "predictor_output" not in full
    assert _rel(full["target_hidden_state"], ref_full) <= 1e-4


def test_vjepa_loss_valid_rows_match_jax():
    pred, teach = _rand(70, (3, 32, 16)), _rand(71, (3, 32, 16))
    tb = np.random.default_rng(2).random((3, 32)) < 0.5
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    for v in (None, valid):
        want = jvjepa_loss(pred, teach, tb, valid=v)
        got = vjepa_loss(torch.from_numpy(pred), torch.from_numpy(teach),
                         torch.from_numpy(tb),
                         valid=None if v is None else torch.from_numpy(v))
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
