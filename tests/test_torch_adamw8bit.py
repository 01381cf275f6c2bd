"""The port's 8-bit AdamW (`train/quantized.py`) against the JAX package's
`adamw8bit` on the CPU: the blockwise quantisation pair, one update from
the same state, a 60-step trajectory, a bitwise checkpoint resume, and the
tiers and clip of `make_optimizer(optim="adamw8bit")`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smb_vision_tpu.train import optim as joptim
from smb_vision_tpu.train import quantized as jq
from smb_vision_tpu_torch.train import optim as toptim
from smb_vision_tpu_torch.train import quantized as tq

torch.set_num_threads(1)

# codes may differ by one step at rounding ties (the cube root is
# sign(x)|x|^(1/3) here, jnp.cbrt there): at most this share of them
TIE_SHARE = 1e-3


def _code_mismatch(got, want):
    """(share of codes that differ, largest difference in steps)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return float((d > 0).mean()), int(d.max())


@pytest.mark.parametrize("shape", [(1000,), (37, 53), (256,), (3, 256),
                                   (7,)])
def test_quantize_pair_matches_jax(shape):
    """Ragged sizes, one block exactly, and an all-zero block (scale 0,
    read as 1): scales bit for bit, codes equal but at ties (at most 1
    step, on at most TIE_SHARE of them), dequantised values within one
    code's width."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    if len(shape) == 2 and shape[1] == 256:
        x[1] = 0.0                       # an all-zero block
    q = jq._quantize(jnp.asarray(x))
    codes, scales = tq.quantize(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == \
        tuple(q.codes.shape) and tuple(scales.shape) == tuple(q.scales.shape)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(q.scales))
    share, worst = _code_mismatch(codes.numpy(), q.codes)
    assert worst <= 1 and share <= TIE_SHARE, (share, worst)
    # dequantise the same codes both ways
    got = tq.dequantize(torch.from_numpy(np.asarray(q.codes)),
                        torch.from_numpy(np.asarray(q.scales)), shape)
    want = jq._dequantize(q, shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    if len(shape) == 2 and shape[1] == 256:
        assert float(scales[1]) == 0.0 and not codes[1].any()


def test_tie_share_on_adam_moments():
    """The measured share of codes off by one on moment-like data over
    2^20 values: the rule is at most TIE_SHARE."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(1 << 20) * rng.uniform(0, 1e-2, 1 << 20)
         ).astype(np.float32)
    q = jq._quantize(jnp.asarray(x))
    codes, _ = tq.quantize(torch.from_numpy(x))
    share, worst = _code_mismatch(codes.numpy(), q.codes)
    assert worst <= 1 and share <= TIE_SHARE, (share, worst)


def _state_from_jax(opt, params, jstate):
    """Load the JAX state (codes, scales, count) into the port's
    optimizer, byte for byte."""
    (adam, *_) = jstate
    for p, mu, nu in zip(params, jax.tree_util.tree_leaves(
            adam.mu, is_leaf=lambda x: isinstance(x, jq._Quantized)),
            jax.tree_util.tree_leaves(
            adam.nu, is_leaf=lambda x: isinstance(x, jq._Quantized))):
        opt.state[p] = {
            "step": torch.tensor(int(adam.count), dtype=torch.int32),
            "mu": torch.from_numpy(np.asarray(mu.codes)).clone(),
            "mu_scale": torch.from_numpy(np.asarray(mu.scales)).clone(),
            "nu": torch.from_numpy(np.asarray(nu.codes)).clone(),
            "nu_scale": torch.from_numpy(np.asarray(nu.scales)).clone()}


def test_one_update_matches_jax():
    """From the same (non-trivial) 8-bit state, one update with weight
    decay: parameters within 1e-6 of max."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 30)).astype(np.float32)
    grads = [rng.standard_normal(w.shape).astype(np.float32) * s
             for s in (1.0, 0.3, 0.1, 2.0)]
    tx = jq.adamw8bit(1e-2, weight_decay=0.05)
    jw, jst = jnp.asarray(w), tx.init(jnp.asarray(w))
    for g in grads[:3]:
        upd, jst = tx.update(jnp.asarray(g), jst, jw)
        jw = optax.apply_updates(jw, upd)
    p = torch.nn.Parameter(torch.from_numpy(np.asarray(jw)).clone())
    opt = tq.AdamW8bit([p], lr=1e-2, weight_decay=0.05)
    _state_from_jax(opt, [p], jst)
    p.grad = torch.from_numpy(grads[3])
    opt.step()
    upd, jst = tx.update(jnp.asarray(grads[3]), jst, jw)
    want = np.asarray(optax.apply_updates(jw, upd))
    assert float(np.abs(p.detach().numpy() - want).max()) <= 1e-6 * float(
        np.abs(want).max())
    share, worst = _code_mismatch(opt.state[p]["mu"].numpy(),
                                  jst[0].mu.codes)
    assert worst <= 1 and share <= TIE_SHARE


def _problem():
    """tests/test_train.py::test_adamw8bit_tracks_exact_adamw's problem."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(64, 32)).astype(np.float32) * 0.3
    x = rng.normal(size=(256, 64)).astype(np.float32)
    w_true = rng.normal(size=(64, 32)).astype(np.float32)
    return w0, x, x @ w_true


def _torch_losses(opt_cls, steps, **kw):
    w0, x, y = _problem()
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = opt_cls([w], lr=3e-2, weight_decay=1e-3, **kw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(steps):
        loss = ((xt @ w - yt) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(((xt @ w - yt) ** 2).mean()))
    return losses


def test_adamw8bit_tracks_exact_adamw_and_jax():
    """60 steps: the port's 8-bit loss within 1.15x of exact AdamW's and
    below a tenth of the start; the first 10 steps' losses within 1e-3
    relative of the JAX package's 8-bit trajectory."""
    w0, x, y = _problem()

    def jloss(w):
        return jnp.mean((x @ w - y) ** 2)

    tx = jq.adamw8bit(3e-2, weight_decay=1e-3)
    w, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    jl = []
    for _ in range(10):
        upd, st = tx.update(jax.grad(jloss)(w), st, w)
        w = optax.apply_updates(w, upd)
        jl.append(float(jloss(w)))
    l8 = _torch_losses(tq.AdamW8bit, 60)
    lexact = _torch_losses(torch.optim.AdamW, 60)
    assert l8[-1] < lexact[-1] * 1.15, (l8[-1], lexact[-1])
    assert l8[-1] < float(jloss(jnp.asarray(w0))) * 0.1
    np.testing.assert_allclose(l8[:10], jl, rtol=1e-3)


def _named(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [("videomae.encoder.layer_0.mlp.fc1.weight",
             torch.nn.Parameter(torch.randn(24, 16, generator=g))),
            ("videomae.encoder.layer_0.norm1.bias",
             torch.nn.Parameter(torch.randn(16, generator=g))),
            ("classifier.weight",
             torch.nn.Parameter(torch.randn(2, 16, generator=g)))]


def _run(opt, named, steps, seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for _, p in named:
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        g = torch.Generator().manual_seed(int(torch.randint(
            1 << 30, (1,), generator=g)))


def test_checkpoint_resume_is_bitwise(tmp_path):
    """4 steps straight equal 2 steps, a torch.save of the optimizer's
    state_dict and the parameters, a fresh optimizer loaded from it, and
    2 more: parameters, codes and scales byte for byte."""
    kw = dict(learning_rate=1e-2, total_steps=10, warmup_steps=1,
              vision_lr=1e-3, merger_lr=3e-2, optim="adamw8bit")

    def fresh():
        named = _named()
        return named, toptim.make_optimizer(named, **kw)

    named_a, opt_a = fresh()
    for i in range(4):
        _run(opt_a, named_a, 1, seed=i)
    named_b, opt_b = fresh()
    for i in range(2):
        _run(opt_b, named_b, 1, seed=i)
    torch.save({"opt": opt_b.state_dict(),
                "params": [p.detach() for _, p in named_b]},
               tmp_path / "state.pt")
    blob = torch.load(tmp_path / "state.pt", weights_only=True)
    named_c, opt_c = fresh()
    with torch.no_grad():
        for (_, p), v in zip(named_c, blob["params"]):
            p.copy_(v)
    opt_c.load_state_dict(blob["opt"])
    for _, p in named_c:
        st = opt_c.opt.state[p]
        assert st["mu"].dtype == st["nu"].dtype == torch.int8
        assert st["mu_scale"].dtype == st["nu_scale"].dtype == torch.float32
    for i in range(2, 4):
        _run(opt_c, named_c, 1, seed=i)
    for (_, a), (_, c) in zip(named_a, named_c):
        assert torch.equal(a, c)
        sa, sc = opt_a.opt.state[a], opt_c.opt.state[c]
        for k in ("mu", "mu_scale", "nu", "nu_scale", "step"):
            assert torch.equal(sa[k], sc[k]), k
    assert opt_c.updates == 4
    assert opt_a.opt.state[named_a[0][1]]["mu"].dtype == torch.int8


def test_load_keeps_int8_codes_and_float32_scales(tmp_path):
    """bfloat16 parameters: after a load the codes are int8 and the
    scales float32 and bit for bit the saved ones (not rounded to the
    parameter's dtype), and a state_dict taken before the next update
    holds them so."""
    g = torch.Generator().manual_seed(4)
    params = [torch.nn.Parameter(torch.randn(s, generator=g).bfloat16())
              for s in ((40, 30), (300,))]
    opt = tq.AdamW8bit(params, lr=1e-2, weight_decay=0.05)
    for _ in range(2):
        for p in params:
            p.grad = torch.randn(p.shape, generator=g).bfloat16()
        opt.step()
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    saved = torch.load(tmp_path / "opt.pt", weights_only=True)["state"]
    fresh = tq.AdamW8bit(params, lr=1e-2, weight_decay=0.05)
    fresh.load_state_dict(torch.load(tmp_path / "opt.pt",
                                     weights_only=True))
    again = fresh.state_dict()["state"]
    for i, p in enumerate(params):
        for st in (fresh.state[p], again[i]):
            assert st["mu"].dtype == st["nu"].dtype == torch.int8
            assert st["mu_scale"].dtype == st["nu_scale"].dtype == \
                torch.float32
            for k in ("mu", "mu_scale", "nu", "nu_scale", "step"):
                assert torch.equal(st[k], saved[i][k]), k


def test_group_update_equals_each_parameter_alone():
    """The flat group update, over ragged parameters that span several
    chunks, one parameter without a gradient: bit for bit what an
    optimizer of each parameter alone computes; the gradient-less one
    untouched and without state."""
    g = torch.Generator().manual_seed(8)
    shapes = ((3, 100), (7,), (256,), (2, 300), (5, 5))
    make = [torch.randn(s, generator=g) for s in shapes]
    together = [torch.nn.Parameter(x.clone()) for x in make]
    alone = [torch.nn.Parameter(x.clone()) for x in make]
    opt = tq.AdamW8bit(together, lr=1e-2, weight_decay=0.05)
    opts = [tq.AdamW8bit([p], lr=1e-2, weight_decay=0.05) for p in alone]
    chunk_rows, tq.CHUNK_ROWS = tq.CHUNK_ROWS, 3
    try:
        for _ in range(3):
            grads = [torch.randn(s, generator=g) for s in shapes]
            for i, (a, b) in enumerate(zip(together, alone)):
                a.grad = b.grad = None if i == 1 else grads[i].clone()
            opt.step()
            for o in opts:
                o.step()
        assert len(opt._packs[0]["chunks"]) > 1
    finally:
        tq.CHUNK_ROWS = chunk_rows
    for i, (a, b) in enumerate(zip(together, alone)):
        assert torch.equal(a, b), i
        if i == 1:
            assert not opt.state[a] and torch.equal(a, make[1])
            continue
        for k in ("mu", "mu_scale", "nu", "nu_scale", "step"):
            assert torch.equal(opt.state[a][k], opts[i].state[b][k]), (i, k)
    # a parameter that gets its first gradient after the others' first
    # update cannot join their shared count
    together[1].grad = torch.randn(shapes[1], generator=g)
    with pytest.raises(ValueError, match="counts"):
        opt.step()


def test_tiers_and_clip_match_jax():
    """make_optimizer(optim="adamw8bit") with both tiers, warm-up, decay
    and a clip that bites: 3 updates of the port against the JAX chain on
    the same gradients (parameters within 1e-5 relative), the decay mask
    (bias and norm not decayed) and each tier's learning rate."""
    kw = dict(learning_rate=1e-2, total_steps=5, warmup_steps=1,
              vision_lr=1e-3, merger_lr=3e-2, weight_decay=0.1,
              grad_clip=0.5, optim="adamw8bit")
    named = _named(1)
    jparams = {n.replace(".", "/"): jnp.asarray(p.detach().numpy())
               for n, p in named}
    jtx = joptim.make_optimizer(**kw)
    jst = jtx.init(jparams)
    opt = toptim.make_optimizer(named, **kw)
    tiers = {g["tier"] for g in opt.opt.param_groups}
    assert tiers == {"vision", "head"}
    decay = {id(p): g["weight_decay"] for g in opt.opt.param_groups
             for p in g["params"]}
    assert decay[id(named[0][1])] == 0.1 and decay[id(named[1][1])] == 0.0
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) * 3
                 for n, p in named}
        for n, p in named:
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        upd, jst = jtx.update({n.replace(".", "/"): jnp.asarray(g)
                               for n, g in grads.items()}, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for n, p in named:
        want = np.asarray(jparams[n.replace(".", "/")])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
