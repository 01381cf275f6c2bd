"""Pipeline parallelism on the port (GPipe over the model axis of gloo
ranks): `pipeline_apply` through an Encoder stage on each rank, against
the JAX package's sequential Encoder on the same weights: every case of
tests/test_pipeline.py (the stacked layout, 1, 2 and 4 microbatches over
4 stages, the gradients, a 2 x 2 (data, pipe) mesh, remat, the bad
factorings), with the input's gradient (the stage that injects) beside
the layers'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from smb_vision_tpu.models.layers import Encoder as JEncoder
from smb_vision_tpu.parallel.pipeline import (
    stack_layer_params as jstack_layer_params,
)
from smb_vision_tpu.utils.serialization import flatten_params
from smb_vision_tpu.utils.serialization import unflatten_params
from smb_vision_tpu_torch.models import convert
from smb_vision_tpu_torch.models.layers import Encoder
from smb_vision_tpu_torch.parallel.pipeline import (
    PipeStages,
    pipeline_apply,
    stack_layer_params,
    unstack_layer_params,
)

torch.set_num_threads(1)
HID, HEADS, INTER, LAYERS = 32, 4, 64, 4
ENC = dict(num_layers=LAYERS, hidden_size=HID, num_heads=HEADS,
           intermediate_size=INTER)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX Encoder's output and the gradients of the mean squared
    error against a target (layers and input), on the port Encoder's
    weights carried by `models/convert.py`."""
    port = Encoder(**ENC, dtype=torch.float32, attn_impl="xla")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    weights = {k: v.detach().numpy().copy()
               for k, v in port.state_dict().items()}
    params = unflatten_params({k: np.asarray(v) for k, v in
                               convert.params_to_flax(port.state_dict())
                               .items()})
    enc = JEncoder(**ENC, dtype=jnp.float32, attn_impl="xla")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, HID)).astype(np.float32)
    tgt = rng.standard_normal(x.shape).astype(np.float32)
    ref = jax.jit(enc.apply)(params, x)

    def loss(p, x):
        return jnp.mean((enc.apply({"params": p}, x) - tgt) ** 2)

    g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params["params"], x)
    return dict(params=params, weights=weights, x=x, tgt=tgt,
                ref=np.asarray(ref), g_p=flatten_params(g_p),
                g_x=np.asarray(g_x))


def _job(js, model, m, **kw):
    return dict(kind="encoder", config=ENC, weights=js["weights"],
                x=js["x"], model=model, microbatches=m, **kw)


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    js = jax_side
    jobs = {f"mb{m}": _job(js, 4, m) for m in (1, 2, 4)}
    jobs["grads"] = _job(js, 4, 2, tgt=js["tgt"])
    jobs["dp"] = _job(js, 2, 2, tgt=js["tgt"])
    jobs["remat"] = _job(js, 2, 2, tgt=js["tgt"], remat=True)
    jobs["plain2"] = _job(js, 2, 2, tgt=js["tgt"])
    return W.run_ranks("pipeline", 4, {"jobs": jobs},
                       tmp_path_factory.mktemp("pipe"))


def test_stack_roundtrip(jax_side):
    """stack / unstack are inverses, and the stacked tensors are the JAX
    package's stacked leaves (in PyTorch's layouts)."""
    sd = {k: torch.from_numpy(v) for k, v in jax_side["weights"].items()}
    stacked, n = stack_layer_params(sd)
    assert n == LAYERS
    back = unstack_layer_params(stacked, n)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v)
    jst, jn = jstack_layer_params(jax_side["params"]["params"])
    assert jn == LAYERS
    np.testing.assert_array_equal(
        stacked["attention.query.weight"].numpy(),
        np.swapaxes(np.asarray(jst["attention"]["query"]["kernel"]), 1, 2))
    np.testing.assert_array_equal(stacked["norm1.weight"].numpy(),
                                  np.asarray(jst["norm1"]["scale"]))


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipeline_matches_sequential(jax_side, port, microbatches):
    np.testing.assert_allclose(port[f"mb{microbatches}"]["out"],
                               jax_side["ref"], rtol=2e-5, atol=2e-5)


def _check_grads(js, got):
    flat = convert.params_to_flax({k: torch.from_numpy(v)
                                   for k, v in got["grads"].items()})
    want = {k: v for k, v in js["g_p"].items()}
    assert {k[len("params."):] for k in flat} == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(flat["params." + k], v, rtol=5e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["x_grad"], js["g_x"], rtol=5e-4,
                               atol=1e-6)


def test_pipeline_grads_match_sequential(jax_side, port):
    """4 stages x 2 microbatches: every layer's gradient (each stage's
    own) and the input's (reaching every stage from stage 0) as the
    sequential chain's."""
    _check_grads(jax_side, port["grads"])


def test_pipeline_composes_with_data_parallel(jax_side, port):
    """A 2 x 2 (data, pipe) mesh: each data rank streams its 2 rows as 2
    microbatches through 2 stages of 2 layers."""
    np.testing.assert_allclose(port["dp"]["out"], jax_side["ref"],
                               rtol=2e-5, atol=2e-5)
    _check_grads(jax_side, port["dp"])


def test_pipeline_remat_matches(port):
    """remat checkpoints each layer between the shifts: the same
    gradients."""
    a, b = port["plain2"]["grads"], port["remat"]["grads"]
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-8)


def test_pipeline_rejects_bad_factorings(jax_side):
    with pytest.raises(ValueError, match="pipe stages"):
        PipeStages(3, 0).layers(LAYERS)
    with pytest.raises(ValueError, match="pipe stages"):
        Encoder(**ENC, dtype=torch.float32, pipe=PipeStages(3, 1))
    enc = Encoder(**ENC, dtype=torch.float32, attn_impl="xla")
    x = torch.from_numpy(jax_side["x"])
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda layer, h: layer(h), enc.blocks(), x,
                       num_microbatches=3)
    with pytest.raises(ValueError, match="shape/dtype"):
        pipeline_apply(lambda layer, h: layer(h).double(), enc.blocks(), x,
                       num_microbatches=2)


def test_int8_backward_takes_a_zero_scale_for_a_zero_cotangent():
    """The pipeline's bubble ticks and masked outputs hand the backward an
    all-zero cotangent. K7's operands then give such a head the scale 0
    (the quantisation's guard says 1, and the kernel's one-FFMA
    conversion of dp would round at half a unit of it); every other head
    keeps sdo * sv, and the int8 backward of an all-zero cotangent is 0."""
    from smb_vision_tpu_torch.ops import attention as A

    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 16, 3, 32, generator=g) for _ in range(4))
    do[1, :, 2] = 0.0
    *_, sqk, sdv = A._i8_operands(q, k, v, do, 0.2, A.quantize_per_head)
    _, sdo = A.quantize_per_head(do)
    _, sv = A.quantize_per_head(v)
    want = sdo * sv
    want[1, 2] = 0.0
    assert torch.equal(sdv, want)
    out, lse = A.xla_attention(q, k, v, with_lse=True)
    grads = A.attention_bwd_i8_plain(q, k, v, out, lse, torch.zeros_like(do),
                                     scale=32 ** -0.5)
    assert all(float(t.abs().max()) == 0.0 for t in grads)
