"""The PyTorch port's sliding-window embedding against the JAX package's
on the CPU: window geometry, blending weights, a 2-layer VideoMAE loaded
from the JAX package's export run window by window, and the full-extent
preprocessing that feeds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.data import preprocess as jprep
from smb_vision_tpu.inference import sliding_window as jsw
from smb_vision_tpu.models.configs import VideoMAEConfig as JConfig
from smb_vision_tpu.models.videomae import VideoMAEModel as JModel
from smb_vision_tpu.utils.serialization import save_params_safetensors
from smb_vision_tpu_torch.data import preprocess as tprep
from smb_vision_tpu_torch.inference import sliding_window as tsw
from smb_vision_tpu_torch.models.configs import VideoMAEConfig
from smb_vision_tpu_torch.models.convert import load_backbone_into
from smb_vision_tpu_torch.models.videomae import VideoMAEModel

torch.set_num_threads(1)

TINY = dict(image_size=32, num_frames=32, patch_size=16, tubelet_size=16,
            num_channels=1, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64, dtype="float32",
            attn_impl="xla", mlp_impl="xla")
ROI = (32, 32, 32)


@pytest.mark.parametrize("image,roi,overlap", [
    ((48, 56, 24), (32, 32, 32), 0.25),
    ((100, 37, 64), (32, 16, 64), (0.5, 0.1, 0.0)),
    ((512, 512, 448), (512, 512, 320), 0.25),
    ((33, 33, 33), (32, 32, 32), 0.9),
])
def test_window_geometry_matches_jax(image, roi, overlap):
    padded = tuple(max(s, r) for s, r in zip(image, roi))
    iv = tsw.scan_interval(padded, roi, overlap)
    assert iv == jsw.scan_interval(padded, roi, overlap)
    starts = tsw.dense_window_starts(padded, roi, iv)
    np.testing.assert_array_equal(
        starts, jsw.dense_window_starts(padded, roi, iv))
    assert starts.dtype == np.int32


def test_leg_w_geometry():
    """A 512 x 512 x 448 volume under the 512^2 x 320 roi at overlap 0.25:
    two windows, at depth 0 and 128."""
    image, roi = (512, 512, 448), (512, 512, 320)
    starts = tsw.dense_window_starts(image, roi,
                                     tsw.scan_interval(image, roi, 0.25))
    np.testing.assert_array_equal(starts, [[0, 0, 0], [0, 0, 128]])


@pytest.mark.parametrize("mode", ["constant", "gaussian"])
@pytest.mark.parametrize("grid", [None, (2, 4, 3)])
def test_blending_weights_match_jax(mode, grid):
    roi = (16, 12, 8)
    np.testing.assert_allclose(tsw.importance_map(roi, mode, 0.2).numpy(),
                               np.asarray(jsw.importance_map(roi, mode, 0.2)),
                               atol=1e-6)
    if grid is None:
        roi, n = (16, 16, 32), 16       # cubic patch 8 inferred
    else:
        n = int(np.prod(grid))
    out = tsw.token_weights(roi, n, mode, 0.125, grid)
    ref = np.asarray(jsw.token_weights(roi, n, mode, 0.125, grid))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    with pytest.raises(ValueError, match="token grid"):
        tsw.token_weights((16, 12, 8), 7, "gaussian", token_grid=(1, 1, 1))
    with pytest.raises(ValueError, match="blend mode"):
        tsw.importance_map(roi, "linear")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX VideoMAE with random weights (biases and norms perturbed)
    and the port's model loaded from the JAX package's safetensors
    export."""
    cfg = JConfig(**TINY)
    jmodel = JModel(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  np.zeros((1, 32, 1, 32, 32), np.float32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: p + rng.normal(0, 0.05, p.shape).astype(np.float32)
        if p.ndim == 1 else p, params)
    path = tmp_path_factory.mktemp("sw") / "model.safetensors"
    save_params_safetensors(params, path)
    model = VideoMAEModel(VideoMAEConfig(**TINY))
    load_backbone_into(model, str(path))
    return jmodel, params, model.eval()


@pytest.mark.parametrize("mode,pool,grid", [
    ("constant", False, None),
    ("constant", True, None),
    ("gaussian", False, (2, 2, 2)),
    ("gaussian", True, None),
])
def test_sliding_window_embed_matches_jax(models, mode, pool, grid):
    """B = 2, H below the roi (padded by _pad_to_min), 4 windows in chunks
    of 3 (a ragged last chunk)."""
    jmodel, params, model = models
    rng = np.random.default_rng(1)
    vol = rng.uniform(0, 1, (2, 1, 24, 48, 56)).astype(np.float32)

    def jembed(p, wins):
        out, _ = jmodel.apply(p, jnp.transpose(wins, (0, 4, 1, 2, 3)))
        return out

    def tembed(wins):
        out, _ = model(wins.permute(0, 4, 1, 2, 3))
        return out

    kw = dict(overlap=0.25, sw_batch_size=3, mode=mode, pool=pool,
              token_grid=grid, cval=0.5)
    ref, jstarts = jsw.sliding_window_embed(jnp.asarray(vol), ROI, jembed,
                                            state=params, **kw)
    with torch.no_grad():
        out, starts = tsw.sliding_window_embed(torch.from_numpy(vol), ROI,
                                               tembed, **kw)
    np.testing.assert_array_equal(starts, jstarts)
    assert len(starts) == 4
    want = (2, 4, 32) if pool else (2, 4, 8, 32)
    assert tuple(out.shape) == want == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("spacing,shape", [
    ((1.2, 0.8, 2.4), (30, 26, 22)),
    ((3.0, 3.0, 6.0), (16, 16, 24)),    # resamples to 32 x 32 x 48: no pad
])
@pytest.mark.parametrize("flip", [False, True])
def test_preprocess_volume_full_matches_jax(spacing, shape, flip):
    rng = np.random.default_rng(3)
    vol = rng.normal(-100, 400, shape).astype(np.float32)
    aff = np.diag([*spacing, 1.0])
    if flip:
        aff[0, 0] = -aff[0, 0]
    cfg = jprep.CT_PIPELINES["smb-vision"]
    ref = jprep.preprocess_volume_full(vol, aff, cfg)
    out = tprep.preprocess_volume_full(
        vol, aff, tprep.PreprocessConfig(**cfg.__dict__),
        device=torch.device("cpu"))
    assert out.shape == ref.shape and out.dtype == np.float32
    assert all(s % 32 == 0 for s in out.shape)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _window_predictor(xp):
    """A predictor whose output at a voxel depends on its window (through
    the window's mean), with two output channels per input channel."""
    def predict(w):
        m = w.mean(axis=(2, 3, 4), keepdims=True) if xp is jnp else \
            w.mean(dim=(2, 3, 4), keepdim=True)
        cat = jnp.concatenate if xp is jnp else torch.cat
        return cat([w - m, w * m + 0.5], 1)
    return predict


@pytest.mark.parametrize("mode", ["constant", "gaussian"])
@pytest.mark.parametrize("shape,roi,overlap,sw", [
    ((2, 1, 40, 36, 48), (16, 16, 16), 0.25, 1),
    ((1, 2, 20, 24, 16), (16, 16, 16), 0.5, 3),
    ((1, 1, 10, 12, 14), (16, 16, 16), 0.25, 2),    # smaller than the roi
])
def test_sliding_window_inference_matches_jax(mode, shape, roi, overlap, sw):
    vol = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = jsw.sliding_window_inference(
        jnp.asarray(vol), roi, _window_predictor(jnp), overlap=overlap,
        sw_batch_size=sw, mode=mode, cval=0.25)
    got = tsw.sliding_window_inference(
        torch.from_numpy(vol), roi, _window_predictor(torch),
        overlap=overlap, sw_batch_size=sw, mode=mode, cval=0.25)
    assert got.shape == want.shape == (shape[0], 2 * shape[1], *shape[2:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
