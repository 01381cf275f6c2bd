"""The PyTorch port's data path against the JAX package on the CPU:
preprocessing (RAS, resample, window, pad/crop), NIfTI IO, the dataset."""

import json

import numpy as np
import pytest
import torch

from smb_vision_tpu.data import preprocess as jprep
from smb_vision_tpu_torch.data import preprocess as tprep
from smb_vision_tpu_torch.data.dataset import CTDataset
from smb_vision_tpu_torch.data.load import load_data
from smb_vision_tpu_torch.data.nifti import load_nifti, save_nifti

torch.set_num_threads(1)


def _oblique_affine(sp, angle=0.2, origin=(10.0, -4.0, 2.0)):
    """Axes rotated about S by `angle` (an oblique acquisition)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    aff = np.eye(4)
    aff[:3, :3] = rot * np.asarray(sp)[None, :]
    aff[:3, 3] = origin
    return aff


def _lps_permuted_affine(sp):
    """Input axes (y, z, x) with x flipped: not RAS."""
    aff = np.zeros((4, 4))
    aff[3, 3] = 1.0
    aff[0, 2] = -sp[2]
    aff[1, 0] = sp[0]
    aff[2, 1] = sp[1]
    aff[:3, 3] = (10.0, -4.0, 2.0)
    return aff


AFFINES = {
    "ras": lambda sp: np.diag([*sp, 1.0]),
    "oblique": _oblique_affine,
    "lps_permuted": _lps_permuted_affine,
    "flipped": lambda sp: np.diag([-sp[0], -sp[1], sp[2], 1.0]),
}


@pytest.mark.parametrize("affine", sorted(AFFINES))
@pytest.mark.parametrize("cfg", [
    jprep.PreprocessConfig((1.5, 1.5, 3.0), (20, 20, 12)),           # crop
    jprep.PreprocessConfig((0.9, 1.1, 2.0), (40, 36, 24), layout="CHWD"),
])
def test_preprocess_matches_jax(affine, cfg):
    rng = np.random.default_rng(0)
    vol = rng.normal(-100, 400, (30, 26, 22)).astype(np.float32)
    aff = AFFINES[affine]((1.2, 0.8, 2.4))
    ref = jprep.preprocess_volume(vol, aff, cfg)
    tcfg = tprep.PreprocessConfig(**cfg.__dict__)
    out = tprep.preprocess_volume(vol, aff, tcfg, device=torch.device("cpu"))
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_orientation_and_shape_helpers_match_jax():
    aff = _lps_permuted_affine((1.2, 0.8, 2.4))
    assert tprep.io_orientation(aff) == jprep.io_orientation(aff)
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    d_t, a_t = tprep.to_ras(data, aff)
    d_j, a_j = jprep.to_ras(data, aff)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(a_t, a_j)
    assert (tprep.resampled_shape((256, 256, 160), (3.0, 3.0, 6.0),
                                  (1.5, 1.5, 3.0)) == (512, 512, 320))
    assert tprep.CT_PIPELINES.keys() == jprep.CT_PIPELINES.keys()
    for name, cfg in jprep.CT_PIPELINES.items():
        assert tprep.CT_PIPELINES[name].__dict__ == cfg.__dict__


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_nifti_round_trip_bit_exact(tmp_path, suffix, dtype):
    from smb_vision_tpu.data.nifti import load_nifti as jload

    rng = np.random.default_rng(1)
    data = (rng.normal(0, 300, (7, 5, 3))).astype(dtype)
    aff = _oblique_affine((1.5, 1.5, 3.0))
    path = tmp_path / f"vol{suffix}"
    save_nifti(path, data, aff)
    img = load_nifti(path)
    assert img.data.dtype == dtype
    np.testing.assert_array_equal(img.data, data)
    np.testing.assert_allclose(img.affine, aff, atol=1e-5)
    ref = jload(path)                     # the JAX package reads it alike
    np.testing.assert_array_equal(ref.data, img.data)
    np.testing.assert_array_equal(ref.affine, img.affine)


def test_ctdataset_python_backend(tmp_path):
    rng = np.random.default_rng(2)
    items = []
    for i in range(2):
        p = tmp_path / f"case_{i}.nii.gz"
        save_nifti(p, rng.normal(0, 300, (32, 32, 16)).astype(np.int16),
                   np.diag([1.5, 1.5, 3.0, 1.0]))
        items.append({"image": str(p), "label": i})
    spec = tmp_path / "ds.json"
    spec.write_text(json.dumps({"train": items, "validation": items[:1]}))
    assert load_data(spec, split="validation") == items[:1]
    ds = CTDataset(spec, split="train",
                   pipeline=tprep.PreprocessConfig((1.5, 1.5, 3.0),
                                                   (32, 32, 16)))
    assert len(ds) == 2
    ex = ds[1]
    assert ex["image"].shape == (16, 1, 32, 32) and ex["label"] == 1
    assert 0.0 <= ex["image"].min() and ex["image"].max() <= 1.0
    with pytest.raises(NotImplementedError, match="native"):
        CTDataset(items=items, backend="native")
    with pytest.raises(NotImplementedError, match="cache"):
        CTDataset(items=items, cache_dir=str(tmp_path / "cache"))
