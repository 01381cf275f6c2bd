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
    # the python backend asked for by name, beside the native one (the C++
    # loader's float arithmetic: within 1e-4, the JAX package's tolerance)
    py = CTDataset(spec, split="train", backend="python",
                   pipeline=tprep.PreprocessConfig((1.5, 1.5, 3.0),
                                                   (32, 32, 16)))
    nat = CTDataset(items=items, backend="native",
                    pipeline=tprep.PreprocessConfig((1.5, 1.5, 3.0),
                                                    (32, 32, 16)))
    assert (py.backend, nat.backend) == ("python", "native")
    np.testing.assert_allclose(nat[1]["image"], py[1]["image"], atol=1e-4)
    with pytest.raises(ValueError, match="backend"):
        CTDataset(items=items, backend="cpp")


def _cache_items(tmp_path, n, shape, seed, lo=-800, hi=900):
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_nifti(tmp_path / f"v{i}.nii.gz",
                   rng.uniform(lo, hi, shape).astype(np.float32))
    return [{"image": str(tmp_path / f"v{i}.nii.gz")} for i in range(n)]


def test_ctdataset_uint8_cache_and_shipping(tmp_path):
    """cache_dtype 'uint8' stores codes and affine (npz) once; out_dtype
    'uint8' ships them with per-item scale keys; the first load equals the
    reload; a float reader decodes the same cache; an unreadable entry is
    recomputed; the collate carries the affine. The codes are the JAX
    package's quantisation of the port's preprocessed volume."""
    from smb_vision_tpu.data.quantization import quantize_volume as jquant
    from smb_vision_tpu_torch.data.dataset import BatchLoader
    from smb_vision_tpu_torch.data.quantization import (
        OFFSET_KEY,
        SCALE_KEY,
        dequantize_volume,
    )

    items = _cache_items(tmp_path, 2, (12, 12, 8), 2)
    pipe = tprep.PreprocessConfig((1., 1., 1.), (12, 12, 8))
    ds = CTDataset(items=items, pipeline=pipe, cache_dir=str(tmp_path / "c"),
                   cache_dtype="uint8", out_dtype="uint8")
    ex_first = ds[0]                      # computes and writes the entry
    assert ex_first["image"].dtype == np.uint8
    assert "image_scale" in ex_first and "image_offset" in ex_first
    assert sorted(p.suffix for p in (tmp_path / "c").iterdir()) == [".npy"]
    ex_again = ds[0]                      # reads it
    np.testing.assert_array_equal(ex_first["image"], ex_again["image"])
    assert ex_first["image_scale"] == ex_again["image_scale"]
    q, s, o = jquant(CTDataset(items=items, pipeline=pipe)[0]["image"])
    np.testing.assert_array_equal(ex_first["image"], q)
    assert (ex_first["image_scale"], ex_first["image_offset"]) == (s, o)

    ds_f = CTDataset(items=items, pipeline=pipe,
                     cache_dir=str(tmp_path / "c"),
                     cache_dtype="uint8", out_dtype="float32")
    exf = ds_f[0]
    assert exf["image"].dtype == np.float32 and "image_scale" not in exf
    np.testing.assert_array_equal(
        exf["image"], dequantize_volume(ex_first["image"],
                                        ex_first["image_scale"],
                                        ex_first["image_offset"]))
    assert ds.load_volume(items[0]).dtype == np.float32

    ds._cache_path(items[0]).write_bytes(b"garbage")
    np.testing.assert_array_equal(ds[0]["image"], ex_first["image"])

    batch = next(iter(BatchLoader(ds, batch_size=2, drop_last=False,
                                  num_workers=1)))
    assert batch["pixel_values"].dtype == np.uint8
    assert batch[SCALE_KEY].shape == (2,)
    assert batch[OFFSET_KEY].dtype == np.float32


def test_ctdataset_float_cache_uint8_out(tmp_path):
    """out_dtype 'uint8' over a float16 cache quantises at each load."""
    from smb_vision_tpu_torch.data.quantization import dequantize_volume

    items = _cache_items(tmp_path, 1, (10, 10, 6), 3, -500, 500)
    pipe = tprep.PreprocessConfig((1., 1., 1.), (10, 10, 6))
    kw = dict(items=items, pipeline=pipe, cache_dir=str(tmp_path / "c"),
              cache_dtype="float16")
    ref = CTDataset(out_dtype="float32", **kw)[0]["image"]
    ex = CTDataset(out_dtype="uint8", **kw)[0]
    assert ex["image"].dtype == np.uint8
    back = dequantize_volume(ex["image"], ex["image_scale"],
                             ex["image_offset"])
    assert np.abs(back - ref).max() <= float(ex["image_scale"]) / 2 + 2e-3


@pytest.mark.parametrize("cache_dtype", ["float32", "float16"])
@pytest.mark.parametrize("out_dtype", ["float32", "float16", "bfloat16"])
def test_ctdataset_float_cache(tmp_path, cache_dtype, out_dtype):
    """A float cache gives the first load's values on every later load, in
    out_dtype (bfloat16 as a CPU tensor); nothing is left beside the
    entries."""
    items = _cache_items(tmp_path, 2, (12, 10, 8), 4)
    pipe = tprep.PreprocessConfig((1.5, 1.5, 3.0), (16, 16, 8))
    plain = CTDataset(items=items, pipeline=pipe)[1]["image"]
    kw = dict(items=items, pipeline=pipe, cache_dir=str(tmp_path / "c"),
              cache_dtype=cache_dtype, out_dtype=out_dtype)
    first = CTDataset(**kw)[1]["image"]
    again = CTDataset(**kw)[1]["image"]
    files = sorted((tmp_path / "c").iterdir())
    assert len(files) == 1 and files[0].suffix == ".npy"
    want = plain.astype(cache_dtype)              # what the entry holds
    if out_dtype == "bfloat16":
        assert isinstance(first, torch.Tensor)
        assert first.dtype == torch.bfloat16 and first.shape == plain.shape
        first, again = first.float().numpy(), again.float().numpy()
        want = torch.from_numpy(want.astype(np.float32)).bfloat16().float()
        want = want.numpy()
    else:
        assert first.dtype == np.dtype(out_dtype)
        want = want.astype(out_dtype)
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, want)


def test_ctdataset_cache_is_not_shared_with_jax(tmp_path):
    """The two packages' preprocessors agree to 1e-5, not bit for bit: an
    entry the JAX package wrote for the same path and pipeline is never
    read by the port, which writes its own."""
    from smb_vision_tpu.data.dataset import CTDataset as JDataset

    items = _cache_items(tmp_path, 1, (12, 12, 8), 5)
    jpipe = jprep.PreprocessConfig((1.5, 1.5, 3.0), (12, 12, 8))
    pipe = tprep.PreprocessConfig(**jpipe.__dict__)
    cache = tmp_path / "c"
    jds = JDataset(items=items, pipeline=jpipe, cache_dir=str(cache),
                   backend="python")
    jds[0]
    jpath = jds._cache_path(items[0])
    np.save(jpath, np.full(np.load(jpath).shape, 7.0, np.float32))
    ds = CTDataset(items=items, pipeline=pipe, cache_dir=str(cache))
    assert ds._cache_path(items[0]) != jpath
    out = ds[0]["image"]
    np.testing.assert_array_equal(
        out, CTDataset(items=items, pipeline=pipe)[0]["image"])
    assert len(list(cache.iterdir())) == 2
    np.testing.assert_allclose(out, jprep.preprocess_volume(
        *_nifti(items[0]["image"]), jpipe), atol=1e-5)


def _nifti(path):
    img = load_nifti(path)
    return img.data, img.affine


def test_ctdataset_rejects_unknown_dtypes(tmp_path):
    with pytest.raises(ValueError, match="cache_dtype"):
        CTDataset(items=[], cache_dtype="int8")
    with pytest.raises(ValueError, match="out_dtype"):
        CTDataset(items=[], out_dtype="int16")
