"""The port's native C++ CT loader (`smb_vision_tpu_torch/data/native.py`
over `csrc/ctloader.cpp`, built at first use) against the JAX package's
`preprocess_volume` on the CPU, to the JAX package's own tolerance between
its two backends (tests/test_native.py: 1e-4 absolute); bucketed
preprocessing against the exact path; `partition_items` against the JAX
function. The library is built here with g++: where g++ is present a
failed build fails these tests (no skip)."""

import shutil
import struct

import numpy as np
import pytest
import torch

from smb_vision_tpu.data.dataset import partition_items as jpartition
from smb_vision_tpu.data.preprocess import PreprocessConfig as JConfig
from smb_vision_tpu.data.preprocess import preprocess_volume as jpreprocess
from smb_vision_tpu_torch.data import build_native, native
from smb_vision_tpu_torch.data.dataset import CTDataset, partition_items
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.data.preprocess import (
    PreprocessConfig,
    preprocess_volume,
)

torch.set_num_threads(1)

TOL_NATIVE = 1e-4        # tests/test_native.py, native against python


def test_library_builds_from_the_repo_source():
    """The build is keyed by the source's hash and the compiler line; a
    second build of the same source is the same file; a failed compile
    raises with the compiler's output."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is missing: the native loader cannot be built")
    lib = build_native.build()
    assert lib == build_native.library_path() and lib.is_file()
    assert lib.parent.parent == build_native.BUILD_DIR
    assert build_native.build() == lib
    assert native.native_available()
    assert native._load_lib().ctloader_version() >= 1


def test_failed_build_raises_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ctloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build_native, "SRC", bad)
    monkeypatch.setattr(build_native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="ctloader.cpp") as err:
        build_native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").rglob("*.so"))


def _case(tmp_path, rng, shape=(50, 44, 36), spacing=(2.0, 1.5, 3.0),
          name="v.nii.gz", dtype=np.float32, affine=None):
    vol = rng.normal(0, 300, shape).astype(dtype)
    aff = np.diag([*spacing, 1.0]) if affine is None else affine
    p = tmp_path / name
    save_nifti(p, vol, aff)
    return vol, aff, str(p)


CASES = {
    # name: (volume shape, affine or spacing, dtype, suffix, target)
    "ras": ((50, 44, 36), (2.0, 1.5, 3.0), np.float32, ".nii.gz",
            ((1.0, 1.0, 1.0), (64, 56, 48))),
    "flipped": ((30, 28, 20), np.diag([-1.5, -2.0, 2.5, 1.0]), np.float32,
                ".nii.gz", ((1.5, 1.5, 1.5), (32, 32, 32))),
    "int16_uncompressed": ((24, 24, 16), np.eye(4), np.int16, ".nii",
                           ((1.0, 1.0, 1.0), (24, 24, 16))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_jax_preprocess(tmp_path, case):
    """The port's native_load_batch against the JAX package's python
    preprocess_volume: a RAS volume resampled and cropped, an LPS-style
    flipped affine, and int16 data in an uncompressed file."""
    shape, geo, dtype, suffix, (sp, size) = CASES[case]
    rng = np.random.default_rng(0)
    aff = geo if isinstance(geo, np.ndarray) else np.diag([*geo, 1.0])
    vol, _, p = _case(tmp_path, rng, shape=shape, name="v" + suffix,
                      dtype=dtype, affine=aff)
    out, status = native.native_load_batch(
        [p], target_size=size, target_spacing=sp)
    assert status == [0]
    ref = jpreprocess(vol.astype(np.float32), aff, JConfig(sp, size))
    np.testing.assert_allclose(out[0], ref[:, 0].transpose(1, 2, 0),
                               atol=TOL_NATIVE)
    # the model layout of one volume, and CTDataset's native backend
    pipe = PreprocessConfig(sp, size)
    one = native.native_preprocess_volume(p, pipe)
    np.testing.assert_array_equal(one[:, 0].transpose(1, 2, 0), out[0])
    ds = CTDataset(items=[{"image": p}], pipeline=pipe, backend="native")
    np.testing.assert_array_equal(ds[0]["image"], one)


def test_native_error_statuses(tmp_path):
    """A missing file and garbage bytes get their own non-zero status; the
    good volume of the same batch loads."""
    rng = np.random.default_rng(0)
    _, _, good = _case(tmp_path, rng)
    garbage = tmp_path / "garbage.nii"
    garbage.write_bytes(b"\x00" * 500)
    _, status = native.native_load_batch(
        [good, str(tmp_path / "missing.nii"), str(garbage)],
        target_size=(16, 16, 16), target_spacing=(1.0, 1.0, 1.0))
    assert status[0] == 0 and status[1] != 0 and status[2] != 0
    with pytest.raises(FileNotFoundError):
        CTDataset(items=[{"image": str(tmp_path / "missing.nii")}],
                  backend="native")[0]
    with pytest.raises(ValueError, match="native decode failed"):
        CTDataset(items=[{"image": str(garbage)}], backend="native")[0]


def test_native_batch_concurrency(tmp_path):
    """8 volumes on 8 threads: each equals its own single-thread load."""
    rng = np.random.default_rng(0)
    paths = [_case(tmp_path, rng, name=f"v{i}.nii.gz")[2] for i in range(8)]
    kw = dict(target_size=(32, 32, 32), target_spacing=(1.0, 1.0, 1.0))
    out, status = native.native_load_batch(paths, num_threads=8, **kw)
    assert status == [0] * 8 and out.shape == (8, 32, 32, 32)
    for i in (0, 7):
        one, _ = native.native_load_batch([paths[i]], num_threads=1, **kw)
        np.testing.assert_array_equal(out[i], one[0])


@pytest.mark.parametrize("header", ["zero_dim", "nan_scl_slope", "uint32"])
def test_native_header_cases(tmp_path, header):
    """dim[1] = 0 is a clean error status (it once reached the resampler
    with negative indices); a NaN scl_slope means no scaling, as the JAX
    package's python loader reads it; datatype 768 (uint32) loads, equal
    to the JAX package's preprocess of the same values."""
    from smb_vision_tpu.data.nifti import load_nifti as jload

    rng = np.random.default_rng(0)
    p = tmp_path / f"{header}.nii"
    if header == "uint32":
        vol = rng.integers(0, 2000, (16, 16, 12)).astype(np.int32)
    else:
        vol = rng.normal(0, 100, (12, 12, 8)).astype(np.float32)
    save_nifti(p, vol, np.eye(4))
    raw = bytearray(p.read_bytes())
    if header == "zero_dim":
        struct.pack_into("<h", raw, 42, 0)             # dim[1]
    elif header == "nan_scl_slope":
        struct.pack_into("<f", raw, 112, float("nan"))  # scl_slope
        struct.pack_into("<f", raw, 116, 5.0)           # scl_inter
    else:
        struct.pack_into("<h", raw, 70, 768)           # int32 -> uint32
    p.write_bytes(bytes(raw))
    size = vol.shape
    out, status = native.native_load_batch(
        [str(p)], target_size=size, target_spacing=(1.0, 1.0, 1.0))
    if header == "zero_dim":
        assert status[0] != 0
        return
    assert status == [0] and np.isfinite(out[0]).all()
    data = jload(p).data
    np.testing.assert_array_equal(data.astype(np.float64),
                                  vol.astype(np.float64))
    ref = jpreprocess(data.astype(np.float32), np.eye(4),
                      JConfig((1.0, 1.0, 1.0), size))
    np.testing.assert_allclose(out[0], ref[:, 0].transpose(1, 2, 0),
                               atol=TOL_NATIVE)


@pytest.mark.parametrize("in_shape,in_sp", [
    ((40, 37, 29), (0.7, 0.7, 2.5)), ((33, 41, 22), (1.1, 0.9, 4.0)),
    ((24, 24, 24), (2.0, 2.0, 2.0))])
def test_preprocess_bucketed_matches_exact(in_shape, in_sp):
    """preprocess_volume(bucket=16) equals the exact path bit for bit, and
    the JAX package's bucketed path to its own tolerance (2e-5 absolute,
    1e-5 relative: tests/test_data.py)."""
    rng = np.random.default_rng(0)
    vol = rng.normal(0, 300, in_shape).astype(np.float32)
    aff = np.diag([*in_sp, 1.0])
    cfg = PreprocessConfig((1.5, 1.5, 3.0), (24, 24, 16), layout="CHWD")
    exact = preprocess_volume(vol, aff, cfg)
    bucketed = preprocess_volume(vol, aff, cfg, bucket=16)
    np.testing.assert_array_equal(bucketed, exact)
    ref = jpreprocess(vol, aff, JConfig((1.5, 1.5, 3.0), (24, 24, 16),
                                        layout="CHWD"), bucket=16)
    np.testing.assert_allclose(bucketed, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n,shards,even", [
    (10, 3, True), (10, 3, False), (7, 7, True), (3, 4, True),
    (0, 2, True), (12, 4, True)])
def test_partition_items_matches_jax(n, shards, even):
    items = [{"image": f"v{i}"} for i in range(n)]
    for shard in range(shards):
        assert partition_items(items, shards, shard, even) == jpartition(
            items, shards, shard, even)


@pytest.mark.cuda
def test_native_layout_on_the_card_equals_the_host(tmp_path):
    """The (D, 1, H, W) layout made on the card by the device cache's copy
    (a transposed view copied, then laid out there) is the host's, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    _, _, p = _case(tmp_path, rng)
    pipe = PreprocessConfig((1.0, 1.0, 1.0), (64, 56, 48))
    view = native.native_preprocess_volume(p, pipe)
    card = torch.as_tensor(view).to("cuda").contiguous()
    assert card.is_contiguous()
    np.testing.assert_array_equal(card.cpu().numpy(),
                                  np.ascontiguousarray(view))


def test_native_dchw_is_a_view_quantised_in_memory_order(tmp_path):
    """The "DCHW" volume is a transposed view of the loader's (H, W, D)
    array, not a copy; its uint8 codes are those of a contiguous copy bit
    for bit, made in memory order (again a view of a contiguous array);
    and the device cache lays it out contiguous with the same values."""
    from smb_vision_tpu_torch.data.dataset import DeviceCachedBatchLoader
    from smb_vision_tpu_torch.data.quantization import quantize_volume

    rng = np.random.default_rng(0)
    _, _, p = _case(tmp_path, rng)
    pipe = PreprocessConfig((1.0, 1.0, 1.0), (24, 20, 16))
    view = native.native_preprocess_volume(p, pipe)
    dense = np.ascontiguousarray(view)
    assert view.shape == (16, 1, 24, 20) and not view.flags.c_contiguous
    assert view.base is not None and view.base.flags.c_contiguous
    q, s, o = quantize_volume(view)
    qd, sd, od = quantize_volume(dense)
    np.testing.assert_array_equal(q, qd)
    assert (s, o) == (sd, od) and q.base is not None
    assert q.base.flags.c_contiguous and not q.flags.c_contiguous
    ds = CTDataset(items=[{"image": p}], pipeline=pipe, backend="native")
    loader = DeviceCachedBatchLoader(ds, 1)
    loader.attach_device("cpu")
    (batch,) = list(loader)
    assert batch["pixel_values"].is_contiguous()
    np.testing.assert_array_equal(batch["pixel_values"][0].numpy(), dense)


@pytest.mark.parametrize("device,want", [
    (None, "native"), ("cpu", "native"), ("cuda", "python")])
def test_auto_backend_follows_the_device(tmp_path, device, want):
    """"auto" takes the python backend (resample on the card) for a CUDA
    device, and the native loader for the CPU or no device. Only the
    constructor runs: no tensor is made on the device."""
    rng = np.random.default_rng(0)
    _, _, p = _case(tmp_path, rng)
    ds = CTDataset(items=[{"image": p}], backend="auto",
                   device=None if device is None else torch.device(device))
    assert ds.backend == want
