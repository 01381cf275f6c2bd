"""The port's encoder-zoo runner (`inference/runner.py::BaseEncoderRunner`)
and 2D image dataset (`data/image2d.py`) on the CPU: the counterparts of
tests/test_inference.py's runner cases (the manifest check, resume with
the failure retried, quarantine under the right uid, the padded last
batch, a dataset that drops items) and the images against the JAX
package's `Image2DDataset`, bit for bit."""

import json

import numpy as np
import pytest
import torch

from smb_vision_tpu.data.image2d import Image2DDataset as JImage2D
from smb_vision_tpu_torch.data.image2d import Image2DDataset
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.inference.runner import (
    BaseEncoder,
    BaseEncoderRunner,
    SmbVisionEncoder,
)

torch.set_num_threads(1)


class _StubEncoder(BaseEncoder):
    """Records the batch shapes; an image's embedding is its mean, so the
    uid -> content pairing is checkable."""

    model_id = "stub"

    def __init__(self, image_size=8):
        self.image_size = image_size
        self.batch_shapes = []

    def create_dataset(self, items):
        return Image2DDataset(items, image_size=self.image_size)

    def setup_model(self):
        pass

    def generate_embedding(self, batch):
        self.batch_shapes.append(batch.shape)
        return batch.reshape(batch.shape[0], -1).mean(axis=1, keepdims=True)


def _mk_pngs(tmp_path, uids, corrupt=()):
    from PIL import Image

    items = []
    for i, uid in enumerate(uids):
        p = tmp_path / f"{uid}.png"
        if uid in corrupt:
            p.write_bytes(b"not a png at all")
        else:
            Image.fromarray(
                np.full((8, 8, 3), 10 * (i + 1), np.uint8)).save(p)
        items.append({"uid": uid, "image_path": str(p)})
    return items


def test_manifest_validation(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"images": [{"image_path": "x.nii"}]}))
    with pytest.raises(ValueError, match="uid"):
        BaseEncoderRunner.load_input_json(str(bad))
    good = tmp_path / "good.json"
    good.write_text(json.dumps([{"uid": "a", "image_path": "x.nii"}]))
    assert BaseEncoderRunner.load_input_json(str(good))[0]["uid"] == "a"


def test_runner_end_to_end_with_errors_and_resume(tmp_path):
    """A tiny smb-vision encoder over 3 NIfTIs and a missing file: 3
    embedded, 1 quarantined; the second run skips the 3 and retries the
    failure."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    cfg = VideoMAEConfig(image_size=16, num_frames=16, patch_size=8,
                         tubelet_size=8, num_channels=1, hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, dtype="float32",
                         attn_impl="xla")
    cfg.save_json(str(tmp_path / "config.json"))
    rng = np.random.default_rng(0)
    items = []
    for i in range(3):
        p = tmp_path / f"v{i}.nii.gz"
        save_nifti(p, rng.normal(0, 300, (24, 24, 16)).astype(np.float32))
        items.append({"uid": f"v{i}", "image_path": str(p)})
    items.append({"uid": "missing", "image_path": str(tmp_path / "no.nii")})
    enc = SmbVisionEncoder(config_path=str(tmp_path / "config.json"),
                           model_id="test-enc", dtype="float32",
                           attn_impl="xla", device="cpu")
    runner = BaseEncoderRunner(enc, str(tmp_path / "out"), fmt="npy",
                               batch_size=2, num_workers=2)
    assert runner.run(items) == {"embedded": 3, "failed": 1, "skipped": 0}
    assert np.load(tmp_path / "out" / "v0.npy").shape == (8, 32)
    errors = json.loads((tmp_path / "out" / "error_files.json").read_text())
    assert [e["item"]["uid"] for e in errors] == ["missing"]
    assert runner.run(items) == {"embedded": 0, "failed": 1, "skipped": 3}


def test_runner_corrupt_item_keeps_uid_pairing(tmp_path):
    """A corrupt image mid-manifest is quarantined under its own uid and
    later items keep theirs."""
    items = _mk_pngs(tmp_path, ["a", "b", "c"], corrupt=("b",))
    runner = BaseEncoderRunner(_StubEncoder(), str(tmp_path / "out"),
                               fmt="npy", batch_size=1, num_workers=2)
    assert runner.run(items) == {"embedded": 2, "failed": 1, "skipped": 0}
    errors = json.loads((tmp_path / "out" / "error_files.json").read_text())
    assert [e["item"]["uid"] for e in errors] == ["b"]
    # 'c' holds image c's embedding: (30/255 - 0.5) / 0.5
    np.testing.assert_allclose(np.load(tmp_path / "out" / "c.npy"),
                               [2 * (30 / 255) - 1], atol=1e-6)


def test_runner_pads_ragged_final_batch(tmp_path):
    enc = _StubEncoder()
    runner = BaseEncoderRunner(enc, str(tmp_path / "out"), fmt="parquet",
                               batch_size=2, num_workers=2)
    assert runner.run(_mk_pngs(tmp_path, ["a", "b", "c"]))["embedded"] == 3
    assert enc.batch_shapes == [(2, 3, 8, 8), (2, 3, 8, 8)]
    part = tmp_path / "out" / "model_id=stub"
    assert sorted(f.name for f in part.glob("*.parquet")) == \
        ["a.parquet", "b.parquet", "c.parquet"]


def test_runner_rejects_item_dropping_dataset(tmp_path):
    class DroppingEncoder(_StubEncoder):
        def create_dataset(self, items):
            ds = super().create_dataset(items)
            ds.items = ds.items[1:]
            return ds

    runner = BaseEncoderRunner(DroppingEncoder(), str(tmp_path / "out"),
                               fmt="npy", batch_size=1)
    with pytest.raises(ValueError, match="1:1 index pairing"):
        runner.run(_mk_pngs(tmp_path, ["a", "b"]))


def test_image2d_matches_jax(tmp_path):
    """Resize, RGB conversion and normalisation: the same arrays as the
    JAX package's dataset, bit for bit; an unreadable item raises at its
    own index in both."""
    from PIL import Image

    rng = np.random.default_rng(4)
    items = []
    for i, mode in enumerate(("RGB", "L")):
        p = tmp_path / f"x{i}.png"
        shape = (37, 29, 3) if mode == "RGB" else (37, 29)
        Image.fromarray(rng.integers(0, 255, shape, np.uint8),
                        mode=mode).save(p)
        items.append({"uid": f"x{i}", "image_path": str(p)})
    (tmp_path / "bad.png").write_bytes(b"nope")
    items.append({"uid": "bad", "image_path": str(tmp_path / "bad.png")})
    ours = Image2DDataset(items, image_size=24, num_workers=2)
    ref = JImage2D(items, image_size=24, num_workers=2)
    assert ours.invalid.keys() == ref.invalid.keys() == {2}
    for i in range(2):
        np.testing.assert_array_equal(ours[i]["image"], ref[i]["image"])
    with pytest.raises(ValueError, match="unreadable image"):
        ours[2]
    batch = Image2DDataset.collate_fn([ours[0], ours[1]])
    assert batch["pixel_values"].shape == (2, 3, 24, 24)
    assert batch["uid"] == ["x0", "x1"]
