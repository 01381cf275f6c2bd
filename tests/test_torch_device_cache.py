"""The port's DeviceCachedBatchLoader and prefetch_to_device on the CPU
device, against the JAX package's DeviceCachedBatchLoader and the host
BatchLoader: after epoch 0 no volume is read from the host, the batches
equal the host loader's (same shuffle seed), uint8 volumes stay cached as
codes with their affine and are decoded in the step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smb_vision_tpu.data.dataset import CTDataset as JDataset
from smb_vision_tpu.data.dataset import DeviceCachedBatchLoader as JLoader
from smb_vision_tpu.data.preprocess import PreprocessConfig as JConfig
from smb_vision_tpu_torch.data.dataset import (
    BatchLoader,
    CTDataset,
    DeviceCachedBatchLoader,
    default_collate,
    prefetch_to_device,
)
from smb_vision_tpu_torch.data.nifti import save_nifti
from smb_vision_tpu_torch.data.preprocess import PreprocessConfig
from smb_vision_tpu_torch.data.quantization import OFFSET_KEY, SCALE_KEY
from smb_vision_tpu_torch.train.trainer import Trainer, TrainingArguments

torch.set_num_threads(1)

TOL_BACKENDS = 1e-4      # native against python (tests/test_native.py)


def _items(tmp_path, n, shape, seed, lo=-600, hi=600):
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_nifti(tmp_path / f"v{i}.nii.gz",
                   rng.uniform(lo, hi, shape).astype(np.float32))
    return [{"image": str(tmp_path / f"v{i}.nii.gz")} for i in range(n)]


def test_device_cached_loader_zero_host_loads_after_epoch0(tmp_path):
    """Each volume is read once, in epoch 0; epoch 1 reads nothing from
    the host. The batches are tensors equal to the host BatchLoader's
    (same seed), and to the JAX DeviceCachedBatchLoader's within the
    tolerance of the two packages' backends. A label-carrying collate is
    refused (pixel-only cache)."""
    items = _items(tmp_path, 4, (16, 16, 12), 0)
    geo = ((1.0, 1.0, 1.0), (16, 16, 12))
    ds = CTDataset(items=items, pipeline=PreprocessConfig(*geo))
    calls = []
    orig = CTDataset.__getitem__
    ds.__class__ = type("SpyDS", (CTDataset,), {
        "__getitem__": lambda self, i: (calls.append(i), orig(self, i))[1]})
    dev = DeviceCachedBatchLoader(ds, 2, shuffle=True, seed=7)
    dev.attach_device("cpu")
    host = BatchLoader(ds, 2, shuffle=True, seed=7, num_workers=2)
    jdev = JLoader(JDataset(items=items, pipeline=JConfig(*geo)), 2,
                   shuffle=True, seed=7)
    for epoch in range(2):
        for loader in (dev, host, jdev):
            loader.set_epoch(epoch)
        calls.clear()
        got = list(dev)
        if epoch >= 1:
            assert calls == []
        want, jwant = list(host), list(jdev)
        assert len(got) == len(want) == len(jwant) == 2
        for g, w, j in zip(got, want, jwant):
            assert isinstance(g["pixel_values"], torch.Tensor)
            assert g.keys() == {"pixel_values"}
            np.testing.assert_array_equal(g["pixel_values"].numpy(),
                                          w["pixel_values"])
            np.testing.assert_allclose(g["pixel_values"].numpy(),
                                       np.asarray(j["pixel_values"]),
                                       atol=TOL_BACKENDS)
    assert dev.host_loads == {0: 4, 1: 0}
    with pytest.raises(ValueError, match="pixel-only"):
        DeviceCachedBatchLoader(ds, 2, collate=lambda ex: {})


def test_device_cached_loader_stores_input_dtype(tmp_path):
    """With input_dtype bfloat16 the cached float volumes are stored
    already cast; the Trainer attaches its device and passes the cached
    batches to the step as they are (no host cast, no copy)."""
    items = _items(tmp_path, 4, (8, 8, 8), 1)
    ds = CTDataset(items=items,
                   pipeline=PreprocessConfig((1., 1., 1.), (8, 8, 8)))
    loader = DeviceCachedBatchLoader(ds, 2, input_dtype="bfloat16")
    seen = []

    def step_fn(state, batch, gen):
        seen.append(batch["pixel_values"])
        state["step"] += 1
        return {"loss": batch["pixel_values"].float().mean()}

    model = torch.nn.Linear(1, 1)
    tr = Trainer(args=TrainingArguments(output_dir=str(tmp_path / "o"),
                                        device="cpu", num_train_steps=4,
                                        input_dtype="bfloat16",
                                        save_steps=100),
                 state={"model": model, "step": 0, "optimizer":
                        torch.optim.SGD(model.parameters(), lr=0.0)},
                 step_fn=step_fn, train_loader=loader)
    assert loader.device == torch.device("cpu")
    tr.train()
    assert [t.dtype for t in seen] == [torch.bfloat16] * 4
    assert all(e[0].dtype == torch.bfloat16 for e in loader._dev.values())
    assert loader.host_loads == {0: 4, 1: 0}


def test_device_cached_loader_uint8(tmp_path):
    """uint8 volumes are cached as codes (one byte a voxel) with their
    scale and offset, batches carry the affine keys, and the Trainer
    decodes them to bfloat16 in the step, as the JAX package's loader and
    Trainer do; the decoded pixels equal the JAX decode of the JAX
    loader's codes within one bf16 rounding of the two backends' codes."""
    from smb_vision_tpu.data.quantization import dequantize_batch

    items = _items(tmp_path, 8, (12, 12, 8), 6)
    geo = ((1., 1., 1.), (12, 12, 8))
    ds = CTDataset(items=items, pipeline=PreprocessConfig(*geo),
                   out_dtype="uint8")
    loader = DeviceCachedBatchLoader(ds, 8, shuffle=True,
                                     input_dtype="uint8")
    seen = {}

    def step_fn(state, batch, gen):
        seen["dtype"] = batch["pixel_values"].dtype
        seen["has_scale"] = SCALE_KEY in batch
        seen["px"] = batch["pixel_values"].float()
        state["step"] += 1
        return {"loss": (batch["pixel_values"].float() ** 2).mean()}

    model = torch.nn.Linear(1, 1)
    Trainer(args=TrainingArguments(output_dir=str(tmp_path / "out"),
                                   device="cpu", num_train_steps=2,
                                   input_dtype="uint8", logging_steps=1,
                                   save_steps=100),
            state={"model": model, "step": 0, "optimizer":
                   torch.optim.SGD(model.parameters(), lr=0.0)},
            step_fn=step_fn, train_loader=loader).train()
    assert seen["dtype"] == torch.bfloat16 and not seen["has_scale"]
    pinned = next(iter(loader._dev.values()))
    assert pinned[0].dtype == torch.uint8 and len(pinned) == 3
    assert loader.host_loads == {0: 8, 1: 0}

    jds = JDataset(items=items, pipeline=JConfig(*geo), out_dtype="uint8")
    jloader = JLoader(jds, 8, shuffle=True, input_dtype="uint8")
    jloader.set_epoch(1)
    (jbatch,) = list(jloader)
    assert jbatch["pixel_values"].dtype == jnp.uint8
    want = np.asarray(jax.jit(lambda b: dequantize_batch(
        b, jnp.bfloat16))(jbatch)["pixel_values"], np.float32)
    # one code step of the volume's scale at most (the backends' codes may
    # sit on either side of a rounding tie), plus bf16's rounding of [0, 1]
    scale = float(np.asarray(jbatch[SCALE_KEY]).max())
    assert float((seen["px"] - torch.from_numpy(want)).abs().max()) <= (
        scale + 2 ** -8)


def test_prefetch_to_device_on_the_cpu(tmp_path):
    """On the CPU prefetch_to_device is a conversion to tensors, in
    order, every batch once; tensors pass through; a short iterator
    ends."""
    batches = [{"pixel_values": np.full((2, 3), i, np.float32),
                "labels": np.arange(2, dtype=np.int32)} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["pixel_values"], torch.Tensor)
        assert float(b["pixel_values"][0, 0]) == i
        assert b["labels"].dtype == torch.int32
    t = torch.ones(3)
    (one,) = list(prefetch_to_device([{"x": t}], "cpu"))
    assert one["x"] is t
    assert list(prefetch_to_device([], "cpu")) == []


def test_ram_cache_reads_each_volume_once(tmp_path):
    """CTDataset(ram_cache=True) keeps each example's pixels in memory
    after its first load (the JAX package's RAM cache): a second read
    preprocesses nothing and returns the same array."""
    items = _items(tmp_path, 2, (8, 8, 8), 2)
    ds = CTDataset(items=items, ram_cache=True,
                   pipeline=PreprocessConfig((1., 1., 1.), (8, 8, 8)))
    computed = []
    orig = ds._compute
    ds._compute = lambda item: (computed.append(item), orig(item))[1]
    first = [ds[i]["image"] for i in range(2)]
    again = [ds[i]["image"] for i in range(2)]
    assert len(computed) == 2
    assert all(a is b for a, b in zip(first, again))
    batch = default_collate([ds[0], ds[1]])
    assert batch["pixel_values"].shape == (2, 8, 1, 8, 8)
    assert OFFSET_KEY not in batch
