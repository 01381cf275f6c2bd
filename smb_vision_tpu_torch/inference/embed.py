"""Batch embedding: encoder-only forward per volume, written as one .npy
per volume plus metadata.json (or parquet rows), with resume and per-item
error collection.

Counterpart of `smb_vision_tpu/inference/embed.py`; the output layouts are
the same, so either package resumes the other's runs.
"""

from __future__ import annotations

import json
import os
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from smb_vision_tpu_torch.data.dataset import stack_pixels
from smb_vision_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def build_json_from_nifti_files(data_dir: str, out_path: Optional[str] = None
                                ) -> List[Dict]:
    """Recursive *.nii / *.nii.gz glob -> [{'image': path}]. Same-named
    files in different directories get a uid from their relative path."""
    paths = sorted(str(p) for p in Path(data_dir).rglob("*.nii*"))
    items = [{"image": p} for p in paths]
    stems = [EmbeddingWriter.stem_of(p) for p in paths]
    if len(set(stems)) != len(stems):
        for it, p in zip(items, paths):
            rel = Path(p).relative_to(data_dir)
            it["uid"] = str(rel.parent / EmbeddingWriter.stem_of(p)
                            ).replace("/", "__")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(items, f, indent=2)
    return items


class EmbeddingWriter:
    """{uid}.npy + metadata.json, or parquet rows partitioned by model_id
    ({uid, embedding, embedding_shape, model_id}; pandas imported only
    then)."""

    def __init__(self, out_dir: str, fmt: str = "npy",
                 model_id: str = "smb-vision-tpu"):
        if fmt not in ("npy", "parquet"):
            raise ValueError(f"unknown format {fmt!r}; valid: npy, parquet")
        self.out_dir = Path(out_dir)
        self.fmt = fmt
        self.model_id = model_id
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._meta: Dict[str, Dict] = {}

    @staticmethod
    def stem_of(path) -> str:
        stem = Path(path).name
        for suf in (".nii.gz", ".nii"):
            if stem.endswith(suf):
                stem = stem[: -len(suf)]
        return stem

    def uid_of(self, item: Dict) -> str:
        if "uid" in item:
            return str(item["uid"])
        return self.stem_of(item["image"])

    def existing_uids(self) -> set:
        """Resume: uids whose output is already written."""
        if self.fmt == "npy":
            return {p.stem for p in self.out_dir.glob("*.npy")}
        part = self.out_dir / f"model_id={self.model_id}"
        return {p.stem for p in part.glob("*.parquet")}

    def write(self, item: Dict, embedding: np.ndarray) -> None:
        uid = self.uid_of(item)
        if self.fmt == "npy":
            # atomic: a crash mid-write must not leave a truncated file
            # that resume would count as done
            dest = self.out_dir / f"{uid}.npy"
            tmp = self.out_dir / f"{uid}.npy.tmp"
            with open(tmp, "wb") as f:
                np.save(f, embedding)
            os.replace(tmp, dest)
            self._meta[uid] = {"image": item.get("image"),
                               "shape": list(embedding.shape),
                               "model_id": self.model_id}
        else:
            import pandas as pd

            part = self.out_dir / f"model_id={self.model_id}"
            part.mkdir(parents=True, exist_ok=True)
            df = pd.DataFrame([{
                "uid": uid,
                "embedding": embedding.reshape(-1).astype(np.float32),
                "embedding_shape": list(embedding.shape),
                "model_id": self.model_id,
            }])
            tmp = part / f"{uid}.parquet.tmp"
            df.to_parquet(tmp)
            os.replace(tmp, part / f"{uid}.parquet")

    def finalize(self, errors: List[Dict]) -> None:
        if self._meta:
            # merge with earlier runs, so a resumed run keeps their records
            meta_path = self.out_dir / "metadata.json"
            merged: Dict[str, Dict] = {}
            if meta_path.exists():
                try:
                    with open(meta_path) as f:
                        merged = json.load(f)
                except (json.JSONDecodeError, OSError):
                    logger.warning("unreadable metadata.json; rewriting")
            merged.update(self._meta)
            with open(meta_path, "w") as f:
                json.dump(merged, f, indent=2)
        if errors:
            with open(self.out_dir / "error_files.json", "w") as f:
                json.dump(errors, f, indent=2)
            logger.warning("%d items failed; see error_files.json",
                           len(errors))


def run_embedding(dataset, embed_fn: Callable[[np.ndarray], np.ndarray],
                  writer: EmbeddingWriter, *, batch_size: int = 1,
                  resume: bool = True, num_workers: int = 8,
                  fatal: bool = False) -> Dict:
    """Embed every item of `dataset` not yet written, `batch_size` volumes
    per embed_fn call, loading ahead on `num_workers` threads. A volume that
    fails to load or a batch that fails to embed is recorded in
    error_files.json and counted in `failed`; the run carries on. fatal: a
    batch that fails to embed raises instead (ranks that embed together
    must not part ways).
    embed_fn: (N, ...) pixels [, scale (N,), offset (N,) for uint8
    pixels] -> (N, L, D) embeddings."""
    from concurrent.futures import ThreadPoolExecutor

    done = writer.existing_uids() if resume else set()
    todo = [i for i in range(len(dataset))
            if writer.uid_of(dataset.items[i]) not in done]
    if done:
        logger.info("resume: %d already embedded, %d to go",
                    len(done), len(todo))
    errors: List[Dict] = []
    n_ok = 0

    def load(i):
        try:
            return i, dataset[i], None
        except Exception as e:  # noqa: BLE001 — per-item quarantine
            return i, None, {"item": dataset.items[i], "error": str(e),
                             "trace": traceback.format_exc(limit=3)}

    with ThreadPoolExecutor(num_workers) as pool:
        batch: List = []
        for i, ex, err in pool.map(load, todo):
            if err is not None:
                errors.append(err)
                continue
            # a uint8 dataset (out_dtype "uint8") gives each volume's
            # affine: embed_fn then takes (pixels, scale, offset)
            batch.append((dataset.items[i], ex["image"],
                          ex.get("image_scale"), ex.get("image_offset")))
            if len(batch) == batch_size:
                n_ok += _flush(batch, embed_fn, writer, errors, fatal)
                batch = []
        if batch:
            n_ok += _flush(batch, embed_fn, writer, errors, fatal)

    writer.finalize(errors)
    return {"embedded": n_ok, "failed": len(errors),
            "skipped": len(done)}


def _flush(batch, embed_fn, writer, errors, fatal: bool = False) -> int:
    items = [b[0] for b in batch]
    pixels = stack_pixels([b[1] for b in batch])
    args = ()
    if batch[0][2] is not None:
        args = (np.asarray([b[2] for b in batch], np.float32),
                np.asarray([b[3] for b in batch], np.float32))
    try:
        emb = np.asarray(embed_fn(pixels, *args))
    except Exception as e:  # noqa: BLE001 — recorded, the run carries on
        if fatal:
            raise
        logger.error("embedding a batch of %d failed: %s", len(items), e)
        errors.extend({"item": it, "error": str(e),
                       "trace": traceback.format_exc(limit=3)}
                      for it in items)
        return 0
    for it, e in zip(items, emb):
        writer.write(it, e)
    return len(items)
