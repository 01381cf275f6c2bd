"""Dataset spec loading, counterpart of `smb_vision_tpu/data/load.py`:
JSON (dict-of-splits or list), CSV / XLSX / Parquet with an optional
'split' column. pandas is imported only for the tabular formats."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union


def load_data(file_path: Union[str, Path],
              split: Optional[str] = None) -> List[Dict]:
    file_path = Path(file_path)
    if not file_path.exists():
        raise FileNotFoundError(
            f"dataset spec does not exist: {file_path}")

    suffix = file_path.suffix.lower()
    if suffix == ".json":
        with open(file_path) as f:
            data = json.load(f)
        if split and isinstance(data, dict):
            if split not in data:
                raise ValueError(
                    f"no split named '{split}' in {file_path.name}; "
                    f"the file defines: {sorted(data.keys())}")
            return data[split]
        if isinstance(data, list):
            return data
        # dict-of-splits with split=None: flatten to one item list —
        # list(values()) would return a list of split-LISTS, which blows
        # up far downstream in __getitem__ with a confusing TypeError
        flat = []
        for v in data.values():
            if isinstance(v, list):
                flat.extend(v)
            else:
                flat.append(v)
        return flat

    import pandas as pd

    if suffix == ".csv":
        df = pd.read_csv(file_path)
    elif suffix == ".xlsx":
        df = pd.read_excel(file_path)
    elif suffix == ".parquet":
        df = pd.read_parquet(file_path)
    else:
        raise ValueError(
            f"cannot read a '{suffix}' dataset spec — use one of "
            ".json / .csv / .parquet / .xlsx")
    if split and "split" in df.columns:
        df = df[df["split"] == split]
    return df.to_dict("records")
