"""Export a checkpoint of the PyTorch port's training CLIs (or the JAX
package's: the same safetensors names) to the HF layout, loadable by
transformers' VideoMAEForPreTraining, VJEPA2Model or Dinov2Model with
load_state_dict(..., strict=False): only the fixed sincos position
buffers are absent (the torch models compute them).

Usage:
  python scripts/export_hf_torch.py --model_dir output/ --out hf_export/ \
      [--family auto|videomae|vjepa2|dinov2] [--wrap] \
      [--conv_name proj|proj_3d]

Reads model.safetensors and config.json from --model_dir and writes
--out/model.safetensors and a copy of config.json. Imports only the
port (`smb_vision_tpu_torch`), never JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--family", default="auto",
                    choices=["auto", "videomae", "vjepa2", "dinov2"])
    ap.add_argument("--wrap", action="store_true",
                    help="vjepa2: prefix backbone keys with 'vjepa2.' "
                         "(VJEPA2ForVideoClassification layout)")
    ap.add_argument("--conv_name", default="proj",
                    choices=["proj", "proj_3d"],
                    help="vjepa2 patch-embed conv key: upstream HF uses "
                         "'proj', the reference's vendored copy 'proj_3d'")
    args = ap.parse_args(argv)

    from smb_vision_tpu_torch.models.convert import (
        export_hf_dinov2,
        export_hf_videomae,
        export_hf_vjepa2,
        params_from_flax,
        read_safetensors,
        write_safetensors,
    )

    model_dir = Path(args.model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    # the training CLIs' names carry "params.", a bare tree's do not
    flat = {(k if k.startswith("params.") else "params." + k): v
            for k, v in read_safetensors(
                model_dir / "model.safetensors").items()}
    family = args.family
    if family == "auto":
        mt = cfg.get("model_type")
        family = (mt if mt in ("vjepa2", "dinov2", "videomae")
                  else "vjepa2" if "pred_num_hidden_layers" in cfg
                  else "videomae")
    names = set(flat)
    if family == "vjepa2":
        state = export_hf_vjepa2(
            params_from_flax(flat, vjepa=True),
            num_layers=cfg["num_hidden_layers"],
            pred_layers=cfg.get("pred_num_hidden_layers", 0),
            wrap=args.wrap, conv_name=args.conv_name)
    elif "params.encoder_to_decoder.kernel" in names:
        state = export_hf_videomae(
            params_from_flax(flat, pretraining=True),
            num_layers=cfg["num_hidden_layers"],
            decoder_layers=cfg.get("decoder_num_hidden_layers", 0))
    else:
        # a backbone, or a classification model with its head
        whole = "params.classifier.kernel" in names
        state = params_from_flax(flat, classification=whole,
                                 backbone=family)
        state = (export_hf_dinov2(state) if family == "dinov2"
                 else export_hf_videomae(state,
                                         num_layers=cfg["num_hidden_layers"],
                                         decoder_layers=0))
    if not state:
        raise ValueError(f"nothing exported: is {model_dir} a {family} "
                         "checkpoint?")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(out / "model.safetensors", state)
    shutil.copy(model_dir / "config.json", out / "config.json")
    print(f"exported {len(state)} tensors ({family}) to "
          f"{out / 'model.safetensors'}")
    return out / "model.safetensors"


if __name__ == "__main__":
    main()
