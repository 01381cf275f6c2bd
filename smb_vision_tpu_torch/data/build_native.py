"""Build the native C++ CT loader (`csrc/ctloader.cpp`) for this package.

The library is built at first use into `smb_vision_tpu_torch/_build/`
(gitignored), under a name keyed by the hash of the source and the
compiler line, so an edited source builds anew and an unchanged one is
built once. Several processes may build at once: each compiles into a
name of its own and renames it into place. A failed build raises with
the compiler's output.

    python -m smb_vision_tpu_torch.data.build_native   # build now

The compiler line is the JAX package's (`scripts/build_native.py`) without
its sanitizer variant. There is no -ffast-math: linking it into a shared
library installs crtfastmath's FTZ/DAZ mode in the whole process and so
changes the host Python's float behaviour.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "csrc" / "ctloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-funroll-loops")
LIBS = ("-lz",)


def library_path() -> Path:
    """Where the library of the present source and flags is built."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"ctloader-{h.hexdigest()[:12]}" / "libctloader.so"


def build(force: bool = False) -> Path:
    """Build the library unless it is there already; returns its path."""
    if not SRC.is_file():
        raise FileNotFoundError(f"{SRC}: the native loader's source is "
                                "missing (run from a checkout of the repo)")
    out = library_path()
    if out.is_file() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *FLAGS, str(SRC), *LIBS, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as err:
        raise RuntimeError(f"building the native CT loader needs g++: "
                           f"{err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native CT loader failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build(force=True)}")
