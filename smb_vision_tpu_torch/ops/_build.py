"""Build and bind the port's hand-written CUDA kernels (`csrc/*.cu`).

The kernels compile at first use with `nvcc` for `sm_90a` into a plain-C
shared library, loaded with `ctypes`. The library lives in
`smb_vision_tpu_torch/_build/<hash>/`, keyed by a hash of the sources, the
shared headers (`csrc/sm90.cuh`, `csrc/gemm_sm90.cuh`) and
the flags, so an edited source rebuilds and an unchanged one loads in
milliseconds. Importing this module builds and loads nothing.

Every kernel launches on PyTorch's current stream, allocates nothing (the
wrappers pass any workspace a kernel needs), and
returns `cudaGetLastError()`; `check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_ROOT = PKG_ROOT / "_build"
SOURCES = ("flash_fwd.cu", "flash_fwd_d80.cu", "flash_fwd_i8_d80.cu",
           "flash_bwd.cu", "flash_bwd_d80.cu", "flash_bwd_i8_d80.cu",
           "flash_bwd_i8_narrow.cu", "mlp_fwd.cu", "mlp_bwd.cu",
           "attn_glue.cu", "quant.cu", "w8a8.cu")
HEADERS = ("sm90.cuh", "gemm_sm90.cuh")
LIB_NAME = "libsmb_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / build_key()


def build() -> Path:
    """Compile the sources (in parallel, one nvcc per file) and link the
    shared library, unless a build of the same sources exists. Returns the
    library's path. The ptxas report (registers, spills, shared memory)
    goes to `build.log` beside it."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = out / f"{Path(name).stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    (out / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def bind(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    handle = ctypes.CDLL(str(path))
    handle.smb_flash_fwd.argtypes = (
        [_P] * 7 + [_I] * 6 + [_P, _F, _P])
    handle.smb_flash_fwd.restype = _I
    handle.smb_flash_fwd_i8pv.argtypes = (
        [_P] * 7 + [_I] * 6 + [_P, _P])
    handle.smb_flash_fwd_i8pv.restype = _I
    handle.smb_flash_bwd.argtypes = (
        [_P] * 9 + [_I] * 5 + [_P, _F, _F, _P])
    handle.smb_flash_bwd.restype = _I
    handle.smb_flash_bwd_i8.argtypes = (
        [_P] * 14 + [_I] * 5 + [_P, _F, _P])
    handle.smb_flash_bwd_i8.restype = _I
    handle.smb_mlp_fwd.argtypes = (
        [_P] * 9 + [_I] * 3 + [_F, _I, _I, _P, _P, _P, _I])
    handle.smb_mlp_fwd.restype = _I
    handle.smb_mlp_bwd.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    handle.smb_mlp_bwd.restype = _I
    handle.smb_swiglu_fwd.argtypes = (
        [_P] * 8 + [_I] * 3 + [_F, _P, _P, _P, _I])
    handle.smb_swiglu_fwd.restype = _I
    handle.smb_qkv_ln_fwd.argtypes = (
        [_P] * 12 + [_I] * 2 + [_F, _P, _P, _I])
    handle.smb_qkv_ln_fwd.restype = _I
    handle.smb_out_res_fwd.argtypes = [_P] * 5 + [_I] * 2 + [_P]
    handle.smb_out_res_fwd.restype = _I
    handle.smb_quantize.argtypes = (
        [_P] + [_I] * 4 + [_P, _F, _P, _P, _P, _I, _I, _P, _I])
    handle.smb_quantize.restype = _I
    handle.smb_quantize_rows.argtypes = (
        [_P] + [_I] * 2 + [ctypes.c_longlong] + [_I] * 2 + [_P] * 3)
    handle.smb_quantize_rows.restype = _I
    handle.smb_w8a8_gemm.argtypes = (
        [_P] * 6 + [_I] * 3 + [ctypes.c_longlong, _I, _P])
    handle.smb_w8a8_gemm.restype = _I
    handle.smb_error_string.argtypes = [_I]
    handle.smb_error_string.restype = ctypes.c_char_p
    return handle


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib().smb_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()
