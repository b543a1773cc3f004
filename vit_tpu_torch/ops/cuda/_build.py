"""Build and load the kernel library (counterpart of
``vit_tpu/ops/pallas/common.py``: what every kernel shares).

``nvcc`` compiles every ``vit_tpu_torch/csrc/*.cu`` into one shared library
with a plain C interface, which is loaded with ``ctypes``. The library is
named by a hash of the sources and flags, so a change to any source
rebuilds it; it lives under ``build/vit_tpu_torch/`` at the repository root.
Nothing is built when the package is imported: the first kernel call
builds, so the package imports on a machine without ``nvcc``.

Every C entry point takes its pointers and sizes, then the dtype code, the
device index and the stream, and returns ``cudaGetLastError()`` after its
launch; :func:`launch` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "vit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: Dtype codes of the C interface (``csrc/common.cuh``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: Arguments of each entry point before the common (dtype, device, stream).
_SIGNATURES = {
    # x, scale, bias, out, rows, d, eps
    "vit_layernorm": (_P, _P, _P, _P, _I, _I, _F),
    # x, w, bias, residual, out, m, n, k, gelu
    "vit_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I),
    # x, ln_scale, ln_bias, w1, b1, w2, b2, out, m, d, mlp, eps
    "vit_mlp_block": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F),
    # qkv, out, batch, seq, d, heads, seq_len, scale
    "vit_attention": (_P, _P, _I, _I, _I, _I, _I, _F),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvit_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these sources exists; returns
    its path. The compiler's output (``-Xptxas=-v``: registers, shared
    memory and spills of each kernel) is kept beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                     delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp_path), *cu],
            capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-8000:]}")
        os.replace(tmp_path, out)
    finally:
        tmp_path.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [*args, _I, _I, _P]
                fn.restype = _I
            lib.vit_error_string.argtypes = [_I]
            lib.vit_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args, like: torch.Tensor) -> None:
    """Call entry point ``name`` with ``args`` (tensors become their data
    pointers, None a null pointer), on ``like``'s device and dtype and the
    current stream; raise if the launch reported an error."""
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    dev = like.device.index if like.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(like.device).cuda_stream
    rc = getattr(lib, name)(*conv, DTYPE_CODES[like.dtype], dev, stream)
    if rc != 0:
        msg = lib.vit_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def check_tensor(t: torch.Tensor, name: str, like: torch.Tensor,
                 shape: tuple[int, ...] | None = None) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``like``'s CUDA device
    with ``like``'s dtype (float32 or bfloat16) and, if given, ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {like.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
