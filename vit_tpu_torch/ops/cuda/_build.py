"""Build and load the kernel library (counterpart of
``vit_tpu/ops/pallas/common.py``: what every kernel shares).

``nvcc`` compiles every ``vit_tpu_torch/csrc/*.cu`` into an object file,
one process a source, all started together, then links them into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library is named by a hash of the sources and flags, so a change to any
source rebuilds it; it lives under ``build/vit_tpu_torch/`` at the
repository root.
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
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "vit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: Dtype codes of the C interface (``csrc/common.cuh``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: The codes :func:`launch` passes: also int8, for a kernel whose inputs
#: are int8 (K22).
_LAUNCH_CODES = {**DTYPE_CODES, torch.int8: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: Arguments of each entry point before the common (dtype, device, stream).
_SIGNATURES = {
    # x, scale, bias, out, rows, d, eps
    "vit_layernorm": (_P, _P, _P, _P, _I, _I, _F),
    # x, mu, rstd, rows, d, eps
    "vit_layernorm_stats": (_P, _P, _P, _I, _I, _F),
    # x, w, bias, residual, out, m, n, k, gelu, trans_a, trans_b, tile
    # (0: gemm_tile.cuh's, 1: gemm_wgmma.cuh's)
    "vit_matmul": (_P, _P, _P, _P, _P, *(_I,) * 7),
    # x, w, bias, residual, mu, rstd, gamma, beta, out, m, n, k, gelu
    "vit_fused_linear": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    # x, ln_scale, ln_bias, w1, b1, w2, b2, out, m, d, mlp, eps, partial,
    # form (fp32: 0 mlp_tile.cuh's FFMA, 1 mlp_tf32.cuh's tensor-core tile)
    "vit_mlp_block": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                      _I),
    # qkv, out, batch, seq, d, heads, seq_len, scale
    "vit_attention": (_P, _P, _I, _I, _I, _I, _I, _F),
    # q, k, v, out, (b, h, s) element strides of q, k, v and out, batch,
    # heads, seq, head_dim, seq_len, scale, out_f32
    "vit_flash_attention": (_P, _P, _P, _P, *(_L,) * 12, _I, _I, _I, _I, _I,
                            _F, _I),
    # q, k, v, g, dq, dk, dv, (b, h, s) element strides of each of the
    # seven, the (3, B*H, S) fp32 stats scratch, batch, heads, seq,
    # head_dim, seq_len, scale
    "vit_flash_attention_bwd": (*(_P,) * 7, *(_L,) * 21, _P, _I, _I, _I, _I,
                                _I, _F),
    # patches, w, bias, cls_row, pos, out, b, n, k, d, sp
    "vit_embed_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    # x, qkv, ctx, hid, acc, out, the 12 stacked encoder tensors, patches,
    # wemb, base, final-LN scale and bias, b, sp, d, mlp, heads, layers,
    # seq_len, n_tok, pd, scale, eps, fold
    "vit_encoder_stack": (*(_P,) * 23, *(_I,) * 9, _F, _F, _I),
    # x, ln scale, ln bias (or two nulls), q, ax, rows, d, eps, form (0
    # the scalar form, 1 the row form)
    "vit_quantize_rows": (_P, _P, _P, _P, _P, _I, _I, _F, _I),
    # xq, ax, wq, wscale, bias, residual, out, m, n, k, gelu
    "vit_matmul_i8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    # the same on the s8 wgmma tile (matmul_i8_wgmma.cu)
    "vit_matmul_i8_wgmma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    # x, ln scale, ln bias, w1, s1, b1, w2, s2, b2, out, m, d, mlp, eps,
    # partial
    "vit_mlp_block_i8": (*(_P,) * 10, _I, _I, _I, _F, _I),
    # x, qkv, ctx, hid, the 12 stacked encoder tensors, the 4 stacked
    # scales, b, sp, d, mlp, heads, layers, seq_len, scale, eps
    "vit_encoder_stack_q": (*(_P,) * 20, *(_I,) * 7, _F, _F),
    # x, y, out, n
    "vit_add": (_P, _P, _P, _L),
    # x, out, rows, d
    "vit_softmax": (_P, _P, _I, _I),
    # x, y, out, b, m, n, k, scale
    "vit_matmul3": (_P, _P, _P, _I, _I, _I, _I, _F),
    # x, ln scale, ln bias, w1, s1, b1, w2, s2, b2, out, m, d, mlp, eps,
    # partial
    "vit_mlp_block_q": (*(_P,) * 10, _I, _I, _I, _F, _I),
    # ctx, x, wout, bout, ln2 scale, ln2 bias, w1, b1, w2, b2, out, m, d,
    # mlp, eps, form (fp32: 0 layer_block.cu's FFMA form, 1 mlp_tf32.cuh's
    # tensor-core tile with its LAYER flag)
    "vit_layer_block": (*(_P,) * 11, _I, _I, _I, _F, _I),
    # x, out, b, c, h, w, p
    "vit_patchify": (_P, _P, _I, _I, _I, _I, _I),
    # x, out, rows, cols, grid x, grid y, then (op, rhs) for axes 0, 1, 2
    "vit_print_if_smoke": (_P, _P, *(_I,) * 10),
    # x, w, out, m, n, k
    "vit_minimal_matmul": (_P, _P, _P, _I, _I, _I),
    # x, w, out, m, n, k
    "vit_dot_probe": (_P, _P, _P, _I, _I, _I),
    # qkv, tbuf, out, batch, s, d, heads, seq_len, ldt, scale, mode
    "vit_attn_probe_core": (_P, _P, _P, *(_I,) * 6, _F, _I),
    # x, w, bias, res, out, alt, m, n, k, d, epilogue
    "vit_attn_probe_gemm": (*(_P,) * 6, *(_I,) * 5),
    # x, g, b, out, d, m, eps
    "vit_attn_probe_colln": (_P, _P, _P, _P, _I, _I, _F),
    # x, qkv, ctx, hid, acc, sink, sink_len, wqkv, wout, w1, w2, ones,
    # zeros, b, sp, d, mlp, heads, layers, scale, eps, variant
    "vit_encstack_probe": (*(_P,) * 6, _I, *(_P,) * 6, *(_I,) * 6, _F, _F,
                           _I),
    # a, b, out, m, n, k, path (0 wgmma, 1 mma.sync), mode (0 the split, 1
    # the split with each K step summed apart, 2 one pass)
    "vit_tf32_split_probe": (_P, _P, _P, *(_I,) * 5),
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
    its path. Every source compiles in its own ``nvcc`` process, all at
    once; the compiler's output (``-Xptxas=-v``: registers, shared memory
    and spills of each kernel) and each source's compile seconds are kept
    beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            objs.append(str(obj))
            text = open(Path(tmp) / f"{src.stem}.txt", "w+")
            procs.append((src.name, text, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                 str(src)],
                stdout=text, stderr=subprocess.STDOUT)))
        # Each source's seconds from the common start to its exit.
        seconds = {}
        while len(seconds) < len(procs):
            for name, _, proc in procs:
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            time.sleep(0.05)
        log, failed = [], []
        for name, text, proc in procs:
            text.seek(0)
            body = text.read()
            text.close()
            log.append(f"== {name} ({seconds[name]:.1f} s)\n{body}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{body[-4000:]}")
        lib = Path(tmp) / out.name
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objs],
                capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n"
                              f"{link.stderr[-4000:]}")
        out.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(lib, out)
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
            # Not launches: x, w, n, k, dtype -> the tile K6 (matmul.cu),
            # K22 (dot_probe.cu) and K23's GEMMs (attn_core_probe.cu) run.
            for tile in ("vit_fused_linear_tile", "vit_dot_probe_tile",
                         "vit_attn_probe_gemm_tile"):
                getattr(lib, tile).argtypes = [_P, _P, _I, _I, _I]
                getattr(lib, tile).restype = _I
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
    rc = getattr(lib, name)(*conv, _LAUNCH_CODES[like.dtype], dev, stream)
    if rc != 0:
        msg = lib.vit_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def check_tensor(t: torch.Tensor, name: str, like: torch.Tensor,
                 shape: tuple[int, ...] | None = None, *,
                 contiguous: bool = True,
                 dtype: torch.dtype | None = None) -> None:
    """Raise unless ``t`` is a tensor on ``like``'s CUDA device with
    ``like``'s dtype (float32 or bfloat16) or, if given, ``dtype``,
    ``shape`` if given, and, unless ``contiguous`` is False, contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if dtype is not None:
        if t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    elif t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    elif t.dtype != like.dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {like.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
