"""Minimal matmul on the card: the teaching companion of the port's kernels
(counterpart of ``examples/minimal_pallas_matmul.py``).

It shows the bare essentials of a kernel of this package, with none of the
production machinery of K2 (``csrc/matmul.cu``: no tensor cores, no
epilogues, no ragged edges):

- the kernel, K21 (``vit_tpu_torch/csrc/minimal_matmul.cu``), is CUDA C++
  behind a plain ``extern "C"`` function; ``nvcc`` compiles it with every
  other source into the package's one shared library at first use
  (``vit_tpu_torch/ops/cuda/_build.py``), which ``ctypes`` loads;
- ``ctypes`` passes what it is told: ``_build._SIGNATURES`` declares each
  pointer ``c_void_p`` and each size ``c_int`` (an undeclared pointer would
  be cut to 32 bits), and :func:`~vit_tpu_torch.ops.cuda._build.launch`
  passes ``tensor.data_ptr()`` for each tensor, then the dtype code, the
  device and PyTorch's current stream, and raises if the launch reports an
  error;
- the wrapper checks what the kernel cannot (device, dtype, shapes -- every
  dimension a multiple of 128, the Pallas example's assert -- and
  contiguity) and allocates the output with ``torch.empty``; the kernel
  allocates nothing and does not synchronise;
- a plain PyTorch version of the same function sits beside it, for CPU
  tensors and to check the kernel against.

Run on the card (``--device cpu`` runs the plain version)::

    python -m vit_tpu_torch.examples.minimal_matmul
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vit_tpu_torch.ops.cuda import _build, count_launch
from vit_tpu_torch.ops.dispatch import resolve_impl

#: Every dimension must be a multiple of this, as in the Pallas example
#: (one MXU tile there; the CUDA kernel's own tile is 32).
TILE = 128


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed in fp32, cast once to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           impl: str | None = None) -> torch.Tensor:
    """``(M, K) @ (K, N)`` with every dimension a multiple of :data:`TILE`:
    K21 on CUDA tensors (counted as ``minimal_matmul``), the plain version
    on CPU tensors."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    (m, k), n = x.shape, w.shape[1]
    if m % TILE or k % TILE or n % TILE:
        raise ValueError(f"every dimension must be a multiple of {TILE}: "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if resolve_impl(impl, x) == "torch":
        return matmul_plain(x, w)
    _build.check_tensor(x, "x", x)
    _build.check_tensor(w, "w", x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.launch("vit_minimal_matmul", x, w, out, m, n, k, like=x)
    count_launch("minimal_matmul")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, the default) or cpu (the plain "
                         "version)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain version")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((256, 384)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((384, 512)) * 0.1).astype(np.float32)
    got = matmul(torch.from_numpy(x).to(args.device),
                 torch.from_numpy(w).to(args.device)).cpu().numpy()
    diff = float(np.abs(got - x @ w).max())
    ok = diff < 1e-3
    print(f"minimal matmul on {args.device}: max|diff| = {diff:.2e} -> "
          f"{'PASSED' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
