"""Where K3's fp32 tile (``csrc/mlp_tf32.cuh``) spends its time on the card,
by ablation.

Each variant is a copy of ``mlp_tf32.cuh`` and ``mlp_block_tf32.cu``
under ``build/mlp_tf32_ablate/<name>/`` with one part of the tile's work
taken out, or one of its choices changed, by a textual substitution
(``VARIANTS``), built by ``nvcc`` alone with a small harness (the fp32
tensor maps and a C entry point) into a library of its own, which a
process of its own loads (every such library links its own CUDA
runtime). Outputs of the ``no_*`` variants are wrong by design: the time
a variant saves against ``base`` is what the part costs on the tile's
path. The variants:

- ``no_mma``: no wgmma is issued (loads, splits, LN(x), h, barriers and
  the rings stay; a named barrier of the warpgroup stands in for the
  step's wgmma, which keeps its four warps together so that a stage is
  released only once all of them have loaded from it);
- ``no_fc1_mma`` / ``no_fc2_mma``: fc1's or fc2's steps issue no wgmma
  (the same barrier in their place);
- ``threads352``: 352 threads a block (two normalising warps, no
  setmaxnreg), so that ptxas may give a thread 184 registers in place of
  168.

Times: K3 fp32 at B/16 bs=32 (6656 x 768, mlp 3072), L/16-384 bs=8 (4736
x 1024, 4096) and H/14 bs=2 (544 x 1280, 5120): the mean of 20 calls
queued back to back between two CUDA events, variants in turns (``base``
first and last), with each output's max|diff| against
``reference.mlp_block``. Prints a line a run and a JSON line with the
card::

    python -m vit_tpu_torch.tools.mlp_tf32_ablate [--variants base no_mma]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CSRC = HERE / "vit_tpu_torch" / "csrc"
OUT = HERE / "build" / "mlp_tf32_ablate"

#: name -> [(file, pattern, replacement)], re.MULTILINE.
VARIANTS = {
    "base": [],
    "no_mma": [("mlp_tf32.cuh", r"^(\s*)step<BM>\(",
                r"\1wg::named_sync(2 + wgi); if (0) step<BM>(")],
    "no_fc1_mma": [("mlp_tf32.cuh", r"^(\s*)step<BM>\(",
                    r"\1if (FC1) wg::named_sync(2 + wgi); else step<BM>(")],
    "no_fc2_mma": [("mlp_tf32.cuh", r"^(\s*)step<BM>\(",
                    r"\1if (!FC1) wg::named_sync(2 + wgi); else step<BM>(")],
    "threads352": [
        ("mlp_tf32.cuh", r"kThreads = 384;", "kThreads = 352;"),
        ("mlp_tf32.cuh", r"kHelpThreads = 96;", "kHelpThreads = 64;"),
        ("mlp_tf32.cuh", r"^\s*asm volatile\(\"setmaxnreg\.\w+\.sync\.aligned"
         r"\.u32 %0;\" ::\"n\"\(k\w+Regs\)\);", ""),
        ("mlp_block_tf32.cu", r"attr\.numRegs \* mt::kThreads < mt::kPoolRegs",
         "false")],
}

# The tensor maps (matmul_tf32.cu's, without the rest of the library) and
# a C entry point around launch_mlp_tf32.
HARNESS = r"""
#include <cuda.h>
#include <cuda_runtime.h>
namespace vit {
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
    void*, const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows, int cols,
                    int ld, int box_rows) {
  static Encode fn = nullptr;
  if (!fn) {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult r{};
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q, cudaEnableDefault,
                            &r);
    fn = reinterpret_cast<Encode>(q);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32u, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                  const_cast<void*>(p), dims, strides, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
cudaError_t launch_mlp_tf32(const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, float*, int, int, int, float, int,
                            int, cudaStream_t);
}  // namespace vit
extern "C" int k3_tf32(const float* x, const float* g, const float* b,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, float* out, int m, int d, int mlp,
                       void* st) {
  return vit::launch_mlp_tf32(x, g, b, w1, b1, w2, b2, out, m, d, mlp,
                              1e-12f, 0, 0, static_cast<cudaStream_t>(st));
}
"""

WORKER = r"""
import ctypes, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from vit_tpu_torch.ops import reference
fn = ctypes.CDLL(sys.argv[2]).k3_tf32
fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
gen = torch.Generator(device="cuda").manual_seed(0)


def rnd(*shape, std=1.0, mean=0.0):
    return torch.randn(shape, generator=gen, device="cuda") * std + mean


res = {}
for tag, m, d, mlp in (("b16", 6656, 768, 3072),
                       ("l16_384", 4736, 1024, 4096),
                       ("h14", 544, 1280, 5120)):
    args = (rnd(m, d, std=1.5, mean=0.2), rnd(d, std=0.1, mean=1.0),
            rnd(d, std=0.05), rnd(d, mlp, std=0.03), rnd(mlp, std=0.02),
            rnd(mlp, d, std=0.03), rnd(d, std=0.02))
    out = torch.empty_like(args[0])
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*(t.data_ptr() for t in (*args, out)), m, d, mlp, stream)
        if rc:
            raise SystemExit(f"k3_tf32 failed: CUDA error {rc}")
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        call()
    b.record()
    b.synchronize()
    res[tag] = a.elapsed_time(b) / 20
    want = reference.mlp_block(*args, eps=1e-12)
    res[tag + "_err"] = float((out - want).abs().max())
print(json.dumps(res))
"""


def make_variant(name: str) -> Path:
    """The variant's sources under ``OUT``, edited by ``VARIANTS[name]``;
    raises if a substitution matches nothing (the sources moved on)."""
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for src in CSRC.glob("*.cuh"):
        shutil.copy(src, root)
    shutil.copy(CSRC / "mlp_block_tf32.cu", root)
    (root / "harness.cu").write_text(HARNESS)
    for file, pattern, repl in VARIANTS[name]:
        path = root / file
        text, n = re.subn(pattern, repl, path.read_text(), flags=re.M)
        if not n:
            raise SystemExit(f"variant {name}: {pattern!r} matched nothing")
        path.write_text(text)
    return root


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    from vit_tpu_torch.ops.cuda import _build
    from vit_tpu_torch.tools import card_line
    names = ["base"] + [v for v in args.variants if v != "base"]
    libs = {}
    builds = {}
    for n in names:
        root = make_variant(n)
        libs[n] = root / "libk3.so"
        builds[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(root),
             "-o", str(libs[n]), str(root / "harness.cu"),
             str(root / "mlp_block_tf32.cu"), "-lcuda"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for n, p in builds.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"variant {n}: the build failed\n{log[-3000:]}")
        serial = sum("C7512" in line for line in log.splitlines())
        print(f"{n:12s} built; ptxas serialises wgmma in {serial} kernels",
              flush=True)
    runs = []
    for n in names + ["base"]:
        res = subprocess.run(
            [sys.executable, "-c", WORKER, str(HERE), str(libs[n])],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"variant {n}: {res.stderr[-3000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"variant": n, **got})
        print(f"{n:12s} " + "  ".join(
            f"{k} {v:.4g}" for k, v in got.items()), flush=True)
    print(json.dumps({"ablation": runs, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
