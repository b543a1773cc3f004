"""Where K3's fp32 tile (``csrc/mlp_tf32.cuh``) and K17's fp32 form on it
(its Q flag) spend their time on the card, by ablation.

Each variant is a copy of ``mlp_tf32.cuh``, ``mlp_block_tf32.cu`` and
``mlp_block_q_tf32.cu`` under ``build/mlp_tf32_ablate/<name>/`` with one
part of the tile's work taken out, or one of its choices changed, by a
textual substitution (``VARIANTS``), built by ``nvcc`` alone with a small
harness (the fp32 and int8 tensor maps and a C entry point for each
kernel) into a library of its own, which a process of its own loads
(every such library links its own CUDA runtime). Outputs of the ``no_*``
variants are wrong by design: the time a variant
saves against ``base`` is what the part costs on the tile's path. The
variants:

- ``no_mma``: no wgmma is issued (loads, splits, LN(x), h, barriers and
  the rings stay; a named barrier of the warpgroup stands in for the
  step's wgmma, which keeps its four warps together so that a stage is
  released only once all of them have loaded from it);
- ``no_fc1_mma`` / ``no_fc2_mma``: fc1's or fc2's steps issue no wgmma
  (the same barrier in their place);
- ``threads352``: 352 threads a block (two normalising warps, no
  setmaxnreg), so that ptxas may give a thread 184 registers in place of
  168;
- ``q_no_mma``: K17's steps run no wgmma (``mma_q``'s call in
  ``step_qp``; the same barrier in its place);
- ``q_box``: K17's codes converted by the helper warps into an fp32 box
  beside each stage (``convert_stage``, which this tool adds), which the
  consumers read as K3's ``load_w`` reads its stage, unsplit (``load_wf``:
  8-byte loads, two wavefronts), one step after another, where ``base``
  converts them in the consumers' registers straight from the int8 box
  (``load_wq``: one 2-byte load a K row, one wavefront);
- ``q_nopipe``: K17's consumers load and convert each step's A fragments
  after the previous step's ``wgmma`` are waited for, where ``base``
  (``run_acc_qp``) loads them into a second buffer while they run;
- ``q_no_cvt``: K17's codes passed to ``wgmma`` as their loads give them,
  not converted (the bits of two codes; the values are wrong);
- ``q_no_ln``: K17's helper warps leave x's boxes as TMA wrote them (no
  LN, no split; the values are wrong);
- ``q_ring16``: sixteen weight stages where the shared memory holds
  them (K17's 4 KB stages; 512 bytes of barriers), in place of eight.

Times: K3 fp32 at B/16 bs=32 (6656 x 768, mlp 3072), L/16-384 bs=8 (4736
x 1024, 4096) and H/14 bs=2 (544 x 1280, 5120), and K17 fp32 at the same
three and B/16 bs=32's shard over model=2 (6656 x 768, mlp 1536, the
partial form): the mean of 20 calls queued back to back between two CUDA
events, variants in turns (``base`` first and last), with each output's
max|diff| against ``reference.mlp_block`` or ``reference.mlp_block_q``.
Each build's ``HGMMA`` count of K3's and K17's kernels (``cuobjdump``,
``tools/sass_count.py``) is printed too, and a ``*no_mma`` variant whose
target kernel still holds one is refused: its edit missed the path that
``base`` runs. Prints a line a run and a JSON line with the card::

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
#: The launch units each variant builds beside its harness.
UNITS = ("mlp_block_tf32.cu", "mlp_block_q_tf32.cu")


def q_loop(load: str) -> str:
    """K17's run_acc as one loop, each step's A fragments loaded by
    ``load`` (into ``aq``), its products started and waited for in turn: the
    unpipelined walk (``q_nopipe``, ``q_box``)."""
    return """
    const int t = threadIdx.x % 128;
    uint32_t aq[4][4];
    for (int st = 0; st < steps; ++st) {
      LOAD
      uint32_t bhi;
      if (FC1) {
        mbar_wait(sm.xfull(xr.s), xr.ph);
        bhi = sm.xstage(xr.s) + Cfg<BM>::kXBox;
      } else {
        bhi = hb + st * Cfg<BM>::kXBox;
      }
      const uint32_t blo = bhi + (FC1 ? 1 : 4) * Cfg<BM>::kXBox;
      mma_q<BM>(acc, aq, bhi, blo, fresh && st == 0);
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(sm.wempty(w.s));
      w.next();
      if (FC1) {
        if (t == 0) mbar_arrive(sm.xempty(xr.s));
        xr.next();
      }
    }""".replace("LOAD", load)


#: ``q_box``'s device functions. load_wf: load_w's fragments of the fp32
#: box at box0 (four 32 x 32 boxes, as K3's stage), each value exact and
#: passed unsplit. convert_stage: a helper thread's share (j of
#: kHelpThreads) of turning the int8 stage at raw (32 rows x 128 codes,
#: TMA's 128-byte swizzle) into the fp32 box after it; unit u is row u / 8,
#: raw chunk c = u % 8 (columns 16 c .. + 15): one 16-byte load, four
#: 16-byte stores into box c / 2, lane c of a quarter-warp phase storing its
#: four chunks rotated by c / 2, so that the eight lanes hit eight distinct
#: chunks of the row, as their loads do.
Q_BOX_CONVERT = r"""
__device__ __forceinline__ void load_wf(uint32_t box0, int wgi,
                                        uint32_t (&a)[4][4]) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int col = 64 * wgi + 16 * warp + 2 * g;
  const uint32_t box = box0 + (col >> 5) * kSub;
  const int c = col & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2 v0 = ld_shared_v2(box + sw128_f32(8 * s + perm8(q), c));
    const float2 v1 = ld_shared_v2(box + sw128_f32(8 * s + perm8(q + 4), c));
    a[s][0] = __float_as_uint(v0.x);
    a[s][1] = __float_as_uint(v0.y);
    a[s][2] = __float_as_uint(v1.x);
    a[s][3] = __float_as_uint(v1.y);
  }
}

__device__ __forceinline__ void convert_stage(uint32_t raw, int j) {
  const uint32_t fp = raw + kWStageQ;
  for (int u = j; u < 256; u += kHelpThreads) {
    const int k = u >> 3, c = u & 7;
    uint32_t r[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(raw + k * 128 + ((c ^ (k & 7)) << 4)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ii = (i + (c >> 1)) & 3;
      uint32_t w = r[0];
      if (ii == 1) w = r[1];
      if (ii == 2) w = r[2];
      if (ii == 3) w = r[3];
      uint32_t f0, f1, f2, f3;
      codes_f32(w, f0, f1);
      codes_f32(w >> 16, f2, f3);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                       fp + (c >> 1) * kSub +
                       sw128_f32(k, (c & 1) * 16 + 4 * ii)),
                   "r"(f0), "r"(f1), "r"(f2), "r"(f3)
                   : "memory");
    }
  }
}

"""

#: ``q_box``'s helper warps: LN(x) of each x box, split, and each int8
#: weight stage converted, in the consumers' order (K3's loop below it
#: becomes the else branch).
Q_BOX_HELPERS = r"""
        if constexpr (Q) {
          Ring<Cfg<BM, Q>::kSW> w;
          auto convert_next = [&]() {
            mbar_wait(sm.wfull(w.s), w.ph);
            convert_stage(sm.wstage(w.s), j);
            __syncwarp();
            if (j % 32 == 0) mbar_arrive(sm.wconv(w.s));
            w.next();
          };
          for (int c = 0; c < nc; ++c) {
            for (int kb = 0; kb < nkd; ++kb) {
              mbar_wait(sm.xraw(xr.s), xr.ph);
              normalize_box<BM>(sm.xstage(xr.s), gs, bs, mean, rstd,
                                kBK * kb, a.d, j);
              asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
              __syncwarp();
              if (j % 32 == 0) mbar_arrive(sm.xfull(xr.s));
              xr.next();
              convert_next();
            }
            for (int qg = 0; qg < ng; ++qg)
              for (int st = 0; st < kCT / kBK; ++st) convert_next();
          }
        } else"""

#: name -> [(file, pattern, replacement)], re.MULTILINE; a replacement is a
#: string or a function of the match.
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
         "false"),
        ("mlp_block_q_tf32.cu",
         r"attr\.numRegs \* mt::kThreads < mt::kPoolRegs", "false")],
    "q_no_mma": [("mlp_tf32.cuh", r"^(\s*)mma_q<BM>\(",
                  r"\1wg::named_sync(2 + wgi); if (0) mma_q<BM>(")],
    "q_box": [
        ("mlp_tf32.cuh", r"Q \? kWStageQ : kWStage;",
         "Q ? kWStageQ + kWStage : kWStage;"),
        ("mlp_tf32.cuh", r"kBarBytes = 256;", "kBarBytes = 512;"),
        ("mlp_tf32.cuh",
         r"^(\s*__device__ __forceinline__ uint32_t ydone\(\) const.*)$",
         r"\1\n  __device__ __forceinline__ uint32_t wconv(int s) const "
         r"{ return xraw(3 * kSX + 1 + s); }"),
        ("mlp_tf32.cuh", r"^(// K17's K step started:)",
         lambda m: Q_BOX_CONVERT + m.group(1)),
        ("mlp_tf32.cuh",
         r"^\s*run_acc_qp<BM, FC1>\(sm, wgi, w, xr, steps, hb, acc, fresh\);",
         lambda m: q_loop("mbar_wait(sm.wconv(w.s), w.ph);\n"
                          "      load_wf(sm.wstage(w.s) + kWStageQ, wgi, aq);")),
        ("mlp_tf32.cuh", r"^(\s*if \(LAYER\) mbar_init\(sm\.ydone\(\), 256 / 32\);)",
         r"\1\n    if (Q) for (int s = 0; s < Cfg<BM, Q>::kSW; ++s) "
         r"mbar_init(sm.wconv(s), kHelpThreads / 32);"),
        ("mlp_tf32.cuh", r"^(\s*// ---- LN\(x\) of each x box, split ----)",
         lambda m: Q_BOX_HELPERS + m.group(1))],
    "q_nopipe": [
        ("mlp_tf32.cuh",
         r"^\s*run_acc_qp<BM, FC1>\(sm, wgi, w, xr, steps, hb, acc, fresh\);",
         lambda m: q_loop("mbar_wait(sm.wfull(w.s), w.ph);\n"
                          "      load_wq(sm.wstage(w.s), wgi, aq);"))],
    "q_no_cvt": [("mlp_tf32.cuh", r"^(\s*)codes_f32\(v0, a\[s\]\[0\], a\[s\]\[1\]\);",
                  r"\1a[s][0] = v0; a[s][1] = v0 >> 8;"),
                 ("mlp_tf32.cuh", r"^(\s*)codes_f32\(v1, a\[s\]\[2\], a\[s\]\[3\]\);",
                  r"\1a[s][2] = v1; a[s][3] = v1 >> 8;")],
    "q_no_ln": [("mlp_tf32.cuh", r"^(\s*)normalize_box<BM>\(sm\.xstage\(xr\.s\), gs, bs, mean, rstd, kBK \* kb,\n\s*a\.d, j\);",
                 r"\1if (Q) {} else normalize_box<BM>(sm.xstage(xr.s), gs, bs, mean, rstd, kBK * kb, a.d, j);")],
    "q_ring16": [
        ("mlp_tf32.cuh", r"kSWraw < 8 \? kSWraw : 8", "kSWraw < 16 ? kSWraw : 16"),
        ("mlp_tf32.cuh", r"kBarBytes = 256;", "kBarBytes = 512;")],
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
bool tensor_map_i8(CUtensorMap* map, const void* p, int rows, int cols,
                   int ld, int box_cols, int box_rows) {
  static Encode fn = nullptr;
  if (!fn) {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult r{};
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q, cudaEnableDefault,
                            &r);
    fn = reinterpret_cast<Encode>(q);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                  const_cast<void*>(p), dims, strides, box, es,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
cudaError_t launch_mlp_tf32(const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, float*, int, int, int, float, int,
                            int, cudaStream_t);
cudaError_t launch_mlp_q_tf32(const float*, const float*, const float*,
                              const signed char*, const float*, const float*,
                              const signed char*, const float*, const float*,
                              float*, int, int, int, float, int, int,
                              cudaStream_t);
}  // namespace vit
extern "C" int k3_tf32(const float* x, const float* g, const float* b,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, float* out, int m, int d, int mlp,
                       void* st) {
  return vit::launch_mlp_tf32(x, g, b, w1, b1, w2, b2, out, m, d, mlp,
                              1e-12f, 0, 0, static_cast<cudaStream_t>(st));
}
extern "C" int k17_tf32(const float* x, const float* g, const float* b,
                        const signed char* w1, const float* s1,
                        const float* b1, const signed char* w2,
                        const float* s2, const float* b2, float* out, int m,
                        int d, int mlp, int partial, void* st) {
  return vit::launch_mlp_q_tf32(x, g, b, w1, s1, b1, w2, s2, b2, out, m, d,
                                mlp, 1e-12f, partial, 0,
                                static_cast<cudaStream_t>(st));
}
"""

WORKER = r"""
import ctypes, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from vit_tpu_torch.ops import reference
from vit_tpu_torch.quant import quantize_weight
torch.backends.cuda.matmul.allow_tf32 = False
lib = ctypes.CDLL(sys.argv[2])
k3, k17 = lib.k3_tf32, lib.k17_tf32
k3.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
k17.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
gen = torch.Generator(device="cuda").manual_seed(0)


def rnd(*shape, std=1.0, mean=0.0):
    return torch.randn(shape, generator=gen, device="cuda") * std + mean


def timed(call):
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
    return a.elapsed_time(b) / 20


res = {}
stream = torch.cuda.current_stream().cuda_stream
for tag, m, d, mlp, partial in (("b16", 6656, 768, 3072, 0),
                                ("b16_shard", 6656, 768, 1536, 1),
                                ("l16_384", 4736, 1024, 4096, 0),
                                ("h14", 544, 1280, 5120, 0)):
    x, g, b = (rnd(m, d, std=1.5, mean=0.2), rnd(d, std=0.1, mean=1.0),
               rnd(d, std=0.05))
    b1, b2 = rnd(mlp, std=0.02), rnd(d, std=0.02)
    out = torch.empty_like(x)
    if not partial:
        args = (x, g, b, rnd(d, mlp, std=0.03), b1, rnd(mlp, d, std=0.03),
                b2)

        def call():
            rc = k3(*(t.data_ptr() for t in (*args, out)), m, d, mlp, stream)
            if rc:
                raise SystemExit(f"k3_tf32 failed: CUDA error {rc}")
        res["k3_" + tag] = timed(call)
        want = reference.mlp_block(*args, eps=1e-12)
        res["k3_" + tag + "_err"] = float((out - want).abs().max())
    w1 = quantize_weight(rnd(d, mlp, std=0.03))
    w2 = quantize_weight(rnd(mlp, d, std=0.03))
    qargs = (x, g, b, w1["q"], w1["scale"], b1, w2["q"], w2["scale"], b2)

    def qcall():
        rc = k17(*(t.data_ptr() for t in (*qargs, out)), m, d, mlp, partial,
                 stream)
        if rc:
            raise SystemExit(f"k17_tf32 failed: CUDA error {rc}")
    res["k17_" + tag] = timed(qcall)
    want = reference.mlp_block_q(*qargs, eps=1e-12, partial_out=bool(partial))
    res["k17_" + tag + "_err"] = float((out - want).abs().max())
print(json.dumps(res))
"""


#: The kernel each variant that removes every wgmma edits, by its
#: demangled name: its build must hold no HGMMA there.
NO_MMA = {"no_mma": "vit::mt::mlp_tf32_kernel",
          "q_no_mma": "vit::mt::mlp_q_tf32_kernel"}


def hgmma_counts(lib: str) -> dict[str, int]:
    """The ``HGMMA`` instructions (static) of every copy of K3's and K17's
    fp32 tile kernels in ``lib``, summed over their forms (``base`` is
    refused where a count is 0: the names were not found)."""
    from vit_tpu_torch.tools import sass_count
    out = dict.fromkeys(NO_MMA.values(), 0)
    for name, cs in sass_count.by_name(lib).items():
        for prefix in out:
            if prefix + "<" in name:
                out[prefix] += sum(sass_count.counts(c)["HGMMA"] for c in cs)
    return out


def make_variant(name: str) -> Path:
    """The variant's sources under ``OUT``, edited by ``VARIANTS[name]``;
    raises if a substitution matches nothing (the sources moved on)."""
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for src in CSRC.glob("*.cuh"):
        shutil.copy(src, root)
    for unit in UNITS:
        shutil.copy(CSRC / unit, root)
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
             *(str(root / u) for u in UNITS), "-lcuda"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    hgmma = {}
    for n, p in builds.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"variant {n}: the build failed\n{log[-3000:]}")
        serial = sum("C7512" in line for line in log.splitlines())
        hgmma[n] = hgmma_counts(str(libs[n]))
        print(f"{n:12s} built; ptxas serialises wgmma in {serial} kernels; "
              f"HGMMA {hgmma[n]}", flush=True)
        if n == "base" and not all(hgmma[n].values()):
            raise SystemExit(f"base: the tile kernels not found: {hgmma[n]}")
        if n in NO_MMA and hgmma[n][NO_MMA[n]]:
            raise SystemExit(f"variant {n}: {NO_MMA[n]} still runs wgmma")
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
    print(json.dumps({"ablation": runs, "hgmma": hgmma,
                      "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
