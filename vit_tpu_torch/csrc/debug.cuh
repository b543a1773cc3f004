// In-kernel debugging: printf gated on the block's index (counterpart of
// vit_tpu/ops/pallas/debug.py:pid_conds and print_if, which gate
// pl.debug_print on pl.program_id).
//
// A condition string such as "=0,>1" ("grid axis 0 == 0 and axis 1 > 1",
// an empty entry always true) is parsed on the host
// (vit_tpu_torch/ops/debug.py:pid_conds) into one (op, rhs) pair an axis,
// for blockIdx.x, .y and .z, and passed to the kernel by value:
//
//   __global__ void k(..., vit::PidConds conds) {
//     vit::print_if(conds, "block (%d, %d) acc = %f\n", blockIdx.x,
//                   blockIdx.y, acc);
//   }
//
// Device printf lands in a buffer that the runtime flushes to the process's
// standard output at the next synchronisation (cudaDeviceSynchronize and
// the like), not when the kernel returns.

#pragma once

#include <cstdio>

namespace vit {

// The comparison codes of vit_tpu_torch/ops/debug.py:OPS.
enum PidOp : int {
  kPidAlways = 0,
  kPidEq = 1,
  kPidNe = 2,
  kPidLt = 3,
  kPidLe = 4,
  kPidGt = 5,
  kPidGe = 6,
};

struct PidConds {
  int op[3];
  int rhs[3];
};

__device__ __forceinline__ bool pid_holds(int op, int v, int rhs) {
  switch (op) {
    case kPidEq: return v == rhs;
    case kPidNe: return v != rhs;
    case kPidLt: return v < rhs;
    case kPidLe: return v <= rhs;
    case kPidGt: return v > rhs;
    case kPidGe: return v >= rhs;
    default: return true;
  }
}

// Whether this block's index satisfies every axis's condition.
__device__ __forceinline__ bool pid_conds(const PidConds& c) {
  return pid_holds(c.op[0], blockIdx.x, c.rhs[0]) &&
         pid_holds(c.op[1], blockIdx.y, c.rhs[1]) &&
         pid_holds(c.op[2], blockIdx.z, c.rhs[2]);
}

// printf(fmt, args...) from the calling thread where pid_conds(c) holds;
// call it from one thread of the block for one line a block.
template <typename... Args>
__device__ __forceinline__ void print_if(const PidConds& c, const char* fmt,
                                         Args... args) {
  if (pid_conds(c)) printf(fmt, args...);
}

}  // namespace vit
