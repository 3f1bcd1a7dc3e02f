// gact_tb: batched GACT traceback walk for Hopper (sm_90a).
//
// Replaces darwin_tpu/ops/gact_pallas.py:_tb_kernel (K2, lines 620-753)
// and _tb_kernel_safe (K3, lines 756-841).  Plain PyTorch twin:
// darwin_tpu_torch/ops/gact.py:traceback.
//
// What it computes: the reference's traceback state machine
// (DIAG/DEL/INS/DEL_L/INS_L; an open bit returns to DIAG) from
// (start_q, start_r), stopping on a ZERO T field, on i < 0, or when q or r
// steps reach max_tb (checked before every op).  Per visited column it
// writes the record nI | closing << 14 (nI I-ops, then the closing M or D
// op, or 0 if the walk ended there) into a zeroed (RT, B) buffer, plus the
// per-tile q and r step counts — _tb_kernel_safe's output exactly.
//
// Design.  One thread per tile walks its trace serially in global memory.
// A serial walker handles any number of insert runs in a column, so it
// never spills: it computes what the TPU's fast sweep (K2) and its
// while-loop recovery kernel (K3) compute together, and the port needs no
// spill flag and no rerun.
//
// Bound: latency of dependent byte loads — each step's address depends on
// the previous step's word, ~2*tile steps per tile.  Enough tiles per
// launch keep many walks in flight; the later levers are staging the
// walked band in shared memory and a warp per tile for the M-runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gact.h"

namespace {

constexpr int T8_DEL = 1, T8_INS = 2, T8_DEL_L = 3, T8_INS_L = 4,
              T8_DIAG = 5;
constexpr int E_OPEN8 = 8, F_OPEN8 = 16, EL_OPEN8 = 32, FL_OPEN8 = 64;
constexpr int OP_D = 2, OP_M = 3;

__global__ void gact_tb_kernel(const uint8_t* __restrict__ trace,
                               const int32_t* __restrict__ start_q,
                               const int32_t* __restrict__ start_r, int B,
                               int QT, int RT, int max_tb,
                               int32_t* __restrict__ rec,
                               int32_t* __restrict__ q_steps,
                               int32_t* __restrict__ r_steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* tr = trace + (size_t)b * RT * QT;
  int i = start_q[b];
  int j = start_r[b];
  int qs = 0, rs = 0, n_ins = 0, st = T8_DIAG;
  if (j >= 0 && j < RT) {
    while (qs != max_tb && rs != max_tb && i >= 0) {
      const int w = i < QT ? (int)tr[(size_t)j * QT + i] : 0;
      const int eff = st == T8_DIAG ? (w & 7) : st;
      if (eff == T8_DIAG) {
        rec[(size_t)j * B + b] = n_ins | (OP_M << 14);
        n_ins = 0;
        ++qs;
        ++rs;
        --i;
        --j;
        st = T8_DIAG;
      } else if (eff == T8_DEL || eff == T8_DEL_L) {
        const int open = w & (eff == T8_DEL ? E_OPEN8 : EL_OPEN8);
        rec[(size_t)j * B + b] = n_ins | (OP_D << 14);
        n_ins = 0;
        ++rs;
        --j;
        st = open ? T8_DIAG : eff;
      } else if (eff == T8_INS || eff == T8_INS_L) {
        const int open = w & (eff == T8_INS ? F_OPEN8 : FL_OPEN8);
        ++n_ins;
        ++qs;
        --i;
        st = open ? T8_DIAG : eff;
      } else {
        break;                   // ZERO: the local alignment starts here
      }
      if (j < 0) break;
    }
    if (j >= 0 && n_ins > 0) rec[(size_t)j * B + b] = n_ins;
  }
  q_steps[b] = qs;
  r_steps[b] = rs;
}

}  // namespace

extern "C" int gact_tb(const uint8_t* trace, const int32_t* start_q,
                       const int32_t* start_r, int B, int QT, int RT,
                       int max_tb, int32_t* rec, int32_t* q_steps,
                       int32_t* r_steps, void* stream) {
  if (B < 1 || QT < 1 || RT < 1) return (int)cudaErrorInvalidValue;
  const int nt = 128;
  gact_tb_kernel<<<(B + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      trace, start_q, start_r, B, QT, RT, max_tb, rec, q_steps, r_steps);
  return (int)cudaGetLastError();
}
