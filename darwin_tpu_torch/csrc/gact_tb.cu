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
// Bound: latency.  A walk is one chain of dependent loads — where the next
// word lies depends on the word before — and moves a byte per step, so
// neither bytes nor operations hold it; the round trips do.
//
// Design.  One warp per tile; a round trip to device memory per patch of
// the trace, and a round of shared-memory loads per run, not per step.
//  * The walk only moves up and left, so the PH x PW words up and left of
//    the current cell hold its next 32 steps at least.  The warp stages that
//    patch in shared memory (lane k loads the PW bytes of row j - k, as
//    three 16-byte loads where QT allows) and stages the next one when the
//    walk leaves it.
//  * The state says where the walk goes next whatever the words hold: up
//    the diagonal in DIAG, up the column in DEL / DEL_L, left along the row
//    in INS / INS_L.  So the 32 lanes read the next 32 words along that line
//    at once, a ballot finds the first word that ends the run (a T field
//    that is not DIAG; a set open bit of the state's gap lane; the patch's
//    or the tile's edge), and the whole run is emitted in one step: lane k
//    writes the record of the run's k-th column.  The word that ends a DIAG
//    run is already in a register, so the gap it starts takes its first op
//    at once, and a gap of one op (most are) costs no round.
//  * The run is clipped to what max_tb and the tile's edge leave.  The warp
//    walks serially from run to run, so it handles any number of insert
//    runs in a column and never spills: it computes what the TPU's fast
//    sweep (K2) and its while-loop recovery kernel (K3) compute together.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gact.h"

namespace {

constexpr int T8_DEL = 1, T8_INS = 2, T8_DEL_L = 3, T8_INS_L = 4,
              T8_DIAG = 5;
constexpr int E_OPEN8 = 8, F_OPEN8 = 16, EL_OPEN8 = 32, FL_OPEN8 = 64;
constexpr int OP_D = 2, OP_M = 3;
constexpr unsigned FULL = 0xffffffffu;

constexpr int PH = 32;          // ref columns of a staged patch
constexpr int PW = 48;          // query rows of it: 32 and the slack that
                                // starts it on a multiple of 16

__global__ void __launch_bounds__(32)
gact_tb_kernel(const uint8_t* __restrict__ trace,
               const int32_t* __restrict__ start_q,
               const int32_t* __restrict__ start_r, int B, int QT, int RT,
               int max_tb, int32_t* __restrict__ rec,
               int32_t* __restrict__ q_steps, int32_t* __restrict__ r_steps) {
  __shared__ __align__(16) uint8_t patch[PH * PW];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* tr = trace + (size_t)b * RT * QT;
  const bool aligned = ((uintptr_t)trace | (unsigned)QT) % 16 == 0;
  // the walk's state, the same in every lane
  int i = start_q[b];
  int j = start_r[b];
  int qs = 0, rs = 0, n_ins = 0, st = T8_DIAG;
  // the patch holds query rows [pi, pi + PW) of ref columns (pj - PH, pj]
  int pi = 0, pj = 0;
  bool staged = false;
  if (j >= 0 && j < RT) {
    while (qs != max_tb && rs != max_tb && i >= 0 && j >= 0) {
      if (!staged || i < pi || j <= pj - PH) {
        __syncwarp();
        staged = true;
        pj = j;
        pi = max(i - 31, 0) & ~15;
        const int row = pj - lane;
        if (row >= 0) {
          const uint8_t* src = tr + (size_t)row * QT + pi;
          uint8_t* dst = patch + lane * PW;
          if (aligned) {
#pragma unroll
            for (int k = 0; k < PW; k += 16)
              if (pi + k < QT)
                *reinterpret_cast<uint4*>(dst + k) =
                    *reinterpret_cast<const uint4*>(src + k);
          } else {
            for (int k = 0; k < PW; ++k)
              if (pi + k < QT) dst[k] = src[k];
          }
        }
        __syncwarp();
      }
      // this lane's cell on the line of travel; a column right of the tile
      // reads as word 0, a cell above or left of the tile ends every run,
      // a cell beyond the patch ends the round
      const int di = st == T8_DEL || st == T8_DEL_L ? 0 : lane;
      const int dj = st == T8_INS || st == T8_INS_L ? 0 : lane;
      const int ci = i - di, cj = j - dj;
      const bool inside = ci >= 0 && cj >= 0;
      const bool known = ci >= pi && cj > pj - PH;
      const int w = inside && known && ci < QT
                        ? (int)patch[(pj - cj) * PW + (ci - pi)]
                        : 0;
      if (st == T8_DIAG) {
        const unsigned ends = __ballot_sync(
            FULL, !inside || !known || (w & 7) != T8_DIAG);
        const int run = ends ? __ffs(ends) - 1 : 32;
        const int m = min(run, min(max_tb - qs, max_tb - rs));
        if (lane < m)
          rec[(size_t)cj * B + b] = (lane == 0 ? n_ins : 0) | (OP_M << 14);
        if (m > 0) n_ins = 0;
        qs += m;
        rs += m;
        i -= m;
        j -= m;
        if (m < run || run == 32) continue;  // clipped, or the run goes on
        // the word that ended the run is the walk's next cell
        if (!__shfl_sync(FULL, (int)inside, run)) break;   // i < 0 or j < 0
        if (!__shfl_sync(FULL, (int)known, run)) continue;  // the next patch
        const int wt = __shfl_sync(FULL, w, run);
        const int t = wt & 7;
        if (t < T8_DEL || t > T8_INS_L) break;   // ZERO: the alignment starts
        if (qs == max_tb || rs == max_tb) break;
        // a gap run starts at this cell; its first op needs no load, and
        // most gaps open where they close, so most gap runs end here
        if (t == T8_DEL || t == T8_DEL_L) {
          if (lane == 0) rec[(size_t)j * B + b] = n_ins | (OP_D << 14);
          n_ins = 0;
          ++rs;
          --j;
          st = wt & (t == T8_DEL ? E_OPEN8 : EL_OPEN8) ? T8_DIAG : t;
        } else {
          ++n_ins;
          ++qs;
          --i;
          st = wt & (t == T8_INS ? F_OPEN8 : FL_OPEN8) ? T8_DIAG : t;
        }
      } else {
        // a gap run takes the cell whose open bit ends it; the tile's or
        // the patch's edge ends it before the cell
        const bool del = st == T8_DEL || st == T8_DEL_L;
        const int bit = st == T8_DEL ? E_OPEN8
                        : st == T8_DEL_L ? EL_OPEN8
                        : st == T8_INS ? F_OPEN8 : FL_OPEN8;
        const bool usable = inside && known;
        const unsigned ends = __ballot_sync(FULL, !usable || (w & bit));
        const int first = ends ? __ffs(ends) - 1 : 32;
        const bool opened =
            first < 32 && __shfl_sync(FULL, (int)usable, first & 31);
        const int run = opened ? first + 1 : first;
        const int m = min(run, max_tb - (del ? rs : qs));
        if (del) {
          if (lane < m)
            rec[(size_t)cj * B + b] = (lane == 0 ? n_ins : 0) | (OP_D << 14);
          n_ins = 0;
          rs += m;
          j -= m;
        } else {
          n_ins += m;
          qs += m;
          i -= m;
        }
        if (opened && m == run) st = T8_DIAG;
      }
    }
    if (lane == 0 && j >= 0 && n_ins > 0) rec[(size_t)j * B + b] = n_ins;
  }
  if (lane == 0) {
    q_steps[b] = qs;
    r_steps[b] = rs;
  }
}

}  // namespace

extern "C" int gact_tb(const uint8_t* trace, const int32_t* start_q,
                       const int32_t* start_r, int B, int QT, int RT,
                       int max_tb, int32_t* rec, int32_t* q_steps,
                       int32_t* r_steps, void* stream) {
  if (B < 1 || QT < 1 || RT < 1) return (int)cudaErrorInvalidValue;
  gact_tb_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      trace, start_q, start_r, B, QT, RT, max_tb, rec, q_steps, r_steps);
  return (int)cudaGetLastError();
}
