// gact_dp: batched GACT tile DP for Hopper (sm_90a).
//
// Replaces darwin_tpu/ops/gact_pallas.py:_dp_kernel (K1, lines 103-312)
// and _dp_strip_kernel (K4, lines 343-488), their generic-scoring branches
// included (lines 196-223 and 417-430).  Plain PyTorch twin:
// darwin_tpu_torch/ops/gact.py:batch_align (same results, byte for byte).
//
// What it computes: two-piece affine local Smith-Waterman over a batch of
// tiles (H, E, E_L, F, F_L), in max-cell mode (earliest column with a
// strict improvement, then the smallest q) or start-to-end mode (H at
// (qlen-1, rlen-1)), optionally writing the 8-bit trace word per cell in
// the (B, RT, QT) layout.  The within-column gap lanes are the coupled
// recurrence itself, exact for any scoring:
//     F(q)   = max(H(q-1) + go,  F(q-1)   + ge)
//     F_L(q) = max(H(q-1) + goL, F_L(q-1) + geL)
// with H(-1) = 0 and F(-1) = F_L(-1) = -inf.  The TPU kernel needs closed
// forms (prefix-max scans, and for scorings whose gap open is cheaper than
// their gap extend a cross-lane term besides) because its query axis is a
// vector; here a thread walks its rows in order, so F and F_L are carried
// down the rows in registers and across strips through the edge.  Where
// darwin_tpu takes its generic branch every trace byte equals its own;
// elsewhere it windows its scans, and H, T fields and every walked bit do.
//
// Design.  One thread block per tile; each thread owns a strip of S
// consecutive query rows and keeps their H, E, E_L and pending E-open bits
// in registers for the whole tile.  The reference-column loop runs inside
// the block as an anti-diagonal wavefront over strips: at step t, thread k
// computes column t - k of its strip, having received from thread k-1
// (through a double-buffered shared-memory edge, one __syncthreads per
// step) H, F and F_L of the row above and that row's F/F_L open
// predicates.  The TPU's sequential grid axis becomes this in-block loop;
// the 512-row strips K4 needed for VMEM are gone: one runtime QT up to 2048
// (S = 16, 128 threads) covers the 384x384 standard tiles and the 1984x960
// / 960x1984 escalation tiles alike.
//
// Bound: int32 ALU work, no reuse to exploit.  The recurrence needs 16
// integer operations per cell (2 for the diagonal, 2 for Hp, 10 for the
// four gap lanes with H + open shared, 2 for H), max-cell tracking 4 more,
// the trace word 24 more (5 compares and 7 selects of the T field, 4
// compares, 4 selects and 2 ors of the open bits, 2 adds); the compiler
// emits about 64 instructions per cell with trace (nvcc 12.9, S = 3),
// moves, addressing and loop overhead included.  On top come one block
// barrier per wavefront step and (NT-1)/(RT+NT-1) idle fill/drain.  Trace
// stores are S bytes per thread per step.  The later levers are Hopper's
// DPX add-then-max instructions (__viaddmax_s32, __vimax3_s32) on the
// recurrence, 16-bit packed lanes, and staging trace rows in shared memory
// for wider stores.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "gact.h"

namespace {

constexpr int T8_ZERO = 0, T8_DEL = 1, T8_INS = 2, T8_DEL_L = 3,
              T8_INS_L = 4, T8_DIAG = 5;
constexpr int E_OPEN8 = 8, F_OPEN8 = 16, EL_OPEN8 = 32, FL_OPEN8 = 64;
constexpr int NT_MAX = 128;     // threads (strips) per tile
static_assert(GACT_QT_MAX == NT_MAX * 16,
              "the QT limit is NT_MAX strips of the largest height, 16");

struct Scoring {
  int sub[25];                  // sub[q_code * 5 + r_code]
  int go, ge, goL, geL;
};

// What a strip hands the strip below it for one column.
struct Edge {
  int h;     // H of the strip's last row
  int f;     // F of the last row
  int fl;    // F_L of the last row
  int raw;   // F/F_L open predicates of the last row
};

// F(-1) = F_L(-1): survives "+ gap extend" without wrapping, never wins a max
constexpr int NEG_INF = -(1 << 28);

template <int S>
__global__ void __launch_bounds__(NT_MAX)
gact_dp_kernel(const uint8_t* __restrict__ qcodes,
               const uint8_t* __restrict__ rcodes,
               const int32_t* __restrict__ qlens,
               const int32_t* __restrict__ rlens,
               const uint8_t* __restrict__ start_end, int QT, int RT,
               Scoring sc, int32_t* __restrict__ score,
               int32_t* __restrict__ qpos, int32_t* __restrict__ rpos,
               uint8_t* __restrict__ trace) {
  extern __shared__ uint8_t rcol[];          // the tile's RT ref codes
  __shared__ int sub_s[25];
  __shared__ Edge edge[2][NT_MAX];
  __shared__ int best_s[NT_MAX], br_s[NT_MAX], bq_s[NT_MAX];
  __shared__ int hend_s;

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int NT = blockDim.x;
  const int q0 = k * S;
  const int qlen = qlens[b];
  const int rlen = rlens[b];
  const bool track = start_end[b] == 0;
  const int go = sc.go, ge = sc.ge, goL = sc.goL, geL = sc.geL;

  for (int x = k; x < RT; x += NT) rcol[x] = rcodes[(size_t)b * RT + x];
  if (k < 25) sub_s[k] = sc.sub[k];
  if (k == 0) hend_s = 0;

  int qc5[S], Hc[S], E[S], EL[S], EB[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = q0 + s;
    qc5[s] = (q < QT ? (int)qcodes[(size_t)b * QT + q] : 4) * 5;
    Hc[s] = 0;                               // H at column -1
    E[s] = go;                               // E entering column 0
    EL[s] = goL;
    EB[s] = E_OPEN8 | EL_OPEN8;
  }
  int diag_top = 0;          // H(q0 - 1, r - 1)
  int best = 0, br = 0, bq = 0;
  __syncthreads();

  const int n_steps = RT + NT - 1;
  for (int t = 0; t < n_steps; ++t) {
    const int r = t - k;
    if (r >= 0 && r < RT) {
      int h_up, f, fl, raw;
      if (k == 0) {              // row -1: H = 0, F = -inf, both open
        h_up = 0;
        f = NEG_INF;
        fl = NEG_INF;
        raw = F_OPEN8 | FL_OPEN8;
      } else {
        const Edge up = edge[(t - 1) & 1][k - 1];
        h_up = up.h;
        f = up.f;
        fl = up.fl;
        raw = up.raw;
      }
      const int rc = rcol[r];
      int hdiag = diag_top;
      diag_top = h_up;
      uint8_t* trow =
          trace != nullptr ? trace + ((size_t)b * RT + r) * QT : nullptr;
      int h = h_up;              // H of the row above, same column
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int q = q0 + s;
        const int dag = max(hdiag + sub_s[qc5[s] + rc], 0);
        const int e = E[s], el = EL[s];
        const int hp = max(max(dag, e), el);
        f = max(h + go, f + ge);
        fl = max(h + goL, fl + geL);
        h = max(hp, max(f, fl));
        if (trow != nullptr && q < QT) {
          // T field: darwin_tpu's select tree (gact_pallas.py:233-244)
          const bool is_f = h == f, is_fl = h == fl, is_el = h == el;
          int tv;
          if (h == dag)
            tv = is_el ? T8_DEL_L : (is_fl ? T8_INS_L
                                           : (h == 0 ? T8_ZERO : T8_DIAG));
          else
            tv = is_f ? T8_INS
                      : (is_fl ? T8_INS_L : (is_el ? T8_DEL_L : T8_DEL));
          trow[q] = (uint8_t)(tv + EB[s] + raw);
        }
        raw = (h + go > f + ge ? F_OPEN8 : 0) |
              (h + goL > fl + geL ? FL_OPEN8 : 0);
        EB[s] = (h + go > e + ge ? E_OPEN8 : 0) |
                (h + goL > el + geL ? EL_OPEN8 : 0);
        E[s] = max(h + go, e + ge);
        EL[s] = max(h + goL, el + geL);
        hdiag = Hc[s];
        Hc[s] = h;
        if (track && q < qlen && r < rlen && h > best) {
          best = h;
          br = r;
          bq = q;
        }
        if (q == qlen - 1 && r == rlen - 1) hend_s = h;
      }
      edge[t & 1][k] = Edge{h, f, fl, raw};
    }
    __syncthreads();
  }

  best_s[k] = best;
  br_s[k] = br;
  bq_s[k] = bq;
  __syncthreads();
  if (k == 0) {
    if (!track) {
      score[b] = hend_s;
      qpos[b] = qlen - 1;
      rpos[b] = rlen - 1;
    } else {
      // each strip holds its earliest (r, q) at its own max; the tile's
      // answer is the largest max, ties to the smallest (r, q)
      int bb = best_s[0], rr = br_s[0], qq = bq_s[0];
      for (int x = 1; x < NT; ++x) {
        const int v = best_s[x], vr = br_s[x], vq = bq_s[x];
        if (v > bb || (v == bb && (vr < rr || (vr == rr && vq < qq)))) {
          bb = v;
          rr = vr;
          qq = vq;
        }
      }
      score[b] = bb;
      qpos[b] = qq;
      rpos[b] = rr;
    }
  }
}

template <int S>
void launch(int B, int QT, int RT, const Scoring& sc,
            const uint8_t* q, const uint8_t* r, const int32_t* qlen,
            const int32_t* rlen, const uint8_t* se, int32_t* score,
            int32_t* qpos, int32_t* rpos, uint8_t* trace,
            cudaStream_t stream) {
  const int nt = (QT + S - 1) / S;
  gact_dp_kernel<S><<<B, nt, (size_t)RT, stream>>>(
      q, r, qlen, rlen, se, QT, RT, sc, score, qpos, rpos, trace);
}

}  // namespace

extern "C" int gact_dp(const uint8_t* q, const uint8_t* r,
                       const int32_t* qlen, const int32_t* rlen,
                       const uint8_t* start_end, int B, int QT, int RT,
                       const int32_t* sub25, int gap_open, int gap_extend,
                       int long_gap_open, int long_gap_extend,
                       int32_t* score, int32_t* qpos, int32_t* rpos,
                       uint8_t* trace, void* stream) {
  if (B < 1 || QT < 1 || QT > GACT_QT_MAX || RT < 1 || RT > GACT_RT_MAX)
    return (int)cudaErrorInvalidValue;
  Scoring sc;
  memcpy(sc.sub, sub25, sizeof(sc.sub));
  sc.go = gap_open;
  sc.ge = gap_extend;
  sc.goL = long_gap_open;
  sc.geL = long_gap_extend;
  // smallest strip height that keeps the block at <= NT_MAX threads
  const int need = (QT + NT_MAX - 1) / NT_MAX;
  cudaStream_t st = (cudaStream_t)stream;
#define GACT_DP_LAUNCH(SS)                                            \
  launch<SS>(B, QT, RT, sc, q, r, qlen, rlen, start_end, score, qpos, \
             rpos, trace, st)
  if (need <= 1)
    GACT_DP_LAUNCH(1);
  else if (need <= 2)
    GACT_DP_LAUNCH(2);
  else if (need <= 3)
    GACT_DP_LAUNCH(3);
  else if (need <= 4)
    GACT_DP_LAUNCH(4);
  else if (need <= 8)
    GACT_DP_LAUNCH(8);
  else
    GACT_DP_LAUNCH(16);
#undef GACT_DP_LAUNCH
  return (int)cudaGetLastError();
}
