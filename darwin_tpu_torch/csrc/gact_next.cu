// gact_next: the next tile of a speculative extension chain, for Hopper
// (sm_90a).
//
// Replaces darwin_tpu/ops/dispatch.py:_device_consumed (lines 273-329) fused
// with the next-request arithmetic of _extend_round_spec_pallas (:433-451).
// That is XLA code in darwin_tpu (a lax.scan over the 32-op words of the
// walk), not a Pallas kernel; as torch code it would be some ten small
// kernels per word, per chain level.  Plain PyTorch twin:
// darwin_tpu_torch/ops/gact.py:spec_next.
//
// What it computes, per lane: the walk's op stream, read from the walker's
// records (rec (RT, B) int32, nI | closing << 14 per column, columns
// visited from RT - 1 down to 0: nI I-ops, then the closing op), cut at
// L = 32 * ceil(max_ops / 32) ops; the advance (dr, dq) under the
// extender's early-cutoff rule (extender.cpp:280-331): ops are taken per
// 32-op word, and a word is taken only up to and including its first M
// once the applied count at the word's start plus the M's place in the
// word (1-based) reaches stop_thr; then the extension's new position and
// the next square tile of side T, clamped at the chromosome's and the
// read's ends exactly as _extend_round_spec_pallas does.  All in int64:
// the requests are the same numbers darwin_tpu's uint32 arithmetic gives
// for in-range addresses.
//
// Bound: latency.  The records are RT * B * 4 bytes (0.79 MB at
// 384 x 512), read once, a column per step; a lane's walk is a serial
// chain of dependent adds and compares whose length is the tile's ops, so
// bytes over 3.35 TB/s (0.24 us) is far below the kernel's floor, the
// chain of RT loads and branches.
//
// Design.  One thread per lane, 128 lanes a block: column c of the records
// is one coalesced row read by neighbouring threads, and a thread issues
// the loads of 8 columns before it walks them, so one round trip to memory
// serves 8 columns.  An insert run is taken a word segment at a time (it
// never holds an M), a closing op one at a time, so a lane does
// O(RT + ops / 32) steps, not O(ops) ones.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gact.h"

namespace {

constexpr int OP_I = 1, OP_D = 2, OP_M = 3;
constexpr int LANES_PER_BLOCK = 128;
constexpr int COLS = 8;         // record columns loaded together

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// One lane's walk: the op stream's place, the applied count, and the
// advance so far.
struct Advance {
  int p = 0;          // ops of the stream so far
  int count = 0;      // ops taken (applied)
  int base = 0;       // ops taken before p's word began
  bool cut = false;   // p's word was cut at an M
  int dr = 0, dq = 0;

  __device__ __forceinline__ void word_start() {
    if ((p & 31) == 0) {
      base = count;
      cut = false;
    }
  }

  // one column's record: nI I-ops (taken a word segment at a time: an I
  // never cuts a word), then the closing op, if any
  __device__ __forceinline__ void column(int w, int stop_thr, int L) {
    int n_ins = w & 0x3FFF;
    const int closing = (w >> 14) & 3;
    while (n_ins > 0 && p < L) {
      word_start();
      const int seg = min(n_ins, min(32 - (p & 31), L - p));
      if (!cut) {
        dq += seg;
        count += seg;
      }
      p += seg;
      n_ins -= seg;
    }
    if (closing != 0 && p < L) {
      word_start();
      if (!cut) {
        dr += closing != OP_I;
        dq += closing != OP_D;
        ++count;
        cut = closing == OP_M && base + (p & 31) + 1 >= stop_thr;
      }
      ++p;
    }
  }
};

__global__ void __launch_bounds__(LANES_PER_BLOCK)
gact_next_kernel(const int32_t* __restrict__ rec,
                 const int64_t* __restrict__ lane,
                 const int64_t* __restrict__ curr, int B, int RT, int T,
                 int stop_thr, int L, int64_t* __restrict__ out) {
  const int b = blockIdx.x * LANES_PER_BLOCK + threadIdx.x;
  if (b >= B) return;
  Advance a;
  // the columns in groups of COLS, each group's loads issued together
  for (int c0 = RT - 1; c0 >= 0 && a.p < L; c0 -= COLS) {
    int w[COLS];
#pragma unroll
    for (int u = 0; u < COLS; ++u)
      w[u] = c0 - u >= 0 ? rec[(size_t)(c0 - u) * B + b] : 0;
#pragma unroll
    for (int u = 0; u < COLS; ++u) a.column(w[u], stop_thr, L);
  }
  const int64_t dr = a.dr, dq = a.dq;
  // lane: rev, chrom_start, chrom_len, q_buf_start, q_len
  const bool rev = lane[b] != 0;
  const int64_t chrom_start = lane[B + b];
  const int64_t chrom_len = lane[2 * (size_t)B + b];
  const int64_t q_buf_start = lane[3 * (size_t)B + b];
  const int64_t q_len = lane[4 * (size_t)B + b];
  int64_t cr = curr[b], cq = curr[B + b];
  int64_t r_size, q_size, r_rel, q_rel;
  if (rev) {   // right extension: the window starts at curr
    cr = min64(cr + dr, chrom_len);
    cq = min64(cq + dq, q_len);
    r_size = min64(chrom_len - cr, T);
    q_size = min64(q_len - cq, T);
    r_rel = cr;
    q_rel = cq;
  } else {     // left extension: the window ends at curr
    cr = max64(cr - dr, 0);
    cq = max64(cq - dq, 0);
    r_size = min64(cr + 1, T);
    q_size = min64(cq + 1, T);
    r_rel = cr >= T ? cr - T + 1 : 0;
    q_rel = cq >= T ? cq - T + 1 : 0;
  }
  out[b] = chrom_start + r_rel;
  out[B + b] = max64(r_size, 1);
  out[2 * (size_t)B + b] = q_buf_start + q_rel;
  out[3 * (size_t)B + b] = max64(q_size, 1);
  out[4 * (size_t)B + b] = cr;
  out[5 * (size_t)B + b] = cq;
  out[6 * (size_t)B + b] = dr;
  out[7 * (size_t)B + b] = dq;
}

}  // namespace

extern "C" int gact_next(const int32_t* rec, const int64_t* lane,
                         const int64_t* curr, int B, int RT, int T,
                         int stop_thr, int max_ops, int64_t* out,
                         void* stream) {
  if (B < 1 || RT < 1 || T < 1 || max_ops < 0)
    return (int)cudaErrorInvalidValue;
  const int L = (max_ops + 31) / 32 * 32;
  const int blocks = (B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  gact_next_kernel<<<blocks, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      rec, lane, curr, B, RT, T, stop_thr, L, out);
  return (int)cudaGetLastError();
}
