// gact_next: the next tile of a speculative extension chain, for Hopper
// (sm_90a), with the tile's codes gathered.
//
// Replaces darwin_tpu/ops/dispatch.py:_device_consumed (lines 273-329) fused
// with the next-request arithmetic of _extend_round_spec_pallas (:433-451)
// and the gather of the next level's tiles (one_tile(rs2, ...), :452).
// That is XLA code in darwin_tpu (a lax.scan over the 32-op words of the
// walk, then the tile gather), not a Pallas kernel; as torch code it would
// be some ten small kernels per word and a dozen for the gather, per chain
// level.  Plain PyTorch twin: darwin_tpu_torch/ops/gact.py:spec_next_tiles
// (spec_next, then gather_tiles and tile_sizes).
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
// for in-range addresses.  Last, the next level's inputs: the (T,) query
// and ref tiles from the resident code buffers (reversed index ranges for
// a right extension, int64 indices clamped into the buffer, as
// gather_tiles does, so every byte equals the twin's) and the int32 sizes
// gact_dp and gact_tb take.
//
// Bound: latency.  The records are RT * B * 4 bytes (0.79 MB at
// 384 x 512, resident in L2: gact_tb just wrote them), the tiles 2 * T * B
// bytes; at 3.35 TB/s that is well under a microsecond.  What a lane costs
// is its walk, a chain of dependent steps over its columns.
//
// Design.  A warp per lane, 8 lanes (warps) a block.
//  - Staging: the block copies its 8 lanes' records, CHUNK_ROWS rows at a
//    time, into shared memory: a row of 8 lanes is one 32-byte sector, and
//    each thread issues all its loads of a chunk before it stores any, so a
//    chunk costs one round trip to L2.  The patch is stored lane-major with
//    a row stride of PSTRIDE (= 4 mod 32 banks): the staging writes (4 rows
//    x 8 lanes per warp instruction) and the walk's reads (32 rows of one
//    lane) are both free of bank conflicts.
//  - The walk: 32 columns a step, one per thread, from RT - 1 down.  Each
//    thread forms its column's op count nI + (closing != 0); a warp
//    inclusive scan (__shfl_up_sync) places every column in the op stream.
//    The carry from step to step — the stream position p, the applied
//    count, the current word's base (applied count at its start) and
//    whether it was already cut — is warp-uniform.
//  - Words: an M only ever closes a column, so for each word the step
//    touches, the first M that cuts it is the lowest set bit of one
//    __ballot_sync over "my closing op is an M in this word and base +
//    place >= stop_thr".  The word is taken up to it, or to the end of the
//    word or of the step's ops; each thread adds the taken part of its own
//    insert run and closing op to its partial (dr, dq), summed across the
//    warp once at the end (__reduce_add_sync).  An insert run never cuts a
//    word, so a run that spans many words costs a few instructions a word.
//    A word that goes on into the next step keeps its base and cut flag in
//    the carry; a word that begins exactly at a step's first op starts
//    fresh, as the serial walk's lazy word start does.
//  - Gather: the warp writes the lane's tiles, 32 consecutive bytes per
//    store (one sector), each thread loading all its codes before it
//    stores any.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gact.h"

namespace {

constexpr int OP_I = 1, OP_D = 2, OP_M = 3;
constexpr int WARP = 32;              // record columns per step
constexpr int LANES_PER_BLOCK = 8;    // one warp per lane
constexpr int THREADS = WARP * LANES_PER_BLOCK;
constexpr int CHUNK_ROWS = 384;       // record rows staged per pass
constexpr int PSTRIDE = CHUNK_ROWS + 4;   // lane stride of the patch
constexpr int STAGE = CHUNK_ROWS * LANES_PER_BLOCK / THREADS;  // loads each
constexpr int GATHER = 12;            // tile bytes in flight per thread
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNK_ROWS % WARP == 0 && CHUNK_ROWS % 4 == 0 &&
              PSTRIDE % 32 == 4 &&
              CHUNK_ROWS * LANES_PER_BLOCK % THREADS == 0,
              "patch geometry");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The (T,) tiles of one lane: code j of a tile is buf[clamp(first + step *
// j, 0, n - 1)], first = start (step 1) or start + size - 1 (step -1).
__device__ __forceinline__ void gather_pair(
    const uint8_t* __restrict__ ref, int64_t n_ref, int64_t r_first,
    const uint8_t* __restrict__ qry, int64_t n_qry, int64_t q_first,
    int64_t step, int T, int t, uint8_t* __restrict__ rdst,
    uint8_t* __restrict__ qdst) {
  for (int j0 = 0; j0 < T; j0 += WARP * GATHER) {
    uint8_t vr[GATHER], vq[GATHER];
#pragma unroll
    for (int g = 0; g < GATHER; ++g) {
      const int j = j0 + g * WARP + t;
      const int64_t ri = min64(max64(r_first + step * j, 0), n_ref - 1);
      const int64_t qi = min64(max64(q_first + step * j, 0), n_qry - 1);
      vr[g] = j < T ? ref[ri] : 0;
      vq[g] = j < T ? qry[qi] : 0;
    }
#pragma unroll
    for (int g = 0; g < GATHER; ++g) {
      const int j = j0 + g * WARP + t;
      if (j < T) {
        rdst[j] = vr[g];
        qdst[j] = vq[g];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gact_next_kernel(const int32_t* __restrict__ rec,
                 const int64_t* __restrict__ lane,
                 const int64_t* __restrict__ curr,
                 const uint8_t* __restrict__ ref, int64_t n_ref,
                 const uint8_t* __restrict__ qry, int64_t n_qry, int B,
                 int RT, int T, int stop_thr, int L,
                 int64_t* __restrict__ out, uint8_t* __restrict__ qtile,
                 uint8_t* __restrict__ rtile, int32_t* __restrict__ sizes) {
  __shared__ int32_t patch[LANES_PER_BLOCK * PSTRIDE];
  const int t = threadIdx.x & (WARP - 1);
  const int wi = threadIdx.x / WARP;
  const int b0 = blockIdx.x * LANES_PER_BLOCK;
  const int b = b0 + wi;
  const int nl = min(LANES_PER_BLOCK, B - b0);
  // the carry, warp-uniform
  int p = 0;          // ops of the stream so far
  int count = 0;      // ops taken (applied)
  int base = 0;       // ops taken before p's word began
  bool cut = false;   // p's word was cut at an M
  // this thread's part of the advance
  int dr = 0, dq = 0;
  for (int hi = RT - 1; hi >= 0; hi -= CHUNK_ROWS) {
    if (__syncthreads_and(b >= B || p >= L)) break;
    const int rows = min(CHUNK_ROWS, hi + 1);
    // walk row r of the chunk is record column hi - r
    int32_t v[STAGE];
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int g = threadIdx.x + k * THREADS;
      const int r = g / LANES_PER_BLOCK, l = g % LANES_PER_BLOCK;
      v[k] = r < rows && l < nl ? rec[(size_t)(hi - r) * B + b0 + l] : 0;
    }
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int g = threadIdx.x + k * THREADS;
      patch[(g % LANES_PER_BLOCK) * PSTRIDE + g / LANES_PER_BLOCK] = v[k];
    }
    __syncthreads();
    if (b < B) {
      for (int s0 = 0; s0 < rows && p < L; s0 += WARP) {
        const int w = patch[wi * PSTRIDE + s0 + t];   // 0 past the rows
        const int n_ins = w & 0x3FFF;
        const int closing = (w >> 14) & 3;
        const int cnt = n_ins + (closing != 0);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < WARP; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (t >= o) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, WARP - 1);
        if (total == 0) continue;
        const int s = p + incl - cnt;        // this column's first op
        const int cpos = s + n_ins;          // its closing op's place
        const int end = min(p + total, L);
        for (int ws = p & ~31; ws < end; ws += 32) {
          if (ws >= p) {                     // the word starts here
            base = count;
            cut = false;
          }
          if (cut) continue;
          const int lo = max(p, ws);
          int hi_op = min(ws + 32, end);
          const bool m = closing == OP_M && cpos >= lo && cpos < hi_op &&
                         base + (cpos - ws) + 1 >= stop_thr;
          const unsigned bal = __ballot_sync(FULL, m);
          if (bal) {
            hi_op = __shfl_sync(FULL, cpos, __ffs(bal) - 1) + 1;
            cut = true;
          }
          dq += max(min(s + n_ins, hi_op) - max(s, lo), 0);
          if (closing != 0 && cpos >= lo && cpos < hi_op) {
            dr += closing != OP_I;
            dq += closing != OP_D;
          }
          count += hi_op - lo;
        }
        p += total;
      }
    }
    __syncthreads();
  }
  if (b >= B) return;
  const int64_t adr = __reduce_add_sync(FULL, dr);
  const int64_t adq = __reduce_add_sync(FULL, dq);
  // lane: rev, chrom_start, chrom_len, q_buf_start, q_len
  const bool rev = lane[b] != 0;
  const int64_t chrom_start = lane[B + b];
  const int64_t chrom_len = lane[2 * (size_t)B + b];
  const int64_t q_buf_start = lane[3 * (size_t)B + b];
  const int64_t q_len = lane[4 * (size_t)B + b];
  int64_t cr = curr[b], cq = curr[B + b];
  int64_t r_size, q_size, r_rel, q_rel;
  if (rev) {   // right extension: the window starts at curr
    cr = min64(cr + adr, chrom_len);
    cq = min64(cq + adq, q_len);
    r_size = min64(chrom_len - cr, T);
    q_size = min64(q_len - cq, T);
    r_rel = cr;
    q_rel = cq;
  } else {     // left extension: the window ends at curr
    cr = max64(cr - adr, 0);
    cq = max64(cq - adq, 0);
    r_size = min64(cr + 1, T);
    q_size = min64(cq + 1, T);
    r_rel = cr >= T ? cr - T + 1 : 0;
    q_rel = cq >= T ? cq - T + 1 : 0;
  }
  r_size = max64(r_size, 1);
  q_size = max64(q_size, 1);
  const int64_t r_start = chrom_start + r_rel;
  const int64_t q_start = q_buf_start + q_rel;
  if (t == 0) {
    out[b] = r_start;
    out[B + b] = r_size;
    out[2 * (size_t)B + b] = q_start;
    out[3 * (size_t)B + b] = q_size;
    out[4 * (size_t)B + b] = cr;
    out[5 * (size_t)B + b] = cq;
    out[6 * (size_t)B + b] = adr;
    out[7 * (size_t)B + b] = adq;
    sizes[b] = (int32_t)q_size;
    sizes[B + b] = (int32_t)r_size;
    sizes[2 * B + b] = (int32_t)q_size - 1;
    sizes[3 * B + b] = (int32_t)r_size - 1;
  }
  gather_pair(ref, n_ref, rev ? r_start + r_size - 1 : r_start, qry, n_qry,
              rev ? q_start + q_size - 1 : q_start, rev ? -1 : 1, T, t,
              rtile + (size_t)b * T, qtile + (size_t)b * T);
}

}  // namespace

extern "C" int gact_next(const int32_t* rec, const int64_t* lane,
                         const int64_t* curr, const uint8_t* ref,
                         int64_t n_ref, const uint8_t* query, int64_t n_query,
                         int B, int RT, int T, int stop_thr, int max_ops,
                         int64_t* out, uint8_t* qtile, uint8_t* rtile,
                         int32_t* sizes, void* stream) {
  if (B < 1 || RT < 1 || T < 1 || max_ops < 0 || max_ops > (1 << 30) ||
      n_ref < 1 || n_query < 1)
    return (int)cudaErrorInvalidValue;
  const int L = (max_ops + 31) / 32 * 32;
  const int blocks = (B + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  gact_next_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rec, lane, curr, ref, n_ref, query, n_query, B, RT, T, stop_thr, L,
      out, qtile, rtile, sizes);
  return (int)cudaGetLastError();
}
