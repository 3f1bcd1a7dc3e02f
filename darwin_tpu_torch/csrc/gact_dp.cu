// gact_dp: batched GACT tile DP for Hopper (sm_90a).
//
// Replaces darwin_tpu/ops/gact_pallas.py:_dp_kernel (K1, lines 103-312)
// and _dp_strip_kernel (K4, lines 343-488), their generic-scoring branches
// (K5, lines 196-223 and 417-430) included.  Plain PyTorch twin:
// darwin_tpu_torch/ops/gact.py:batch_align (same score, positions and valid
// trace bytes, bit for bit).
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
// vector; here a lane walks its rows in order, so F and F_L are carried
// down the rows in registers and across lanes by shuffles.  Where
// darwin_tpu takes its generic branch every trace byte equals its own;
// elsewhere it windows its scans, and H, T fields and every walked bit do.
//
// Bound: int32 ALU work, no reuse to exploit: 16 integer operations per
// cell for the recurrence, 4 more for max-cell tracking, 24 more for the
// trace word; against them 1 byte of trace per cell.
//
// Design (the public model is CUDASW++ 4.0's warp-shuffle Smith-Waterman).
//  * One block of W warps per tile.  Lane l of warp w owns the S query
//    rows from (32 w + l) S and keeps their H, E, E_L, pending E-open bits
//    and query codes in registers for the whole tile.  A warp is an
//    anti-diagonal wavefront over its 32 S rows: at its step u lane l
//    computes column u - l and takes (H, F, F_L) of the row above from
//    lane l - 1 by three __shfl_up_sync; the F / F_L open bits of a row
//    compare those three values, so they need no hand-off of their own.
//    There is no block barrier in the column loop, and fill/drain is 31
//    steps of S cells per lane whatever the tile's height.
//  * Warp w runs LAG steps behind warp w - 1 and reads its top edge from a
//    ring in shared memory that lane 31 of the warp above fills.  The two
//    meet at a named barrier of their own (bar.sync id, 64) once every
//    CHUNK steps; a column is read at least one barrier after it was
//    written because LAG >= CHUNK + 31, and the pair is never more than
//    CHUNK steps apart, so a ring of ERING columns is never overrun.
//    (S, W) come from QT and B alone (plan() below): W > 1 where 32 x 16
//    rows are too few for the tile, and where B warps would leave most of
//    the card's 132 x 4 schedulers empty.
//  * The trace leaves the SM as full lines.  A lane stores each cell's byte
//    into its warp's ring of TRING columns x 32 S rows in shared memory;
//    every TGROUP steps the whole warp copies the TGROUP columns that lane
//    31 has finished to the (RT, QT) tile, consecutive lanes on consecutive
//    addresses (16-byte, 4-byte or single-byte accesses by the alignment QT
//    allows; bytes at q >= QT are masked).
//  * Per cell: Hopper's DPX instructions do add-then-max (__viaddmax_s32)
//    and three-way max (__vimax3_s32), so the recurrence is 9 instructions;
//    an open bit ("opening beats extending", H + go > X + ge) is one
//    compare of X against H + (go - ge), a sum that the E lane of a row and
//    the F lane of the next row share.  (__vibmax_s32, max with the
//    compare's predicate, compiles to a compare and a select on this card
//    and saves nothing.)  The T field is darwin_tpu's select tree
//    (gact_pallas.py:233-244) term for term, since ties decide the path,
//    but looked up: the tree's five predicates (H == dag, E_L, F_L, F;
//    dag == 0) index a 32-entry table that the tree itself fills, and
//    each predicate is one add-then-max, max(x - H, -1), so the field
//    costs 5 instructions of the compare / select pipe, not 13.
//  * Only the valid region is computed: columns r < rlen, warps that hold a
//    row q < qlen.  Trace bytes outside it are left unwritten: a walk that
//    starts inside moves up and left and never reads them.  A tile with an
//    empty side has no valid cell, and max-cell mode reports (0, 0) for it,
//    so its word (0, 0) is written as ZERO, as the twin's is: a walk from the
//    reported cell stops at once.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "gact.h"

namespace {

constexpr int T8_ZERO = 0, T8_DEL = 1, T8_INS = 2, T8_DEL_L = 3,
              T8_INS_L = 4, T8_DIAG = 5;
constexpr int E_OPEN8 = 8, F_OPEN8 = 16, EL_OPEN8 = 32, FL_OPEN8 = 64;
constexpr int W_MAX = 4;        // warps per tile
constexpr int S_MAX = 16;       // query rows per lane
static_assert(GACT_QT_MAX == W_MAX * 32 * S_MAX,
              "the QT limit is W_MAX warps of 32 lanes of S_MAX rows");
static_assert(GACT_QT_MAX <= (1 << 11) && GACT_RT_MAX <= (1 << 15),
              "a best cell is packed as r << 11 | q");
constexpr int CHUNK = 8;        // steps between two meetings of a warp pair
constexpr int LAG = 40;         // steps warp w runs behind warp w - 1
constexpr int ERING = 64;       // edge columns kept per warp pair
constexpr int TRING = 64;       // trace columns staged per warp
constexpr int TGROUP = 4;       // trace columns flushed together
constexpr int TFLUSH = TGROUP + 31;   // steps from a group's start to its flush
static_assert(LAG % CHUNK == 0, "a warp starts on a chunk's first step");
static_assert(TRING >= TFLUSH + TGROUP && (TRING & (TRING - 1)) == 0,
              "a staged column is flushed before its slot is written again");
static_assert(LAG >= CHUNK + 31 && ERING >= LAG + CHUNK,
              "an edge column is read a barrier after it was written and "
              "before its slot is written again");
// a batch of fewer warps than this leaves schedulers of the card idle (132
// SMs x 4), so its tiles are spread over more warps
constexpr int FILL_WARPS = 132 * 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SUB_BYTES = 112;  // the 25 int32 of the matrix, padded to 16

struct Scoring {
  int sub[25];                  // sub[q_code * 5 + r_code]
  int go, ge, goL, geL;
};

// F(-1) = F_L(-1): survives "+ gap extend" without wrapping, never wins a
// max, and F(0) = max(0 + go, F(-1) + ge) = go drops it at the first row
constexpr int NEG_INF = -(1 << 28);

__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// The T field of a cell: darwin_tpu's select tree (gact_pallas.py:233-244)
// term for term, since ties decide the path.  Bit k of x is SET where the
// predicate does NOT hold: 0 H == dag, 1 H == E_L, 2 H == F_L, 3 H == F,
// 4 dag == 0.
__device__ __forceinline__ int t_field(int x) {
  const bool is_dag = !(x & 1), is_el = !(x & 2), is_fl = !(x & 4),
             is_f = !(x & 8), is_zero = !(x & 16);
  if (is_dag)
    return is_el ? T8_DEL_L
                 : (is_fl ? T8_INS_L : (is_zero ? T8_ZERO : T8_DIAG));
  return is_f ? T8_INS : (is_fl ? T8_INS_L : (is_el ? T8_DEL_L : T8_DEL));
}

// Dynamic shared memory of a block: the edge rings (16-byte entries), the
// warps' staged trace columns, the tile's ref codes, the substitution
// matrix, the T-field table.  Everything in it is addressed as this array
// plus a 32-bit offset, so no address is rebuilt from a pointer at run time.
extern __shared__ int4 smem[];

// What a lane keeps for the whole tile.
template <int S>
struct Strip {
  int qoff[S];                  // byte offset of the query code's row of sub
  int H[S];                     // H of the last column done
  int best, bpos;               // max-cell mode: largest H, r << 11 | q
};

// What a warp's column loop needs besides its strip; *_off are byte offsets
// into smem.
struct WarpJob {
  int rcol_off;                 // the tile's ref codes
  int sub_off;                  // the 5 x 5 substitution matrix, int32
  int lut_off;                  // the T field by its five predicates
  int edge_in_off;              // ring the warp above fills (if has_in)
  int edge_out_off;             // ring for the warp below (if has_out)
  bool has_in, has_out;
  int ring_off;                 // this warp's staged trace columns
  uint8_t* tout;                // the tile's trace at this warp's first row
  int QT, tn, talign;           // tn: bytes of a column inside the tile
  int n, w, nw, lane, q0, nv;   // n columns, nw warps at work, nv valid rows
  int go, ge, goL, geL;
};

// Copy TGROUP finished trace columns of this warp, from column c0 on, to the
// tile in units of UNIT bytes: consecutive lanes take consecutive units of a
// column.  tn bytes of a column lie inside the tile, n columns exist.
template <int S, int UNIT, typename T>
__device__ __forceinline__ void flush_group(const uint8_t* ring, uint8_t* dst,
                                            int c0, int QT, int tn, int n,
                                            int lane) {
  constexpr int PER_COL = 32 * S / UNIT;     // units in a staged column
  // the 16-byte form is the main path's (QT a multiple of 16): unrolled
#pragma unroll(UNIT == 16 ? 4 : 1)
  for (int x = 0; x < (TGROUP * PER_COL + 31) / 32; ++x) {
    const int k = lane + 32 * x;
    const int col = k / PER_COL, at = (k % PER_COL) * UNIT;
    const int c = c0 + col;
    if (col < TGROUP && at < tn && c < n)
      *reinterpret_cast<T*>(dst + (size_t)col * QT + at) =
          *reinterpret_cast<const T*>(ring + (c & (TRING - 1)) * (32 * S) +
                                      at);
  }
}

// The column loop of one warp.
template <int S, bool TRACE, bool TRACK>
__device__ __forceinline__ void column_loop(Strip<S>& st, const WarpJob& j) {
  constexpr int PITCH = 32 * S;
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem);
  const int lane = j.lane, n = j.n, go = j.go, ge = j.ge, goL = j.goL,
            geL = j.geL;
  // "opening beats extending" as one compare against the lane's value:
  // H + go > X + ge  <=>  H + (go - ge) > X
  const int gd = go - ge, gdL = goL - geL;
  int E[S], EL[S], EB[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    st.H[s] = 0;                             // H at column -1
    E[s] = go;                               // E entering column 0
    EL[s] = goL;
    EB[s] = E_OPEN8 | EL_OPEN8;
  }
  int diag_top = 0;                          // H(q0 - 1, r - 1)
  int eh = 0, ef = NEG_INF, efl = NEG_INF;   // this lane's last row
  // a group of TGROUP columns is flushed TFLUSH steps after its first one
  // began: lane 31 has then finished its last
  const int steps = TRACE ? n + TFLUSH : n + 31;   // of this warp
  const int total = steps + (j.nw - 1) * LAG;      // of the tile
  const int lag = j.w * LAG;
  const uint8_t* const ring = sm + j.ring_off;
  uint8_t* const lane_ring = sm + j.ring_off + lane * S;
  const uint8_t* const rcol = sm + j.rcol_off;
  const uint8_t* const sub = sm + j.sub_off;
  const uint8_t* const lut = sm + j.lut_off;
  const int4* const edge_in = reinterpret_cast<const int4*>(
      sm + j.edge_in_off);
  int4* const edge_out = reinterpret_cast<int4*>(sm + j.edge_out_off);
  uint8_t* tdst = j.tout;                    // where the next flush goes
  for (int g0 = 0; g0 < total; g0 += CHUNK) {
    if (j.nw > 1 && g0 > 0) {
      if (j.has_in) pair_barrier(j.w);       // with the warp above
      if (j.has_out) pair_barrier(j.w + 1);  // with the warp below
    }
    // this warp's steps of the chunk (LAG is a multiple of CHUNK)
    const int u1 = min(g0 + CHUNK - lag, steps);
#pragma unroll 1
    for (int u = max(g0 - lag, 0); u < u1; ++u) {
      if (TRACE && (u & (TGROUP - 1)) == TGROUP - 1) {
        __syncwarp();
        if (u >= TFLUSH) {
          const int c0 = u - TFLUSH;
          if (j.talign == 16)
            flush_group<S, 16, uint4>(ring, tdst, c0, j.QT, j.tn, n, lane);
          else if (j.talign == 4)
            flush_group<S, 4, uint32_t>(ring, tdst, c0, j.QT, j.tn, n, lane);
          else
            flush_group<S, 1, uint8_t>(ring, tdst, c0, j.QT, j.tn, n, lane);
          tdst += (size_t)TGROUP * j.QT;
        }
      }
      int uh = __shfl_up_sync(FULL, eh, 1);
      int uf = __shfl_up_sync(FULL, ef, 1);
      int ufl = __shfl_up_sync(FULL, efl, 1);
      const int r = u - lane;
      if ((unsigned)r < (unsigned)n) {
        if (lane == 0) {
          uh = 0;                            // row -1: H = 0, F = -inf
          uf = NEG_INF;
          ufl = NEG_INF;
          if (j.has_in) {
            const int4 up = edge_in[r & (ERING - 1)];
            uh = up.x;
            uf = up.y;
            ufl = up.z;
          }
        }
        const uint8_t* subcol = sub + 4 * (int)rcol[r];
        int hdiag = diag_top;
        diag_top = uh;
        int h = uh, f = uf, fl = ufl;
        int a = uh + go, al = uh + goL;      // H of the row above + open
        int ad = uh + gd, adL = uh + gdL;
        uint8_t* tcol = lane_ring + (r & (TRING - 1)) * PITCH;
        const int cb = (r << 11) + j.q0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int sub_qr =
              *reinterpret_cast<const int*>(subcol + st.qoff[s]);
          const int dag = __viaddmax_s32(hdiag, sub_qr, 0);
          const int e = E[s], el = EL[s];
          const int hp = __vimax3_s32(dag, e, el);
          int bits = 0;
          if (TRACE)
            bits = EB[s] + (ad > f ? F_OPEN8 : 0) + (adL > fl ? FL_OPEN8 : 0);
          f = __viaddmax_s32(f, ge, a);
          fl = __viaddmax_s32(fl, geL, al);
          h = __vimax3_s32(hp, f, fl);
          a = h + go;
          al = h + goL;
          if (TRACE) {
            ad = h + gd;
            adL = h + gdL;
            EB[s] = (ad > e ? E_OPEN8 : 0) + (adL > el ? EL_OPEN8 : 0);
            // T field: which of (dag, E_L, F_L, F) equal H and whether dag
            // is 0, as a 5-bit index into the table.  No candidate exceeds
            // H, so max(x - H, -1) is 0 where x equals H, else -1
            const int nh = -h;
            const int t1 = 2 * __viaddmax_s32(el, nh, -1) +
                           __viaddmax_s32(dag, nh, -1);
            const int t2 = 4 * __viaddmax_s32(fl, nh, -1) + t1;
            const int t3 = 8 * __viaddmax_s32(f, nh, -1) + t2;
            tcol[s] = (uint8_t)(lut[16 * min(dag, 1) - t3] + bits);
          }
          E[s] = __viaddmax_s32(e, ge, a);
          EL[s] = __viaddmax_s32(el, geL, al);
          hdiag = st.H[s];
          st.H[s] = h;
          if (TRACK && s < j.nv && h > st.best) {
            st.best = h;
            st.bpos = cb + s;
          }
        }
        eh = h;
        ef = f;
        efl = fl;
        if (j.has_out && lane == 31)
          edge_out[r & (ERING - 1)] = make_int4(h, f, fl, 0);
      }
    }
  }
}

template <int S, bool TRACE>
__global__ void __launch_bounds__(32 * W_MAX)
gact_dp_kernel(const uint8_t* __restrict__ qcodes,
               const uint8_t* __restrict__ rcodes,
               const int32_t* __restrict__ qlens,
               const int32_t* __restrict__ rlens,
               const uint8_t* __restrict__ start_end, int QT, int RT,
               Scoring sc, int32_t* __restrict__ score,
               int32_t* __restrict__ qpos, int32_t* __restrict__ rpos,
               uint8_t* __restrict__ trace) {
  __shared__ int best_s[W_MAX], bpos_s[W_MAX];

  const int b = blockIdx.x;
  const int W = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qlen = min(qlens[b], QT);
  const int n = min(rlens[b], RT);
  const bool track = start_end[b] == 0;
  if (qlen <= 0 || n <= 0) {                 // an empty side: nothing to do
    if (threadIdx.x == 0) {
      score[b] = 0;
      qpos[b] = track ? 0 : qlen - 1;
      rpos[b] = track ? 0 : n - 1;
      if (TRACE) trace[(size_t)b * RT * QT] = T8_ZERO;
    }
    return;
  }
  constexpr int PITCH = 32 * S;
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem);
  const int rings_off = (W - 1) * ERING * (int)sizeof(int4);
  const int rcol_off = rings_off + (TRACE ? W * TRING * PITCH : 0);
  const int sub_off = rcol_off + (RT + 15) / 16 * 16;
  const int lut_off = sub_off + SUB_BYTES;

  for (int x = threadIdx.x; x < n; x += blockDim.x)
    sm[rcol_off + x] = rcodes[(size_t)b * RT + x];
  if (threadIdx.x < 25)
    reinterpret_cast<int*>(sm + sub_off)[threadIdx.x] = sc.sub[threadIdx.x];
  if (TRACE && threadIdx.x < 32)
    sm[lut_off + threadIdx.x] = (uint8_t)t_field(threadIdx.x);
  __syncthreads();

  const int nw = (qlen + PITCH - 1) / PITCH;   // warps that hold a valid row
  const int q0 = (w * 32 + lane) * S;
  Strip<S> st;
  st.best = 0;
  st.bpos = 0;
  if (w < nw) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = q0 + s;
      st.qoff[s] = (q < QT ? (int)qcodes[(size_t)b * QT + q] : 4) * 20;
    }
    WarpJob j;
    j.rcol_off = rcol_off;
    j.sub_off = sub_off;
    j.lut_off = lut_off;
    j.has_in = w > 0;
    j.has_out = w + 1 < nw;
    j.edge_in_off = (j.has_in ? w - 1 : 0) * ERING * (int)sizeof(int4);
    j.edge_out_off = (j.has_out ? w : 0) * ERING * (int)sizeof(int4);
    j.ring_off = rings_off + w * TRING * PITCH;
    j.tout = nullptr;
    j.talign = 1;
    if (TRACE) {
      j.tout = trace + (size_t)b * RT * QT + w * PITCH;
      const unsigned bits = (unsigned)(uintptr_t)trace | (unsigned)QT;
      j.talign = bits % 16 == 0 ? 16 : (bits % 4 == 0 ? 4 : 1);
    }
    j.QT = QT;
    j.tn = min(PITCH, QT - w * PITCH);
    j.n = n;
    j.w = w;
    j.nw = nw;
    j.lane = lane;
    j.q0 = q0;
    j.nv = qlen - q0;
    j.go = sc.go;
    j.ge = sc.ge;
    j.goL = sc.goL;
    j.geL = sc.geL;
    if (track)
      column_loop<S, TRACE, true>(st, j);
    else
      column_loop<S, TRACE, false>(st, j);
  }

  if (!track) {
    // H of the last column is still in the registers of the lane that owns
    // row qlen - 1
    if (w * 32 + lane == (qlen - 1) / S) {
      int h = 0;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s == (qlen - 1) % S) h = st.H[s];
      score[b] = h;
      qpos[b] = qlen - 1;
      rpos[b] = n - 1;
    }
    return;
  }
  // each lane holds its earliest (r, q) at its own max; the tile's answer is
  // the largest max, ties to the smallest (r, q)
  int bb = st.best, bp = st.bpos;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int v = __shfl_xor_sync(FULL, bb, d);
    const int vp = __shfl_xor_sync(FULL, bp, d);
    if (v > bb || (v == bb && vp < bp)) {
      bb = v;
      bp = vp;
    }
  }
  if (lane == 0) {
    best_s[w] = bb;
    bpos_s[w] = bp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int x = 1; x < W; ++x) {
      const int v = best_s[x], vp = bpos_s[x];
      if (v > bb || (v == bb && vp < bp)) {
        bb = v;
        bp = vp;
      }
    }
    score[b] = bb;
    qpos[b] = bp & ((1 << 11) - 1);
    rpos[b] = bp >> 11;
  }
}

// Rows per lane (S) and warps per tile (W) for a tile of QT query rows in a
// batch of B tiles.  W is the fewest warps whose 32 x S_MAX rows cover QT,
// doubled while the batch would leave schedulers without a warp; S the
// smallest height built that covers QT with W warps.
void plan(int B, int QT, int* S, int* W) {
  int w = 1;
  while (w < W_MAX && QT > w * 32 * S_MAX) w *= 2;
  while (w < W_MAX && B * w < FILL_WARPS && QT > w * 32) w *= 2;
  const int need = (QT + 32 * w - 1) / (32 * w);
  const int built[] = {1, 2, 3, 4, 6, 8, 12, 16};
  int s = S_MAX;
  for (int k = 7; k >= 0; --k)
    if (built[k] >= need) s = built[k];
  *S = s;
  *W = w;
}

template <int S, bool TRACE>
int launch(int B, int QT, int RT, int W, const Scoring& sc, const uint8_t* q,
           const uint8_t* r, const int32_t* qlen, const int32_t* rlen,
           const uint8_t* se, int32_t* score, int32_t* qpos, int32_t* rpos,
           uint8_t* trace, cudaStream_t stream) {
  const size_t bytes = (size_t)(W - 1) * ERING * sizeof(int4) +
                       (TRACE ? (size_t)W * TRING * 32 * S : 0) +
                       (size_t)(RT + 15) / 16 * 16 + SUB_BYTES + 32;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gact_dp_kernel<S, TRACE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  gact_dp_kernel<S, TRACE><<<B, 32 * W, bytes, stream>>>(
      q, r, qlen, rlen, se, QT, RT, sc, score, qpos, rpos, trace);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gact_dp_plan(int B, int QT, int* S, int* W) {
  if (B < 1 || QT < 1 || QT > GACT_QT_MAX) return (int)cudaErrorInvalidValue;
  plan(B, QT, S, W);
  return 0;
}

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
  int S, W;
  plan(B, QT, &S, &W);
  cudaStream_t st = (cudaStream_t)stream;
#define GACT_DP_CASE(SS)                                                   \
  case SS:                                                                 \
    return trace != nullptr                                                \
               ? launch<SS, true>(B, QT, RT, W, sc, q, r, qlen, rlen,      \
                                  start_end, score, qpos, rpos, trace, st) \
               : launch<SS, false>(B, QT, RT, W, sc, q, r, qlen, rlen,     \
                                   start_end, score, qpos, rpos, trace, st)
  switch (S) {
    GACT_DP_CASE(1);
    GACT_DP_CASE(2);
    GACT_DP_CASE(3);
    GACT_DP_CASE(4);
    GACT_DP_CASE(6);
    GACT_DP_CASE(8);
    GACT_DP_CASE(12);
    GACT_DP_CASE(16);
  }
#undef GACT_DP_CASE
  return (int)cudaErrorInvalidValue;
}
