// Plain C interface of the GACT tile kernels (built with nvcc into one
// shared library, loaded with ctypes by darwin_tpu_torch/ops/build.py).
//
// Every entry point enqueues on the given CUDA stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() after its launch
// (0 = launched).  A batch or tile outside the limits below launches
// nothing and returns cudaErrorInvalidValue; an empty batch (B = 0) is
// outside them, so a 0 return always means one kernel launch.

#pragma once
#include <stdint.h>

// Tile limits of gact_dp: at most 4 warps per tile, each lane owning at most
// 16 query rows; the tile's ref codes are staged in shared memory.
#define GACT_QT_MAX 2048
#define GACT_RT_MAX (32 * 1024)

#ifdef __cplusplus
extern "C" {
#endif

// Batched tile DP (gact_dp.cu), B >= 1, 1 <= QT <= GACT_QT_MAX,
// 1 <= RT <= GACT_RT_MAX.  q: (B, QT) and r: (B, RT) uint8 codes 0-4;
// qlen/rlen: (B,) int32 in [0, QT] / [0, RT]; start_end: (B,) uint8.
// sub25: host pointer to the 5x5 substitution matrix, row = query code.
// Outputs (B,) int32 score/qpos/rpos; trace (B, RT, QT) uint8 or NULL:
// written where q < qlen and r < rlen and left as it was elsewhere, but for
// word (0, 0) of a tile with qlen = 0 or rlen = 0, which is written as 0.
// Any scoring is taken.
int gact_dp(const uint8_t* q, const uint8_t* r, const int32_t* qlen,
            const int32_t* rlen, const uint8_t* start_end, int B, int QT,
            int RT, const int32_t* sub25, int gap_open, int gap_extend,
            int long_gap_open, int long_gap_extend, int32_t* score,
            int32_t* qpos, int32_t* rpos, uint8_t* trace, void* stream);

// What gact_dp will launch for a batch of B tiles of QT query rows: S rows
// per lane, W warps per tile.  Launches nothing; 0, or cudaErrorInvalidValue
// outside the limits.
int gact_dp_plan(int B, int QT, int* S, int* W);

// Batched traceback walk (gact_tb.cu), B, QT, RT >= 1.  trace: (B, RT, QT)
// uint8; start_q/start_r: (B,) int32.  rec: (RT, B) int32, ZEROED by the
// caller; q_steps/r_steps: (B,) int32.
int gact_tb(const uint8_t* trace, const int32_t* start_q,
            const int32_t* start_r, int B, int QT, int RT, int max_tb,
            int32_t* rec, int32_t* q_steps, int32_t* r_steps, void* stream);

// The next tile of a speculative chain (gact_next.cu), B, RT, T >= 1,
// 0 <= max_ops <= 2^30, n_ref, n_query >= 1.  rec: (RT, B) int32 walker
// records; lane: (5, B) int64 rows rev, chrom_start, chrom_len,
// q_buf_start, q_len; curr: (2, B) int64 rows curr_ref, curr_q
// (chromosome- and read-relative); ref / query: the code buffers, n_ref /
// n_query codes.  out: (8, B) int64 rows r_start, r_size, q_start, q_size
// of the next tile, the new curr_ref, curr_q, and the advance dr, dq;
// qtile / rtile: (B, T) uint8, the next tile's codes (reversed for a right
// extension, indices clamped into the buffers); sizes: (4, B) int32 rows
// q_size, r_size, q_size - 1, r_size - 1.
int gact_next(const int32_t* rec, const int64_t* lane, const int64_t* curr,
              const uint8_t* ref, int64_t n_ref, const uint8_t* query,
              int64_t n_query, int B, int RT, int T, int stop_thr,
              int max_ops, int64_t* out, uint8_t* qtile, uint8_t* rtile,
              int32_t* sizes, void* stream);

#ifdef __cplusplus
}
#endif
