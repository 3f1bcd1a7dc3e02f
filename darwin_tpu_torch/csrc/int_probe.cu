// int_probe: sustained int32 op-rate probe for Hopper (sm_90a).
//
// Replaces tools/vpu_probe.py:probe_kernel (the Pallas kernel behind the
// TPU roofline's op-rate ceiling).  Plain PyTorch twin:
// darwin_tpu_torch/tools/vpu_probe.py:probe_plain (same result, exactly).
//
// What it computes: one "program" reads a (384, 128) int32 block, runs one
// of five dependent op chains of 64 reps on every element, all in
// registers, and writes o = x + y back as a (384, 128) block:
//   max    x = max(x, y);          y = y + x
//   add    x = x + y;              y = y ^ x
//   sel    x = (x > y ? y : x) + 1; y = y + 1
//   shift  x = max(rows shifted down by one (row 0 takes 0), y); y = y + x
//   max4   two max chains and two add chains side by side, 32 reps
// `programs` programs run the same block (as the TPU grid does); all write
// the same values.  These are the integer ops the tile DP is made of, so
// the rates divide the DP's op count into its bound on this card.
//
// Arithmetic is two's-complement wraparound: the chains overflow int32
// within 64 reps, signed overflow is undefined in C++, and torch's int32
// wraps.  So values are uint32_t and only max / compare see them signed.
//
// Mapping.  A thread holds R = 12 consecutive rows of one lane (column) in
// registers — 12 independent chains per thread, 24 to 48 live values.  The
// 32 threads of a warp hold the 384 rows of one column, so the row shift
// is a register move inside the thread plus one __shfl_up_sync for the row
// that crosses to the next thread; warp thread 0 takes the 0 of row -1.  A
// thread block is 8 warps = 8 adjacent columns, staged through shared
// memory so that global loads and stores are whole 32-byte sectors; a
// program is 16 such blocks.
//
// Bound: operations (the chain); the block in and out is 2 x 192 KB per
// program against ~6 M integer instructions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 384, LANES = 128, REPS = 64;
constexpr int R = 12;                 // rows per thread; 32 * R == QT
constexpr int COLS = 8;               // columns (warps) per thread block
constexpr int NT = 32 * COLS;
static_assert(32 * R == QT && LANES % COLS == 0, "block geometry");

__device__ __forceinline__ uint32_t smax(uint32_t a, uint32_t b) {
  return (uint32_t)max((int32_t)a, (int32_t)b);
}

template <int MODE>
__global__ void __launch_bounds__(NT)
int_probe_kernel(const int32_t* __restrict__ xin, int32_t* __restrict__ out) {
  __shared__ uint32_t tile[QT * COLS];
  const int col0 = (blockIdx.x % (LANES / COLS)) * COLS;
  for (int i = threadIdx.x; i < QT * COLS; i += NT)
    tile[i] = (uint32_t)xin[(i / COLS) * LANES + col0 + i % COLS];
  __syncthreads();

  const int w = threadIdx.x >> 5;     // column within the block
  const int t = threadIdx.x & 31;     // strip of R rows within the column
  uint32_t x[R], y[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    x[s] = tile[(t * R + s) * COLS + w];
    y[s] = x[s] + 1u;
  }

  if (MODE == 0) {                    // max
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        x[s] = smax(x[s], y[s]);
        y[s] = y[s] + x[s];
      }
  } else if (MODE == 1) {             // add
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        x[s] = x[s] + y[s];
        y[s] = y[s] ^ x[s];
      }
  } else if (MODE == 2) {             // sel
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const bool m = (int32_t)x[s] > (int32_t)y[s];
        x[s] = (m ? y[s] : x[s]) + 1u;
        y[s] = y[s] + 1u;
      }
  } else if (MODE == 3) {             // shift
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep) {
      uint32_t up = __shfl_up_sync(0xffffffffu, x[R - 1], 1);
      if (t == 0) up = 0u;
#pragma unroll
      for (int s = R - 1; s > 0; --s) x[s] = smax(x[s - 1], y[s]);
      x[0] = smax(up, y[0]);
#pragma unroll
      for (int s = 0; s < R; ++s) y[s] = y[s] + x[s];
    }
  } else {                            // max4
    uint32_t c[R], d[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      c[s] = x[s] + 3u;
      d[s] = y[s] ^ 5u;
    }
#pragma unroll
    for (int rep = 0; rep < REPS / 2; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        x[s] = smax(x[s], y[s]);
        y[s] = y[s] + 1u;
        c[s] = smax(c[s], d[s]);
        d[s] = d[s] + 3u;
      }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      x[s] = x[s] + c[s];
      y[s] = y[s] + d[s];
    }
  }

  // each thread overwrites only the tile entries it alone read
#pragma unroll
  for (int s = 0; s < R; ++s) tile[(t * R + s) * COLS + w] = x[s] + y[s];
  __syncthreads();
  for (int i = threadIdx.x; i < QT * COLS; i += NT)
    out[(i / COLS) * LANES + col0 + i % COLS] = (int32_t)tile[i];
}

}  // namespace

// x, out: (384, 128) int32 on the device.  mode: 0 max, 1 add, 2 sel,
// 3 shift, 4 max4.  programs >= 1: how many times the block is computed
// (each program is 16 thread blocks of 256 threads).  Enqueues on `stream`,
// never synchronises; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (nothing launched) for a mode or count outside
// these limits.
extern "C" int int_probe(const int32_t* x, int32_t* out, int mode,
                         int programs, void* stream) {
  if (mode < 0 || mode > 4 || programs < 1 || programs > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const int grid = programs * (LANES / COLS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: int_probe_kernel<0><<<grid, NT, 0, st>>>(x, out); break;
    case 1: int_probe_kernel<1><<<grid, NT, 0, st>>>(x, out); break;
    case 2: int_probe_kernel<2><<<grid, NT, 0, st>>>(x, out); break;
    case 3: int_probe_kernel<3><<<grid, NT, 0, st>>>(x, out); break;
    default: int_probe_kernel<4><<<grid, NT, 0, st>>>(x, out); break;
  }
  return (int)cudaGetLastError();
}
