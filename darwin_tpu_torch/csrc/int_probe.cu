// int_probe: sustained int32 op-rate probe for Hopper (sm_90a).
//
// Replaces tools/vpu_probe.py:probe_kernel (the Pallas kernel behind the
// TPU roofline's op-rate ceiling).  Plain PyTorch twin:
// darwin_tpu_torch/tools/vpu_probe.py:probe_plain (same result, exactly).
//
// What it computes: one "program" reads a (384, 128) int32 block, runs one
// of five dependent op chains of 64 reps on every element, all in
// registers, and gives o = x + y as a (384, 128) block:
//   max    x = max(x, y);          y = y + x
//   add    x = x + y;              y = y ^ x
//   sel    x = (x > y ? y : x) + 1; y = y + 1
//   shift  x = max(rows shifted down by one (row 0 takes 0), y); y = y + x
//   max4   two max chains and two add chains side by side, 32 reps
// `programs` programs compute the same block (as the TPU grid does), so
// one launch is `programs` times the chain.  These are the integer ops the
// tile DP is made of, so the rates divide the DP's op count into its bound
// on this card.
//
// Arithmetic is two's-complement wraparound: the chains overflow int32
// within 64 reps, signed overflow is undefined in C++, and torch's int32
// wraps.  So values are uint32_t and only max / compare see them signed.
//
// Bound: operations (the chain); the block in and out is 2 x 192 KB per
// launch against ~6 M integer instructions per program.
//
// Mapping.  A thread holds R consecutive rows of one lane (column) in
// registers — R independent chains.  TPC = 384 / R threads of a warp hold
// the rows of one column, so the row shift is a register move inside the
// thread plus one __shfl_up_sync (width TPC) for the row that crosses to
// the next thread; the column's first thread takes the 0 of row -1.  A
// thread block holds COLS adjacent columns, a column slice; a program is
// SLICES such slices.
//
// Schedule: persistent blocks.  The grid is as many blocks as the card
// holds at once (grid_of), in whole sets of SLICES, so block b keeps slice
// b % SLICES and runs programs b / SLICES, + grid / SLICES, ... for as
// long as there are programs.  It loads its slice into registers once,
// recomputes the chain from them for every program of its share, and
// writes the last program's result once; every program gives the same
// values.  No shared memory, no barrier: the program loop is the chain
// and a dozen instructions.  Each program's input is x0 + zero x the
// output of the program before: `zero` is a kernel argument the entry
// point sets to 0, so the values do not change, but to the compiler every
// program's chain feeds the next and none can be left out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 384;               // rows of the block
constexpr int LANES = 128;            // its columns
constexpr int REPS = 64;              // chain length
constexpr int R = 12;                 // rows per thread
constexpr int TPC = QT / R;           // threads per column
constexpr int COLS = 8;               // columns per thread block
constexpr int NT = TPC * COLS;        // threads per block
constexpr int SLICES = LANES / COLS;  // blocks per program
static_assert(TPC * R == QT && TPC <= 32 && 32 % TPC == 0 &&
              LANES % COLS == 0, "block geometry");

// The chains' max and add, in C or as PTX (max.s32, add.u32), whichever
// measured faster for the mode (PERF.md): PTX for max, add and shift, which
// the compiler then keeps in fewer registers (31, 32, 46 a thread against
// 46, 48, 60 from C: more blocks an SM); C for sel and max4, whose
// constant adds it folds into three-source adds and add-mins.
template <int MODE>
constexpr bool PTX = MODE == 0 || MODE == 1 || MODE == 3;

template <bool P>
__device__ __forceinline__ uint32_t smax(uint32_t a, uint32_t b) {
  if (!P) return (uint32_t)max((int32_t)a, (int32_t)b);
  uint32_t r;
  asm("max.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
template <bool P>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if (!P) return a + b;
  uint32_t r;
  asm("add.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// One program on a thread's R rows (t: the thread's strip in its column):
// x in, x + y out.
template <int MODE>
__device__ __forceinline__ void chain(uint32_t (&x)[R], int t) {
  constexpr bool P = PTX<MODE>;
  uint32_t y[R];
#pragma unroll
  for (int s = 0; s < R; ++s) y[s] = add<P>(x[s], 1u);
  if (MODE == 0) {                    // max
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        x[s] = smax<P>(x[s], y[s]);
        y[s] = add<P>(y[s], x[s]);
      }
  } else if (MODE == 1) {             // add
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        x[s] = add<P>(x[s], y[s]);
        y[s] = y[s] ^ x[s];
      }
  } else if (MODE == 2) {             // sel
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const bool m = (int32_t)x[s] > (int32_t)y[s];
        x[s] = add<P>(m ? y[s] : x[s], 1u);
        y[s] = add<P>(y[s], 1u);
      }
  } else if (MODE == 3) {             // shift
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep) {
      uint32_t up = __shfl_up_sync(0xffffffffu, x[R - 1], 1, TPC);
      if (t == 0) up = 0u;
#pragma unroll
      for (int s = R - 1; s > 0; --s) x[s] = smax<P>(x[s - 1], y[s]);
      x[0] = smax<P>(up, y[0]);
#pragma unroll
      for (int s = 0; s < R; ++s) y[s] = add<P>(y[s], x[s]);
    }
  } else {                            // max4
    uint32_t c[R], d[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      c[s] = add<P>(x[s], 3u);
      d[s] = y[s] ^ 5u;
    }
#pragma unroll
    for (int rep = 0; rep < REPS / 2; ++rep)
#pragma unroll
      for (int s = 0; s < R; ++s) {
        x[s] = smax<P>(x[s], y[s]);
        y[s] = add<P>(y[s], 1u);
        c[s] = smax<P>(c[s], d[s]);
        d[s] = add<P>(d[s], 3u);
      }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      x[s] = add<P>(x[s], c[s]);
      y[s] = add<P>(y[s], d[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < R; ++s) x[s] = add<P>(x[s], y[s]);
}

template <int MODE>
__global__ void __launch_bounds__(NT)
int_probe_kernel(const int32_t* __restrict__ xin, int32_t* __restrict__ out,
                 int programs, uint32_t zero) {
  const int step = gridDim.x / SLICES;          // programs in flight
  int p = blockIdx.x / SLICES;
  if (p >= programs) return;
  const int t = threadIdx.x % TPC;
  const int off = t * R * LANES + blockIdx.x % SLICES * COLS +
                  threadIdx.x / TPC;
  uint32_t x0[R], x[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    x0[s] = (uint32_t)xin[off + s * LANES];
    x[s] = 0u;
  }
#pragma unroll 1
  for (;;) {
    // x = x0 + zero * (the program before's x + y): x0 at run time, but to
    // the compiler each program's input is the output of the one before,
    // so it must compute every program's chain inside the loop — no
    // hoisting one chain out, no sinking only the last one past the exit.
    // In PTX, so that the compiler's loop analysis sees an opaque value
    // and does not expand the 64-rep max / add expressions behind it
    // (expanded from the loop's counter, the build ran past 15 minutes).
#pragma unroll
    for (int s = 0; s < R; ++s)
      asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(x[s])
          : "r"(x[s]), "r"(zero), "r"(x0[s]));
    chain<MODE>(x, t);
    p += step;
    if (p >= programs) break;
  }
#pragma unroll
  for (int s = 0; s < R; ++s) out[off + s * LANES] = (int32_t)x[s];
}

// Blocks of one launch: as many as the card holds at once (this mode's
// blocks per SM times the SMs), rounded down to whole sets of SLICES so
// that a block keeps one slice, and no more than the programs need.
template <int MODE>
cudaError_t grid_of(int programs, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, int_probe_kernel<MODE>, NT, 0);
  if (e != cudaSuccess) return e;
  int lanes = per_sm * sms / SLICES;
  if (lanes < 1) lanes = 1;
  *blocks = SLICES * (programs < lanes ? programs : lanes);
  return cudaSuccess;
}

template <int MODE>
int run(const int32_t* x, int32_t* out, int programs, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t e = grid_of<MODE>(programs, &blocks);
  if (e != cudaSuccess) return (int)e;
  int_probe_kernel<MODE><<<blocks, NT, 0, st>>>(x, out, programs, 0u);
  return (int)cudaGetLastError();
}

template <int MODE>
int blocks_of(int programs) {
  int blocks = 0;
  const cudaError_t e = grid_of<MODE>(programs, &blocks);
  return e == cudaSuccess ? blocks : -(int)e;
}

bool valid(int mode, int programs) {
  return mode >= 0 && mode <= 4 && programs >= 1 && programs <= (1 << 24);
}

}  // namespace

// x, out: (384, 128) int32 on the device.  mode: 0 max, 1 add, 2 sel,
// 3 shift, 4 max4.  programs >= 1: how many times the block is computed.
// Enqueues on `stream`, never synchronises; returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue (nothing launched) for a mode
// or count outside these limits.
extern "C" int int_probe(const int32_t* x, int32_t* out, int mode,
                         int programs, void* stream) {
  if (!valid(mode, programs)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: return run<0>(x, out, programs, st);
    case 1: return run<1>(x, out, programs, st);
    case 2: return run<2>(x, out, programs, st);
    case 3: return run<3>(x, out, programs, st);
    default: return run<4>(x, out, programs, st);
  }
}

// The blocks int_probe launches for (mode, programs) on the current
// device, each of NT threads; minus a CUDA error code on failure, or -1
// for a mode or count outside int_probe's limits.
extern "C" int int_probe_grid(int mode, int programs) {
  if (!valid(mode, programs)) return -(int)cudaErrorInvalidValue;
  switch (mode) {
    case 0: return blocks_of<0>(programs);
    case 1: return blocks_of<1>(programs);
    case 2: return blocks_of<2>(programs);
    case 3: return blocks_of<3>(programs);
    default: return blocks_of<4>(programs);
  }
}
