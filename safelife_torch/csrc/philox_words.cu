// T1: the field of Philox words, the counterpart of the TPU's in-core PRNG
// probe (tests/test_fused_step.py:256 _interpret_prng_is_zero.kern:
// pltpu.prng_seed, then pltpu.prng_random_bits).  Each (H, W, B) cell gets
// the first word of philox4x32 at counter (r * W + c, b, 0, 0) and key
// (seed, 0), the word the CA kernels draw their spawns from; the seed is
// an int32 on the device.  The bits are not the TPU's: the port's spawn
// draw is Philox (philox.cuh).
//
// Bound: launch latency at the probe's sizes (4 bytes written per word);
// at large fields the ten Philox rounds (about 90 integer operations a
// word) and the write.
//
// Design: one thread per (environment, cell), 128 environments per block
// and one cell per grid row, so a warp writes 128 contiguous bytes.
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using namespace safelife;

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    words_kernel(const int32_t* __restrict__ seed, int32_t* __restrict__ out,
                 int B) {
  const long long b = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (b >= B) return;
  const uint32_t cell = blockIdx.y;
  out[cell * static_cast<long long>(B) + b] = static_cast<int32_t>(
      philox_word(static_cast<uint32_t>(seed[0]), cell,
                  static_cast<uint32_t>(b)));
}

// T1's launch floor: the same grid, block and arguments, and no work but
// the bound check (timed beside T1 by chip_smoke.py).
__global__ void __launch_bounds__(THREADS)
    floor_kernel(const int32_t* __restrict__ seed, int32_t* __restrict__ out,
                 int B) {
  const long long b = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (b >= B) return;
}

}  // namespace

extern "C" int sl_philox_words(const int32_t* seed, int32_t* out, int H,
                               int W, int B, cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS, H * W);
  words_kernel<<<grid, THREADS, 0, stream>>>(seed, out, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sl_philox_floor(const int32_t* seed, int32_t* out, int H,
                               int W, int B, cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS, H * W);
  floor_kernel<<<grid, THREADS, 0, stream>>>(seed, out, B);
  return static_cast<int>(cudaGetLastError());
}
