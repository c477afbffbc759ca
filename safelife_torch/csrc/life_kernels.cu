// K4: standalone spawnless CA advance of (H, W, B) uint16 boards.
//
// Replaces the TPU kernel safelife_tpu/ops/life_pallas.py:_spawnless_kernel
// (advance_spawnless): the single-stencil full rule for boards without
// spawners.  The advance kernel of env_step_kernels.cu inlines the same
// device function (safelife_rule.cuh).
//
// Bound: bytes.  Each cell is read once and written once, 4 bytes per cell
// (177 MB at B = 65536 on 26x26 boards, 0.053 ms at 3.35 TB/s); the rule
// is ~60 integer operations per cell.
//
// Design: one thread per (environment, row), 128 environments per block,
// so a warp reads and writes 64 contiguous bytes per cell.  Each thread
// slides a three-row column sum along its row; the rows above and below
// are reread by neighbouring rows' threads and come from L2.
#include <cuda_runtime.h>

#include "safelife_rule.cuh"

namespace {

__global__ void __launch_bounds__(128)
    spawnless_kernel(const uint16_t* __restrict__ in,
                     uint16_t* __restrict__ out, int H, int W, int B) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int r = blockIdx.y;
  uint16_t* dst = out + static_cast<long long>(r) * W * B + b;
  safelife::advance_row_spawnless(in, r, H, W, B, b, [&](int c, int cell) {
    dst[static_cast<long long>(c) * B] = static_cast<uint16_t>(cell);
  });
}

}  // namespace

extern "C" int sl_advance_spawnless(const uint16_t* in, uint16_t* out, int H,
                                    int W, int B, cudaStream_t stream) {
  const dim3 grid((B + 127) / 128, H);
  spawnless_kernel<<<grid, 128, 0, stream>>>(in, out, H, W, B);
  return static_cast<int>(cudaGetLastError());
}
