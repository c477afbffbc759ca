// S4 and the observation unpack: the agent-centred view that the advance
// kernel writes as (vh, vw, B) uint16 words, made batch-major in one pass.
//
// Replaces:
//   S4  scripts/obs_micro.py make_transpose_kernel (:89, launched :103):
//       (vh * vw, B) -> (B, vh * vw), the KEEP epilogue (C = 0);
//   and, not a TPU kernel, the XLA part of the step that follows the
//   Pallas advance (safelife_tpu/ops/obs.py:79-87 unpack_channels,
//   jnp.transpose(view, (2, 0, 1)) then shift-and-mask inside the jitted
//   step, env/env.py:346-351): the UNPACK epilogue, (B, vh, vw, C) uint8
//   with channel c of cell (i, j) of environment b equal to
//   (view[i, j, b] >> bit[c]) & 1, for any list of C <= 16 bit positions.
//
// Bound: bytes.  The view is read once (2 bytes a cell) and the output
// written once: 2 bytes a cell (KEEP) or C (UNPACK; at B = 65536, 15x15,
// C = 15: 29.5 MB read and 221 MB written, 0.075 ms at 3.35 TB/s).
//
// Design: a block owns E environments (ops/obs.py view_geometry; 16 or 32,
// a multiple of 16 wherever the slab fits, so that each block's output is
// one contiguous range of device memory that starts on a 16-byte
// boundary).
//   1. stage the block's (vh * vw, E) slab with 16-byte cp.async
//      (slab.cuh), each byte read from device memory once;
//   2. transpose it in shared memory to (E, vh * vw): the KEEP output;
//   3. UNPACK: a thread takes 16 consecutive cells of that tile (two
//      16-byte loads) and writes their 16 * C channel bytes as C 16-byte
//      vectors into an output buffer in shared memory; a byte is its
//      cell's word shifted by its channel's bit (a kernel parameter) and
//      masked, and with C a template constant each byte's cell and channel
//      are known at compile time;
//   4. write the block's range out with one Hopper bulk copy
//      (cp.async.bulk.global.shared::cta) issued by one thread (as fast as
//      16-byte vector stores by all threads, which it replaced); the ragged
//      tail of a range that is not a multiple of 16 bytes in narrow
//      stores.
// B % 8 != 0 or a misaligned view takes 2-byte staging; a block range of
// E * vh * vw * C bytes (2 a cell for KEEP) that is not a multiple of 16,
// narrow stores (1 byte for UNPACK, 2 for KEEP), all in the same kernel.  A view too large for a
// slab of 8 environments takes the streamed variant: one thread per
// (environment, cell) on the view in device memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "slab.cuh"

namespace {

using safelife::cp_async_wait_all;
using safelife::stage;

// Limits of the launch (ops/obs.py view_geometry): VIEW_THREADS threads a
// staged block, a slab of E environments dividing it, at most MAX_CHANNELS
// channels; the streamed variant runs STREAM_THREADS environments a block.
constexpr int VIEW_THREADS = 256;
constexpr int MAX_ENVS = 32;
constexpr int MAX_CHANNELS = 16;
constexpr int STREAM_THREADS = 128;

// Channel c's bit in a 32-bit word of two cells: shift[h][c] is its bit
// position plus 16 for the cell in the high half (h = 1).
struct Channels {
  unsigned char shift[2][MAX_CHANNELS];
};

// Bytes [0, nbytes) of shared src to dst: with bulk, one bulk copy of the
// whole 16-byte vectors, then elements of T for the rest.
template <typename T>
__device__ __forceinline__ void write_out(unsigned char* __restrict__ dst,
                                          const unsigned char* src,
                                          int nbytes, int bulk) {
  const int t = threadIdx.x;
  const int whole = bulk ? nbytes & ~15 : 0;
  if (t == 0 && whole) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;\n"
        "cp.async.bulk.wait_group.read 0;\n" ::"l"(dst),
        "r"(s), "r"(whole)
        : "memory");
  }
  const int n = static_cast<int>(sizeof(T));
  for (int i = whole / n + t; i < nbytes / n; i += VIEW_THREADS) {
    reinterpret_cast<T*>(dst)[i] = reinterpret_cast<const T*>(src)[i];
  }
}

// C = 0: KEEP, (B, vh * vw) uint16.  C = 1 .. 16: UNPACK, (B, vh * vw, C)
// uint8.
template <int C>
__global__ void __launch_bounds__(VIEW_THREADS)
    staged_view_kernel(const uint16_t* __restrict__ view,
                       unsigned char* __restrict__ out, int cells, int B,
                       int E, int vec, int bulk, const Channels ch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* slab = reinterpret_cast<uint16_t*>(smem);
  uint16_t* tile = slab + cells * E;
  const int t = threadIdx.x;
  const long long BB = B;
  const long long b0 = static_cast<long long>(blockIdx.x) * E;
  const int lanes = static_cast<int>(min(BB - b0, 0LL + E));
  stage(slab, view + b0, cells, E, lanes, BB, vec != 0);
  cp_async_wait_all();
  __syncthreads();
  {
    // Lane = environment: a warp reads consecutive words of one cell.
    const int e = t % E, step = VIEW_THREADS / E;
    if (e < lanes) {
      for (int cell = t / E; cell < cells; cell += step) {
        tile[e * cells + cell] = slab[cell * E + e];
      }
    }
  }
  const int units = lanes * cells;
  unsigned char* dst = out + b0 * cells * (C ? C : 2);
  if constexpr (C == 0) {
    if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    write_out<uint16_t>(dst, reinterpret_cast<unsigned char*>(tile),
                        units * 2, bulk);
  } else {
    // The output buffer follows the tile; the tile's size is a multiple of
    // 16 bytes (E a multiple of 8).
    unsigned char* obuf = reinterpret_cast<unsigned char*>(tile + cells * E);
    __syncthreads();
    const int groups = (units + 15) / 16;
    for (int k = t; k < groups; k += VIEW_THREADS) {
      // 16 cells in output order; past the last unit the values are not
      // written out.
      const uint4* src = reinterpret_cast<const uint4*>(tile + 16 * k);
      const uint4 lo = src[0], hi = src[1];
      const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
      uint4* o = reinterpret_cast<uint4*>(obuf + 16 * C * k);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        uint32_t w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t word = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // Byte q of the group: channel q % C of its cell q / C.
            const int q = 16 * j + 4 * m + i, cell = q / C;
            word |= ((words[cell >> 1] >> ch.shift[cell & 1][q % C]) & 1u)
                    << (8 * i);
          }
          w[m] = word;
        }
        o[j] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    write_out<unsigned char>(dst, obuf, units * C, bulk);
  }
}

// The streamed variant: one thread per (environment, cell), environments
// fastest, so the view is read in whole warps.
template <bool UNPACK>
__global__ void __launch_bounds__(STREAM_THREADS)
    streamed_view_kernel(const uint16_t* __restrict__ view,
                         unsigned char* __restrict__ out, int cells, int B,
                         int C, const Channels ch) {
  const long long b =
      static_cast<long long>(blockIdx.x) * STREAM_THREADS + threadIdx.x;
  if (b >= B) return;
  const int cell = blockIdx.y;
  const uint32_t v = view[cell * static_cast<long long>(B) + b];
  const long long u = b * cells + cell;
  if (!UNPACK) {
    reinterpret_cast<uint16_t*>(out)[u] = static_cast<uint16_t>(v);
    return;
  }
  for (int c = 0; c < C; ++c) {
    out[u * C + c] = static_cast<unsigned char>((v >> ch.shift[0][c]) & 1u);
  }
}

template <int C>
int launch_staged(const uint16_t* view, unsigned char* out, int cells, int B,
                  int envs, int vector, int bulk, const Channels& ch,
                  cudaStream_t stream) {
  // Slab and tile, then for UNPACK the output buffer with room for the
  // last group of 16 cells (ops/obs.py view_smem); the wrapper has checked
  // that they fit.
  const int smem = cells * envs * (4 + C) + 16 * C;
  auto kernel = staged_view_kernel<C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + envs - 1) / envs);
  kernel<<<grid, VIEW_THREADS, smem, stream>>>(view, out, cells, B, envs,
                                               vector, bulk, ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C: 0 for KEEP, else the channels, their bit positions 4 bits each in
// chans (channel c at bits 4c .. 4c + 3).  Geometry (ops/obs.py
// view_geometry): envs (slab width E), vector (16-byte staging), bulk (the
// bulk copy, else narrow stores), staged.
extern "C" int sl_view(const uint16_t* view, void* out, int vh, int vw, int B,
                       int C, unsigned long long chans, int envs, int vector,
                       int bulk, int staged, cudaStream_t stream) {
  const int cells = vh * vw;
  if (C < 0 || C > MAX_CHANNELS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Channels ch{};
  for (int c = 0; c < C; ++c) {
    const unsigned bit = (chans >> (4 * c)) & 15u;
    ch.shift[0][c] = static_cast<unsigned char>(bit);
    ch.shift[1][c] = static_cast<unsigned char>(bit + 16);
  }
  auto* o = static_cast<unsigned char*>(out);
  if (!staged) {
    if (vector || bulk || cells > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((B + STREAM_THREADS - 1) / STREAM_THREADS, cells);
    if (C == 0) {
      streamed_view_kernel<false>
          <<<grid, STREAM_THREADS, 0, stream>>>(view, o, cells, B, C, ch);
    } else {
      streamed_view_kernel<true>
          <<<grid, STREAM_THREADS, 0, stream>>>(view, o, cells, B, C, ch);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (envs % 8 != 0 || envs > MAX_ENVS || VIEW_THREADS % envs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SL_VIEW_CASE(n)                                                     \
  case n:                                                                   \
    return launch_staged<n>(view, o, cells, B, envs, vector, bulk, ch,    \
                            stream);
  switch (C) {
    SL_VIEW_CASE(0)
    SL_VIEW_CASE(1)
    SL_VIEW_CASE(2)
    SL_VIEW_CASE(3)
    SL_VIEW_CASE(4)
    SL_VIEW_CASE(5)
    SL_VIEW_CASE(6)
    SL_VIEW_CASE(7)
    SL_VIEW_CASE(8)
    SL_VIEW_CASE(9)
    SL_VIEW_CASE(10)
    SL_VIEW_CASE(11)
    SL_VIEW_CASE(12)
    SL_VIEW_CASE(13)
    SL_VIEW_CASE(14)
    SL_VIEW_CASE(15)
    SL_VIEW_CASE(16)
  }
#undef SL_VIEW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
