// S3 and S5: the observation and stencil micro-experiments of
// scripts/obs_micro.py, on (H, W, B) uint16 boards with the environment
// batch innermost.  S4 (make_transpose_kernel) is the KEEP epilogue of the
// view kernel in view_kernels.cu.
//
// Replaces the TPU kernels of scripts/obs_micro.py:
//   S3  make_roll_kernel (:53, launched :77): the agent-centred torus crop
//       v[i][j][b] = x[(i + rs_b) mod H][(j + cs_b) mod W][b] to (vh, vw),
//       there a barrel roll over the shift bits, here a gather from a slab
//       staged in shared memory (the GPU reads any address; ops/obs.py
//       made the same choice).  COMPUTE int32 holds each environment's
//       value in a 32-bit register of its own; uint16 holds two
//       environments' values packed in one register as they are gathered.
//   S5  make_nbsum_kernel (:115, launched :133): sum over planes p of the
//       3x3 torus neighbour sum of x + p, at the width of int32, uint16 or
//       uint8, wrapping there.  The narrow widths are SIMD within a
//       register: two uint16 lanes (__vadd2) or four uint8 lanes (__vadd4)
//       per 32-bit add, the counterpart of the TPU's denser narrow lanes.
//
// Bound: bytes.  S3 reads the view's cells and writes them (4 bytes per
// view cell, 7.4 MB at B = 16384 for a 15x15 view); random shifts make the
// union of a slab's windows nearly the whole board, so its design floor is
// the whole board read and the view written (1802 bytes an environment at
// 26x26, 0.0088 ms).  S5 reads and writes 2 bytes a cell (44 MB at B =
// 16384 on 26x26 boards), with 8 integer operations per cell and plane.
//
// Design.  Both stage a slab of E environments (ops/obs_micro.py
// crop_geometry, nbsum_geometry): the board's (H * W, E) slab in shared
// memory, copied with 16-byte cp.async (slab.cuh), each byte read from
// device memory once.  B % 8 != 0, or a tensor that is not 16-byte aligned,
// takes the same kernel with 2-byte accesses; a board too large for a slab
// of 8 environments the streamed variant, which reads the board in device
// memory.
// S3 gathers each environment's view from the slab: a thread takes view
// cells of 8 neighbouring environments and writes them as one 16-byte
// vector.  Its streamed variant: one thread per (environment or pair, view
// row).
// S5: a thread per (lane word, row part) walks the row in the staged slab,
// sliding a three-column window of each plane's vertical 3-sums (x + p at
// the rows above, at and below) in registers, adds the planes' horizontal
// 3-sums and writes each cell to device memory; the slab holds only the
// cells, 2 bytes an environment.  A lane word holds one environment
// (int32), two (uint16, __vadd2) or four (uint8, __vadd4).  Every plane's
// stencil is computed: the plane constants are opaque to the compiler.
// The streamed variant is the same walk on the board in device memory,
// one thread per (lane word, row).
#include <cuda_runtime.h>

#include <cstdint>

#include "slab.cuh"

namespace {

using safelife::cp_async_wait_all;
using safelife::stage;
using safelife::store16;

constexpr int THREADS = 128;

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

// ---- S3: the view crop ----------------------------------------------------

// Limits of the staged launch (ops/obs_micro.py crop_geometry): a slab of
// at most CROP_MAX_ENVS environments, a multiple of 8, and CROP_THREADS
// threads a block.
constexpr int CROP_MAX_ENVS = 32;
constexpr int CROP_THREADS = 256;

template <bool PAIR>
__global__ void __launch_bounds__(CROP_THREADS)
    staged_crop_kernel(const uint16_t* __restrict__ x,
                       const int32_t* __restrict__ si,
                       uint16_t* __restrict__ out, int H, int W, int B, int vh,
                       int vw, int E, int vec) {
  extern __shared__ __align__(16) uint16_t slab[];
  // Per environment: the row and column shift, reduced onto the board.
  __shared__ int shift[2][CROP_MAX_ENVS];
  const int t = threadIdx.x;
  const long long BB = B;
  const long long b0 = static_cast<long long>(blockIdx.x) * E;
  const int lanes = static_cast<int>(min(BB - b0, 0LL + E));
  if (t < lanes) {
    shift[0][t] = floor_mod(si[b0 + t], H);
    shift[1][t] = floor_mod(si[BB + b0 + t], W);
  }
  stage(slab, x + b0, H * W, E, lanes, BB, vec != 0);
  cp_async_wait_all();
  __syncthreads();
  const int nv = vh * vw;
  // The cell of view pixel (ii, jj) of environment k, ii < H and jj < W.
  auto cell = [&](int k, int rs, int cs, int ii, int jj) -> uint32_t {
    int r = rs + ii;
    r -= r >= H ? H : 0;
    int c = cs + jj;
    c -= c >= W ? W : 0;
    return slab[(r * W + c) * E + k];
  };
  if (vec) {
    const int G = E >> 3, g = t % G, step = CROP_THREADS / G;
    if (g * 8 >= lanes) return;
    int rs[8], cs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      rs[k] = shift[0][g * 8 + k];
      cs[k] = shift[1][g * 8 + k];
    }
    const long long stride = step * BB;
    uint16_t* dst = out + (t / G) * BB + b0 + g * 8;
    for (int v = t / G; v < nv; v += step, dst += stride) {
      const int i = v / vw, j = v - i * vw;
      const int ii = i % H, jj = j % W;
      uint32_t w[4];
      if (PAIR) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = cell(g * 8 + 2 * k, rs[2 * k], cs[2 * k], ii, jj) |
                 cell(g * 8 + 2 * k + 1, rs[2 * k + 1], cs[2 * k + 1], ii, jj)
                     << 16;
        }
      } else {
        int val[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          val[k] = static_cast<int>(cell(g * 8 + k, rs[k], cs[k], ii, jj));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = static_cast<uint32_t>(val[2 * k]) |
                 static_cast<uint32_t>(val[2 * k + 1]) << 16;
        }
      }
      store16(dst, make_uint4(w[0], w[1], w[2], w[3]));
    }
  } else {
    const int e = t % E, step = CROP_THREADS / E;
    if (e >= lanes) return;
    const int rs = shift[0][e], cs = shift[1][e];
    const long long stride = step * BB;
    uint16_t* dst = out + (t / E) * BB + b0 + e;
    for (int v = t / E; v < nv; v += step, dst += stride) {
      const int i = v / vw, j = v - i * vw;
      *dst = static_cast<uint16_t>(cell(e, rs, cs, i % H, j % W));
    }
  }
}

// The streamed variant.  PAIR: two neighbouring environments per thread,
// packed into one word.
template <bool PAIR>
__global__ void __launch_bounds__(THREADS)
    streamed_crop_kernel(const uint16_t* __restrict__ x,
                         const int32_t* __restrict__ si,
                         uint16_t* __restrict__ out, int H, int W, int B,
                         int vh, int vw) {
  constexpr int E = PAIR ? 2 : 1;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * E;
  if (b0 >= B) return;
  const long long BB = B;
  const int i = blockIdx.y;
  const int r0 = floor_mod(i + si[b0], H);
  const int cs0 = si[BB + b0];
  if (!PAIR) {
    for (int j = 0; j < vw; ++j) {
      const int c = floor_mod(j + cs0, W);
      const int v = x[(static_cast<long long>(r0) * W + c) * BB + b0];
      out[(static_cast<long long>(i) * vw + j) * BB + b0] =
          static_cast<uint16_t>(v);
    }
    return;
  }
  const bool two = b0 + 1 < B;
  const int r1 = two ? floor_mod(i + si[b0 + 1], H) : 0;
  const int cs1 = two ? si[BB + b0 + 1] : 0;
  // A 4-byte store needs an even offset: B even.
  const bool packed = two && (B & 1) == 0;
  for (int j = 0; j < vw; ++j) {
    uint32_t v = x[(static_cast<long long>(r0) * W + floor_mod(j + cs0, W)) *
                       BB + b0];
    if (two) {
      v |= static_cast<uint32_t>(
               x[(static_cast<long long>(r1) * W + floor_mod(j + cs1, W)) *
                     BB + b0 + 1])
           << 16;
    }
    uint16_t* o = out + (static_cast<long long>(i) * vw + j) * BB + b0;
    if (packed) {
      *reinterpret_cast<uint32_t*>(o) = v;
    } else {
      o[0] = static_cast<uint16_t>(v);
      if (two) o[1] = static_cast<uint16_t>(v >> 16);
    }
  }
}

template <bool PAIR>
int launch_crop(const uint16_t* x, const int32_t* si, uint16_t* out, int H,
                int W, int B, int vh, int vw, int envs, int vector, int staged,
                cudaStream_t stream) {
  if (!staged) {
    if (vector) return static_cast<int>(cudaErrorInvalidValue);
    const int per = PAIR ? 2 : 1;
    const dim3 grid((B + THREADS * per - 1) / (THREADS * per), vh);
    streamed_crop_kernel<PAIR><<<grid, THREADS, 0, stream>>>(x, si, out, H,
                                                             W, B, vh, vw);
    return static_cast<int>(cudaGetLastError());
  }
  if (envs % 8 != 0 || envs > CROP_MAX_ENVS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The wrapper has checked that the slab fits.
  const int smem = H * W * envs * static_cast<int>(sizeof(uint16_t));
  auto kernel = staged_crop_kernel<PAIR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + envs - 1) / envs);
  kernel<<<grid, CROP_THREADS, smem, stream>>>(x, si, out, H, W, B, vh, vw,
                                               envs, vector);
  return static_cast<int>(cudaGetLastError());
}

// ---- S5: the neighbour sum ------------------------------------------------

enum Width { WIDTH_I32 = 0, WIDTH_U16 = 1, WIDTH_U8 = 2 };

// E lanes of width 32 / E bits in one 32-bit word, adding with wrap at
// the lane width.
template <int WIDTH>
struct Lanes;

template <>
struct Lanes<WIDTH_I32> {
  static constexpr int E = 1;
  __device__ static uint32_t add(uint32_t a, uint32_t b) { return a + b; }
  __device__ static uint32_t splat(uint32_t p) { return p; }
  __device__ static uint32_t load(const uint16_t* x) { return x[0]; }
  __device__ static uint32_t load_narrow(const uint16_t* x) { return x[0]; }
  __device__ static void store(uint16_t* o, uint32_t v) {
    o[0] = static_cast<uint16_t>(v);
  }
};

template <>
struct Lanes<WIDTH_U16> {
  static constexpr int E = 2;
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    return __vadd2(a, b);
  }
  __device__ static uint32_t splat(uint32_t p) { return p * 0x00010001u; }
  __device__ static uint32_t load(const uint16_t* x) {
    return *reinterpret_cast<const uint32_t*>(x);
  }
  // The same from 2-byte loads, for a board of any alignment.
  __device__ static uint32_t load_narrow(const uint16_t* x) {
    return x[0] | static_cast<uint32_t>(x[1]) << 16;
  }
  __device__ static void store(uint16_t* o, uint32_t v) {
    *reinterpret_cast<uint32_t*>(o) = v;
  }
};

template <>
struct Lanes<WIDTH_U8> {
  static constexpr int E = 4;
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    return __vadd4(a, b);
  }
  __device__ static uint32_t splat(uint32_t p) { return p * 0x01010101u; }
  // The low byte of each of four uint16 values.
  __device__ static uint32_t load(const uint16_t* x) {
    const uint2 w = *reinterpret_cast<const uint2*>(x);
    return __byte_perm(w.x, w.y, 0x6420);
  }
  __device__ static uint32_t load_narrow(const uint16_t* x) {
    return __byte_perm(x[0] | static_cast<uint32_t>(x[1]) << 16,
                       x[2] | static_cast<uint32_t>(x[3]) << 16, 0x6420);
  }
  // Each byte zero-extended to a uint16.
  __device__ static void store(uint16_t* o, uint32_t v) {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(__byte_perm(v, 0, 0x4140), __byte_perm(v, 0, 0x4342));
  }
};

// A plane's constant p in every lane, opaque to the compiler: it cannot
// fold the planes' sums into one (each plane's stencil is computed).
template <int WIDTH>
__device__ __forceinline__ uint32_t plane_constant(uint32_t p) {
  uint32_t k = Lanes<WIDTH>::splat(p);
  asm("" : "+r"(k));
  return k;
}

// Limits of the staged launch (ops/obs_micro.py nbsum_geometry): a slab of
// at most NB_MAX_ENVS environments, a multiple of 8, and NB_MAX_THREADS
// threads a block.
constexpr int NB_MAX_ENVS = 32;
constexpr int NB_MAX_THREADS = 512;

// One lane word's walk along row r: `len` cells from column `start` (on
// the torus) of sum_p nb3x3(x + p), its cells `step` elements apart in x
// (rows W * step) and `ostep` in out.  A three-column window of each
// plane's vertical 3-sums slides along the row in registers; each column's
// three cells are read from x once, in one access a cell (ALIGNED: x is
// aligned to the lane word) or in 2-byte loads.
template <int WIDTH, int PLANES, bool ALIGNED, typename I>
__device__ __forceinline__ void walk_row(const uint16_t* x, uint16_t* out,
                                         I step, long long ostep, int H,
                                         int W, int r, int start, int len,
                                         const uint32_t (&k)[PLANES]) {
  using L = Lanes<WIDTH>;
  const I row = static_cast<I>(W) * step;
  const uint16_t* up = x + (r == 0 ? H - 1 : r - 1) * row;
  const uint16_t* mid = x + r * row;
  const uint16_t* down = x + (r + 1 == H ? 0 : r + 1) * row;
  uint16_t* const orow = out + r * W * ostep;
  uint32_t next[PLANES];
  auto column = [&](int c) {
    const I at = c * step;
    const uint32_t a = ALIGNED ? L::load(up + at) : L::load_narrow(up + at);
    const uint32_t m = ALIGNED ? L::load(mid + at) : L::load_narrow(mid + at);
    const uint32_t d =
        ALIGNED ? L::load(down + at) : L::load_narrow(down + at);
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      next[p] = L::add(L::add(L::add(a, k[p]), L::add(m, k[p])),
                       L::add(d, k[p]));
    }
  };
  uint32_t left[PLANES], cur[PLANES], first[PLANES];
  column(start == 0 ? W - 1 : start - 1);
#pragma unroll
  for (int p = 0; p < PLANES; ++p) left[p] = next[p];
  column(start);
#pragma unroll
  for (int p = 0; p < PLANES; ++p) cur[p] = first[p] = next[p];
  uint16_t* o = orow + start * ostep;
  for (int i = 0, c = start; i < len; ++i) {
    const int n = c + 1 == W ? 0 : c + 1;
    if (i + 1 < W) {
      column(n);
    } else {
#pragma unroll
      for (int p = 0; p < PLANES; ++p) next[p] = first[p];
    }
    uint32_t acc = 0;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const uint32_t s3 = L::add(L::add(left[p], cur[p]), next[p]);
      acc = p == 0 ? s3 : L::add(acc, s3);
      left[p] = cur[p];
      cur[p] = next[p];
    }
    L::store(o, acc);
    o = n == 0 ? orow : o + ostep;
    c = n;
  }
}

// The staged variant: the block's (H * W, E) slab in shared memory; slots
// threads a lane word take its H * parts row parts in turn and write the
// result to device memory (a cell's E environments are 2E contiguous
// bytes).  Where W is even, each row's walk starts one column further on
// than the row above, so that the rows of one warp read other banks.
template <int WIDTH, int PLANES>
__global__ void __launch_bounds__(NB_MAX_THREADS)
    staged_nbsum_kernel(const uint16_t* __restrict__ x,
                        uint16_t* __restrict__ out, int H, int W, int B,
                        int E, int slots, int parts, int vec) {
  using L = Lanes<WIDTH>;
  extern __shared__ __align__(16) uint16_t slab[];
  const int t = threadIdx.x;
  const long long BB = B;
  const long long b0 = static_cast<long long>(blockIdx.x) * E;
  const int lanes = static_cast<int>(min(BB - b0, 0LL + E));
  stage(slab, x + b0, H * W, E, lanes, BB, vec != 0);
  uint32_t k[PLANES];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) k[p] = plane_constant<WIDTH>(p);
  cp_async_wait_all();
  __syncthreads();
  const int G = E / L::E, g = t % G;
  if (g * L::E >= lanes) return;
  const int skew = W % 2 == 0 ? 1 : 0;
  const int len = (W + parts - 1) / parts;
  for (int u = t / G; u < H * parts; u += slots) {
    const int r = u / parts, from = u % parts * len;
    walk_row<WIDTH, PLANES, true, int>(slab + g * L::E,
                                       out + b0 + g * L::E, E, BB, H, W, r,
                                       (from + skew * r) % W,
                                       min(len, W - from), k);
  }
}

// The streamed variant: one thread per (lane word, row) on the board in
// device memory (2-byte loads: the board may start anywhere), the rows
// above and below read again from L1/L2.
template <int WIDTH, int PLANES>
__global__ void __launch_bounds__(THREADS)
    streamed_nbsum_kernel(const uint16_t* __restrict__ x,
                          uint16_t* __restrict__ out, int H, int W, int B) {
  using L = Lanes<WIDTH>;
  const long long BB = B;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * L::E;
  if (b0 >= B) return;
  uint32_t k[PLANES];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) k[p] = plane_constant<WIDTH>(p);
  walk_row<WIDTH, PLANES, false, long long>(x + b0, out + b0, BB, BB, H,
                                            W, blockIdx.y, 0, W, k);
}

template <int WIDTH, int PLANES>
int launch_nbsum(const uint16_t* x, uint16_t* out, int H, int W, int B,
                 int envs, int slots, int parts, int vector, int staged,
                 cudaStream_t stream) {
  constexpr int LANES = Lanes<WIDTH>::E;
  if (!staged) {
    if (vector) return static_cast<int>(cudaErrorInvalidValue);
    const long long groups = B / LANES;
    const dim3 grid(static_cast<unsigned>((groups + THREADS - 1) / THREADS),
                    H);
    streamed_nbsum_kernel<WIDTH, PLANES>
        <<<grid, THREADS, 0, stream>>>(x, out, H, W, B);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = envs / LANES * slots;
  // At least a thread an environment: stage() copies with every thread.
  if (envs % 8 != 0 || envs > NB_MAX_ENVS || slots < 1 || parts < 1 ||
      parts > W || threads < envs || threads > NB_MAX_THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The slab; the wrapper has checked that it fits.
  const int smem = H * W * envs * static_cast<int>(sizeof(uint16_t));
  auto kernel = staged_nbsum_kernel<WIDTH, PLANES>;
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
  kernel<<<grid, threads, smem, stream>>>(x, out, H, W, B, envs, slots,
                                          parts, vector);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// compute: 0 int32, 1 uint16.  Geometry: envs (slab width E), vector
// (16-byte path), staged.
extern "C" int sl_view_crop(const uint16_t* x, const int32_t* si,
                            uint16_t* out, int H, int W, int B, int vh, int vw,
                            int compute, int envs, int vector, int staged,
                            cudaStream_t stream) {
  if (compute == 0) {
    return launch_crop<false>(x, si, out, H, W, B, vh, vw, envs, vector,
                              staged, stream);
  }
  if (compute == 1) {
    return launch_crop<true>(x, si, out, H, W, B, vh, vw, envs, vector,
                             staged, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// width: 0 int32, 1 uint16, 2 uint8; planes 1 or 4.  B must be a multiple
// of the lanes per word (1, 2 or 4).  Geometry (ops/obs_micro.py
// nbsum_geometry): envs (slab width E), slots (threads a lane word),
// parts (walks a row), vector (16-byte staging), staged.
extern "C" int sl_nb_sum_planes(const uint16_t* x, uint16_t* out, int H, int W,
                                int B, int width, int planes, int envs,
                                int slots, int parts, int vector, int staged,
                                cudaStream_t stream) {
#define SL_NB_SUM(w, p)                                                   \
  if (width == w && planes == p) {                                         \
    return launch_nbsum<w, p>(x, out, H, W, B, envs, slots, parts, vector, \
                              staged, stream);                             \
  }
  SL_NB_SUM(WIDTH_I32, 1)
  SL_NB_SUM(WIDTH_U16, 1)
  SL_NB_SUM(WIDTH_U8, 1)
  SL_NB_SUM(WIDTH_I32, 4)
  SL_NB_SUM(WIDTH_U16, 4)
  SL_NB_SUM(WIDTH_U8, 4)
#undef SL_NB_SUM
  return static_cast<int>(cudaErrorInvalidValue);
}
