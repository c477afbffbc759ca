// S3-S5: the observation and stencil micro-experiments of
// scripts/obs_micro.py, on (H, W, B) uint16 boards with the environment
// batch innermost.
//
// Replaces the TPU kernels of scripts/obs_micro.py:
//   S3  make_roll_kernel (:53, launched :77): the agent-centred torus crop
//       v[i][j][b] = x[(i + rs_b) mod H][(j + cs_b) mod W][b] to (vh, vw),
//       there a barrel roll over the shift bits, here a gather (the GPU
//       reads any address; ops/obs.py made the same choice).  COMPUTE
//       int32 holds one environment's value in a 32-bit register and
//       stores 2 bytes; uint16 holds two environments' values packed in
//       one register and stores them as one 4-byte word.
//   S4  make_transpose_kernel (:89, launched :103): (vh * vw, B) ->
//       (B, vh * vw), a shared-memory tile transpose with the tile held as
//       int32 or as uint16, padded against bank conflicts.
//   S5  make_nbsum_kernel (:115, launched :133): sum over planes p of the
//       3x3 torus neighbour sum of x + p, at the width of int32, uint16 or
//       uint8, wrapping there.  The narrow widths are SIMD within a
//       register: two uint16 lanes (__vadd2) or four uint8 lanes (__vadd4)
//       per 32-bit add, the counterpart of the TPU's denser narrow lanes.
//
// Bound: bytes.  S3 reads the view's cells and writes them (4 bytes per
// view cell, 7.4 MB at B = 16384 for a 15x15 view; the per-environment
// shifts leave the warp's reads scattered, so the kernel moves far more
// sectors than that); S4 reads and writes 2 bytes a cell; S5 reads and
// writes 2 bytes a cell (44 MB at B = 16384 on 26x26 boards), with 8
// integer operations per cell and plane.
//
// Design: one thread per (environment or lane group, row); each thread
// walks its row.  S5 keeps a three-column window of column sums per plane
// in registers; the rows above and below come again from L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

// ---- S3: the view crop ----------------------------------------------------

// PAIR: two neighbouring environments per thread, packed into one word.
template <bool PAIR>
__global__ void __launch_bounds__(THREADS)
    crop_kernel(const uint16_t* __restrict__ x, const int32_t* __restrict__ si,
                uint16_t* __restrict__ out, int H, int W, int B, int vh,
                int vw) {
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

// ---- S4: the view transpose -----------------------------------------------

constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;

template <typename T>
__global__ void __launch_bounds__(TILE * TILE_ROWS)
    transpose_kernel(const uint16_t* __restrict__ in,
                     uint16_t* __restrict__ out, int cells, int B) {
  // One 4-byte bank of padding per row: a column of the tile then lies
  // in 32 different banks.
  constexpr int PAD = 4 / sizeof(T);
  __shared__ T tile[TILE][TILE + PAD];
  const long long BB = B;
  const int tx = threadIdx.x;
  const long long b = static_cast<long long>(blockIdx.x) * TILE + tx;
  const int cell0 = blockIdx.y * TILE;
  for (int k = threadIdx.y; k < TILE; k += TILE_ROWS) {
    const int cell = cell0 + k;
    if (cell < cells && b < B) tile[k][tx] = in[cell * BB + b];
  }
  __syncthreads();
  const int cell = cell0 + tx;
  for (int k = threadIdx.y; k < TILE; k += TILE_ROWS) {
    const long long bk = static_cast<long long>(blockIdx.x) * TILE + k;
    if (cell < cells && bk < B) {
      out[bk * cells + cell] = static_cast<uint16_t>(tile[tx][k]);
    }
  }
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
  // Each byte zero-extended to a uint16.
  __device__ static void store(uint16_t* o, uint32_t v) {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(__byte_perm(v, 0, 0x4140), __byte_perm(v, 0, 0x4342));
  }
};

template <int WIDTH, int PLANES>
__global__ void __launch_bounds__(THREADS)
    nbsum_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                 int H, int W, int B) {
  using L = Lanes<WIDTH>;
  const long long BB = B;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * L::E;
  if (b0 >= B) return;
  const int r = blockIdx.y;
  const long long up = static_cast<long long>(r == 0 ? H - 1 : r - 1) * W;
  const long long mid = static_cast<long long>(r) * W;
  const long long down = static_cast<long long>(r + 1 == H ? 0 : r + 1) * W;

  // Column sums of x + p over the three rows, for every plane p.
  uint32_t next[PLANES];
  auto column = [&](int c) {
    const uint32_t a = L::load(x + (up + c) * BB + b0);
    const uint32_t m = L::load(x + (mid + c) * BB + b0);
    const uint32_t d = L::load(x + (down + c) * BB + b0);
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const uint32_t k = L::splat(p);
      next[p] = L::add(L::add(L::add(a, k), L::add(m, k)), L::add(d, k));
    }
  };
  uint32_t left[PLANES], cur[PLANES], first[PLANES];
  column(W - 1);
#pragma unroll
  for (int p = 0; p < PLANES; ++p) left[p] = next[p];
  column(0);
#pragma unroll
  for (int p = 0; p < PLANES; ++p) cur[p] = first[p] = next[p];
  for (int c = 0; c < W; ++c) {
    if (c + 1 < W) {
      column(c + 1);
    } else {
#pragma unroll
      for (int p = 0; p < PLANES; ++p) next[p] = first[p];
    }
    uint32_t acc = 0;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      acc = L::add(acc, L::add(L::add(left[p], cur[p]), next[p]));
      left[p] = cur[p];
      cur[p] = next[p];
    }
    L::store(out + (mid + c) * BB + b0, acc);
  }
}

template <int WIDTH, int PLANES>
int launch_nbsum(const uint16_t* x, uint16_t* out, int H, int W, int B,
                 cudaStream_t stream) {
  const long long groups = B / Lanes<WIDTH>::E;
  const dim3 grid(static_cast<unsigned>((groups + THREADS - 1) / THREADS), H);
  nbsum_kernel<WIDTH, PLANES><<<grid, THREADS, 0, stream>>>(x, out, H, W, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// compute: 0 int32, 1 uint16.
extern "C" int sl_view_crop(const uint16_t* x, const int32_t* si,
                            uint16_t* out, int H, int W, int B, int vh, int vw,
                            int compute, cudaStream_t stream) {
  const int per = compute == 1 ? 2 : 1;
  const dim3 grid((B + THREADS * per - 1) / (THREADS * per), vh);
  if (compute == 0) {
    crop_kernel<false><<<grid, THREADS, 0, stream>>>(x, si, out, H, W, B, vh,
                                                     vw);
  } else if (compute == 1) {
    crop_kernel<true><<<grid, THREADS, 0, stream>>>(x, si, out, H, W, B, vh,
                                                    vw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sl_view_transpose(const uint16_t* in, uint16_t* out, int cells,
                                 int B, int compute, cudaStream_t stream) {
  const dim3 grid((B + TILE - 1) / TILE, (cells + TILE - 1) / TILE);
  const dim3 block(TILE, TILE_ROWS);
  if (compute == 0) {
    transpose_kernel<int32_t><<<grid, block, 0, stream>>>(in, out, cells, B);
  } else if (compute == 1) {
    transpose_kernel<uint16_t><<<grid, block, 0, stream>>>(in, out, cells, B);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// width: 0 int32, 1 uint16, 2 uint8; planes 1 or 4.  B must be a multiple
// of the lanes per word (1, 2 or 4).
extern "C" int sl_nb_sum_planes(const uint16_t* x, uint16_t* out, int H, int W,
                                int B, int width, int planes,
                                cudaStream_t stream) {
  if (planes == 1) {
    if (width == WIDTH_I32) return launch_nbsum<WIDTH_I32, 1>(x, out, H, W, B, stream);
    if (width == WIDTH_U16) return launch_nbsum<WIDTH_U16, 1>(x, out, H, W, B, stream);
    if (width == WIDTH_U8) return launch_nbsum<WIDTH_U8, 1>(x, out, H, W, B, stream);
  } else if (planes == 4) {
    if (width == WIDTH_I32) return launch_nbsum<WIDTH_I32, 4>(x, out, H, W, B, stream);
    if (width == WIDTH_U16) return launch_nbsum<WIDTH_U16, 4>(x, out, H, W, B, stream);
    if (width == WIDTH_U8) return launch_nbsum<WIDTH_U8, 4>(x, out, H, W, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
