// R1: the int32 sum of a uint8 or uint16 tensor of any shape, the way the
// bench and the measurement entry points consume every observation
// (safelife_torch/bench.py run_steps, scripts/__init__.py obs_sum).
//
// Not a TPU kernel: the reference's consumer, bench.py:215
// `ts.obs.astype(jnp.int32).sum()`, is one fused read under XLA.  The
// plain PyTorch expression first writes an int32 copy of the whole
// observation (221 MB at B = 65536 with 15 channels of a 15x15 view) and
// then reduces the copy.
//
// Bound: bytes.  Each byte of the tensor is read once, 4 bytes written
// (0.066 ms for 221 MB at 3.35 TB/s); the additions are one instruction for
// every four bytes.
//
// Design: each thread reads 16-byte vectors through the non-allocating load
// path (ld.global.nc.L1::no_allocate), four in flight, over a grid-stride
// loop, and accumulates four bytes an instruction: __dp4a(word, 0x01010101)
// for uint8, __dp2a_lo(word, 0x0101) (two uint16 halves) for uint16.  The
// ragged head before the first 16-byte boundary and the tail after the last
// are read as scalars by block 0.  A warp reduces with shuffles, the block
// through shared memory, and one atomicAdd a block adds into a zeroed int32
// scalar.  All sums are modulo 2^32 in unsigned arithmetic: integer
// addition is associative, so the result equals torch's int32 sum bit for
// bit, wrap included.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Threads a block (a multiple of 32) and vectors in flight a thread.
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The sum of the elements of one 32-bit word added to acc.
template <int ELEM>
__device__ __forceinline__ uint32_t add_word(uint32_t w, uint32_t acc) {
  if (ELEM == 1) return __dp4a(w, 0x01010101u, acc);
  return __dp2a_lo(w, 0x0101u, acc);
}

template <int ELEM>
__device__ __forceinline__ uint32_t add_vec(uint4 v, uint32_t acc) {
  acc = add_word<ELEM>(v.x, acc);
  acc = add_word<ELEM>(v.y, acc);
  acc = add_word<ELEM>(v.z, acc);
  return add_word<ELEM>(v.w, acc);
}

template <int ELEM>
__device__ __forceinline__ uint32_t element(const unsigned char* p) {
  if (ELEM == 1) return *p;
  return *reinterpret_cast<const uint16_t*>(p);
}

// x: the tensor's first byte; n: its elements.  head: the elements before
// the first 16-byte boundary (at most n); vecs: the whole 16-byte vectors
// after them.
template <int ELEM>
__global__ void __launch_bounds__(THREADS)
    sum_kernel(const unsigned char* __restrict__ x, long long n, int head,
               long long vecs, int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[THREADS / 32];
  const int t = threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(x + head * ELEM);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long i = static_cast<long long>(blockIdx.x) * THREADS + t;
  uint32_t acc = 0;
  for (; i + (UNROLL - 1) * stride < vecs; i += UNROLL * stride) {
    uint4 w[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) w[k] = load_nc(v + i + k * stride);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) acc = add_vec<ELEM>(w[k], acc);
  }
  for (; i < vecs; i += stride) acc = add_vec<ELEM>(load_nc(v + i), acc);
  if (blockIdx.x == 0) {
    // The head, and the tail after the last whole vector.
    const long long tail0 = head + vecs * (16 / ELEM);
    const long long tail = n - tail0;
    if (t < head) acc += element<ELEM>(x + t * ELEM);
    if (t < tail) acc += element<ELEM>(x + (tail0 + t) * ELEM);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((t & 31) == 0) warp_sums[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    acc = t < THREADS / 32 ? warp_sums[t] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (t == 0) atomicAdd(reinterpret_cast<unsigned int*>(out), acc);
  }
}

}  // namespace

// elem: 1 (uint8) or 2 (uint16); out: a zeroed int32 scalar; blocks: the
// grid (ops/obs.py sum_geometry).  The head and tail are at most 15
// elements each, read by block 0's first threads.
extern "C" int sl_obs_sum(const void* x, long long n, int elem, int blocks,
                          int32_t* out, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if ((elem != 1 && elem != 2) || addr % elem != 0 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long skip = static_cast<long long>((16 - addr % 16) % 16) / elem;
  const int head = static_cast<int>(skip < n ? skip : n);
  const long long vecs = (n - head) * elem / 16;
  const auto* p = static_cast<const unsigned char*>(x);
  if (elem == 1) {
    sum_kernel<1><<<blocks, THREADS, 0, stream>>>(p, n, head, vecs, out);
  } else {
    sum_kernel<2><<<blocks, THREADS, 0, stream>>>(p, n, head, vecs, out);
  }
  return static_cast<int>(cudaGetLastError());
}
