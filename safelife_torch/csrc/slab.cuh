// Moving slabs of (H, W, B) uint16 boards between device memory and shared
// memory: the block's E environments of every cell, (H * W, E) with the
// environment innermost.  Shared by the staged kernels: K2/K3
// (env_step_kernels.cu), K4-K8 (life_kernels.cu) and S3 (obs_micro.cu).
//
// On the vector path (B % 8 == 0 and every tensor 16-byte aligned) a cell's
// 8 neighbouring environments are one 16-byte access: one cp.async into
// shared memory, one 16-byte store out.  Otherwise 2-byte accesses.
#pragma once

#include <cstdint>

namespace safelife {

__device__ __forceinline__ uint4 load16(const uint16_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 ldg16(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16(uint16_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void cp_async16(uint16_t* smem,
                                           const uint16_t* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copies the block's (H * W, E) slab of a (H, W, B) board (src at the
// block's first environment) into shared memory: one 16-byte cp.async per
// cell and 8 environments on the vector path, else 2-byte loads.
__device__ __forceinline__ void stage(uint16_t* dst,
                                      const uint16_t* __restrict__ src, int n,
                                      int E, int lanes, long long B, bool vec) {
  const int t = threadIdx.x;
  const int T = blockDim.x;
  if (vec) {
    const int G = E >> 3, g = t % G, step = T / G;
    if (g * 8 >= lanes) return;
    const long long stride = step * B;
    src += (t / G) * B + g * 8;
    dst += g * 8;
    for (int cell = t / G; cell < n; cell += step, src += stride) {
      cp_async16(dst + cell * E, src);
    }
  } else {
    const int e = t % E, step = T / E;
    if (e >= lanes) return;
    const long long stride = step * B;
    src += (t / E) * B + e;
    dst += e;
    for (int cell = t / E; cell < n; cell += step, src += stride) {
      dst[cell * E] = *src;
    }
  }
}

// The inverse of stage: writes the block's (H * W, E) slab from shared
// memory to its environments of a (H, W, B) board (dst at the block's first
// environment), 16 bytes a store on the vector path, else 2 bytes.
__device__ __forceinline__ void unstage(uint16_t* __restrict__ dst,
                                        const uint16_t* src, int n, int E,
                                        int lanes, long long B, bool vec) {
  const int t = threadIdx.x;
  const int T = blockDim.x;
  if (vec) {
    const int G = E >> 3, g = t % G, step = T / G;
    if (g * 8 >= lanes) return;
    const long long stride = step * B;
    dst += (t / G) * B + g * 8;
    src += g * 8;
    for (int cell = t / G; cell < n; cell += step, dst += stride) {
      store16(dst, load16(src + cell * E));
    }
  } else {
    const int e = t % E, step = T / E;
    if (e >= lanes) return;
    const long long stride = step * B;
    dst += (t / E) * B + e;
    src += e;
    for (int cell = t / E; cell < n; cell += step, dst += stride) {
      *dst = src[cell * E];
    }
  }
}

}  // namespace safelife
