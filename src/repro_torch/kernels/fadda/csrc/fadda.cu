// Strictly ordered f32 accumulation (SVE fadda) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fadda_pallas (src/repro/kernels/fadda/kernel.py,
// body _fadda_kernel), and computes in the same pass the row-wise inclusive
// ordered scan that core.reductions.fadda_scan is in the JAX package (a
// lax.scan there, on the top-p path of every stochastic decode step).
//
// What it computes.  x (rows, ld) f32, per-row n and init -> out (rows,) and,
// when asked, partials (rows, v): partials[r, i] is the accumulator after
// elements 0..i of row r, each added in ascending element order with
// round-to-nearest (__fadd_rn: no contraction, no reassociation), inactive
// elements (the whilelt predicate i < n[r] is false) adding +0.0 -- not
// skipped, as the JAX versions mask them to 0.  out[r] = partials[r, v - 1].
// The results equal the sequential scalar loop bit for bit, at every tile
// width (the VL): the tile is only how the row is staged.
//
// What bounds it on an H100.  Not bytes: the adds form one dependency chain
// per row, and any tree would re-associate and change the bits (the paper's
// point about fadda, §2.4: its cost is proportional to VL).  The floor is
// min(n, v) dependent FADDs per row at ~4 cycles each; rows run in parallel
// on their own SMs.  At the top-p call, (8, 50304) at 1.98 GHz: ~0.10 ms.
//
// What this design does about it.  Keep everything else off the chain.  One
// CTA per row: warps 1-3 stage block-wide tiles of the row into a ring of
// kStages shared buffers with cp.async (16-byte copies where the row is
// 16-byte aligned), kStages - 1 tiles ahead of the walker; one thread (warp
// 0, lane 0) walks each tile in element order, reading 8 values ahead into
// registers so that shared-memory latency is not on the chain, and writes
// each partial into one of two shared partial tiles, which warps 1-3 store
// to device memory coalesced while the walker walks the next tile.  Elements
// past n are not loaded: their partials are the final accumulator plus +0.0,
// written after the walk.
//
// C interface for ctypes: pointers and the stream are void*; the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // warp 0: the walker; warps 1-3: loads and stores
constexpr int kLoaders = kThreads - 32;
constexpr int kStages = 4;      // input tiles in flight
constexpr int kMaxBlock = 8192; // (kStages + 2) * 8192 floats = 192 KB of shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy of which the first src_bytes are read, the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The chain over one tile: m elements of xt into acc, partials into pt.
template <bool kPartials>
__device__ __forceinline__ float walk_tile(const float* __restrict__ xt, float* __restrict__ pt,
                                           int m, float acc) {
  const int m8 = m & ~7;
  int j = 0;
  if (m8 > 0) {
    float4 a = *reinterpret_cast<const float4*>(xt);
    float4 b = *reinterpret_cast<const float4*>(xt + 4);
    for (; j < m8; j += 8) {
      float4 na = a, nb = b;
      if (j + 8 < m8) {  // the next 8 values, read while these 8 are added
        na = *reinterpret_cast<const float4*>(xt + j + 8);
        nb = *reinterpret_cast<const float4*>(xt + j + 12);
      }
      float4 pa, pb;
      acc = __fadd_rn(acc, a.x); pa.x = acc;
      acc = __fadd_rn(acc, a.y); pa.y = acc;
      acc = __fadd_rn(acc, a.z); pa.z = acc;
      acc = __fadd_rn(acc, a.w); pa.w = acc;
      acc = __fadd_rn(acc, b.x); pb.x = acc;
      acc = __fadd_rn(acc, b.y); pb.y = acc;
      acc = __fadd_rn(acc, b.z); pb.z = acc;
      acc = __fadd_rn(acc, b.w); pb.w = acc;
      if (kPartials) {
        *reinterpret_cast<float4*>(pt + j) = pa;
        *reinterpret_cast<float4*>(pt + j + 4) = pb;
      }
      a = na;
      b = nb;
    }
  }
  for (; j < m; ++j) {
    acc = __fadd_rn(acc, xt[j]);
    if (kPartials) pt[j] = acc;
  }
  return acc;
}

template <bool kVec, bool kPartials>
__global__ void __launch_bounds__(kThreads)
    fadda_rows_kernel(const float* __restrict__ x, long long ld, const int* __restrict__ n_rows,
                      const float* __restrict__ init, float* __restrict__ partials,
                      float* __restrict__ out, int v, int block) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // kStages tiles of the row
  float* ps = smem + kStages * block;     // 2 tiles of partials
  __shared__ float final_acc;

  const int row = blockIdx.x;
  const float* xr = x + row * ld;
  float* pr = kPartials ? partials + (long long)row * v : nullptr;
  const int len = max(0, min(n_rows[row], v));   // the active prefix: whilelt(0, n)
  const int tiles = (len + block - 1) / block;
  const int loader = (int)threadIdx.x - 32;      // < 0 in warp 0

  // Loaders: copy tile t (its active part) into its ring slot; one commit
  // group per call, empty past the last tile, so that waiting for all but
  // kStages - 2 groups always means tile t has landed.
  auto load_tile = [&](int t) {
    if (t < tiles) {
      float* dst = xs + (t % kStages) * block;
      const float* src = xr + (long long)t * block;
      const int m = min(block, len - t * block);
      if (kVec) {
        for (int c = loader * 4; c < m; c += kLoaders * 4)
          cp_async16(dst + c, src + c, 4 * min(4, m - c));
      } else {
        for (int c = loader; c < m; c += kLoaders) cp_async4(dst + c, src + c);
      }
    }
    cp_async_commit();
  };
  auto store_partials = [&](int t) {
    const float* pt = ps + (t & 1) * block;
    float* dst = pr + (long long)t * block;
    const int m = min(block, len - t * block);
    for (int c = loader; c < m; c += kLoaders) dst[c] = pt[c];
  };

  if (loader >= 0)
    for (int t = 0; t < kStages - 1; ++t) load_tile(t);
  float acc = init[row];
  for (int t = 0; t < tiles; ++t) {
    if (loader >= 0) cp_async_wait<kStages - 2>();   // tile t has landed
    // tile t is visible to the walker; the walk of tile t - 1 is done, so its
    // partials are complete and its ring slot is free
    __syncthreads();
    if (threadIdx.x == 0) {
      acc = walk_tile<kPartials>(xs + (t % kStages) * block, ps + (t & 1) * block,
                                 min(block, len - t * block), acc);
    } else if (loader >= 0) {
      if (kPartials && t > 0) store_partials(t - 1);
      load_tile(t + kStages - 1);
    }
  }
  if (threadIdx.x == 0) final_acc = acc;
  __syncthreads();
  // inactive elements each add +0.0: after the first, acc + 0.0 is a fixed point
  const float fin = len < v ? __fadd_rn(final_acc, 0.0f) : final_acc;
  if (kPartials) {
    if (loader >= 0 && tiles > 0) store_partials(tiles - 1);
    for (int i = len + (int)threadIdx.x; i < v; i += kThreads) pr[i] = fin;
  }
  if (threadIdx.x == 0) out[row] = fin;
}

template <bool kVec, bool kPartials>
int launch(const float* x, long long ld, const int* n, const float* init, float* partials,
           float* out, int rows, int v, int block, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)(kStages + 2) * block;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fadda_rows_kernel<kVec, kPartials>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fadda_rows_kernel<kVec, kPartials><<<rows, kThreads, smem, st>>>(x, ld, n, init, partials,
                                                                  out, v, block);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, ld) f32 with rows of v elements; n (rows,) int32; init (rows,)
// f32; out (rows,) f32; partials (rows, v) f32 or null.  block (the VL) is a
// multiple of 8 in [8, 8192].
extern "C" int fadda_rows(const float* x, long long ld, const int* n, const float* init,
                          float* partials, float* out, int rows, int v, int block,
                          void* stream) {
  if (rows < 1 || v < 0 || ld < v || block < 8 || block % 8 != 0 ||
      block > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (ld % 4 == 0);
  if (partials != nullptr)
    return vec ? launch<true, true>(x, ld, n, init, partials, out, rows, v, block, st)
               : launch<false, true>(x, ld, n, init, partials, out, rows, v, block, st);
  return vec ? launch<true, false>(x, ld, n, init, nullptr, out, rows, v, block, st)
             : launch<false, false>(x, ld, n, init, nullptr, out, rows, v, block, st);
}
