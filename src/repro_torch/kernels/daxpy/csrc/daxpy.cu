// Predicated daxpy (the paper's Fig. 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel daxpy_pallas (src/repro/kernels/daxpy/kernel.py,
// body _daxpy_kernel).
//
// What it computes.  out[i] = a * x[i] + y[i] for i < n and out[i] = y[i] for
// n <= i < len (merging predication, SVE /m), for f32 or bf16 x, y, out.  The
// arithmetic is PyTorch's two elementwise ops, rounded as they round: in f32
// __fadd_rn(__fmul_rn(a, x), y) (nvcc would otherwise contract a*x+y into an
// FMA, one rounding instead of two); in bf16 the product and the sum are
// each taken in f32 and rounded to bf16.  So the result equals the plain
// version torch.where(i < n, a * x + y, y) bit for bit on the card.
//
// What bounds it on an H100.  Bytes: each element reads x and y and writes
// out once (12 bytes in f32, 6 in bf16) for two operations; at 2^26
// elements in f32, 805 MB at 3.35 TB/s is 0.240 ms.
//
// What this design does about it.  The loop of Fig. 2 is strip-mined by
// `block` elements (the VL): a CTA takes strips in a grid-stride loop, and a
// strip's 16-byte chunks (4 f32 or 8 bf16) are spread over its threads, each
// a 16-byte load of x and of y and a 16-byte store, neighbouring threads on
// neighbouring chunks.  The whilelt predicate i < n is taken per element
// inside the chunk; the ragged end of the array (len not a multiple of the
// chunk) and rows that are not 16-byte aligned go element by element.
// Nothing is padded.
//
// C interface for ctypes: pointers and the stream are void*; the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float axpy(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ __nv_bfloat16 axpy(float a, __nv_bfloat16 x, __nv_bfloat16 y) {
  const __nv_bfloat16 ax = __float2bfloat16_rn(__fmul_rn(a, __bfloat162float(x)));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(ax), __bfloat162float(y)));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    daxpy_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, float a,
                 long long n, long long len, int block) {
  constexpr int kElems = 16 / sizeof(T);   // elements in a 16-byte chunk
  const long long strips = (len + block - 1) / block;
  for (long long s = blockIdx.x; s < strips; s += gridDim.x) {
    const long long base = s * block;
    const int m = (int)min((long long)block, len - base);
    if (kVec) {
      for (int c = threadIdx.x * kElems; c < m; c += kThreads * kElems) {
        const long long i0 = base + c;
        if (c + kElems <= m) {
          const uint4 rx = *reinterpret_cast<const uint4*>(x + i0);
          const uint4 ry = *reinterpret_cast<const uint4*>(y + i0);
          uint4 ro;
          const T* vx = reinterpret_cast<const T*>(&rx);
          const T* vy = reinterpret_cast<const T*>(&ry);
          T* vo = reinterpret_cast<T*>(&ro);
#pragma unroll
          for (int e = 0; e < kElems; ++e) vo[e] = i0 + e < n ? axpy(a, vx[e], vy[e]) : vy[e];
          *reinterpret_cast<uint4*>(out + i0) = ro;
        } else {
          for (int e = 0; c + e < m; ++e)
            out[i0 + e] = i0 + e < n ? axpy(a, x[i0 + e], y[i0 + e]) : y[i0 + e];
        }
      }
    } else {
      for (int c = threadIdx.x; c < m; c += kThreads) {
        const long long i = base + c;
        out[i] = i < n ? axpy(a, x[i], y[i]) : y[i];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, float a, long long n, long long len,
           int block, cudaStream_t st) {
  const long long strips = (len + block - 1) / block;
  const int grid = (int)(strips < kMaxBlocks ? strips : kMaxBlocks);
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  if (vec)
    daxpy_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, yt, ot, a, n, len, block);
  else
    daxpy_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, yt, ot, a, n, len, block);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y, out (len,) of one type: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// block (the VL) is a multiple of 8 elements.
extern "C" int daxpy(const void* x, const void* y, void* out, float a, long long n,
                     long long len, int block, int is_bf16, void* stream) {
  if (len < 0 || block < 8 || block % 8 != 0) return (int)cudaErrorInvalidValue;
  if (len == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, y, out, a, n, len, block, st)
                 : launch<float>(x, y, out, a, n, len, block, st);
}
