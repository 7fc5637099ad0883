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
// `block` elements (the VL).  One CTA of 1024 threads takes one span of
// whole strips, with no grid-stride loop: a strip of at least 1024 16-byte
// chunks (4096 f32, 8192 bf16 elements) is a span of its own, shorter
// strips are grouped into a span of about that size.  The span's 16-byte
// chunks (4 f32 or 8 bf16) are spread over the threads, neighbouring
// threads on neighbouring chunks, and each thread issues the loads of its
// chunks of y and of x, up to 4 of each, before its first store.  Offsets
// inside a span are 32-bit.  The whilelt predicate i < n is decided per
// span: a span wholly below n runs without it, a span wholly past n copies
// y and never reads x, and only the span that holds n (and the ragged end
// of the array, where len is not a whole number of chunks) tests each
// element.  Rows that are not 16-byte aligned go element by element.
// Nothing is padded, and the result does not depend on `block`.
//
// What the measurements chose (chip_smoke.py time_daxpy, on an H100):
// plain loads and stores, since cache-streaming loads (__ldcs) and
// evict-first stores (__stcs) made the kernel slower, not faster; one CTA
// per span, since one resident wave of CTAs each walking a contiguous
// share was slower; 1024 threads and one chunk a thread at the default
// block, a hair ahead of 256 and 512 threads and of more chunks in flight.
// At 2^26 elements every such variant reads and writes at the rate that
// y.add_(x, alpha=a) reaches, about nine tenths of the card's 3.35 TB/s:
// the bytes bound it, and no layout of the same bytes moved them faster.
//
// C interface for ctypes: pointers and the stream are void*; the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDepth = 4;     // 16-byte chunks of x and of y in flight a thread

__device__ __forceinline__ float axpy(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ __nv_bfloat16 axpy(float a, __nv_bfloat16 x, __nv_bfloat16 y) {
  const __nv_bfloat16 ax = __float2bfloat16_rn(__fmul_rn(a, __bfloat162float(x)));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(ax), __bfloat162float(y)));
}

enum Mode { kInactive, kActive, kMixed };

// The span's whole chunks [0, chunks), D of them a thread in flight at a
// time.  kMixed tests each element against `act`, the span's active prefix.
template <typename T, int D, Mode kMode>
__device__ __forceinline__ void chunks_pass(const uint4* xs, const uint4* ys, uint4* os, float a,
                                            int act, int chunks) {
  constexpr int kElems = 16 / sizeof(T);
  for (int j0 = 0; j0 * kThreads < chunks; j0 += D) {
    uint4 rx[D], ry[D];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int c = (j0 + u) * kThreads + threadIdx.x;
      if (c < chunks) {
        ry[u] = ys[c];
        if (kMode != kInactive) rx[u] = xs[c];
      }
    }
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int c = (j0 + u) * kThreads + threadIdx.x;
      if (c >= chunks) continue;
      uint4 ro = ry[u];
      if (kMode != kInactive) {
        const T* vx = reinterpret_cast<const T*>(&rx[u]);
        const T* vy = reinterpret_cast<const T*>(&ry[u]);
        T* vo = reinterpret_cast<T*>(&ro);
#pragma unroll
        for (int e = 0; e < kElems; ++e)
          vo[e] = kMode == kActive || c * kElems + e < act ? axpy(a, vx[e], vy[e]) : vy[e];
      }
      os[c] = ro;
    }
  }
}

// One CTA per span of `span` elements (a whole number of strips), 16-byte
// chunks; x, y and out 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    daxpy_vec(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, float a,
              long long n, long long len, int span) {
  constexpr int kElems = 16 / sizeof(T);
  const long long base = (long long)blockIdx.x * span;
  const int m = (int)min((long long)span, len - base);     // elements of this span
  const long long na = n - base;
  const int act = na <= 0 ? 0 : na >= m ? m : (int)na;     // its active prefix
  const int chunks = m / kElems;
  const uint4* xs = reinterpret_cast<const uint4*>(x + base);
  const uint4* ys = reinterpret_cast<const uint4*>(y + base);
  uint4* os = reinterpret_cast<uint4*>(out + base);
  if (act == m)
    chunks_pass<T, D, kActive>(xs, ys, os, a, act, chunks);
  else if (act == 0)
    chunks_pass<T, D, kInactive>(xs, ys, os, a, act, chunks);
  else
    chunks_pass<T, D, kMixed>(xs, ys, os, a, act, chunks);
  // the ragged end of the array: fewer than one chunk of elements
  const int i = chunks * kElems + threadIdx.x;
  if (i < m) {
    const long long g = base + i;
    out[g] = i < act ? axpy(a, x[g], y[g]) : y[g];
  }
}

// Rows off a 16-byte boundary: element by element, one CTA per span.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    daxpy_elems(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, float a,
                long long n, long long len, int span) {
  const long long base = (long long)blockIdx.x * span;
  const int m = (int)min((long long)span, len - base);
  const long long na = n - base;
  for (int i = threadIdx.x; i < m; i += kThreads)
    out[base + i] = i < na ? axpy(a, x[base + i], y[base + i]) : y[base + i];
}

template <typename T, int D>
int launch_vec(const T* x, const T* y, T* out, float a, long long n, long long len, int span,
               int grid, cudaStream_t st) {
  daxpy_vec<T, D><<<grid, kThreads, 0, st>>>(x, y, out, a, n, len, span);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* y, void* out, float a, long long n, long long len,
           int block, cudaStream_t st) {
  constexpr int kElems = 16 / sizeof(T);
  // a span of whole strips: one strip of at least kThreads chunks, or as
  // many shorter strips as fit in kThreads chunks
  const int floor_elems = kThreads * kElems;
  const int span = block >= floor_elems ? block : block * (floor_elems / block);
  const long long grid = (len + span - 1) / span;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (!vec) {
    daxpy_elems<T><<<(int)grid, kThreads, 0, st>>>(xt, yt, ot, a, n, len, span);
    return (int)cudaGetLastError();
  }
  // chunks a thread takes in one span, rounded up to a power of two, at
  // most kMaxDepth in flight
  const int per_thread = (span / kElems + kThreads - 1) / kThreads;
  const int g = (int)grid;
  if (per_thread <= 1) return launch_vec<T, 1>(xt, yt, ot, a, n, len, span, g, st);
  if (per_thread <= 2) return launch_vec<T, 2>(xt, yt, ot, a, n, len, span, g, st);
  return launch_vec<T, kMaxDepth>(xt, yt, ot, a, n, len, span, g, st);
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
