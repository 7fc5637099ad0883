// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/kernel.py:
//   ssd_scan_fwd <- ssd_scan_pallas (_ssd_kernel)
//
// It computes, for each lane b and head h, the chunked form of
//     h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (x_t outer B_t)      (P, N)
//     y_t = h_t . C_t                                               (P,)
// seeded from h0, and returns y and the final state.  Within a chunk of Q
// steps, with cum the inclusive cumsum of a = dt * A:
//     y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//          + exp(cum_i) C_i . h_prev                                (inter)
//     h    = exp(cum_Q) h_prev + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// x, B, C and y are f32 or bf16; dt, A, the state and every sum are f32.
// Steps past S are inert (dt = 0, x = B = C = 0, y not written), which is
// what the TPU op's padding to a multiple of Q gives, so nothing is padded.
//
// What bounds it on an H100.  At the serving path's prefill shapes (Q = 128,
// P = 64, N = 64 or 128) the work is 2Q^2 N + 2Q^2 P + 4QPN FLOPs per
// (b, h, chunk) against about 2P + 2N/H bytes per step and head: some 100
// FLOPs per byte, below the 295 at which the bf16 tensor cores would bound
// it, so the device memory (3.35 TB/s) bounds it in principle.  This first
// version runs the products on the CUDA cores in f32 (67 TFLOP/s, and
// shared-memory reads before that), so it is bound by operations as written;
// mma/wgmma on bf16 tiles is later work.
//
// Design.  The TPU runs the grid (Bz, H, S/Q) in order and keeps the (P, N)
// state in VMEM across the chunk axis.  Hopper runs blocks in any order, so
// one block takes one (b, h) and loops over the chunks itself, with the f32
// state in shared memory.  The working set at Q = 128, P = 64, N = 128 in f32
// (x 32 KB, B and C 64 KB each, the Q x Q decay-weighted products 64 KB, state
// 32 KB) exceeds the 227 KB a block may use, so the Q x Q products are TILED
// BY ROWS: 32 query rows at a time, with only those rows of C and of the
// product matrix in shared memory (16 KB each); B and x stay whole.  A row
// tile skips the keys past its last row (causal), which halves the
// intra-chunk work.  The inner loops are bound by shared-memory load
// instructions, so C, B and the product rows are read 16 bytes (4 values)
// at a time: rows of B are padded by four floats, which keeps those loads
// aligned and puts the 8 lanes of each load phase, each on its own key row,
// on different banks; each warp updates 8 contiguous state columns.  The
// state is kept transposed (N x P) so that lanes, which own head dims, read
// it on consecutive banks.  The 128 steps of a chunk's cumsum are one warp
// scan.  Global loads are staged with kBatch loads in flight per thread
// before their shared-memory stores.  Takes Q % 4 == 0 and N % 8 == 0.
//
// C interface for ctypes: pointers and the stream are void*, the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                      // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kTile = kWarps * kRowsPerWarp;   // 32 query rows per row tile
constexpr int kMaxQ = 128;                     // chunk length
constexpr int kQK = kMaxQ / kWarp;             // key columns (and scan steps) per lane
constexpr int kMaxP = 128;                     // head dim
constexpr int kNT = 8;                         // state columns per warp per pass
constexpr int kPadB = 4;                       // floats after each row of B
constexpr int kBatch = 8;                      // global loads in flight per thread
constexpr size_t kMaxSmem = 232448;            // 227 KB
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Args {
  const void* x;      // (Bz, S, H, P)
  const float* dt;    // (Bz, S, H)
  const float* A;     // (H,)
  const void* B;      // (Bz, S, N)
  const void* C;      // (Bz, S, N)
  const float* h0;    // (Bz, H, P, N)
  void* y;            // (Bz, S, H, P)
  float* h_out;       // (Bz, H, P, N)
  int s, h, p, n, q;
};

size_t smem_floats(int q, int p, int n) {
  return (size_t)q * (n + kPadB)  // B, padded rows
         + (size_t)kTile * n      // C, one row tile
         + (size_t)q * p          // x
         + (size_t)kTile * q      // decay-weighted C.B^T, one row tile
         + (size_t)n * p          // state, transposed
         + 3 * (size_t)q;         // cum, dt, state-update weights
}

// rows x cols of src (row stride src_ld) -> dst (row stride ld) as f32; rows
// at or past `valid` read as 0.
template <typename T>
__device__ void stage(float* dst, int ld, const T* src, long long src_ld, int rows,
                      int valid, int cols) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / cols;
      v[u] = (idx < total && r < valid) ? to_float(src[r * src_ld + (idx - r * cols)]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int r = idx / cols;
        dst[r * ld + (idx - r * cols)] = v[u];
      }
    }
  }
}

template <typename T, int PM>
__global__ void __launch_bounds__(kThreads) ssd_fwd(const Args a) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int P = a.p, N = a.n, Q = a.q;
  const int ldb = N + kPadB;
  // every array starts on a 16-byte boundary (Q % 4 == 0, N % 8 == 0)
  float* Bs = sm;                         // Q x ldb
  float* Cs = Bs + (size_t)Q * ldb;       // kTile x N
  float* xs = Cs + (size_t)kTile * N;     // Q x P
  float* att = xs + (size_t)Q * P;        // kTile x Q
  float* hT = att + (size_t)kTile * Q;    // N x P
  float* cum = hT + (size_t)N * P;        // Q
  float* dts = cum + Q;                   // Q
  float* wts = dts + Q;                   // Q

  const int hh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float A = a.A[hh];
  const long long xrow = (long long)a.h * P;                  // step stride of x, y
  const long long xoff = (long long)b * a.s * xrow + (long long)hh * P;
  const T* x = static_cast<const T*>(a.x) + xoff;
  T* y = static_cast<T*>(a.y) + xoff;
  const float* dt = a.dt + (long long)b * a.s * a.h + hh;
  const T* Bg = static_cast<const T*>(a.B) + (long long)b * a.s * N;
  const T* Cg = static_cast<const T*>(a.C) + (long long)b * a.s * N;
  const long long hoff = ((long long)b * a.h + hh) * P * N;

  for (int idx = threadIdx.x; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    hT[(idx - p * N) * P + p] = a.h0[hoff + idx];
  }

  const int n_chunks = (a.s + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int qv = min(Q, a.s - t0);      // live steps of this chunk
    if (warp == 0) {
      // inclusive cumsum of dt * A over the chunk: kQK steps per lane, then
      // a warp scan of the lane totals
      float d[kQK], cs[kQK];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < kQK; ++u) {
        const int i = lane * kQK + u;
        d[u] = i < qv ? dt[(long long)(t0 + i) * a.h] : 0.f;
        run += d[u] * A;
        cs[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(kFull, incl, kWarp - 1);
#pragma unroll
      for (int u = 0; u < kQK; ++u) {
        const int i = lane * kQK + u;
        if (i < Q) {
          const float ci = excl + cs[u];
          cum[i] = ci;
          dts[i] = d[u];
          wts[i] = expf(last - ci) * d[u];
        }
      }
    }
    stage<T>(Bs, ldb, Bg + (long long)t0 * N, N, Q, qv, N);
    stage<T>(xs, P, x + t0 * xrow, xrow, Q, qv, P);
    __syncthreads();

    for (int i0 = 0; i0 < qv; i0 += kTile) {
      const int jn = min(i0 + kTile, qv);   // keys that reach this row tile
      const int kn = (jn + kWarp - 1) / kWarp;
      stage<T>(Cs, N, Cg + (long long)(t0 + i0) * N, N, kTile, qv - i0, N);
      __syncthreads();

      // (1) att[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i: this
      // warp's 4 rows against the lane's keys j = lane + 32k, 4 state
      // columns per 16-byte load
      {
        float acc[kRowsPerWarp][kQK];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int k = 0; k < kQK; ++k) acc[r][k] = 0.f;
        const float* crow = Cs + warp * kRowsPerWarp * N;
        for (int n = 0; n < N; n += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            cv[r] = *reinterpret_cast<const float4*>(crow + r * N + n);
#pragma unroll
          for (int k = 0; k < kQK; ++k) {
            if (k < kn) {
              const int j = lane + k * kWarp;
              const float4 bv = j < jn ? *reinterpret_cast<const float4*>(Bs + j * ldb + n)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) {
                acc[r][k] = fmaf(cv[r].x, bv.x, acc[r][k]);
                acc[r][k] = fmaf(cv[r].y, bv.y, acc[r][k]);
                acc[r][k] = fmaf(cv[r].z, bv.z, acc[r][k]);
                acc[r][k] = fmaf(cv[r].w, bv.w, acc[r][k]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int il = warp * kRowsPerWarp + r;
          const int i = i0 + il;
#pragma unroll
          for (int k = 0; k < kQK; ++k) {
            const int j = lane + k * kWarp;
            if (j < Q)
              att[il * Q + j] = (i < qv && j <= i)
                                    ? acc[r][k] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
        }
      }
      __syncthreads();

      // (2) y_i = sum_j att[i][j] x_j + exp(cum_i) C_i . h_prev: this warp's
      // 4 rows, the lane's head dims p = lane + 32m; 4 keys (4 state
      // columns) per 16-byte load of att (of C).  Q % 4 == 0, and att is 0
      // and x is 0 from jn up to the next multiple of 4
      {
        float acc[kRowsPerWarp][PM], inter[kRowsPerWarp][PM];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int m = 0; m < PM; ++m) acc[r][m] = inter[r][m] = 0.f;
        const float* arow = att + warp * kRowsPerWarp * Q;
        for (int j = 0; j < jn; j += 4) {
          float4 av[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            av[r] = *reinterpret_cast<const float4*>(arow + r * Q + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float xv[PM];
#pragma unroll
            for (int m = 0; m < PM; ++m) {
              const int p = lane + m * kWarp;
              xv[m] = p < P ? xs[(j + u) * P + p] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float w = u == 0 ? av[r].x : u == 1 ? av[r].y : u == 2 ? av[r].z : av[r].w;
#pragma unroll
              for (int m = 0; m < PM; ++m) acc[r][m] = fmaf(w, xv[m], acc[r][m]);
            }
          }
        }
        const float* crow = Cs + warp * kRowsPerWarp * N;
        for (int n = 0; n < N; n += 4) {
          float4 cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            cv[r] = *reinterpret_cast<const float4*>(crow + r * N + n);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float hv[PM];
#pragma unroll
            for (int m = 0; m < PM; ++m) {
              const int p = lane + m * kWarp;
              hv[m] = p < P ? hT[(n + u) * P + p] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float w = u == 0 ? cv[r].x : u == 1 ? cv[r].y : u == 2 ? cv[r].z : cv[r].w;
#pragma unroll
              for (int m = 0; m < PM; ++m) inter[r][m] = fmaf(w, hv[m], inter[r][m]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = i0 + warp * kRowsPerWarp + r;
          if (i < qv) {
            const float e = expf(cum[i]);
#pragma unroll
            for (int m = 0; m < PM; ++m) {
              const int p = lane + m * kWarp;
              if (p < P) store(y + (t0 + i) * xrow + p, fmaf(e, inter[r][m], acc[r][m]));
            }
          }
        }
      }
      __syncthreads();
    }

    // (3) h = exp(cum_Q) h_prev + sum_j w_j x_j B_j^T: this warp's 8
    // contiguous state columns (two 16-byte loads of B a step), the lane's
    // head dims.  N % 8 == 0
    const float decay = expf(cum[Q - 1]);
    for (int n0 = warp * kNT; n0 < N; n0 += kWarps * kNT) {
      float acc[kNT][PM];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int m = 0; m < PM; ++m) {
          const int p = lane + m * kWarp;
          acc[t][m] = p < P ? hT[(n0 + t) * P + p] * decay : 0.f;
        }
      for (int j = 0; j < qv; ++j) {
        const float wj = wts[j];
        float xv[PM];
#pragma unroll
        for (int m = 0; m < PM; ++m) {
          const int p = lane + m * kWarp;
          xv[m] = p < P ? xs[j * P + p] * wj : 0.f;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + j * ldb + n0);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + j * ldb + n0 + 4);
        const float bv[kNT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int m = 0; m < PM; ++m) acc[t][m] = fmaf(xv[m], bv[t], acc[t][m]);
      }
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int m = 0; m < PM; ++m) {
          const int p = lane + m * kWarp;
          if (p < P) hT[(n0 + t) * P + p] = acc[t][m];
        }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    a.h_out[hoff + idx] = hT[(idx - p * N) * P + p];
  }
}

template <typename T, int PM>
int launch_as(const Args& a, int bz, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd<T, PM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_fwd<T, PM><<<dim3(a.h, bz), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int bz, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.q, a.p, a.n);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (a.p <= kWarp) return launch_as<T, 1>(a, bz, smem, stream);
  if (a.p <= 2 * kWarp) return launch_as<T, 2>(a, bz, smem, stream);
  return launch_as<T, 4>(a, bz, smem, stream);
}

}  // namespace

extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* B,
                            const void* C, const float* h0, void* y, float* h_out, int bz,
                            int s, int h, int p, int n, int chunk, int is_bf16,
                            void* stream) {
  if (bz < 1 || s < 0 || h < 1 || p < 1 || p > kMaxP || n < 8 || n % 8 != 0 ||
      chunk < 4 || chunk % 4 != 0 || chunk > kMaxQ || bz > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{x, dt, A, B, C, h0, y, h_out, s, h, p, n, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, bz, st) : launch<float>(a, bz, st);
}
