// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan/kernel.py:
//   ssd_scan_fwd_tc (bf16), ssd_scan_fwd (f32, off-grid bf16)
//                               <- ssd_scan_pallas (_ssd_kernel)
//
// Both compute, for each lane b and head h, the chunked form of
//     h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (x_t outer B_t)      (P, N)
//     y_t = h_t . C_t                                               (P,)
// seeded from h0, and return y and the final state.  Within a chunk of Q
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
// it, so the device memory (3.35 TB/s) bounds it in principle.  The first
// design (the CUDA-core body below) ran every product in f32 on the CUDA
// cores out of shared memory, one block per (lane, head): 192 blocks at
// mamba2's shape, 512 at zamba2's, each walking its chunks in turn, 26x and
// 70x above that bound.
//
// The two bodies; the wrapper picks one per call (kernel.plan_ssd).
//
// ssd_tc<PB>, the tensor-core body: bf16 with Q, P and N multiples of 16
// and N <= 128 (both serving shapes).  Row p of the state depends only on
// column p of x (the recurrence never mixes head dims), so one block owns a
// slice of PB head dims of one (lane, head) and walks that slice's chunks
// in order: the grid is (P / PB, H, Bz), the f32 state slice never leaves
// the chip between chunks, and a call is one launch.  Eight warps; warp w
// owns the chunk's query rows [16w, 16w + 16).  Per chunk, on mma.sync
// m16n8k16 (bf16 in, f32 accumulators):
//   y    = exp(cum_i) C . h_prev^T                   C in registers (ldmatrix)
//   G    = C . B^T, one 16-key block at a time, causal blocks only, as two
//          partial sums (even and odd k-steps), halving the dependent chain
//   att  = G * exp(cum_i - cum_j) * dt_j  (0 for j > i), in registers as
//          the A fragments of the next product
//   y   += att . x
//   h    = exp(cum_Q) h_prev + x^T . (w * B),  w_j = exp(cum_Q - cum_j) dt_j
// x, B and C arrive in bf16 and are exact as operands.  Every f32 operand
// (att, h_prev, w * B) goes in as a hi and a lo bf16 half, one mma each, so
// it keeps ~16 bits (h_final is held to 1e-4, y to one bf16 rounding step).
// The decay of att is taken in the difference form, in base 2: warp 0's
// scan stores cum * log2(e) beside dt for every step, and each element costs
// one subtraction and one ex2.approx (with the accurate expf per element the
// call took 0.2827 ms against 0.2597 at zamba2's shape on an H100).  The
// f32 state lives in the accumulator fragments of the warps with the
// fewest key blocks, two 8-column n-tiles of all PB rows each (warps 0-3 at
// N = 64, all 8 at N = 128), so each scaled and split B fragment serves all
// PB / 16 m-tiles; its hi and lo halves go to shared memory once a chunk
// for the next chunk's inter term.
// A 2-stage cp.async ring brings the next chunk's B and x slice (16-byte
// copies) and dt (4-byte copies) while this chunk computes; C has one stage
// in shared memory and the other in registers: each warp reads only its own
// 16 rows, so it copies the next chunk's rows in as soon as its fragments
// of the current ones are loaded.  Rows are padded by 16 bytes, so ldmatrix
// is free of bank conflicts.  Warp 0, which has the fewest key blocks, scans
// the next chunk's dt (which it copied itself) while the others finish
// this one.  B and C (Bz, S, N) are read by every head and slice; they
// total 2-4 MB at the serving shapes, so L2 serves the re-reads.  Slices of
// 64 head dims (a whole head at the serving shapes) were the fastest of 16,
// 32 and 64 at both serving shapes on an H100 (chip_smoke.py prints the
// sweep): narrower slices recompute G and att for every slice.  Shared
// memory, bytes (ldn = N + 8, ldx = PB + 8):
//     2 * (Q * ldn * 2 + Q * ldx * 2 + 4 * Q)         B, x, dt; 2 stages
//   + Q * ldn * 2                                     C
//   + 2 * 16 * Q                                      scan: (cum log2 e, dt),
//                                                     w, exp(cum); 2 buffers
//   + 2 * PB * ldn * 2                                state hi and lo halves
// (Q 128, PB 64: zamba2, N 64, 115,712; mamba2, N 128, 181,248: one block
// of 8 warps per SM).  The chunk-parallel multi-pass design of Mamba2's
// published kernels would write and read f32 chunk states (about 67 MB at
// zamba2's shape), roughly doubling the bytes that bound the call, so the
// single pass stays.
//
// ssd_fwd<T, PM>, the CUDA-core body: f32 (the tensor cores would round it
// to TF32) and bf16 shapes off the 16-grid.  One block per (lane, head)
// loops over the chunks with the f32 state in shared memory; products in
// f32 on the CUDA cores.  The Q x Q products are TILED BY ROWS: 32 query
// rows at a time, with only those rows of C and of the product matrix in
// shared memory; B and x stay whole.  A row tile skips the keys past its
// last row (causal), which halves the intra-chunk work.  The inner loops
// are bound by shared-memory load instructions, so C, B and the product
// rows are read 16 bytes (4 values) at a time: rows of B are padded by
// four floats, which keeps those loads aligned and puts the 8 lanes of each
// load phase, each on its own key row, on different banks; each warp
// updates 8 contiguous state columns.  The state is kept transposed (N x P)
// so that lanes, which own head dims, read it on consecutive banks.  The
// 128 steps of a chunk's cumsum are one warp scan.  Global loads are staged
// with kBatch loads in flight per thread before their shared-memory stores.
// Takes Q % 4 == 0 and N % 8 == 0.  Shared memory, bytes:
//     4 * (Q * (N + 4) + 32 * N + Q * P + 32 * Q + N * P + 3 * Q)
//
// C interface for ctypes: pointers and the stream are void*, each entry
// point returns cudaGetLastError() as an int (0 = launched).

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

// ---------------------------------------------------------------------------
// The tensor-core body (bf16).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 8;                    // one 16-row query tile each
constexpr int kTcThreads = kTcWarps * kWarp;
constexpr int kMaxTcN = 128;                   // state columns the fragments hold
constexpr int kMaxNK = kMaxTcN / 16;           // mma k-steps over the state
constexpr int kPadH = 8;                       // bf16 after each row: 16 bytes

size_t tc_smem_bytes(int q, int pb, int n) {
  const size_t ldn = n + kPadH, ldx = pb + kPadH;
  return 2 * (q * ldn * 2 + q * ldx * 2 + 4 * (size_t)q)  // B, x, dt; 2 stages
         + q * ldn * 2                                    // C (the other stage: registers)
         + 2 * 16 * (size_t)q                             // key data, w, exp(cum); 2 buffers
         + 2 * pb * ldn * 2;                              // state hi, lo
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte copies into shared memory; ok false zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair hi plus the bf16 pair lo of what hi rounded off:
// hi + lo keeps ~16 significant bits of each.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// One block: PB head dims [p0, p0 + PB) of head h of lane b, every chunk in
// order.  Fragment notation: g = lane / 4, t = lane % 4; an accumulator
// tile holds rows g and g + 8, columns 2t and 2t + 1.
template <int PB>
__global__ void __launch_bounds__(kTcThreads, PB <= 32 ? 2 : 1) ssd_tc(const Args a) {
  constexpr int NY = PB / 8;                   // n-tiles of 8 head dims in y
  constexpr int MT = PB / 16;                  // m-tiles of 16 head dims in the state
  constexpr int NTW = kMaxTcN / 8 / kTcWarps;  // most state n-tiles a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.n, Q = a.q;
  const int ldn = N + kPadH, ldx = PB + kPadH;
  const int nk = N / 16;                       // k-steps over the state
  const int ntn = N / 8;                       // n-tiles of 8 state columns
  // the state's n-tiles go NTW at a time to the warps with the fewest key
  // blocks: warp w < sw holds n-tiles w + u * sw
  const int sw = (ntn + NTW - 1) / NTW;
  const size_t stage_bytes = (size_t)Q * ldn * 2 + (size_t)Q * ldx * 2 + 4 * (size_t)Q;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + 2 * stage_bytes);
  unsigned char* scans = reinterpret_cast<unsigned char*>(Cs + Q * ldn);
  bf16* h_hi = reinterpret_cast<bf16*>(scans + 2 * 16 * (size_t)Q);   // (PB, ldn)
  bf16* h_lo = h_hi + PB * ldn;

  const int p0 = blockIdx.x * PB, hh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;                    // this warp's first query row
  const float A = a.A[hh];
  const long long xrow = (long long)a.h * a.p;           // step stride of x, y
  const long long xoff = (long long)b * a.s * xrow + (long long)hh * a.p + p0;
  const bf16* xg = static_cast<const bf16*>(a.x) + xoff;
  bf16* yg = static_cast<bf16*>(a.y) + xoff;
  const float* dtg = a.dt + (long long)b * a.s * a.h + hh;
  const bf16* Bg = static_cast<const bf16*>(a.B) + (long long)b * a.s * N;
  const bf16* Cg = static_cast<const bf16*>(a.C) + (long long)b * a.s * N;
  const long long hoff = (((long long)b * a.h + hh) * a.p + p0) * N;
  const int n_chunks = (a.s + Q - 1) / Q;

  auto stage_of = [&](int st, bf16*& Bs, bf16*& xs, float*& dts) {
    unsigned char* base = smem_raw + st * stage_bytes;
    Bs = reinterpret_cast<bf16*>(base);
    xs = Bs + Q * ldn;
    dts = reinterpret_cast<float*>(xs + Q * ldx);
  };
  // a chunk's scan in buffer k: per step (cum * log2 e, dt), w and exp(cum)
  auto scan_of = [&](int k, float2*& kd, float*& wts, float*& ecum) {
    kd = reinterpret_cast<float2*>(scans + k * 16 * (size_t)Q);
    wts = reinterpret_cast<float*>(kd + Q);
    ecum = wts + Q;
  };
  // chunk c's B and x slice into stage st by every thread, its dt by warp 0
  // (which scans it), left in flight; rows at or past S read as 0
  auto stage_chunk = [&](int c, int st) {
    bf16 *Bs, *xs;
    float* dts;
    stage_of(st, Bs, xs, dts);
    const int t0 = c * Q, qv = min(Q, a.s - t0);
    const int cpr = N / 8;
    for (int i = threadIdx.x; i < Q * cpr; i += kTcThreads) {
      const int r = i / cpr, col = (i - r * cpr) * 8;
      const bool ok = r < qv;
      cp_async16(Bs + r * ldn + col, Bg + (long long)(t0 + (ok ? r : 0)) * N + col, ok);
    }
    constexpr int xpr = PB / 8;
    for (int i = threadIdx.x; i < Q * xpr; i += kTcThreads) {
      const int r = i / xpr, col = (i - r * xpr) * 8;
      const bool ok = r < qv;
      cp_async16(xs + r * ldx + col, xg + (long long)(t0 + (ok ? r : 0)) * xrow + col, ok);
    }
    if (warp == 0) {
      for (int i = lane; i < Q; i += kWarp) {
        const bool ok = i < qv;
        cp_async4(dts + i, dtg + (long long)(t0 + (ok ? i : 0)) * a.h, ok);
      }
    }
  };
  // chunk c's rows of C that this warp owns (each warp reads only its own)
  auto stage_c = [&](int c) {
    if (r0 >= Q) return;
    const int t0 = c * Q, qv = min(Q, a.s - t0);
    const int cpr = N / 8;
    for (int i = lane; i < 16 * cpr; i += kWarp) {
      const int r = r0 + i / cpr, col = (i % cpr) * 8;
      const bool ok = r < qv;
      cp_async16(Cs + r * ldn + col, Cg + (long long)(t0 + (ok ? r : 0)) * N + col, ok);
    }
  };
  // warp 0: inclusive cumsum of dt * A over chunk c, 4 steps per lane, then
  // a warp scan of the lane totals; its dt copies must have landed
  auto scan = [&](int c) {
    bf16 *Bs, *xs;
    float* dts;
    stage_of(c & 1, Bs, xs, dts);
    float2* kd;
    float *wts, *ecum;
    scan_of(c & 1, kd, wts, ecum);
    float d[4], cs[4];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = lane * 4 + u;
      d[u] = i < Q ? dts[i] : 0.f;
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
    for (int u = 0; u < 4; ++u) {
      const int i = lane * 4 + u;
      if (i < Q) {
        const float ci = excl + cs[u];
        kd[i] = make_float2(ci * kLog2e, d[u]);
        wts[i] = expf(last - ci) * d[u];
        ecum[i] = expf(ci);
      }
    }
  };

  // the f32 state: this warp holds state n-tiles nt = warp + u * sw, each
  // with its MT m-tiles: rows mt * 16 + {g, g + 8}, columns nt * 8 +
  // {2t, 2t + 1}
  float hs[NTW][MT][4];
  auto put_state = [&]() {   // hi and lo halves of the state into shared memory
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
      const int nt = warp + u * sw;
      if (warp < sw && nt < ntn) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int off = (mt * 16 + g) * ldn + nt * 8 + 2 * t;
          unsigned hi, lo;
          split_bf16(hs[u][mt][0], hs[u][mt][1], hi, lo);
          *reinterpret_cast<unsigned*>(h_hi + off) = hi;
          *reinterpret_cast<unsigned*>(h_lo + off) = lo;
          split_bf16(hs[u][mt][2], hs[u][mt][3], hi, lo);
          *reinterpret_cast<unsigned*>(h_hi + off + 8 * ldn) = hi;
          *reinterpret_cast<unsigned*>(h_lo + off + 8 * ldn) = lo;
        }
      }
    }
  };
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int nt = warp + u * sw;
    if (warp < sw && nt < ntn) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* src = a.h0 + hoff + (long long)(mt * 16 + g) * N + nt * 8 + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(src);
        const float2 v1 = *reinterpret_cast<const float2*>(src + 8 * N);
        hs[u][mt][0] = v0.x;
        hs[u][mt][1] = v0.y;
        hs[u][mt][2] = v1.x;
        hs[u][mt][3] = v1.y;
      }
    }
  }
  put_state();

  // one cp.async group for chunk 0 (B, x, dt and C), then one a chunk for
  // chunk c + 1's B, x and dt (issued at the top of chunk c) and one for its
  // C rows (issued once this warp has consumed chunk c's C)
  if (n_chunks > 0) {
    stage_chunk(0, 0);
    stage_c(0);
  }
  cp_async_commit();
  if (warp == 0 && n_chunks > 0) {
    cp_async_wait<0>();
    __syncwarp();
    scan(0);
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                        // chunk c has landed
    __syncthreads();
    bf16 *Bs, *xs;
    float* dts;
    stage_of(c & 1, Bs, xs, dts);
    float2* kd;
    float *wts, *ecum;
    scan_of(c & 1, kd, wts, ecum);
    const int t0 = c * Q, qv = min(Q, a.s - t0);

    if (r0 < qv) {                             // warp-uniform
      unsigned cf[kMaxNK][4];                  // this warp's 16 rows of C
#pragma unroll
      for (int kk = 0; kk < kMaxNK; ++kk)
        if (kk < nk) ldsm_x4(cf[kk], Cs + (r0 + lane % 16) * ldn + kk * 16 + (lane / 16) * 8);
      // inter: y = C . h_prev^T, h_prev as hi + lo halves
      float y[NY][4];
#pragma unroll
      for (int n = 0; n < NY; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxNK; ++kk) {
        if (kk < nk) {
          unsigned hb[PB / 16][2][4];
#pragma unroll
          for (int pp = 0; pp < PB / 16; ++pp) {
            const int off = (pp * 16 + (lane % 8) + (lane / 16) * 8) * ldn + kk * 16 +
                            ((lane / 8) % 2) * 8;
            ldsm_x4(hb[pp][0], h_hi + off);
            ldsm_x4(hb[pp][1], h_lo + off);
          }
#pragma unroll
          for (int pp = 0; pp < PB / 16; ++pp) {
#pragma unroll
            for (int hl = 0; hl < 2; ++hl) {
              mma_bf16(y[2 * pp], cf[kk], hb[pp][hl][0], hb[pp][hl][1]);
              mma_bf16(y[2 * pp + 1], cf[kk], hb[pp][hl][2], hb[pp][hl][3]);
            }
          }
        }
      }
      // every C fragment has been read: the next chunk's rows may land
      if (c + 1 < n_chunks) stage_c(c + 1);
      cp_async_commit();
      const int i0 = r0 + g, i1 = i0 + 8;
      const float e0 = ecum[i0], e1 = ecum[i1];
      const float l0 = kd[i0].x, l1 = kd[i1].x;
#pragma unroll
      for (int n = 0; n < NY; ++n) {
        y[n][0] *= e0;
        y[n][1] *= e0;
        y[n][2] *= e1;
        y[n][3] *= e1;
      }
      // intra: key blocks of 16 up to the diagonal; att = G * exp(cum_i -
      // cum_j) * dt_j with G = C . B^T, in the base-2 difference form, 0
      // past the diagonal, as hi + lo halves
      for (int kb = 0; kb <= warp; ++kb) {
        unsigned bb[kMaxNK][4], xb[PB / 16][4];
#pragma unroll
        for (int kk = 0; kk < kMaxNK; ++kk)
          if (kk < nk)
            ldsm_x4(bb[kk], Bs + (kb * 16 + (lane % 8) + (lane / 16) * 8) * ldn + kk * 16 +
                                ((lane / 8) % 2) * 8);
#pragma unroll
        for (int dp = 0; dp < PB / 16; ++dp)
          ldsm_x4_trans(xb[dp], xs + (kb * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldx +
                                    dp * 16 + (lane / 16) * 8);
        // G = C . B^T as two partial sums (even and odd k-steps): half the
        // dependent mma chain
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float so[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kMaxNK; kk += 2) {
          if (kk < nk) {
            mma_bf16(s[0], cf[kk], bb[kk][0], bb[kk][1]);
            mma_bf16(s[1], cf[kk], bb[kk][2], bb[kk][3]);
          }
          if (kk + 1 < nk) {
            mma_bf16(so[0], cf[kk + 1], bb[kk + 1][0], bb[kk + 1][1]);
            mma_bf16(so[1], cf[kk + 1], bb[kk + 1][2], bb[kk + 1][3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += so[nt][e];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int j = kb * 16 + nt * 8 + 2 * t + e1;
            const float2 kj = kd[j];
            s[nt][e1] *= ex2(l0 - kj.x) * kj.y;
            s[nt][2 + e1] *= ex2(l1 - kj.x) * kj.y;
            if (kb == warp) {
              if (j > i0) s[nt][e1] = 0.f;
              if (j > i1) s[nt][2 + e1] = 0.f;
            }
          }
        }
        unsigned ph[4], pl[4];
        split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
        split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
        split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
        split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < PB / 16; ++dp) {
          mma_bf16(y[2 * dp], ph, xb[dp][0], xb[dp][1]);
          mma_bf16(y[2 * dp + 1], ph, xb[dp][2], xb[dp][3]);
          mma_bf16(y[2 * dp], pl, xb[dp][0], xb[dp][1]);
          mma_bf16(y[2 * dp + 1], pl, xb[dp][2], xb[dp][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NY; ++n) {
        const int col = n * 8 + 2 * t;
        if (i0 < qv)
          *reinterpret_cast<__nv_bfloat162*>(yg + (long long)(t0 + i0) * xrow + col) =
              __floats2bfloat162_rn(y[n][0], y[n][1]);
        if (i1 < qv)
          *reinterpret_cast<__nv_bfloat162*>(yg + (long long)(t0 + i1) * xrow + col) =
              __floats2bfloat162_rn(y[n][2], y[n][3]);
      }
    } else {
      if (c + 1 < n_chunks) stage_c(c + 1);
      cp_async_commit();
    }

    // state: h = exp(cum_Q) h_prev + x^T . (w * B), w * B as hi + lo halves
    // (scaled and split once per B fragment, for all MT m-tiles); steps past
    // S hold x = B = w = 0
    const float decay = ecum[Q - 1];
    const int kq = (qv + 15) / 16;
#pragma unroll
    for (int u = 0; u < NTW; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[u][mt][e] *= decay;
    if (warp < sw) {
      for (int kk = 0; kk < kq; ++kk) {
        unsigned xa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4_trans(xa[mt], xs + (kk * 16 + (lane % 8) + (lane / 16) * 8) * ldx + mt * 16 +
                                    ((lane / 8) % 2) * 8);
        const int j = kk * 16 + 2 * t;
        const float2 w0 = *reinterpret_cast<const float2*>(wts + j);
        const float2 w1 = *reinterpret_cast<const float2*>(wts + j + 8);
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int nt = warp + u * sw;
          if (nt < ntn) {
            unsigned bb[2];
            ldsm_x2_trans(bb, Bs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldn + nt * 8);
            const float2 b0 = unpack_bf16(bb[0]), b1 = unpack_bf16(bb[1]);
            unsigned bh0, bl0, bh1, bl1;
            split_bf16(b0.x * w0.x, b0.y * w0.y, bh0, bl0);
            split_bf16(b1.x * w1.x, b1.y * w1.y, bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(hs[u][mt], xa[mt], bh0, bh1);
              mma_bf16(hs[u][mt], xa[mt], bl0, bl1);
            }
          }
        }
      }
    }
    // warp 0 (the fewest key blocks) scans the next chunk while the others
    // finish this one
    if (warp == 0 && c + 1 < n_chunks) {
      cp_async_wait<0>();
      __syncwarp();
      scan(c + 1);
    }
    __syncthreads();                           // every read of this stage and state is done
    put_state();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int nt = warp + u * sw;
    if (warp < sw && nt < ntn) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* dst = a.h_out + hoff + (long long)(mt * 16 + g) * N + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(hs[u][mt][0], hs[u][mt][1]);
        *reinterpret_cast<float2*>(dst + 8 * N) = make_float2(hs[u][mt][2], hs[u][mt][3]);
      }
    }
  }
}

template <int PB>
int launch_tc(const Args& a, int bz, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(a.q, PB, a.n);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(ssd_tc<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_tc<PB><<<dim3(a.p / PB, a.h, bz), kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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

extern "C" int ssd_scan_fwd_tc(const void* x, const float* dt, const float* A, const void* B,
                               const void* C, const float* h0, void* y, float* h_out, int bz,
                               int s, int h, int p, int n, int chunk, int slice,
                               void* stream) {
  if (bz < 1 || s < 0 || h < 1 || p < 16 || p % 16 != 0 || n < 16 || n % 16 != 0 ||
      n > kMaxTcN || chunk < 16 || chunk % 16 != 0 || chunk > kMaxQ || bz > 65535 ||
      h > 65535 || (slice != 16 && slice != 32 && slice != 64) || p % slice != 0)
    return (int)cudaErrorInvalidValue;
  Args a{x, dt, A, B, C, h0, y, h_out, s, h, p, n, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slice == 16) return launch_tc<16>(a, bz, st);
  if (slice == 32) return launch_tc<32>(a, bz, st);
  return launch_tc<64>(a, bz, st);
}
