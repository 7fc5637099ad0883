// Predicated flash-attention backward for Hopper (sm_90a).
//
// Replaces the JAX package's hand-written flash backward,
// src/repro/kernels/flash_attention/xla_impl.py::_flash_bwd (the custom VJP
// of _flash), which is what JAX training differentiates through: the same
// two deterministic passes, each recomputing P from the forward's row
// log-sum-exp instead of storing it.
//
//   delta[b, h, i] = sum_d dO[i, d] * O[i, d]                  (launch 1)
//   P[i, j]  = pred(i, j) ? exp(S[i, j] * scale - lse[i]) : 0,  S = Q K^T
//   dP[i, j] = dO[i] . V[j]
//   dS[i, j] = P[i, j] * (dP[i, j] - delta[i]) * scale
//   dQ = dS K            (launch 2: one CTA per 32 query rows of one head,
//                         walking the KV tiles its rows may attend)
//   dV = P^T dO, dK = dS^T Q
//                        (launch 3: one CTA per block of keys of one KV
//                         head, walking the group's query heads and the
//                         query tiles that may attend its keys)
//
// The predicate is the forward's: key kpos is live for query qpos = q_offset
// [b] + i iff kpos < kv_lens[b], kpos > qpos - window and (causal) qpos >=
// kpos.  A row with no live key has lse = -1e30 (the forward's) and every P
// of it is 0 by the predicate, so its gradients are exactly 0.  GQA: dK and
// dV of a KV head sum over its Hq / Hkv query heads, in head order.
//
// No atomics: each output element is written by one thread after a fixed
// walk, so two calls on the same inputs give the same bits.
//
// Two bodies, chosen by the wrapper (kernel.plan_bwd).  The tensor-core
// body (bf16, every head dim up to 160) is below, after the first design.
// The CUDA-core body (f32, which the tensor cores would round to TF32;
// it is instantiated for f32 only): lse and the delta scratch f32; the
// arithmetic is f32 on the CUDA cores: every tile is staged in shared memory
// (rows padded to an odd stride, so a warp's reads of one column across
// rows hit distinct banks).  Each thread owns 2 rows x 4 keys of S and dP
// and 2 rows x ceil(D / 8) head dims of its dQ (or dK and dV) accumulators:
// at D 160 that is 40 (80) f32 registers.  Every head dim <= 160 runs.
//
// What bounds it on an H100.  The backward does five S x S x D products
// (S and dP in both passes, then dQ; dV and dK), halved by a causal mask:
// at long sequences it is bound by operations.  The CUDA-core body runs
// them from shared memory (about 1.3 FMAs per shared-memory load), far
// from any tensor-core rate, which is why bf16 takes the tensor-core body;
// wgmma with TMA is the next step for that body (ROADMAP Queue 2b).
//
// C interface for ctypes: pointers and the stream are void*, the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kBQ = 32;                // query rows per tile
constexpr int kBK = 32;                // keys per tile
constexpr int kMaxD = 160;
constexpr int kBothTcD = 128;          // widest head dim of one dK/dV launch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;     // (B, Hq, Sq)
  float* delta;         // (B, Hq, Sq) scratch
  void* dq;
  void* dk;
  void* dv;
  const int* kv_lens;
  const int* q_offset;
  const int* window;
  int hq, hkv, sq, skv, d, causal;
  float scale;
};

// delta = rowsum(dO * O) in f32: one warp per (b, h, row).
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const Args a, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.o) + row * a.d;
  const T* g = static_cast<const T*>(a.dout) + row * a.d;
  float s = 0.f;
  for (int c = lane; c < a.d; c += kWarp) s = fmaf(to_float(g[c]), to_float(o[c]), s);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) a.delta[row] = s;
}

// Rows [first, first + n) of a row-major (rows, d) array into dst (stride
// ld) as f32; rows at or past `end` read as 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int first, int end,
                                      int d, int n) {
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d;
    dst[r * ld + c] = first + r < end ? to_float(src[(size_t)(first + r) * d + c]) : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's rows (2 ty, 2 ty + 1) and keys
// (tx + 8 j), then P and dS by the predicate.  qs/dos hold kBQ query rows,
// ks/vs kBK keys (stride ld); row r's query sits at qpos0 + r, key c at
// kpos0 + c; ls/dl are the rows' lse and delta.
__device__ __forceinline__ void scores(const Args& a, const float* qs, const float* dos,
                                       const float* ks, const float* vs, const float* ls,
                                       const float* dl, int ld, long long qpos0, int rows,
                                       long long kpos0, long long kv_len, long long win,
                                       float (&p)[2][4], float (&ds)[2][4]) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
  const float* q0 = qs + (2 * ty) * ld;
  const float* g0 = dos + (2 * ty) * ld;
#pragma unroll 4
  for (int c = 0; c < a.d; ++c) {
    const float qa = q0[c], qb = q0[ld + c], ga = g0[c], gb = g0[ld + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float kv = ks[(tx + 8 * j) * ld + c], vv = vs[(tx + 8 * j) * ld + c];
      s[0][j] = fmaf(qa, kv, s[0][j]);
      s[1][j] = fmaf(qb, kv, s[1][j]);
      dp[0][j] = fmaf(ga, vv, dp[0][j]);
      dp[1][j] = fmaf(gb, vv, dp[1][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * ty + r;
    const long long qpos = qpos0 + row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long kpos = kpos0 + tx + 8 * j;
      bool pred = row < rows && kpos < kv_len && kpos > qpos - win;
      if (a.causal) pred = pred && qpos >= kpos;
      const float pv = pred ? expf(s[r][j] * a.scale - ls[row]) : 0.f;
      p[r][j] = pv;
      ds[r][j] = pv * (dp[r][j] - dl[row]) * a.scale;
    }
  }
}

// Pass 1: dQ.  One CTA per (32 query rows, query head, lane).
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* qs = smem;
  float* dos = qs + kBQ * ld;
  float* ks = dos + kBQ * ld;
  float* vs = ks + kBK * ld;
  float* dss = vs + kBK * ld;           // (kBQ, kBK + 1)
  float* ls = dss + kBQ * (kBK + 1);
  float* dl = ls + kBQ;

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, a.sq - q0);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const long long kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b];
  const long long win = a.window[0];
  const size_t qbase = ((size_t)b * a.hq + h) * a.sq;
  const size_t kbase = ((size_t)b * a.hkv + hk) * a.skv;

  stage(qs, ld, static_cast<const T*>(a.q) + qbase * d, q0, a.sq, d, kBQ);
  stage(dos, ld, static_cast<const T*>(a.dout) + qbase * d, q0, a.sq, d, kBQ);
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    ls[r] = r < rows ? a.lse[qbase + q0 + r] : 0.f;
    dl[r] = r < rows ? a.delta[qbase + q0 + r] : 0.f;
  }

  // keys outside [k_begin, k_end) are masked for every row of the tile
  long long k_begin = qoff + q0 - win + 1;
  if (k_begin < 0) k_begin = 0;
  long long k_end = kv_len;
  if (a.causal && qoff + q0 + rows < k_end) k_end = qoff + q0 + rows;

  float acc[2][NI];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;

  for (long long t0 = (k_begin / kBK) * kBK; t0 < k_end; t0 += kBK) {
    __syncthreads();                     // the last tile is consumed
    stage(ks, ld, static_cast<const T*>(a.k) + kbase * d, (int)t0, (int)k_end, d, kBK);
    stage(vs, ld, static_cast<const T*>(a.v) + kbase * d, (int)t0, (int)k_end, d, kBK);
    __syncthreads();
    float p[2][4], ds[2][4];
    scores(a, qs, dos, ks, vs, ls, dl, ld, qoff + q0, rows, t0, kv_len, win, p, ds);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(2 * ty + r) * (kBK + 1) + tx + 8 * j] = ds[r][j];
    __syncthreads();
    const float* d0 = dss + (2 * ty) * (kBK + 1);
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float da = d0[j], db = d0[kBK + 1 + j];
      const float* krow = ks + j * ld;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c = tx + 8 * i;
        const float kv = c < d ? krow[c] : 0.f;
        acc[0][i] = fmaf(da, kv, acc[0][i]);
        acc[1][i] = fmaf(db, kv, acc[1][i]);
      }
    }
  }

  T* dq = static_cast<T*>(a.dq) + qbase * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * ty + r;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = tx + 8 * i;
      if (c < d) store(dq + (size_t)(q0 + row) * d + c, acc[r][i]);
    }
  }
}

// Pass 2: dK and dV.  One CTA per (32 keys, KV head, lane), walking the
// group's query heads in order and, in each, the query tiles that may
// attend its keys.
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* qs = smem;
  float* dos = qs + kBQ * ld;
  float* ks = dos + kBQ * ld;
  float* vs = ks + kBK * ld;
  float* ps = vs + kBK * ld;             // (kBQ, kBK + 1)
  float* dss = ps + kBQ * (kBK + 1);     // (kBQ, kBK + 1)
  float* ls = dss + kBQ * (kBK + 1);
  float* dl = ls + kBQ;

  const int b = blockIdx.z, hk = blockIdx.y, group = a.hq / a.hkv;
  const int k0 = blockIdx.x * kBK;
  const int keys = min(kBK, a.skv - k0);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const long long kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b];
  const long long win = a.window[0];
  const size_t kbase = ((size_t)b * a.hkv + hk) * a.skv;

  stage(ks, ld, static_cast<const T*>(a.k) + kbase * d, k0, a.skv, d, kBK);
  stage(vs, ld, static_cast<const T*>(a.v) + kbase * d, k0, a.skv, d, kBK);

  // query rows that may attend a key of [k0, k1): qpos >= k0 (causal) and
  // qpos < k1 - 1 + window; none when the block lies past kv_len
  const long long k1 = min((long long)k0 + keys, kv_len);
  long long r_begin = a.causal ? k0 - qoff : 0;
  if (r_begin < 0) r_begin = 0;
  long long r_end = k1 - 1 + win - qoff;
  if (r_end > a.sq) r_end = a.sq;
  if (k1 <= k0) r_end = 0;

  float dk[2][NI], dv[2][NI];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) dk[r][i] = dv[r][i] = 0.f;

  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const size_t qbase = ((size_t)b * a.hq + h) * a.sq;
    for (long long q0 = (r_begin / kBQ) * kBQ; q0 < r_end; q0 += kBQ) {
      const int rows = (int)min((long long)kBQ, a.sq - q0);
      __syncthreads();                   // the last tile is consumed
      stage(qs, ld, static_cast<const T*>(a.q) + qbase * d, (int)q0, a.sq, d, kBQ);
      stage(dos, ld, static_cast<const T*>(a.dout) + qbase * d, (int)q0, a.sq, d, kBQ);
      for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
        ls[r] = r < rows ? a.lse[qbase + q0 + r] : 0.f;
        dl[r] = r < rows ? a.delta[qbase + q0 + r] : 0.f;
      }
      __syncthreads();
      float p[2][4], ds[2][4];
      scores(a, qs, dos, ks, vs, ls, dl, ld, qoff + q0, rows, k0, kv_len, win, p, ds);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(2 * ty + r) * (kBK + 1) + tx + 8 * j] = p[r][j];
          dss[(2 * ty + r) * (kBK + 1) + tx + 8 * j] = ds[r][j];
        }
      __syncthreads();
      // this thread's keys 2 ty, 2 ty + 1 and head dims tx + 8 i
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        const float pa = ps[r * (kBK + 1) + 2 * ty], pb = ps[r * (kBK + 1) + 2 * ty + 1];
        const float da = dss[r * (kBK + 1) + 2 * ty], db = dss[r * (kBK + 1) + 2 * ty + 1];
        const float* grow = dos + r * ld;
        const float* qrow = qs + r * ld;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int c = tx + 8 * i;
          const float gv = c < d ? grow[c] : 0.f;
          const float qv = c < d ? qrow[c] : 0.f;
          dv[0][i] = fmaf(pa, gv, dv[0][i]);
          dv[1][i] = fmaf(pb, gv, dv[1][i]);
          dk[0][i] = fmaf(da, qv, dk[0][i]);
          dk[1][i] = fmaf(db, qv, dk[1][i]);
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + kbase * d;
  T* dvg = static_cast<T*>(a.dv) + kbase * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = 2 * ty + r;
    if (key >= keys) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = tx + 8 * i;
      if (c < d) {
        store(dkg + (size_t)(k0 + key) * d + c, dk[r][i]);
        store(dvg + (size_t)(k0 + key) * d + c, dv[r][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 inputs, every head dim up to 160.  The products run
// on mma.sync m16n8k16 (bf16 in, f32 accumulators) with the fragment layout
// of the forward's tensor-core body (flash_attention.cu): row-major A
// fragments by ldmatrix, B fragments by ldmatrix (S = Q.K^T style) or
// ldmatrix.trans (P.V style), and the accumulators of one product reused
// as the A fragments of the next.  P and dS enter their products as a hi
// and a lo bf16 half (~16 bits, as the forward's P).  A CTA is 4 warps x 16
// rows: 64 query rows of one head (dQ pass) or 64 keys of one KV head
// (dK/dV pass); the tiles it walks (64 keys, or 64 query rows) arrive
// through a 2-stage cp.async ring.  Every fragment of the CTA's own rows is
// read from shared memory per use, so only S, dP and the f32 outputs stay
// in registers (dK and dV of 16 keys x DP each: 2 DP / 8 a thread).  Past
// DP 128 (stablelm-12b's 160) dK and dV take a launch each, so a call is
// four launches there (delta, dQ, dV, dK) and three below.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcTile = 64;            // rows of a CTA and of a walked tile
constexpr int kTcThreads = 128;        // 4 warps x 16 rows
constexpr int kStages = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
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
// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) as a bf16 pair hi plus the bf16 pair lo of what hi rounded off.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// Rows [first, first + 64) of a row-major (rows, d) bf16 array into dst
// (stride ld, dp >= d columns); rows at or past `end` and columns d..dp
// read as 0.  With vec (d a multiple of 8, 16-byte aligned rows) by
// cp.async 16-byte copies left in flight, else by element copies.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, int first,
                                           int end, int d, int dp, bool vec) {
  if (vec) {
    const int per_row = dp / 8;
    for (int c = threadIdx.x; c < kTcTile * per_row; c += blockDim.x) {
      const int r = c / per_row, col = (c - r * per_row) * 8;
      const bool ok = first + r < end && col < d;
      cp_async16(dst + r * ld + col, ok ? src + (size_t)(first + r) * d + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTcTile * dp; e += blockDim.x) {
      const int r = e / dp, col = e - r * dp;
      const bool ok = first + r < end && col < d;
      dst[r * ld + col] = ok ? src[(size_t)(first + r) * d + col] : __float2bfloat16(0.f);
    }
  }
}

// acc[n] (16 rows x 8 columns each, 8 n-tiles = 64 columns) += A (the 16
// rows of this warp at `a_rows`, stride ld) . B^T, B the 64 rows of `b_rows`
// (stride ld), over DP/16 k-steps: the S = Q.K^T pattern.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a_rows,
                                        const bf16* b_rows, int ld) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    unsigned af[4];
    ldsm_x4(af, a_rows + (lane % 16) * ld + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bf[4];
      ldsm_x4(bf, b_rows + (np * 16 + (lane % 8) + (lane / 16) * 8) * ld + kk * 16 +
                      ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[n] (16 rows x DP columns, DP/8 n-tiles) += X . B, X the 16 x 64 f32
// accumulators `x` of this warp (as hi + lo bf16 A fragments), B the 64
// rows of `b_rows` (stride ld, DP columns): the O += P.V pattern.
template <int DP>
__device__ __forceinline__ void mma_xb(float (&out)[DP / 8][4], const float (&x)[8][4],
                                       const bf16* b_rows, int ld) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    unsigned ph[4], pl[4];
    split_bf16(x[2 * kb][0], x[2 * kb][1], ph[0], pl[0]);
    split_bf16(x[2 * kb][2], x[2 * kb][3], ph[1], pl[1]);
    split_bf16(x[2 * kb + 1][0], x[2 * kb + 1][1], ph[2], pl[2]);
    split_bf16(x[2 * kb + 1][2], x[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b_rows + (kb * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld + dp * 16 +
                            (lane / 16) * 8);
      mma_bf16(out[2 * dp], ph, bf[0], bf[1]);
      mma_bf16(out[2 * dp + 1], ph, bf[2], bf[3]);
      mma_bf16(out[2 * dp], pl, bf[0], bf[1]);
      mma_bf16(out[2 * dp + 1], pl, bf[2], bf[3]);
    }
  }
}

// Pass 1 on the tensor cores: dQ of 64 query rows of one head.
template <int DP>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_tc(const Args a, int vec) {
  constexpr int LD = DP + 8;       // row stride: ldmatrix rows hit distinct banks
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // (64, LD)
  bf16* dos = qs + kTcTile * LD;                         // (64, LD)
  bf16* ks = dos + kTcTile * LD;                         // (kStages, 64, LD)
  bf16* vs = ks + kStages * kTcTile * LD;                // (kStages, 64, LD)
  float* ls = reinterpret_cast<float*>(vs + kStages * kTcTile * LD);   // (64)
  float* dl = ls + kTcTile;                                             // (64)

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * kTcTile;
  const int d = a.d;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b];
  const long long win = a.window[0];
  const size_t qbase = ((size_t)b * a.hq + h) * a.sq;
  const bf16* qg = static_cast<const bf16*>(a.q) + qbase * d;
  const bf16* gg = static_cast<const bf16*>(a.dout) + qbase * d;
  const bf16* kg = static_cast<const bf16*>(a.k) + ((size_t)b * a.hkv + hk) * a.skv * d;
  const bf16* vg = static_cast<const bf16*>(a.v) + ((size_t)b * a.hkv + hk) * a.skv * d;

  const int rows = min(kTcTile, a.sq - q0);
  long long k_begin = qoff + q0 - win + 1;
  if (k_begin < 0) k_begin = 0;
  long long k_end = kv_len;
  if (a.causal && qoff + q0 + rows < k_end) k_end = qoff + q0 + rows;
  const int t_start = (int)((k_begin / kTcTile) * kTcTile);
  const int n_tiles = k_end > k_begin ? (int)((k_end - t_start + kTcTile - 1) / kTcTile) : 0;

  stage_rows(qs, LD, qg, q0, a.sq, d, DP, vec);
  stage_rows(dos, LD, gg, q0, a.sq, d, DP, vec);
  cp_async_commit();
  for (int r = threadIdx.x; r < kTcTile; r += blockDim.x) {
    ls[r] = r < rows ? a.lse[qbase + q0 + r] : 0.f;
    dl[r] = r < rows ? a.delta[qbase + q0 + r] : 0.f;
  }
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_tiles) {
      stage_rows(ks + p * kTcTile * LD, LD, kg, t_start + p * kTcTile, (int)k_end, d, DP, vec);
      stage_rows(vs + p * kTcTile * LD, LD, vg, t_start + p * kTcTile, (int)k_end, d, DP, vec);
    }
    cp_async_commit();
  }

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const int r0 = warp * 16 + g, r1 = r0 + 8;            // this thread's rows, local
  const long long qp0 = qoff + q0 + r0, qp1 = qp0 + 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int nx = it + kStages - 1;
    if (nx < n_tiles) {
      const int st = nx % kStages;
      stage_rows(ks + st * kTcTile * LD, LD, kg, t_start + nx * kTcTile, (int)k_end, d, DP, vec);
      stage_rows(vs + st * kTcTile * LD, LD, vg, t_start + nx * kTcTile, (int)k_end, d, DP, vec);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const long long t0 = t_start + it * kTcTile;
    const bf16* kt = ks + (it % kStages) * kTcTile * LD;
    const bf16* vt = vs + (it % kStages) * kTcTile * LD;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<DP>(s, qs + warp * 16 * LD, kt, LD);
    mma_abt<DP>(dp, dos + warp * 16 * LD, vt, LD);
    const float l0 = ls[r0], l1 = ls[r1], d0 = dl[r0], d1 = dl[r1];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kp = t0 + n * 8 + 2 * t + (e & 1);
        const long long qp = e < 2 ? qp0 : qp1;
        const int r = e < 2 ? r0 : r1;
        bool pred = r < rows && kp < kv_len && kp > qp - win;
        if (a.causal) pred = pred && qp >= kp;
        const float p = pred ? expf(s[n][e] * a.scale - (e < 2 ? l0 : l1)) : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? d0 : d1)) * a.scale;     // dS
      }
    }
    mma_xb<DP>(dq, s, kt, LD);
    __syncthreads();               // every warp is done with this stage
  }
  cp_async_wait<0>();

  bf16* dqg = static_cast<bf16*>(a.dq) + qbase * d;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= d) continue;
      if (r0 < rows) dqg[(size_t)(q0 + r0) * d + c + e] = __float2bfloat16(dq[n][e]);
      if (r1 < rows) dqg[(size_t)(q0 + r1) * d + c + e] = __float2bfloat16(dq[n][2 + e]);
    }
  }
}

// Pass 2 on the tensor cores: dK and dV of 64 keys of one KV head, walking
// the group's query heads in order and, in each, the 64-row query tiles
// that may attend its keys (the tiles of all heads form one ring).  kOut
// says which it writes: kBoth; or, where a warp's dK and dV accumulators
// (16 keys x DP each) would not fit its registers together (DP > 128), one
// launch for kDV (no dP product) and one for kDK, each recomputing S.
constexpr int kDV = 1, kDK = 2, kBoth = kDV | kDK;
template <int DP, int kOut>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkdv_tc(const Args a, int vec) {
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);        // (64, LD)
  bf16* vs = ks + kTcTile * LD;                          // (64, LD)
  bf16* qs = vs + kTcTile * LD;                          // (kStages, 64, LD)
  bf16* dos = qs + kStages * kTcTile * LD;               // (kStages, 64, LD)
  float* ls = reinterpret_cast<float*>(dos + kStages * kTcTile * LD);  // (kStages, 64)
  float* dl = ls + kStages * kTcTile;                                   // (kStages, 64)

  const int b = blockIdx.z, hk = blockIdx.y, group = a.hq / a.hkv;
  const int k0 = blockIdx.x * kTcTile;
  const int d = a.d;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const long long kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b];
  const long long win = a.window[0];
  const size_t kbase = ((size_t)b * a.hkv + hk) * a.skv;
  const bf16* kg = static_cast<const bf16*>(a.k) + kbase * d;
  const bf16* vg = static_cast<const bf16*>(a.v) + kbase * d;

  // query rows that may attend a key of [k0, k1), as the CUDA-core body
  const long long k1 = min((long long)k0 + kTcTile, kv_len);
  long long r_begin = a.causal ? k0 - qoff : 0;
  if (r_begin < 0) r_begin = 0;
  long long r_end = k1 - 1 + win - qoff;
  if (r_end > a.sq) r_end = a.sq;
  if (k1 <= k0) r_end = 0;
  const int q_first = (int)((r_begin / kTcTile) * kTcTile);
  const int per_head = r_end > r_begin ? (int)((r_end - q_first + kTcTile - 1) / kTcTile) : 0;
  const int n_tiles = per_head * group;

  auto stage_tile = [&](int i, int st) {
    const int hg = i / per_head, q0 = q_first + (i - hg * per_head) * kTcTile;
    const size_t qbase = ((size_t)b * a.hq + hk * group + hg) * a.sq;
    stage_rows(qs + st * kTcTile * LD, LD, static_cast<const bf16*>(a.q) + qbase * d, q0, a.sq,
               d, DP, vec);
    stage_rows(dos + st * kTcTile * LD, LD, static_cast<const bf16*>(a.dout) + qbase * d, q0,
               a.sq, d, DP, vec);
    for (int r = threadIdx.x; r < kTcTile; r += blockDim.x) {
      const bool ok = q0 + r < a.sq;
      ls[st * kTcTile + r] = ok ? a.lse[qbase + q0 + r] : 0.f;
      dl[st * kTcTile + r] = ok ? a.delta[qbase + q0 + r] : 0.f;
    }
  };

  stage_rows(ks, LD, kg, k0, a.skv, d, DP, vec);
  stage_rows(vs, LD, vg, k0, a.skv, d, DP, vec);
  cp_async_commit();
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_tiles) stage_tile(p, p);
    cp_async_commit();
  }

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int r0 = warp * 16 + g;                          // this thread's keys, local
  const long long kp0 = k0 + r0, kp1 = kp0 + 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int nx = it + kStages - 1;
    if (nx < n_tiles) stage_tile(nx, nx % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = it % kStages;
    const int hg = it / per_head;
    const long long q0 = q_first + (it - hg * per_head) * kTcTile;
    const bf16* qt = qs + st * kTcTile * LD;
    const bf16* gt = dos + st * kTcTile * LD;
    const float* lt = ls + st * kTcTile;
    const float* dt = dl + st * kTcTile;
    float s[8][4], dp[8][4];        // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<DP>(s, ks + warp * 16 * LD, qt, LD);
    if constexpr ((kOut & kDK) != 0) mma_abt<DP>(dp, vs + warp * 16 * LD, gt, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);             // query, local
        const long long qp = qoff + q0 + c;
        const long long kp = e < 2 ? kp0 : kp1;
        bool pred = q0 + c < a.sq && kp < kv_len && kp > qp - win;
        if (a.causal) pred = pred && qp >= kp;
        const float p = pred ? expf(s[n][e] * a.scale - lt[c]) : 0.f;
        s[n][e] = p;                                        // P^T
        dp[n][e] = p * (dp[n][e] - dt[c]) * a.scale;        // dS^T
      }
    }
    if constexpr ((kOut & kDV) != 0) mma_xb<DP>(dv, s, gt, LD);
    if constexpr ((kOut & kDK) != 0) mma_xb<DP>(dk, dp, qt, LD);
    __syncthreads();               // every warp is done with this stage
  }
  cp_async_wait<0>();

  const int keys = min(kTcTile, a.skv - k0);
  bf16* dkg = static_cast<bf16*>(a.dk) + kbase * d;
  bf16* dvg = static_cast<bf16*>(a.dv) + kbase * d;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= d) continue;
      if (r0 < keys) {
        if constexpr ((kOut & kDK) != 0)
          dkg[(size_t)(k0 + r0) * d + c + e] = __float2bfloat16(dk[n][e]);
        if constexpr ((kOut & kDV) != 0)
          dvg[(size_t)(k0 + r0) * d + c + e] = __float2bfloat16(dv[n][e]);
      }
      if (r0 + 8 < keys) {
        if constexpr ((kOut & kDK) != 0)
          dkg[(size_t)(k0 + r0 + 8) * d + c + e] = __float2bfloat16(dk[n][2 + e]);
        if constexpr ((kOut & kDV) != 0)
          dvg[(size_t)(k0 + r0 + 8) * d + c + e] = __float2bfloat16(dv[n][2 + e]);
      }
    }
  }
}

template <int DP, int kOut>
int launch_dkdv_tc(const Args& a, int b, int vec, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<DP, kOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_tc<DP, kOut>
      <<<dim3((a.skv + kTcTile - 1) / kTcTile, a.hkv, b), kTcThreads, smem, st>>>(a, vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tc(const Args& a, int b, int vec, cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (size_t)(DP + 8) * kTcTile * (2 + 2 * kStages) +
                      sizeof(float) * 2 * kStages * kTcTile;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * a.hq * a.sq;
  const int per = kThreads / kWarp;
  flash_bwd_delta<bf16><<<(unsigned)((rows + per - 1) / per), kThreads, 0, st>>>(a, rows);
  flash_bwd_dq_tc<DP><<<dim3((a.sq + kTcTile - 1) / kTcTile, a.hq, b), kTcThreads, smem, st>>>(
      a, vec);
  if constexpr (DP <= kBothTcD) {
    return launch_dkdv_tc<DP, kBoth>(a, b, vec, smem, st);
  } else {
    const int e = launch_dkdv_tc<DP, kDV>(a, b, vec, smem, st);
    return e != 0 ? e : launch_dkdv_tc<DP, kDK>(a, b, vec, smem, st);
  }
}

// The tensor-core body's instance for head dim d (rounded up to 16).
int launch_tc_d(const Args& a, int b, int vec, cudaStream_t st) {
  switch ((a.d + 15) / 16) {
    case 1: return launch_tc<16>(a, b, vec, st);
    case 2: return launch_tc<32>(a, b, vec, st);
    case 3: return launch_tc<48>(a, b, vec, st);
    case 4: return launch_tc<64>(a, b, vec, st);
    case 5: return launch_tc<80>(a, b, vec, st);
    case 6: return launch_tc<96>(a, b, vec, st);
    case 7: return launch_tc<112>(a, b, vec, st);
    case 8: return launch_tc<128>(a, b, vec, st);
    case 9: return launch_tc<144>(a, b, vec, st);
    case 10: return launch_tc<160>(a, b, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int NI>
int launch_ni(const Args& a, int b, cudaStream_t st) {
  const int ld = a.d + 1;
  const size_t tiles = sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * ld + 2 * kBQ);
  const size_t smem_dq = tiles + sizeof(float) * kBQ * (kBK + 1);
  const size_t smem_kv = tiles + sizeof(float) * 2 * kBQ * (kBK + 1);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<T, NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, NI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * a.hq * a.sq;
  const int per = kThreads / kWarp;
  flash_bwd_delta<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0, st>>>(a, rows);
  flash_bwd_dq<T, NI><<<dim3((a.sq + kBQ - 1) / kBQ, a.hq, b), kThreads, smem_dq, st>>>(a);
  flash_bwd_dkdv<T, NI><<<dim3((a.skv + kBK - 1) / kBK, a.hkv, b), kThreads, smem_kv, st>>>(a);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& a, int b, cudaStream_t st) {
  if (a.d <= 64) return launch_ni<float, 8>(a, b, st);
  if (a.d <= 80) return launch_ni<float, 10>(a, b, st);
  if (a.d <= 128) return launch_ni<float, 16>(a, b, st);
  return launch_ni<float, 20>(a, b, st);
}

}  // namespace

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o and dout like q, all f32
// (is_bf16 = 0: the CUDA-core body) or all bf16 (1: the tensor-core body);
// lse (B, Hq, Sq) f32 from the forward; delta (B, Hq, Sq) f32 scratch;
// dq/dk/dv like q/k/v; kv_lens, q_offset (B,) and window (1,) int32.  Three
// launches on `stream`: delta, dQ, dK/dV (four on the tensor-core body past
// head dim 128).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, const int* kv_lens, const int* q_offset,
                                   const int* window, int b, int hq, int hkv, int sq, int skv,
                                   int d, int causal, float scale, int is_bf16, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 0 || skv < 0 || d < 1 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  if (sq == 0 || skv == 0) return (int)cudaGetLastError();
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, kv_lens, q_offset, window,
         hq, hkv, sq, skv, d, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(dout);
    return launch_tc_d(a, b, vec, st);
  }
  return launch_f32(a, b, st);
}
