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
//   dQ = dS K            (launch 2: one CTA per 128 query rows of one
//                         head, walking the KV tiles its rows may attend)
//   dV = P^T dO, dK = dS^T Q
//                        (launch 3: one CTA per 128 keys of one KV head,
//                         walking the group's query heads and the query
//                         tiles that may attend its keys)
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
// Two bodies, chosen by the wrapper (kernel.plan_bwd): bf16 takes the
// wgmma body (below, after the first design), f32 the CUDA-core body, which
// the tensor cores would round to TF32 (it is instantiated for f32 only):
// lse and the delta scratch f32, the arithmetic f32 on the CUDA cores,
// every tile staged in shared memory (rows padded to an odd stride, so a
// warp's reads of one column across rows hit distinct banks).  Each thread
// owns 2 rows x 4 keys of S and dP and 2 rows x ceil(D / 8) head dims of its
// dQ (or dK and dV) accumulators: at D 160 that is 40 (80) f32 registers.
// Every head dim <= 160 runs.
//
// The wgmma body (bf16, head dims 64, 80, 128 and 160; the wrapper pads any
// other to the next of these with zero columns).  A CTA is three
// warpgroups: the first is the producer (24 registers a thread after
// setmaxnreg), whose first thread keeps TMA loads in flight
// (cp.async.bulk.tensor into a ring of mbarrier-guarded stages); the other
// two are consumers of 64 rows each (240 registers) that only compute.  Every
// product is a warpgroup wgmma (m64nNk16, bf16 in, f32 accumulators) on
// 128-byte-swizzled shared tiles addressed by matrix descriptors.  A row of
// a tile is loaded as boxes of 64 columns (80 = 64 + 16, 160 = 64 + 64 + 32;
// TMA fills the rest of the last box, and sequence tails, with zeros): a
// product over D (S, dP) steps through the boxes, a product of N = D
// columns (dQ, dV, dK) is one wgmma whose descriptor strides from box to
// box.  The dQ pass loads its 128 rows of Q and dO once and streams 64-key
// tiles of K and V: S = Q K^T and dP = dO V^T run shared x shared, P and dS
// are formed in the accumulators, and dQ += dS K takes dS from registers as
// the A operand and K as B through the descriptor's transpose.  The dK/dV
// pass loads its 128 keys of K and V once and streams query tiles of Q and
// dO, 64 rows (48 at D 128 and 32 at D 160, so that dK and dV of 64 keys x D
// fit beside S^T and dP^T with no spill, in one launch), with the tile
// rows' lse and delta, which the producer's first warp copies beside the
// TMA loads: S^T = K Q^T and dP^T = V dO^T leave P^T and dS^T in the A
// operand layout of dV += P^T dO and dK += dS^T Q, so neither passes
// through shared memory, and dV's products run while dS^T is formed.  P and
// dS enter their products as a hi and a lo bf16 half: as one bf16 operand
// each (FlashAttention's choice) the gradients miss chip_smoke.py's
// TOL["bwd"] against the f32 backward (tests/test_torch_flash_bwd.py models
// the rounding; --bwd-probes runs such a copy on the card), so a call runs
// 10 products of S x S x D (S and dP in both passes, dQ, dV and dK twice)
// against the bound's 5.  Both consumers run every tile of their CTA's walk
// (a branch around the products cost more than the few tiles it skipped);
// only tiles that cross the predicate's edge evaluate it.
//
// What bounds it on an H100.  The backward does five S x S x D products,
// halved by a causal mask: at long sequences it is bound by operations
// (989 TFLOP/s bf16).  The dQ pass's CTAs start with the longest rows; the
// dK/dV pass's CTAs run in key order, the most-attended keys first.
//
// C interface for ctypes: pointers and the stream are void*, the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda.h>
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
// The bf16 body: warpgroup wgmma fed by a TMA ring (see the header).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWgThreads = 384;        // a producer warpgroup and two consumers
constexpr int kConsumers = 2;
constexpr int kRows = 64;              // rows of one consumer warpgroup (wgmma M)
constexpr int kCtaRows = kConsumers * kRows;
constexpr int kKeyTile = 64;           // keys per tile of the dQ pass
constexpr int kSw = 64;                // bf16 columns of one 128-byte swizzled box
constexpr int kRowBytes = 128;         // one row of a box in shared memory
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// The plan of head dim DP (64, 80, 128 or 160: the wrapper pads any other
// head dim to the next of these).  kernel.plan_bwd_launch mirrors it, and
// the wrapper passes its two shared-memory sizes, which the launcher checks.
template <int DP>
struct WgPlan {
  static constexpr int NR = (DP + kSw - 1) / kSw;            // boxes per row
  static constexpr int BQ = DP > 128 ? 32 : (DP > 80 ? 48 : 64);   // query rows per dK/dV tile
  static constexpr int DQ_STAGES = DP > 128 ? 2 : 4;
  static constexpr int KV_STAGES = 4;
  // 1024 of alignment slack, the CTA's 128 rows of two tensors, the ring,
  // 256 bytes of mbarriers
  static constexpr int DQ_SMEM =
      1024 + 2 * NR * kCtaRows * kRowBytes + DQ_STAGES * 2 * NR * kKeyTile * kRowBytes + 256;
  static constexpr int KV_SMEM = 1024 + 2 * NR * kCtaRows * kRowBytes +
                                 KV_STAGES * (2 * NR * BQ * kRowBytes + 2 * BQ * 4) + 256;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// mbarriers
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A TMA load into shared memory, completing on `bar`: a box of a 3-d map
// (columns, rows, head).
__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                     int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr` (the box 1024-byte aligned; a K-major k-step advances `addr`
// by 32 bytes inside it): 8-row groups 1024 bytes apart; for an MN-major
// operand wider than one box, `lead` bytes from one box of 64 columns to
// the next.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr, unsigned lead = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulators that an
// asynchronous wgmma owns across the fence, commit or wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Keeps A fragments (registers a wgmma reads until its group is waited
// for) alive to here, so nothing is allocated into them before.
template <int K>
__device__ __forceinline__ void fence_frags(const unsigned (&f)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(f[i][j]) : "memory");
}

// d (m64nN, f32) = or += A . B: A (64 x 16) and B (N x 16), both K-major in
// shared memory (the S = Q K^T pattern); acc 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc);
// d (m64nN, f32) += A . B: A (64 x 16 bf16) in registers (the accumulator
// layout of a product just computed), B (16 x N) MN-major in shared memory
// (rows of K, columns of N contiguous: the O += P V pattern).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const unsigned (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<48>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<160>(float* d, const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x += A . B^T over the DP / 16 k-steps of DP columns: A the 64 rows at
// `a_box0` (boxes `a_box` bytes apart), B the rows at `b_box0` (boxes
// `b_box` bytes apart), both K-major; the first step overwrites x.
template <int DP, int N>
__device__ __forceinline__ void wgmma_abt(float* x, unsigned a_box0, int a_box, unsigned b_box0,
                                          int b_box) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk % 4) * 32;
    wgmma_ss<N>(x, desc_sw128(a_box0 + (kk / 4) * a_box + off),
                desc_sw128(b_box0 + (kk / 4) * b_box + off), kk > 0);
  }
}

// 2^x (ex2.approx: relative error ~2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as a bf16 pair hi plus the bf16 pair lo of what hi rounded off.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// The accumulators x (64 x N) as the A fragments of N / 16 k-steps, hi and lo.
template <int N>
__device__ __forceinline__ void to_a_frags(const float* x, unsigned (&hi)[N / 16][4],
                                           unsigned (&lo)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(x[8 * kc + 2 * i], x[8 * kc + 2 * i + 1], hi[kc][i], lo[kc][i]);
}

struct DqMaps {
  CUtensorMap q, dout, k, v;          // boxes of 128 query rows, 64 keys
};
struct KvMaps {
  CUtensorMap k, v, q, dout;          // boxes of 128 keys, BQ query rows
};

// Pass 1: dQ of 128 query rows of one head, 64 per consumer warpgroup,
// walking the 64-key tiles its rows may attend (the longest rows first).
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wg(const __grid_constant__ DqMaps m, const Args a) {
  using Plan = WgPlan<DP>;
  constexpr int NR = Plan::NR, S = Plan::DQ_STAGES;
  constexpr int QBOX = kCtaRows * kRowBytes, KBOX = kKeyTile * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);            // (NR, 128, 128 B)
  unsigned char* dos = qs + NR * QBOX;                 // (NR, 128, 128 B)
  unsigned char* ks = dos + NR * QBOX;                 // (S, NR, 64, 128 B)
  unsigned char* vs = ks + S * NR * KBOX;              // (S, NR, 64, 128 B)
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + S * NR * KBOX);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (a.hq / a.hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kCtaRows;
  const int rows = min(kCtaRows, a.sq - q0);
  const long long kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b], win = a.window[0];
  // keys outside [k_begin, k_end) are masked for every row of the CTA
  long long k_begin = qoff + q0 - win + 1;
  if (k_begin < 0) k_begin = 0;
  long long k_end = kv_len;
  if (a.causal && qoff + q0 + rows < k_end) k_end = qoff + q0 + rows;
  const int t_start = k_end > k_begin ? (int)((k_begin / kKeyTile) * kKeyTile) : 0;
  const int n_tiles = k_end > k_begin ? (int)((k_end - t_start + kKeyTile - 1) / kKeyTile) : 0;

  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: one thread keeps the ring's TMA loads in flight
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int qh = b * a.hq + h, kh = b * a.hkv + hk;
      bar_arrive_tx(qbar, 2 * NR * QBOX);
      for (int r = 0; r < NR; ++r) {
        tma3(qs + r * QBOX, &m.q, qbar, r * kSw, q0, qh);
        tma3(dos + r * QBOX, &m.dout, qbar, r * kSw, q0, qh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        if (it >= S) bar_wait(empty + s, (it / S - 1) & 1);
        bar_arrive_tx(full + s, 2 * NR * KBOX);
        const int t0 = t_start + it * kKeyTile;
        for (int r = 0; r < NR; ++r) {
          tma3(ks + (s * NR + r) * KBOX, &m.k, full + s, r * kSw, t0, kh);
          tma3(vs + (s * NR + r) * KBOX, &m.v, full + s, r * kSw, t0, kh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = c * kRows + w * 16 + g, r1 = r0 + 8;          // this thread's rows, local
  const size_t qbase = ((size_t)b * a.hq + h) * a.sq + q0;
  const float scale_log2 = a.scale * kLog2e;
  // the rows' lse in base 2, and delta times scale: dS = P (dP scale - delta scale)
  const float lr[2] = {r0 < rows ? a.lse[qbase + r0] * kLog2e : 0.f,
                       r1 < rows ? a.lse[qbase + r1] * kLog2e : 0.f};
  const float dr[2] = {r0 < rows ? a.delta[qbase + r0] * a.scale : 0.f,
                       r1 < rows ? a.delta[qbase + r1] * a.scale : 0.f};
  const int qp0 = (int)qoff + q0 + r0;                          // row r0's position
  const int kvl = (int)kv_len, wn = (int)win;
  // the keys every row of this warpgroup attends, [kf_lo, kf_hi): a tile
  // inside them needs no predicate.  Both warpgroups run every tile of the
  // CTA's walk (a tile no row of one attends gives it P = 0): a branch
  // around the products costs more than the few tiles it would skip
  const int qa = q0 + c * kRows, rows_c = rows - c * kRows;
  const long long kf_lo = qoff + qa + kRows - win;
  long long kf_hi = rows_c >= kRows ? kv_len : 0;
  if (a.causal && qoff + qa + 1 < kf_hi) kf_hi = qoff + qa + 1;

  float dq[DP / 2], s[kKeyTile / 2], dp[kKeyTile / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeyTile / 2; ++i) s[i] = dp[i] = 0.f;
  const unsigned q_a = smem_u32(qs) + c * kRows * kRowBytes;
  const unsigned do_a = smem_u32(dos) + c * kRows * kRowBytes;
  bar_wait(qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % S;
    bar_wait(full + st, (it / S) & 1);
    const int t0 = t_start + it * kKeyTile;
    const unsigned k_a = smem_u32(ks) + st * NR * KBOX;
    const unsigned v_a = smem_u32(vs) + st * NR * KBOX;
    fence_regs<kKeyTile / 2>(s);
    fence_regs<kKeyTile / 2>(dp);
    wgmma_fence();
    wgmma_abt<DP, kKeyTile>(s, q_a, QBOX, k_a, KBOX);        // S = Q K^T
    wgmma_commit();
    wgmma_abt<DP, kKeyTile>(dp, do_a, QBOX, v_a, KBOX);      // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<kKeyTile / 2>(s);
    if (t0 >= kf_lo && t0 + kKeyTile <= kf_hi) {            // P, every key live
#pragma unroll
      for (int i = 0; i < kKeyTile / 2; ++i)
        s[i] = ex2(fmaf(s[i], scale_log2, -lr[(i >> 1) & 1]));
    } else {                                                  // P under the predicate
#pragma unroll
      for (int i = 0; i < kKeyTile / 2; ++i) {
        const int kp = t0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const int hf = (i >> 1) & 1, qp = qp0 + 8 * hf;
        bool pred = r0 + 8 * hf < rows && kp < kvl && kp > qp - wn;
        if (a.causal) pred = pred && qp >= kp;
        const float x = ex2(fmaf(s[i], scale_log2, -lr[hf]));
        s[i] = pred ? x : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<kKeyTile / 2>(dp);
#pragma unroll
    for (int i = 0; i < kKeyTile / 2; ++i)
      dp[i] = s[i] * fmaf(dp[i], a.scale, -dr[(i >> 1) & 1]);   // dS
    unsigned hi[kKeyTile / 16][4], lo[kKeyTile / 16][4];
    to_a_frags<kKeyTile>(dp, hi, lo);
    fence_regs<DP / 2>(dq);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 16; ++kc) {             // dQ += dS K, hi then lo
      wgmma_rs<DP>(dq, hi[kc], desc_sw128(k_a + kc * 16 * kRowBytes, KBOX));
      wgmma_rs<DP>(dq, lo[kc], desc_sw128(k_a + kc * 16 * kRowBytes, KBOX));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq);
    fence_frags(hi);
    fence_frags(lo);
    if (lane == 0) bar_arrive(empty + st);
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + qbase * DP;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)r0 * DP + col) =
          __floats2bfloat162_rn(dq[4 * n], dq[4 * n + 1]);
    if (r1 < rows)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)r1 * DP + col) =
          __floats2bfloat162_rn(dq[4 * n + 2], dq[4 * n + 3]);
  }
}

// Pass 2: dK and dV of 128 keys of one KV head, 64 per consumer warpgroup,
// walking the group's query heads in order and, in each, the BQ-row query
// tiles that may attend its keys.  S^T = K Q^T and dP^T = V dO^T, so P^T
// and dS^T are already the A fragments of dV += P^T dO and dK += dS^T Q.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wg(const __grid_constant__ KvMaps m, const Args a) {
  using Plan = WgPlan<DP>;
  constexpr int NR = Plan::NR, S = Plan::KV_STAGES, BQ = Plan::BQ;
  constexpr int KBOX = kCtaRows * kRowBytes, QBOX = BQ * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);            // (NR, 128, 128 B)
  unsigned char* vs = ks + NR * KBOX;                  // (NR, 128, 128 B)
  unsigned char* qs = vs + NR * KBOX;                  // (S, NR, BQ, 128 B)
  unsigned char* dos = qs + S * NR * QBOX;             // (S, NR, BQ, 128 B)
  float* ls = reinterpret_cast<float*>(dos + S * NR * QBOX);   // (S, BQ) lse log2(e)
  float* dls = ls + S * BQ;                                     // (S, BQ) delta scale
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(dls + S * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;

  const int b = blockIdx.z, hk = blockIdx.y, group = a.hq / a.hkv;
  const int k0 = blockIdx.x * kCtaRows;
  const long long kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b], win = a.window[0];
  // query rows that may attend a key of [k0, k1): qpos >= k0 (causal) and
  // qpos < k1 - 1 + window; none when the block lies past kv_len
  const long long k1 = min((long long)k0 + kCtaRows, kv_len);
  long long r_begin = a.causal ? k0 - qoff : 0;
  if (r_begin < 0) r_begin = 0;
  long long r_end = k1 - 1 + win - qoff;
  if (r_end > a.sq) r_end = a.sq;
  if (k1 <= k0) r_end = 0;
  const int q_first = r_end > r_begin ? (int)((r_begin / BQ) * BQ) : 0;
  const int per_head = r_end > r_begin ? (int)((r_end - q_first + BQ - 1) / BQ) : 0;
  const int n_tiles = per_head * group;

  if (threadIdx.x == 0) {
    bar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, kWarp);
      bar_init(empty + s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: the first warp; its lane 0 keeps the TMA loads in
    // flight, and every lane copies lse and delta of its tile rows (a row
    // of a head starts on no 16-byte boundary TMA would take) and arrives
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < kWarp) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        const int kh = b * a.hkv + hk;
        bar_arrive_tx(kvbar, 2 * NR * KBOX);
        for (int r = 0; r < NR; ++r) {
          tma3(ks + r * KBOX, &m.k, kvbar, r * kSw, k0, kh);
          tma3(vs + r * KBOX, &m.v, kvbar, r * kSw, k0, kh);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        if (it >= S) bar_wait(empty + s, (it / S - 1) & 1);
        const int hg = it / per_head;
        const int q0 = q_first + (it - hg * per_head) * BQ;
        const int qh = b * a.hq + hk * group + hg;
        for (int r = lane; r < BQ; r += kWarp) {
          const bool ok = q0 + r < a.sq;
          const size_t row = (size_t)qh * a.sq + q0 + r;
          ls[s * BQ + r] = ok ? a.lse[row] * kLog2e : 0.f;     // base 2
          dls[s * BQ + r] = ok ? a.delta[row] * a.scale : 0.f;
        }
        if (lane == 0) {
          bar_arrive_tx(full + s, 2 * NR * QBOX);
          for (int r = 0; r < NR; ++r) {
            tma3(qs + (s * NR + r) * QBOX, &m.q, full + s, r * kSw, q0, qh);
            tma3(dos + (s * NR + r) * QBOX, &m.dout, full + s, r * kSw, q0, qh);
          }
        } else {
          bar_arrive(full + s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kp0 = k0 + c * kRows + w * 16 + g;                 // this thread's keys: kp0, kp0 + 8
  const int kvl = (int)kv_len, wn = (int)win, qo = (int)qoff;
  const float scale_log2 = a.scale * kLog2e;
  // the query rows that attend all 64 keys of this warpgroup, [rf_lo,
  // rf_hi): a tile inside them needs no predicate (both warpgroups run
  // every tile of the walk, as in the dQ pass)
  const long long kc0 = k0 + c * kRows;
  const long long rf_lo = a.causal ? kc0 + kRows - 1 - qoff : 0;
  long long rf_hi = kc0 + win - qoff;
  if (rf_hi > a.sq) rf_hi = a.sq;
  if (kc0 + kRows > kv_len) rf_hi = 0;

  float dk[DP / 2], dv[DP / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  const unsigned k_a = smem_u32(ks) + c * kRows * kRowBytes;
  const unsigned v_a = smem_u32(vs) + c * kRows * kRowBytes;
  bar_wait(kvbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % S;
    bar_wait(full + st, (it / S) & 1);
    const int hg = it / per_head;
    const int q0 = q_first + (it - hg * per_head) * BQ;
    const unsigned q_a = smem_u32(qs) + st * NR * QBOX;
    const unsigned do_a = smem_u32(dos) + st * NR * QBOX;
    const float* lt = ls + st * BQ;
    const float* dt = dls + st * BQ;
    fence_regs<BQ / 2>(s);
    fence_regs<BQ / 2>(dp);
    wgmma_fence();
    wgmma_abt<DP, BQ>(s, k_a, KBOX, q_a, QBOX);         // S^T = K Q^T
    wgmma_commit();
    wgmma_abt<DP, BQ>(dp, v_a, KBOX, do_a, QBOX);       // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<BQ / 2>(s);
    // element i: key kp0 + 8 ((i >> 1) & 1), query column 8 (i >> 2) + 2 t + (i & 1)
    if (q0 >= rf_lo && q0 + BQ <= rf_hi) {              // P^T, every pair live
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = (i >> 2) * 8 + 2 * t + (i & 1);
        s[i] = ex2(fmaf(s[i], scale_log2, -lt[qc]));
      }
    } else {                                              // P^T under the predicate
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int qc = (i >> 2) * 8 + 2 * t + (i & 1);
        const int qp = qo + q0 + qc, kp = kp0 + 8 * ((i >> 1) & 1);
        bool pred = q0 + qc < a.sq && kp < kvl && kp > qp - wn;
        if (a.causal) pred = pred && qp >= kp;
        const float x = ex2(fmaf(s[i], scale_log2, -lt[qc]));
        s[i] = pred ? x : 0.f;
      }
    }
    unsigned phi[BQ / 16][4], plo[BQ / 16][4];
    to_a_frags<BQ>(s, phi, plo);
    fence_regs<DP / 2>(dv);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {              // dV += P^T dO, hi then lo
      wgmma_rs<DP>(dv, phi[kc], desc_sw128(do_a + kc * 16 * kRowBytes, QBOX));
      wgmma_rs<DP>(dv, plo[kc], desc_sw128(do_a + kc * 16 * kRowBytes, QBOX));
    }
    wgmma_commit();
    wgmma_wait<1>();                                      // dP^T done, dV in flight
    fence_regs<BQ / 2>(dp);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int qc = (i >> 2) * 8 + 2 * t + (i & 1);
      dp[i] = s[i] * fmaf(dp[i], a.scale, -dt[qc]);   // dS^T
    }
    unsigned dhi[BQ / 16][4], dlo[BQ / 16][4];
    to_a_frags<BQ>(dp, dhi, dlo);
    fence_regs<DP / 2>(dk);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {              // dK += dS^T Q, hi then lo
      wgmma_rs<DP>(dk, dhi[kc], desc_sw128(q_a + kc * 16 * kRowBytes, QBOX));
      wgmma_rs<DP>(dk, dlo[kc], desc_sw128(q_a + kc * 16 * kRowBytes, QBOX));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    fence_frags(phi);
    fence_frags(plo);
    fence_frags(dhi);
    fence_frags(dlo);
    if (lane == 0) bar_arrive(empty + st);
  }

  const size_t kbase = ((size_t)b * a.hkv + hk) * a.skv;
  bf16* dkg = static_cast<bf16*>(a.dk) + kbase * DP;
  bf16* dvg = static_cast<bf16*>(a.dv) + kbase * DP;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (kp0 < a.skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)kp0 * DP + col) =
          __floats2bfloat162_rn(dk[4 * n], dk[4 * n + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)kp0 * DP + col) =
          __floats2bfloat162_rn(dv[4 * n], dv[4 * n + 1]);
    }
    if (kp0 + 8 < a.skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)(kp0 + 8) * DP + col) =
          __floats2bfloat162_rn(dk[4 * n + 2], dk[4 * n + 3]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)(kp0 + 8) * DP + col) =
          __floats2bfloat162_rn(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library links no driver library of its own).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (heads, rows, dp) bf16 array as 128-byte-swizzled boxes of 64 columns
// by box_rows rows of one head; past the array's rows and columns TMA
// fills zeros.
bool map_rows(EncodeTiled enc, CUtensorMap* m, const void* p, int dp, int rows, int heads,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dp, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dp * 2, (cuuint64_t)rows * dp * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kSw, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 body at head dim DP: delta, the dQ pass, the dK/dV pass.
template <int DP>
int launch_wg(const Args& a, int b, int smem_dq, int smem_kv, cudaStream_t st) {
  using Plan = WgPlan<DP>;
  if (smem_dq != Plan::DQ_SMEM || smem_kv != Plan::KV_SMEM) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int qheads = b * a.hq, kheads = b * a.hkv;
  DqMaps dm;
  KvMaps km;
  const bool ok = map_rows(enc, &dm.q, a.q, DP, a.sq, qheads, kCtaRows) &&
                  map_rows(enc, &dm.dout, a.dout, DP, a.sq, qheads, kCtaRows) &&
                  map_rows(enc, &dm.k, a.k, DP, a.skv, kheads, kKeyTile) &&
                  map_rows(enc, &dm.v, a.v, DP, a.skv, kheads, kKeyTile) &&
                  map_rows(enc, &km.k, a.k, DP, a.skv, kheads, kCtaRows) &&
                  map_rows(enc, &km.v, a.v, DP, a.skv, kheads, kCtaRows) &&
                  map_rows(enc, &km.q, a.q, DP, a.sq, qheads, Plan::BQ) &&
                  map_rows(enc, &km.dout, a.dout, DP, a.sq, qheads, Plan::BQ);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wg<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wg<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)qheads * a.sq;
  const int per = kThreads / kWarp;
  flash_bwd_delta<bf16><<<(unsigned)((rows + per - 1) / per), kThreads, 0, st>>>(a, rows);
  flash_bwd_dq_wg<DP><<<dim3((a.sq + kCtaRows - 1) / kCtaRows, a.hq, b), kWgThreads, smem_dq,
                        st>>>(dm, a);
  flash_bwd_dkdv_wg<DP><<<dim3((a.skv + kCtaRows - 1) / kCtaRows, a.hkv, b), kWgThreads,
                          smem_kv, st>>>(km, a);
  return (int)cudaGetLastError();
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
// (is_bf16 = 0: the CUDA-core body) or all bf16 (1: the wgmma body, at head
// dims 64, 80, 128 and 160, every pointer 16-byte aligned; smem_dq and
// smem_kv are the wrapper's plan of its two passes' shared memory, checked
// here); lse (B, Hq, Sq) f32 from the forward; delta (B, Hq, Sq) f32
// scratch; dq/dk/dv like q/k/v; kv_lens, q_offset (B,) and window (1,)
// int32.  Three launches on `stream`: delta, dQ, dK/dV.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, const int* kv_lens, const int* q_offset,
                                   const int* window, int b, int hq, int hkv, int sq, int skv,
                                   int d, int causal, float scale, int is_bf16, int smem_dq,
                                   int smem_kv, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 0 || skv < 0 || d < 1 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  if (sq == 0 || skv == 0) return (int)cudaGetLastError();
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, kv_lens, q_offset, window,
         hq, hkv, sq, skv, d, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
      return (int)cudaErrorInvalidValue;
    switch (d) {
      case 64: return launch_wg<64>(a, b, smem_dq, smem_kv, st);
      case 80: return launch_wg<80>(a, b, smem_dq, smem_kv, st);
      case 128: return launch_wg<128>(a, b, smem_dq, smem_kv, st);
      case 160: return launch_wg<160>(a, b, smem_dq, smem_kv, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return launch_f32(a, b, st);
}
