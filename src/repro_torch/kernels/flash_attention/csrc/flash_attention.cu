// Predicated flash attention for Hopper (sm_90a): dense and paged forward,
// the paged one over full-precision or quantized (int8 / fp8 e4m3) pools.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_dense, _dense_tc, _dense_split
//                               <- flash_attention_pallas (_flash_kernel -> _flash_tile)
//   flash_attention_paged, flash_attention_paged_split over bf16 pools
//                               <- flash_attention_pallas_paged (_flash_kernel_paged)
//   flash_attention_paged_quant, flash_attention_paged_split over int8/fp8
//                               <- flash_attention_pallas_paged over narrow
//                                  pools (_flash_kernel_paged_quant)
//
// Both compute the same function: online-softmax attention where key kpos is
// live for query qpos iff  kpos < kv_lens[b]  and (causal) qpos >= kpos  and
// kpos > qpos - window.  Query row i of lane b sits at qpos = q_offset[b] + i.
// GQA maps query head h to KV head h / (Hq / Hkv).  A row with no live key
// returns 0.  Inputs are f32 or bf16; the arithmetic is f32; the output has
// the type of q.  The paged kernel reads logical page j of lane b from
// physical page table[b, j] of a (P, Hkv, ps, D) pool.  The quantized paged
// kernel computes the same function over narrow pools: element x of page p,
// KV head h, slot s widens to float(x) * scale[p, h, s] (f32 scale pools of
// shape (P, Hkv, ps)), in f32, before the unchanged online softmax.
//
// What bounds it on an H100.  Decode (Sq = 1, the path's every step) reads
// each K/V byte once and does ~1 FLOP per byte: it is bound by device memory
// (3.35 TB/s).  Prefill does 4 * D FLOPs per live (query, key) pair, which
// grows with the square of the prompt: from prompts of about a thousand
// tokens on it is bound by operations (989 TFLOP/s on the bf16 tensor
// cores); below that, the bytes of q, K/V and the output bound it.
//
// The bodies; the Python wrappers pick one per call (kernel.plan_dense,
// kernel.plan_paged) and call its entry point.
//
// flash_attention_dense_tc: dense bf16 with more than 16 rows per KV head
// (prefill).  Bound by operations on the tensor cores at long prompts.  One
// CTA serves 64 query rows of one head, 16 per warp, so each K/V tile is
// read once per 64 rows (not per 16).  Q is loaded once (ldmatrix) into
// mma A fragments that stay in registers; K/V tiles of 64 keys stay bf16 in
// shared memory (rows padded by 16 bytes, so ldmatrix is free of bank
// conflicts) and arrive through a 2-stage cp.async ring: the copy of tile
// t + 1 runs while tile t is computed.  S = Q.K^T and O += P.V are
// mma.sync m16n8k16 bf16 -> f32; the S accumulators are the A fragments of
// P, split into a hi and a lo bf16 half with one mma each, so P keeps ~16
// bits, near the TPU body's f32 P (one bf16 P took 9% less time at
// stablelm-3b's prefill shape on an H100, but moved the smoke run's bf16
// prefill logits, kernel against plain, from 0.0188 to 0.0202, over their
// 2e-2 check); V fragments come by ldmatrix.trans.  The online softmax runs
// on the fragments (quad shuffles).  Wholly masked
// tiles are never loaded (the key range from kv_len, the causal edge and
// the window); the element predicate runs only on edge tiles.  Row blocks
// run last-first so under causal the longest start first.  The head dim is
// zero-padded to a multiple of 16 in shared memory: every D <= 128 runs.
// The softmax is the plain version's exp(s * scale - m) by the accurate
// expf in both bf16 bodies.  exp2f with the scale folded in took 12% less
// time at stablelm-3b's prefill shapes on an H100, but it moved the smoke
// run's bf16 decode logits (kernel against plain) from 0.0175 to 0.0188 of
// their 2e-2 check, and to 0.021 with the split-KV body on exp2f too.
// Next step: wgmma and TMA with a producer warp (ROADMAP Queue 2b).
//
// flash_attention_dense_split and flash_attention_paged_split: one body,
// flash_split<R, KV, kPaged>, for bf16 q with at most 16 rows per KV head
// (decode, short chunks), over dense bf16 K/V or over bf16, int8 or fp8
// pools read through the page table.  Bound by bytes: one row does ~1 FLOP
// per K/V byte, so the math stays f32 on the CUDA cores.  One CTA per
// (head, lane) would be 256 CTAs on 132 SMs at the smoke shapes, each
// walking ~720 keys serially; instead the keys of each (KV head, lane)
// split into ranges of split_keys keys at fixed absolute positions (the
// span doubles past 64 splits of a lane), one CTA each, every CTA serving
// all group * Sq rows of its KV head so each K/V byte is read once, through
// a 2-stage cp.async ring of 64-key tiles at 64-aligned positions.  Only
// the lane's own kv_len, q_offset and window place the splits, so a lane's
// bits do not depend on the batch, the KV heads or the cache's allocated
// length; and since what a key contributes depends only on its value and
// absolute position, a paged call and a dense call over the same bf16 keys
// give the same bits.  The CTA templated on its row count keeps only those
// rows' state in registers.  Each split writes (m, l, acc) to f32 scratch
// that the wrapper allocates; a second launch merges the lane's live splits
// in split order (no atomics: the same bits every run).
//
// Over pools the body finds a key's row through the page table.  Reading
// the table and dividing by the page size for every 16-byte chunk, and
// widening K/V to f32 in shared memory, would cost more than the bytes
// (the CUDA-core body below does both).  So it reads each page id once per
// page and tile (a warp's lanes load the tile's page ids, each key takes
// its page's by a shuffle, page_rows) into a ring of pool-row offsets that
// is filled a tile ahead, and copies K/V as stored: 16-byte chunks of 8
// bf16 or 16 int8/fp8 elements, so a narrow pool moves half the bytes,
// with the tile's f32 scales beside them.  A narrow element widens to
// float(x) * scale in registers inside the Q.K^T and P.V loops, rounded
// there as the plain path's gather rounds (fp8 two at a time, by one
// cvt.rn.f16x2.e4m3x2, exact in half and in f32).  At stablelm-3b's decode
// shape on an H100 128-key splits were the fastest of 128, 256 and 512
// (chip_smoke.py prints the sweep).
//
// flash_attention_dense (the first design, kept for f32: the tensor cores
// would round f32 to TF32) and flash_attention_paged / _paged_quant for f32
// q and for bf16 chunks of more than 16 rows per KV head (flash_fwd): the
// products run on the CUDA cores in f32 (one key per lane for Q.K^T, the
// head dims across lanes for P.V).  For the memory bound it (1) skips every
// K/V tile that is masked for all rows of a block by computing the key
// range [k_begin, k_end) from kv_len, the causal edge and the window, so
// decode reads only the live prefix of the cache; (2) in the paged kernel
// serves all Hq/Hkv query heads and all Sq rows of a KV head from one
// block, so each page is read once; (3) when a block has few rows
// (decode), splits the keys across its warps and merges their softmax
// states at the end, so all warps stream K/V instead of one; (4) stages
// each K/V tile with 16-byte loads where the head dim and the pointers
// allow it, kBatch of them in flight per thread before their shared-memory
// stores.  Over a narrow pool the f32 scale of each key row is read beside
// its chunk and the product is taken as the element is widened into shared
// memory.  f32 paged decode stays on this template with f32 dense decode,
// so the two agree bit for bit.
//
// C interface for ctypes: pointers and the stream are void*, every entry
// point returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;              // warps per block
constexpr int kRows = 4;               // query rows per warp
constexpr int kBK = 32;                // keys per warp tile: one per lane
constexpr int kNI = 4;                 // head dims per lane
constexpr int kMaxD = kWarp * kNI;     // 128
constexpr int kBatch = 8;              // K/V loads in flight per thread
constexpr float kNeg = -1e30f;         // finite mask value, as the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Narrow storage types: pools of these carry per-slot f32 scales.
template <typename KV>
struct Narrow {
  static constexpr bool value = false;
};
template <>
struct Narrow<int8_t> {
  static constexpr bool value = true;
};
template <>
struct Narrow<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_lens;
  const int* q_offset;
  const int* window;
  const int* table;   // paged only: (B, n_pages)
  int hq, hkv, sq;
  int skv;            // logical KV extent: dense Skv, paged n_pages * ps
  int d;
  int ps, n_pages, n_pool;
  int causal;
  int splits;         // warps that share one row group, each on its own keys
  float scale;
  const float* k_scale;  // quantized pools only: (P, Hkv, ps)
  const float* v_scale;
  int split_keys;        // split-KV body: keys per split, before doubling
  int max_splits;        // split-KV body: most splits of one lane
};

// How a tile of K/V reaches shared memory: one element of type T per load,
// or (kVec) one 16-byte chunk of n elements, widened to f32 at the store.
// T is the pool's storage type: f32 or bf16 (either way), int8 or fp8 e4m3
// (16-byte chunks only).
template <typename T, bool kVec>
struct Loader {
  static constexpr int n = 1;
  using Raw = float;
  __device__ static Raw load(const T* p) { return to_float(*p); }
  __device__ static Raw zero() { return 0.f; }
  __device__ static void widen(Raw r, float* out) { out[0] = r; }
};

template <>
struct Loader<float, true> {
  static constexpr int n = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void widen(Raw r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};

template <>
struct Loader<__nv_bfloat16, true> {
  static constexpr int n = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(Raw r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Loader<int8_t, true> {
  static constexpr int n = 16;
  using Raw = uint4;
  __device__ static Raw load(const int8_t* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(Raw r, float* out) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < n; ++i) out[i] = static_cast<float>(e[i]);
  }
};

template <>
struct Loader<__nv_fp8_e4m3, true> {
  static constexpr int n = 16;
  using Raw = uint4;
  __device__ static Raw load(const __nv_fp8_e4m3* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(Raw r, float* out) {
    const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&r);
#pragma unroll
    for (int i = 0; i < n; ++i) out[i] = static_cast<float>(e[i]);
  }
};

// Row index of key `key` of KV head hk of lane b: the row's element offset
// is this times d; in a quantized pool it also indexes the row's scale.
template <bool kPaged>
__device__ __forceinline__ size_t kv_slot(const Args& a, int b, int hk, long long key) {
  if (kPaged) {
    const int page = (int)(key / a.ps);
    const int slot = (int)(key - (long long)page * a.ps);
    int phys = a.table[(size_t)b * a.n_pages + page];
    phys = min(max(phys, 0), a.n_pool - 1);
    return ((size_t)phys * a.hkv + hk) * a.ps + slot;
  }
  return ((size_t)b * a.hkv + hk) * a.skv + key;
}

// Stage keys [t0, t0 + tile) into ks (stride ldk) and vs (stride d) as f32;
// keys at or past k_end read as 0.  Each thread issues kBatch loads of K and
// of V before it stores any of them.  A narrow KV widens to float(x) * scale
// of its row.
template <typename KV, bool kPaged, bool kVec>
__device__ __forceinline__ void stage_kv(const Args& a, const KV* kg, const KV* vg, float* ks,
                                         float* vs, int ldk, int b, int hk, long long t0,
                                         long long k_end, int tile) {
  using L = Loader<KV, kVec>;
  constexpr bool kQuant = Narrow<KV>::value;
  const int d = a.d;
  const int per_row = d / L::n;
  const int total = tile * per_row;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    typename L::Raw kr[kBatch], vr[kBatch];
    float ksc[kBatch], vsc[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = base + u * blockDim.x;
      const int j = c / per_row;
      kr[u] = L::zero();
      vr[u] = L::zero();
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      if (c < total && t0 + j < k_end) {
        const size_t row = kv_slot<kPaged>(a, b, hk, t0 + j);
        const size_t off = row * d + (size_t)(c - j * per_row) * L::n;
        kr[u] = L::load(kg + off);
        vr[u] = L::load(vg + off);
        if constexpr (kQuant) {
          ksc[u] = a.k_scale[row];
          vsc[u] = a.v_scale[row];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = base + u * blockDim.x;
      if (c < total) {
        const int j = c / per_row;
        const int e0 = (c - j * per_row) * L::n;
        float kf[L::n], vf[L::n];
        L::widen(kr[u], kf);
        L::widen(vr[u], vf);
        if constexpr (kQuant) {
#pragma unroll
          for (int i = 0; i < L::n; ++i) {
            kf[i] *= ksc[u];
            vf[i] *= vsc[u];
          }
        }
#pragma unroll
        for (int i = 0; i < L::n; ++i) {
          ks[j * ldk + e0 + i] = kf[i];
          vs[j * d + e0 + i] = vf[i];
        }
      }
    }
  }
}

// One block: dense -> (query chunk, query head, lane); paged -> (KV head,
// lane), walking every (head of the group, query row) in chunks.  q and the
// output are T; K/V are stored as KV (T itself, or a narrow type).
template <typename T, typename KV, bool kPaged, bool kVec>
__global__ void __launch_bounds__(kWarps * kWarp) flash_fwd(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  const int ldk = d + 1;                 // odd stride: lane j reads row j conflict-free
  const int row_groups = kWarps / a.splits;
  const int bq = row_groups * kRows;     // rows per chunk
  const int tile = a.splits * kBK;       // keys per block iteration
  float* qs = smem;                      // (bq, d)
  float* ks = qs + bq * d;               // (tile, ldk)
  float* vs = ks + tile * ldk;           // (tile, d)

  const T* qg = static_cast<const T*>(a.q);
  const KV* kg = static_cast<const KV*>(a.k);
  const KV* vg = static_cast<const KV*>(a.v);
  T* og = static_cast<T*>(a.o);

  const int b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int hk = kPaged ? blockIdx.y : blockIdx.y / group;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int rg = warp % row_groups;
  const int split = warp / row_groups;
  const int kv_len = min(a.kv_lens[b], a.skv);
  const long long qoff = a.q_offset[b];
  const long long win = a.window[0];
  const int row_lo = kPaged ? 0 : blockIdx.x * bq;
  const int row_hi = kPaged ? group * a.sq : min(a.sq, row_lo + bq);

  // chunk row rr -> (query head, query row)
  auto head_of = [&](int rr) { return kPaged ? hk * group + rr / a.sq : (int)blockIdx.y; };
  auto qrow_of = [&](int rr) { return kPaged ? rr % a.sq : rr; };

  for (int c0 = row_lo; c0 < row_hi; c0 += bq) {
    const int nr = min(bq, row_hi - c0);
    __syncthreads();                     // the previous chunk is done with smem
    for (int idx = threadIdx.x; idx < bq * d; idx += blockDim.x) {
      const int r = idx / d, dd = idx - r * d;
      float val = 0.f;
      if (r < nr) {
        const int rr = c0 + r;
        val = to_float(qg[(((size_t)b * a.hq + head_of(rr)) * a.sq + qrow_of(rr)) * d + dd]);
      }
      qs[idx] = val;
    }

    // keys outside [k_begin, k_end) are masked for every row of the chunk
    int qi_lo = INT_MAX, qi_hi = -1;
    for (int r = 0; r < nr; ++r) {
      qi_lo = min(qi_lo, qrow_of(c0 + r));
      qi_hi = max(qi_hi, qrow_of(c0 + r));
    }
    long long k_begin = qoff + qi_lo - win + 1;
    if (k_begin < 0) k_begin = 0;
    long long k_end = kv_len;
    if (a.causal && qoff + qi_hi + 1 < k_end) k_end = qoff + qi_hi + 1;

    bool live[kRows];
    long long qpos[kRows];
    float m[kRows], l[kRows], acc[kRows][kNI];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int cr = rg * kRows + r;
      live[r] = cr < nr;
      qpos[r] = qoff + (live[r] ? qrow_of(c0 + cr) : 0);
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kNI; ++i) acc[r][i] = 0.f;
    }
    const bool computes = rg * kRows < nr;

    for (long long t0 = (k_begin / kBK) * kBK; t0 < k_end; t0 += tile) {
      __syncthreads();                   // every warp is done with the last tile
      stage_kv<KV, kPaged, kVec>(a, kg, vg, ks, vs, ldk, b, hk, t0, k_end, tile);
      __syncthreads();
      if (!computes) continue;

      const int j0 = split * kBK;
      const float* krow = ks + (j0 + lane) * ldk;
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float kv = krow[dd];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = fmaf(qs[(rg * kRows + r) * d + dd], kv, s[r]);
      }
      const long long kpos = t0 + j0 + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;          // warp-uniform: rows past the chunk
        bool pred = kpos < kv_len && kpos > qpos[r] - win;
        if (a.causal) pred = pred && qpos[r] >= kpos;
        const float sv = pred ? s[r] * a.scale : kNeg;
        const float m_new = fmaxf(m[r], warp_max(sv));
        const float alpha = expf(m[r] - m_new);
        const float p = pred ? expf(sv - m_new) : 0.f;
        l[r] = alpha * l[r] + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < kNI; ++i) acc[r][i] *= alpha;
        for (int j = 0; j < kBK; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
          const float* vrow = vs + (j0 + j) * d;
#pragma unroll
          for (int i = 0; i < kNI; ++i) {
            const int dd = lane + i * kWarp;
            if (dd < d) acc[r][i] = fmaf(pj, vrow[dd], acc[r][i]);
          }
        }
      }
    }

    if (a.splits > 1) {
      // merge the key splits of each row group: (m, l, acc) of every split
      // rescaled to the common max, as one online-softmax step
      const int stride = d + 2;
      float* mrg = ks;                   // (kWarps, kRows, d + 2)
      __syncthreads();
      if (computes) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float* slot = mrg + (warp * kRows + r) * stride;
          if (lane == 0) {
            slot[0] = m[r];
            slot[1] = l[r];
          }
#pragma unroll
          for (int i = 0; i < kNI; ++i) {
            const int dd = lane + i * kWarp;
            if (dd < d) slot[2 + dd] = acc[r][i];
          }
        }
      }
      __syncthreads();
      if (computes && split == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float mx = kNeg;
          for (int sp = 0; sp < a.splits; ++sp)
            mx = fmaxf(mx, mrg[((sp * row_groups + rg) * kRows + r) * stride]);
          float lt = 0.f;
          float at[kNI];
#pragma unroll
          for (int i = 0; i < kNI; ++i) at[i] = 0.f;
          for (int sp = 0; sp < a.splits; ++sp) {
            const float* slot = mrg + ((sp * row_groups + rg) * kRows + r) * stride;
            const float w = expf(slot[0] - mx);
            lt += w * slot[1];
#pragma unroll
            for (int i = 0; i < kNI; ++i) {
              const int dd = lane + i * kWarp;
              if (dd < d) at[i] += w * slot[2 + dd];
            }
          }
          l[r] = lt;
#pragma unroll
          for (int i = 0; i < kNI; ++i) acc[r][i] = at[i];
        }
      }
    }

    if (computes && split == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;
        const int rr = c0 + rg * kRows + r;
        T* orow = og + (((size_t)b * a.hq + head_of(rr)) * a.sq + qrow_of(rr)) * d;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          const int dd = lane + i * kWarp;
          // an empty predicate row (l == 0) writes 0, as zeroing predication
          if (dd < d) store(orow + dd, l[r] > 0.f ? acc[r][i] * inv : 0.f);
        }
      }
    }
  }
}

// Few rows per block (decode): split the keys across warps.
int splits_for(int rows) {
  if (rows <= kRows) return kWarps;
  if (rows <= 2 * kRows) return kWarps / 2;
  return 1;
}

template <typename T, typename KV, bool kPaged, bool kVec>
int launch_as(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, KV, kPaged, kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_fwd<T, KV, kPaged, kVec><<<grid, kWarps * kWarp, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte K/V loads need every key row to start on a 16-byte boundary.
// Narrow pools are read only so (D a multiple of 16, aligned pools).
template <typename T, typename KV, bool kPaged>
int launch(const Args& a, int grid_x, int grid_y, int grid_z, cudaStream_t stream) {
  const int bq = (kWarps / a.splits) * kRows;
  const int tile = a.splits * kBK;
  const size_t smem = sizeof(float) * ((size_t)bq * a.d + (size_t)tile * (2 * a.d + 1));
  const dim3 grid(grid_x, grid_y, grid_z);
  const bool vec = a.d % Loader<KV, true>::n == 0 && aligned16(a.k) && aligned16(a.v);
  if constexpr (Narrow<KV>::value) {
    return vec ? launch_as<T, KV, kPaged, true>(a, grid, smem, stream)
               : (int)cudaErrorInvalidValue;
  } else {
    return vec ? launch_as<T, KV, kPaged, true>(a, grid, smem, stream)
               : launch_as<T, KV, kPaged, false>(a, grid, smem, stream);
  }
}

bool bad_shape(int b, int hq, int hkv, int sq, int d) {
  return b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 0 || d < 1 || d > kMaxD;
}

// ---------------------------------------------------------------------------
// The two bf16 dense bodies: tensor-core prefill and split-KV decode.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;          // keys per staged K/V tile (both bodies)
constexpr int kTcRows = 64;        // query rows per tensor-core CTA: 16 per warp
constexpr int kTcThreads = kTcRows / 16 * kWarp;
constexpr int kStages = 2;         // K/V ring depth
constexpr int kSplitRows = 16;     // most rows (group * Sq) of one split-KV CTA

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; src_bytes 0 zero-fills the destination.
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

// (x, y) as a bf16 pair hi plus the bf16 pair lo of what hi rounded off:
// hi + lo keeps ~16 significant bits of each, close to the TPU body's f32 P.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// Stage rows [first, first + n) of a row-major (rows, d) bf16 array into
// dst (stride ld, dp >= d columns, dp a multiple of 16).  Rows at or past
// `end` and columns d..dp read as 0.  With vec (d a multiple of 8, the array
// on a 16-byte boundary) by cp.async 16-byte copies, left in flight for the
// caller to wait on; else by element loads and stores.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, int first,
                                           int end, int d, int dp, bool vec, int n = kTile) {
  if (vec) {
    const int per_row = dp / 8;
    for (int c = threadIdx.x; c < n * per_row; c += blockDim.x) {
      const int r = c / per_row, col = (c - r * per_row) * 8;
      const bool ok = first + r < end && col < d;
      cp_async16(dst + r * ld + col, ok ? src + (size_t)(first + r) * d + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * dp; e += blockDim.x) {
      const int r = e / dp, col = e - r * dp;
      const bool ok = first + r < end && col < d;
      dst[r * ld + col] = ok ? src[(size_t)(first + r) * d + col] : __float2bfloat16(0.f);
    }
  }
}

// Tensor-core body.  One CTA: 64 query rows of one query head of one lane,
// 16 rows per warp.  Q stays in registers (A fragments) for the whole key
// walk; K/V tiles of 64 keys come as bf16 through a ring of kStages by
// cp.async; S = Q.K^T and O += P.V run on mma.sync m16n8k16 with f32
// accumulators; the online softmax lives in the accumulator fragments.  DP
// is the head dim rounded up to 16 (the mma k-step); columns d..DP are zero.
template <int DP>
__global__ void __launch_bounds__(kTcThreads) flash_dense_tc(const Args a, int vec) {
  constexpr int LD = DP + 8;       // row stride: ldmatrix rows hit distinct banks
  constexpr int KS = DP / 16;      // mma k-steps over the head dim
  constexpr int NO = DP / 8;       // n-tiles of 8 head dims in O
  constexpr int NS = kTile / 8;    // n-tiles of 8 keys in S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // (kTcRows, LD)
  bf16* ks = qs + kTcRows * LD;                     // (kStages, 64, LD)
  bf16* vs = ks + kStages * kTile * LD;             // (kStages, 64, LD)

  // Row blocks are the slowest grid index and run last-first: under causal
  // the blocks with the most keys start first, so the grid's tail is short.
  const int nblk = gridDim.x;
  const int per_blk = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + nblk * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rb = nblk - 1 - lin / per_blk;
  const int h = (lin % per_blk) % a.hq;
  const int b = (lin % per_blk) / a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int d = a.d;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;

  const int kv_len = min(a.kv_lens[b], a.skv);
  const int qoff = a.q_offset[b];
  const int win = a.window[0];
  const int row_lo = rb * kTcRows;
  const int row_hi = min(a.sq, row_lo + kTcRows) - 1;
  int k_begin = qoff + row_lo - win + 1;
  if (k_begin < 0) k_begin = 0;
  int k_end = kv_len;
  if (a.causal) k_end = min(k_end, qoff + row_hi + 1);
  const int t_start = (k_begin / kTile) * kTile;
  const int n_tiles = k_end > k_begin ? (k_end - t_start + kTile - 1) / kTile : 0;

  const bf16* qg = static_cast<const bf16*>(a.q) + ((size_t)b * a.hq + h) * a.sq * d;
  const bf16* kg = static_cast<const bf16*>(a.k) + ((size_t)b * a.hkv + hk) * a.skv * d;
  const bf16* vg = static_cast<const bf16*>(a.v) + ((size_t)b * a.hkv + hk) * a.skv * d;
  bf16* og = static_cast<bf16*>(a.o) + ((size_t)b * a.hq + h) * a.sq * d;

  // one cp.async group for Q, then one per tile: tiles 0 .. kStages - 2
  // are in flight before the walk, tile it + kStages - 1 during step it
  stage_rows(qs, LD, qg, row_lo, a.sq, d, DP, vec, kTcRows);
  cp_async_commit();
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_tiles) {
      stage_rows(ks + p * kTile * LD, LD, kg, t_start + p * kTile, k_end, d, DP, vec);
      stage_rows(vs + p * kTile * LD, LD, vg, t_start + p * kTile, k_end, d, DP, vec);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();    // Q has landed
  __syncthreads();

  const int w_lo = row_lo + warp * 16;               // this warp's first row
  const bool w_live = w_lo < a.sq;                   // warp-uniform
  const int w_hi = min(w_lo + 15, a.sq - 1);
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;    // rows g and g + 8
  const int qp0 = qoff + w_lo + g, qp1 = qp0 + 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int nx = it + kStages - 1;
    if (nx < n_tiles) {
      const int st = nx % kStages;
      stage_rows(ks + st * kTile * LD, LD, kg, t_start + nx * kTile, k_end, d, DP, vec);
      stage_rows(vs + st * kTile * LD, LD, vg, t_start + nx * kTile, k_end, d, DP, vec);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile it has landed
    __syncthreads();
    const int t0 = t_start + it * kTile;
    const bf16* kt = ks + (it % kStages) * kTile * LD;
    const bf16* vt = vs + (it % kStages) * kTile * LD;
    if (w_live) {
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          unsigned kb[4];
          ldsm_x4(kb, kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                          ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
      // the element predicate only on edge tiles: the kv_len tail, the
      // causal diagonal, the window edge
      const bool full = t0 + kTile <= k_end && (!a.causal || t0 + kTile - 1 <= qoff + w_lo) &&
                        t0 > qoff + w_hi - win;
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[n][e] * a.scale;
          if (!full) {
            const int kp = t0 + n * 8 + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            bool pred = kp < k_end && kp > qp - win;
            if (a.causal) pred = pred && qp >= kp;
            v = pred ? v : -INFINITY;
          }
          s[n][e] = v;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // a masked key is -inf: expf gives 0, also when the row is all masked
      // (mn stays kNeg, finite)
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = expf(s[n][0] - mn0);
        s[n][1] = expf(s[n][1] - mn0);
        s[n][2] = expf(s[n][2] - mn1);
        s[n][3] = expf(s[n][3] - mn1);
        rs0 += s[n][0] + s[n][1];
        rs1 += s[n][2] + s[n][3];
      }
      l0 = l0 * al0 + rs0;         // per-thread partial sums, reduced at the end
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // P (the S accumulators) is the A fragment of the P.V product, as a
      // hi and a lo bf16 half: two mmas per V fragment
#pragma unroll
      for (int kb = 0; kb < kTile / 16; ++kb) {
        unsigned ph[4], pl[4];
        split_bf16(s[2 * kb][0], s[2 * kb][1], ph[0], pl[0]);
        split_bf16(s[2 * kb][2], s[2 * kb][3], ph[1], pl[1]);
        split_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          unsigned vb[4];
          ldsm_x4_trans(vb, vt + (kb * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                                (lane / 16) * 8);
          mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
          mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();               // every warp is done with this stage
  }
  cp_async_wait<0>();

  if (!w_live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  // an empty predicate row (l == 0) writes 0
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int r0 = w_lo + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= d) continue;
      if (r0 < a.sq) og[(size_t)r0 * d + c + e] = __float2bfloat16(o[n][e] * inv0);
      if (r1 < a.sq) og[(size_t)r1 * d + c + e] = __float2bfloat16(o[n][2 + e] * inv1);
    }
  }
}

// The split grid of one lane: split s covers the absolute keys [s * span,
// (s + 1) * span), cut to [k_begin, k_end), the keys some row of the lane
// may attend (kv_len, the causal edge, the window).  span is split_keys
// (a multiple of the 64-key tile), doubled until at most max_splits splits
// cover kv_len.  Only the lane's own kv_len, q_offset and window decide
// it: never the batch, the KV heads or the cache's allocated length.  The
// same as kernel.lane_splits.
struct LaneSplits {
  int k_begin, k_end, span;
  __device__ int first() const { return k_begin / span; }
  __device__ int last() const {    // one past the last live split
    return k_end > k_begin ? (k_end + span - 1) / span : first();
  }
};

__device__ __forceinline__ LaneSplits lane_splits(const Args& a, int b) {
  const int kv_len = min(a.kv_lens[b], a.skv);
  const int qoff = a.q_offset[b];
  LaneSplits ls;
  ls.k_begin = max(qoff - a.window[0] + 1, 0);
  ls.k_end = a.causal ? min(kv_len, qoff + a.sq) : kv_len;
  ls.span = a.split_keys;
  while ((kv_len + ls.span - 1) / ls.span > a.max_splits) ls.span *= 2;
  return ls;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Eight staged K elements from shared memory (16-byte aligned for bf16,
// 8-byte for a narrow type) as f32; a narrow element widens to
// float(x) * sc, rounded once as the plain path's gather does.
__device__ __forceinline__ void widen8(const bf16* p, float, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void widen8(const int8_t* p, float sc, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(static_cast<float>(e[i]), sc);
}
// fp8 e4m3: two elements per conversion (cvt.rn.f16x2.e4m3x2; exact in
// half, then in f32).
__device__ __forceinline__ float2 fp8x2_at(unsigned short pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}
__device__ __forceinline__ void widen8(const __nv_fp8_e4m3* p, float sc, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const unsigned short* pairs = reinterpret_cast<const unsigned short*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = fp8x2_at(pairs[i]);
    f[2 * i] = __fmul_rn(v.x, sc);
    f[2 * i + 1] = __fmul_rn(v.y, sc);
  }
}

// Two staged V elements (head dims c, c + 1) as f32.
__device__ __forceinline__ float2 widen2(const bf16* p, float) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 widen2(const int8_t* p, float sc) {
  const char2 e = *reinterpret_cast<const char2*>(p);
  return make_float2(__fmul_rn(static_cast<float>(e.x), sc),
                     __fmul_rn(static_cast<float>(e.y), sc));
}
__device__ __forceinline__ float2 widen2(const __nv_fp8_e4m3* p, float sc) {
  const float2 v = fp8x2_at(*reinterpret_cast<const unsigned short*>(p));
  return make_float2(__fmul_rn(v.x, sc), __fmul_rn(v.y, sc));
}

// Pool row of each key of the tile at t0 of KV head hk of lane b, or -1 for
// a key at or past `end`: ((page id) * Hkv + hk) * ps + slot, also the index
// of its scale.  Warps 0 and 1 take 32 keys each; lane l reads the page id
// of the warp's l-th page (each page id once per warp and tile) and each
// key gets its page's id by a shuffle.
__device__ __forceinline__ void page_rows(int* roff, const Args& a, int b, int hk, int t0,
                                          int end) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (warp >= kTile / kWarp) return;
  const int first = t0 + warp * kWarp;             // this warp's first key
  const int pg0 = first / a.ps;
  int phys = 0;
  if (pg0 + lane <= (first + kWarp - 1) / a.ps && pg0 + lane < a.n_pages)
    phys = min(max(a.table[(size_t)b * a.n_pages + pg0 + lane], 0), a.n_pool - 1);
  const int key = first + lane;
  const int page = key / a.ps;
  const int id = __shfl_sync(kFull, phys, page - pg0);
  roff[warp * kWarp + lane] = key < end ? (id * a.hkv + hk) * a.ps + (key - page * a.ps) : -1;
}

// Stage the tile's rows through roff (from page_rows) into dst (stride ld
// elements, dp >= d columns; columns d..dp and rows of roff -1 read as 0).
// With vec (rows of whole 16-byte chunks, 16-byte aligned pools) by
// cp.async 16-byte copies left in flight for the caller to wait on, else
// (bf16 only) by element loads and stores.  A narrow pool also stages the
// tile's scales (cp.async, 4 bytes each).
template <typename KV>
__device__ __forceinline__ void stage_paged(KV* dst, int ld, const KV* pool, const int* roff,
                                            int d, int dp, bool vec, float* sc,
                                            const float* sc_pool) {
  constexpr int E = 16 / (int)sizeof(KV);
  if (vec) {
    const int per_row = dp / E;
    for (int c = threadIdx.x; c < kTile * per_row; c += blockDim.x) {
      const int r = c / per_row, col = (c - r * per_row) * E;
      const int o = roff[r];
      const bool ok = o >= 0 && col < d;
      cp_async16(dst + r * ld + col, ok ? pool + (size_t)o * d + col : pool, ok);
    }
  } else if constexpr (!Narrow<KV>::value) {
    for (int e = threadIdx.x; e < kTile * dp; e += blockDim.x) {
      const int r = e / dp, col = e - r * dp;
      const int o = roff[r];
      dst[r * ld + col] = o >= 0 && col < d ? pool[(size_t)o * d + col] : __float2bfloat16(0.f);
    }
  }
  if constexpr (Narrow<KV>::value) {
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      const int o = roff[r];
      cp_async4(sc + r, o >= 0 ? sc_pool + o : sc_pool, o >= 0);
    }
  }
}

// Split-KV body (group * Sq <= 16 rows: decode and short chunks), dense
// (kPaged false: bf16 K/V of (B, Hkv, Skv, D)) or paged (pools of KV: bf16,
// int8 or fp8 e4m3, read through the page table).  One CTA: all rows of
// one KV head of one lane over split blockIdx.x of the lane's split grid
// (lane_splits); a split outside the lane's keys returns at once.  K/V
// tiles of 64 keys, at 64-aligned absolute key positions, arrive as stored
// through a cp.async ring; f32 math on the CUDA cores (one row does ~1 FLOP
// per K/V byte: the bytes bound it, not the operations), a narrow element
// widened to float(x) * scale in registers where it is used.  Each warp
// takes 16 keys of every tile (Q.K^T: a key per half-warp lane, half of
// the head dims per half-warp; P.V: 2 head dims per lane and 64 per pass);
// the 4 warps' softmax states merge in warp order, and the CTA writes its
// (m, l, acc) rows to part (B, Hkv, splits, rows, d + 2) f32.  What a key
// contributes depends only on its value and its absolute position, so the
// dense and the paged instance over the same bf16 keys give the same bits.
template <int R, typename KV, bool kPaged>
__global__ void __launch_bounds__(4 * kWarp) flash_split(const Args a, float* part, int dp,
                                                          int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kNarrow = Narrow<KV>::value;
  const int ld = dp + 16 / (int)sizeof(KV);      // row stride in elements (16-byte pad)
  const int d = a.d;
  const int group = a.hq / a.hkv;
  const int rows = group * a.sq;
  float* qs = reinterpret_cast<float*>(smem_raw);               // (rows, dp) f32
  KV* ks = reinterpret_cast<KV*>(qs + R * dp);                  // (kStages, 64, ld)
  KV* vs = ks + kStages * kTile * ld;
  int* roff = reinterpret_cast<int*>(vs + kStages * kTile * ld);   // (kStages, 64)
  float* ksc = reinterpret_cast<float*>(roff + kStages * kTile);   // (kStages, 64)
  float* vsc = ksc + kStages * kTile;
  float* mrg = reinterpret_cast<float*>(ks);    // after the walk: (4, rows, dp + 2)

  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int j = lane % 16, half = lane / 16;

  const LaneSplits ls = lane_splits(a, b);
  const int lo = max(split * ls.span, ls.k_begin);
  const int hi = min((split + 1) * ls.span, ls.k_end);
  if (lo >= hi) return;                          // uniform: the merge skips it
  const int t_start = lo / kTile * kTile;
  const int n_tiles = (hi - t_start + kTile - 1) / kTile;
  const int qoff = a.q_offset[b];
  const int win = a.window[0];

  const KV* kg = static_cast<const KV*>(a.k);
  const KV* vg = static_cast<const KV*>(a.v);
  if (!kPaged) {
    kg += ((size_t)b * a.hkv + hk) * a.skv * d;
    vg += ((size_t)b * a.hkv + hk) * a.skv * d;
  }
  auto stage = [&](int tile, int st) {
    KV* kd = ks + st * kTile * ld;
    KV* vd = vs + st * kTile * ld;
    const int t0 = t_start + tile * kTile;
    if constexpr (kPaged) {
      stage_paged(kd, ld, kg, roff + st * kTile, d, dp, vec, ksc + st * kTile, a.k_scale);
      stage_paged(vd, ld, vg, roff + st * kTile, d, dp, vec, vsc + st * kTile, a.v_scale);
    } else {
      stage_rows(kd, ld, kg, t0, hi, d, dp, vec);
      stage_rows(vd, ld, vg, t0, hi, d, dp, vec);
    }
  };

  // paged: the pool rows of tiles 0 .. kStages - 1 first; later, those of
  // tile it + kStages while tile it is computed
  if constexpr (kPaged) {
    for (int p = 0; p < kStages; ++p)
      if (p < n_tiles) page_rows(roff + p * kTile, a, b, hk, t_start + p * kTile, hi);
    __syncthreads();
  }
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_tiles) stage(p, p);
    cp_async_commit();
  }
  // while the first tiles are in flight: row rr of the CTA is query head
  // hk * group + rr / Sq, query row rr % Sq
  const bf16* qg = static_cast<const bf16*>(a.q);
  for (int e = threadIdx.x; e < rows * dp; e += blockDim.x) {
    const int rr = e / dp, c = e - rr * dp;
    const int h = hk * group + rr / a.sq, qi = rr % a.sq;
    qs[e] = c < d ? __bfloat162float(qg[(((size_t)b * a.hq + h) * a.sq + qi) * d + c]) : 0.f;
  }

  // the plain version's formula, exp(s * scale - m): decode is bound by
  // bytes, so the accurate expf costs nothing here
  float m[R], l[R], acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  const int hd = dp / 2;           // head dims per half-warp in Q.K^T

  for (int it = 0; it < n_tiles; ++it) {
    const int nx = it + kStages - 1;
    if (nx < n_tiles) stage(nx, nx % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = it % kStages;
    const KV* kt = ks + st * kTile * ld;
    const KV* vt = vs + st * kTile * ld;
    const int key = warp * 16 + j;                   // this lane's key in the tile
    const int kp = t_start + it * kTile + key;
    const float k_sc = kNarrow ? ksc[st * kTile + key] : 1.f;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int c = 0; c < hd; c += 8) {
      float kf[8];
      widen8(kt + key * ld + half * hd + c, k_sc, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float* qr = qs + r * dp + half * hd + c;
#pragma unroll
          for (int i = 0; i < 8; ++i) s[r] = fmaf(qr[i], kf[i], s[r]);
        }
      }
    }
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = 0.f;
      if (r >= rows) continue;     // uniform across the CTA
      s[r] += __shfl_xor_sync(kFull, s[r], 16);
      const int qp = qoff + r % a.sq;
      bool pred = kp >= lo && kp < hi && kp > qp - win;
      if (a.causal) pred = pred && qp >= kp;
      const float sv = pred ? s[r] * a.scale : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float al = expf(m[r] - mn);
      p[r] = expf(sv - mn);
      float ps = p[r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[r] = l[r] * al + ps;
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] *= al;
    }
    // P.V: lane owns head dims 2 * lane + {0, 1} + 64 * i
    for (int jj = 0; jj < 16; ++jj) {
      const KV* vrow = vt + (warp * 16 + jj) * ld;
      const float v_sc = kNarrow ? vsc[st * kTile + warp * 16 + jj] : 1.f;
      float2 vv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = 2 * lane + 64 * i;
        vv[i] = c < dp ? widen2(vrow + c, v_sc) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) continue;
        const float pj = __shfl_sync(kFull, p[r], jj);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[r][2 * i] = fmaf(pj, vv[i].x, acc[r][2 * i]);
          acc[r][2 * i + 1] = fmaf(pj, vv[i].y, acc[r][2 * i + 1]);
        }
      }
    }
    // pool rows of tile it + kStages into the slot tile it staged from
    if constexpr (kPaged) {
      if (it + kStages < n_tiles)
        page_rows(roff + st * kTile, a, b, hk, t_start + (it + kStages) * kTile, hi);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free: reuse it for the merge

  const int stm = dp + 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) continue;
    float* slot = mrg + (warp * rows + r) * stm;
    if (lane == 0) {
      slot[0] = m[r];
      slot[1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < dp) {
        slot[2 + c] = acc[r][2 * i];
        slot[3 + c] = acc[r][2 * i + 1];
      }
    }
  }
  __syncthreads();
  // the 4 warps' states in warp order -> this split's row of part
  float* out = part + (((size_t)b * a.hkv + hk) * splits + split) * rows * (d + 2);
  for (int e = threadIdx.x; e < rows * (d + 2); e += blockDim.x) {
    const int r = e / (d + 2), c = e - r * (d + 2);
    float mx = kNeg;
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, mrg[(w * rows + r) * stm]);
    float val = c == 0 ? mx : 0.f;
    if (c > 0) {
      for (int w = 0; w < 4; ++w) {
        const float* slot = mrg + (w * rows + r) * stm;
        val += expf(slot[0] - mx) * slot[c];
      }
    }
    out[e] = val;
  }
}

// Merge the live splits of each row (lane_splits) in split order (no
// atomics: the same bits every run) and write the normalized row in bf16;
// a lane with no live key writes 0.  One CTA per (KV head, lane).
__global__ void __launch_bounds__(4 * kWarp) flash_split_merge(const Args a, const float* part,
                                                                int splits) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int d = a.d, group = a.hq / a.hkv, rows = group * a.sq;
  const LaneSplits ls = lane_splits(a, b);
  const int s0 = ls.first(), s1 = ls.last();
  const float* pb = part + ((size_t)b * a.hkv + hk) * splits * rows * (d + 2);
  bf16* og = static_cast<bf16*>(a.o);
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d;
    float mx = kNeg;
    for (int sp = s0; sp < s1; ++sp) mx = fmaxf(mx, pb[((size_t)sp * rows + r) * (d + 2)]);
    float lt = 0.f, at = 0.f;
    for (int sp = s0; sp < s1; ++sp) {
      const float* row = pb + ((size_t)sp * rows + r) * (d + 2);
      const float w = expf(row[0] - mx);
      lt += w * row[1];
      at += w * row[2 + c];
    }
    const int h = hk * group + r / a.sq, qi = r % a.sq;
    og[(((size_t)b * a.hq + h) * a.sq + qi) * d + c] = __float2bfloat16(lt > 0.f ? at / lt : 0.f);
  }
}

template <int DP>
int launch_tc(const Args& a, int b, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(DP + 8) * (kTcRows + 2 * kStages * kTile);
  cudaError_t err = cudaFuncSetAttribute(flash_dense_tc<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kTcRows - 1) / kTcRows, a.hq, b);
  flash_dense_tc<DP><<<grid, kTcThreads, smem, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

// R: the most rows the instance serves (registers per row: acc, m, l, s, p).
template <int R, typename KV, bool kPaged>
int launch_split_as(const Args& a, float* part, int dp, int vec, dim3 grid, cudaStream_t stream) {
  const size_t ld = dp + 16 / sizeof(KV);
  const size_t smem = sizeof(float) * R * dp + sizeof(KV) * 2 * kStages * kTile * ld +
                      (kPaged ? (sizeof(int) + 2 * sizeof(float)) * kStages * kTile : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_split<R, KV, kPaged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_split<R, KV, kPaged><<<grid, 4 * kWarp, smem, stream>>>(a, part, dp, vec);
  return (int)cudaGetLastError();
}

// The split launch for `rows` rows per KV head, then the merge launch.
template <typename KV, bool kPaged>
int launch_split(const Args& a, float* part, int vec, int splits, int b, cudaStream_t st) {
  const int dp = (a.d + 15) / 16 * 16;
  const int rows = (a.hq / a.hkv) * a.sq;
  const dim3 grid(splits, a.hkv, b);
  const int err = rows <= 1   ? launch_split_as<1, KV, kPaged>(a, part, dp, vec, grid, st)
                  : rows <= 2 ? launch_split_as<2, KV, kPaged>(a, part, dp, vec, grid, st)
                  : rows <= 4 ? launch_split_as<4, KV, kPaged>(a, part, dp, vec, grid, st)
                  : rows <= 8 ? launch_split_as<8, KV, kPaged>(a, part, dp, vec, grid, st)
                              : launch_split_as<16, KV, kPaged>(a, part, dp, vec, grid, st);
  if (err != 0) return err;
  flash_split_merge<<<dim3(a.hkv, b), 4 * kWarp, 0, st>>>(a, part, splits);
  return (int)cudaGetLastError();
}

bool dense_vec(const void* q, const void* k, const void* v, int d) {
  return d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

}  // namespace

// The CUDA-core body, f32 only (bf16 takes the two bodies below).
extern "C" int flash_attention_dense(const void* q, const void* k, const void* v, void* o,
                                     const int* kv_lens, const int* q_offset,
                                     const int* window, int b, int hq, int hkv, int sq,
                                     int skv, int d, int causal, float scale, void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || skv < 0) return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  Args a{q, k, v, o, kv_lens, q_offset, window, nullptr,
         hq, hkv, sq, skv, d, 0, 0, 0, causal, splits_for(sq < 16 ? sq : 16), scale};
  const int bq = (kWarps / a.splits) * kRows;
  const int grid_x = (sq + bq - 1) / bq;
  return launch<float, float, false>(a, grid_x, hq, b, static_cast<cudaStream_t>(stream));
}

// The tensor-core body: bf16 q, k, v, o; any d <= 128.
extern "C" int flash_attention_dense_tc(const void* q, const void* k, const void* v, void* o,
                                        const int* kv_lens, const int* q_offset,
                                        const int* window, int b, int hq, int hkv, int sq,
                                        int skv, int d, int causal, float scale, void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || skv < 0) return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  Args a{q, k, v, o, kv_lens, q_offset, window, nullptr,
         hq, hkv, sq, skv, d, 0, 0, 0, causal, 1, scale};
  const int vec = dense_vec(q, k, v, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_tc<16>(a, b, vec, st);
    case 2: return launch_tc<32>(a, b, vec, st);
    case 3: return launch_tc<48>(a, b, vec, st);
    case 4: return launch_tc<64>(a, b, vec, st);
    case 5: return launch_tc<80>(a, b, vec, st);
    case 6: return launch_tc<96>(a, b, vec, st);
    case 7: return launch_tc<112>(a, b, vec, st);
    default: return launch_tc<128>(a, b, vec, st);
  }
}

// The split-KV body over dense K/V: bf16 q, k, v, o; (Hq / Hkv) * sq <= 16
// rows; `splits` CTAs per (KV head, lane) (the grid, at least every lane's
// live splits of split_keys keys, at most max_splits a lane) write (m, l,
// acc) rows to part, (b, hkv, splits, rows, d + 2) f32, and a second launch
// merges them in split order.
extern "C" int flash_attention_dense_split(const void* q, const void* k, const void* v,
                                           void* o, void* part, const int* kv_lens,
                                           const int* q_offset, const int* window, int b,
                                           int hq, int hkv, int sq, int skv, int d,
                                           int causal, float scale, int splits, int split_keys,
                                           int max_splits, void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || skv < 0 || splits < 1 || split_keys < kTile ||
      split_keys % kTile != 0 || max_splits < 1 || (hq / hkv) * sq > kSplitRows)
    return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  Args a{q, k, v, o, kv_lens, q_offset, window, nullptr,
         hq, hkv, sq, skv, d, 0, 0, 0, causal, 1, scale};
  a.split_keys = split_keys;
  a.max_splits = max_splits;
  return launch_split<bf16, false>(a, static_cast<float*>(part), dense_vec(q, k, v, d), splits,
                                   b, static_cast<cudaStream_t>(stream));
}

// The split-KV body over pools read through the page table: bf16 q and o;
// bf16 (kv_kind 0), int8 (1) or fp8 e4m3 (2) pools (P, Hkv, ps, d), the
// narrow ones with f32 scale pools (P, Hkv, ps), d a multiple of 16 and
// 16-byte aligned pools; otherwise as flash_attention_dense_split.
extern "C" int flash_attention_paged_split(const void* q, const void* k_pool,
                                           const void* v_pool, const float* k_scale,
                                           const float* v_scale, void* o, void* part,
                                           const int* page_table, const int* kv_lens,
                                           const int* q_offset, const int* window, int b,
                                           int hq, int hkv, int sq, int d, int page_size,
                                           int n_pages, int n_pool, int causal, float scale,
                                           int splits, int split_keys, int max_splits,
                                           int kv_kind, void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || page_size < 1 || n_pages < 1 || n_pool < 1 ||
      splits < 1 || split_keys < kTile || split_keys % kTile != 0 || max_splits < 1 ||
      (hq / hkv) * sq > kSplitRows || kv_kind < 0 || kv_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  Args a{q, k_pool, v_pool, o, kv_lens, q_offset, window, page_table,
         hq, hkv, sq, n_pages * page_size, d, page_size, n_pages, n_pool, causal, 1, scale,
         k_scale, v_scale};
  a.split_keys = split_keys;
  a.max_splits = max_splits;
  float* pf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(k_pool) && aligned16(v_pool);
  if (kv_kind == 0) return launch_split<bf16, true>(a, pf, aligned && d % 8 == 0, splits, b, st);
  if (!aligned || d % 16 != 0) return (int)cudaErrorInvalidValue;
  return kv_kind == 1 ? launch_split<int8_t, true>(a, pf, 1, splits, b, st)
                      : launch_split<__nv_fp8_e4m3, true>(a, pf, 1, splits, b, st);
}

extern "C" int flash_attention_paged(const void* q, const void* k_pool, const void* v_pool,
                                     void* o, const int* page_table, const int* kv_lens,
                                     const int* q_offset, const int* window, int b, int hq,
                                     int hkv, int sq, int d, int page_size, int n_pages,
                                     int n_pool, int causal, float scale, int is_bf16,
                                     void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || page_size < 1 || n_pages < 1 || n_pool < 1)
    return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  const int rows = (hq / hkv) * sq;
  Args a{q, k_pool, v_pool, o, kv_lens, q_offset, window, page_table,
         hq, hkv, sq, n_pages * page_size, d, page_size, n_pages, n_pool, causal,
         splits_for(rows < 16 ? rows : 16), scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, true>(a, 1, hkv, b, st)
                 : launch<float, float, true>(a, 1, hkv, b, st);
}

// The paged kernel over int8 (is_fp8 = 0) or fp8 e4m3 (is_fp8 = 1) pools
// with f32 scale pools (P, Hkv, ps); q and o are f32 or bf16; d is a
// multiple of 16 and the pools start on 16-byte boundaries.
extern "C" int flash_attention_paged_quant(const void* q, const void* k_pool,
                                           const void* v_pool, const float* k_scale,
                                           const float* v_scale, void* o,
                                           const int* page_table, const int* kv_lens,
                                           const int* q_offset, const int* window, int b,
                                           int hq, int hkv, int sq, int d, int page_size,
                                           int n_pages, int n_pool, int causal, float scale,
                                           int is_bf16, int is_fp8, void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || page_size < 1 || n_pages < 1 || n_pool < 1)
    return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  const int rows = (hq / hkv) * sq;
  Args a{q, k_pool, v_pool, o, kv_lens, q_offset, window, page_table,
         hq, hkv, sq, n_pages * page_size, d, page_size, n_pages, n_pool, causal,
         splits_for(rows < 16 ? rows : 16), scale, k_scale, v_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp8)
    return is_bf16 ? launch<__nv_bfloat16, __nv_fp8_e4m3, true>(a, 1, hkv, b, st)
                   : launch<float, __nv_fp8_e4m3, true>(a, 1, hkv, b, st);
  return is_bf16 ? launch<__nv_bfloat16, int8_t, true>(a, 1, hkv, b, st)
                 : launch<float, int8_t, true>(a, 1, hkv, b, st);
}
