// Predicated flash attention for Hopper (sm_90a): dense and paged forward,
// the paged one over full-precision or quantized (int8 / fp8 e4m3) pools.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_dense       <- flash_attention_pallas (_flash_kernel -> _flash_tile)
//   flash_attention_paged       <- flash_attention_pallas_paged (_flash_kernel_paged)
//   flash_attention_paged_quant <- flash_attention_pallas_paged over int8/fp8
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
// What this first design does about it.  It is the simple, right version:
// the products run on the CUDA cores in f32 (one key per lane for Q.K^T, the
// head dims across lanes for P.V), not on wgmma, so prefill stays far below
// the tensor-core bound; that is the next kernel PR's work.  For the memory
// bound it (1) skips every K/V tile that is masked for all rows of a block
// by computing the key range [k_begin, k_end) from kv_len, the causal edge
// and the window, so decode reads only the live prefix of the cache; (2) in
// the paged kernel serves all Hq/Hkv query heads and all Sq rows of a KV head
// from one block, so each page is read once; (3) when a block has few rows
// (decode), splits the keys across its warps and merges their softmax states
// at the end, so all warps stream K/V instead of one; (4) stages each K/V
// tile with 16-byte loads where the head dim and the pointers allow it, kBatch
// of them in flight per thread before their shared-memory stores, so a tile
// costs about one memory latency and not one per element.  The quantized
// kernel is the same template with a narrow storage type: one 16-byte load
// brings 16 elements instead of 8, so decode reads about half the bytes of
// the bf16 pools; the f32 scale of each key row is read beside its chunk
// (the ps scales of a page are one 64-byte row at ps 16, shared through L1)
// and the product is taken as the element is widened into shared memory.
//
// C interface for ctypes: pointers and the stream are void*, every entry
// point returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <climits>
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

}  // namespace

extern "C" int flash_attention_dense(const void* q, const void* k, const void* v, void* o,
                                     const int* kv_lens, const int* q_offset,
                                     const int* window, int b, int hq, int hkv, int sq,
                                     int skv, int d, int causal, float scale, int is_bf16,
                                     void* stream) {
  if (bad_shape(b, hq, hkv, sq, d) || skv < 0) return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaGetLastError();
  Args a{q, k, v, o, kv_lens, q_offset, window, nullptr,
         hq, hkv, sq, skv, d, 0, 0, 0, causal, splits_for(sq < 16 ? sq : 16), scale};
  const int bq = (kWarps / a.splits) * kRows;
  const int grid_x = (sq + bq - 1) / bq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, false>(a, grid_x, hq, b, st)
                 : launch<float, float, false>(a, grid_x, hq, b, st);
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
