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
// What this design does about it.  One thread walks each row and never
// meets a block barrier between the first tile and the last: everything
// else is another warp's work, synchronised through mbarriers.  One CTA
// per row, three warps, each on its own SM sub-partition:
//   * warp 1, lane 0 (the producer) stages block-wide tiles of the row into
//     a ring of `stages` shared buffers with TMA bulk copies, each ending on
//     its stage's "full" mbarrier, and refills a stage once its last reader
//     (the store warp with partials, else the walker) has arrived on its
//     "empty" mbarrier.  A row that starts off a 16-byte
//     boundary is staged from the aligned address below it (its first
//     `head` <= 3 staged values are skipped), and a copy's size is rounded
//     up to 16 bytes: both reads stay inside the 16-byte chunks that hold
//     the row, so they never leave its pages, and the walker never adds
//     what lies outside the row.
//   * warp 0, lane 0 (the walker) adds the staged values in order, in
//     groups of 8 read from a ring of four register groups: the group three
//     ahead (24 values) is loaded before a group is added, unrolled so that
//     no register is copied between iterations; the accumulator is the only
//     dependency from one add to the next.  The walk runs in segments with
//     no branch but the loop's own: before a segment the walker waits for
//     the tiles the segment will read and the checkpoint slots it will
//     write, and hands over the tiles that are done; inside it, it only
//     loads, adds and stores one checkpoint per group (on a one-warp stream
//     every taken branch is exposed, and per group they cost more than the
//     adds).  With partials it stores no partial: it writes the accumulator
//     before each group (a checkpoint) into a ring of `ctiles` checkpoint
//     tiles and hands each tile over on its "cfull" mbarrier.
//   * warp 2 (the store warp) turns a handed-over tile into partials: lane q
//     adds group q of the tile from its checkpoint, in order, exactly as the
//     walker did (the same __fadd_rn on the same values from the same
//     accumulator, so the same bits), into one of two shared partial tiles.
//     It then frees the input stage ("empty") and the checkpoint slots
//     ("cempty") and writes the tile to device memory: one bulk copy
//     (cp.async.bulk.global.shared::cta) where the tile's slots and the
//     row's addresses agree modulo 16 bytes, plain coalesced stores for the
//     <= 3 values at either edge and for a partials row whose alignment
//     differs from x's; before it reuses a partial tile it waits for the
//     copy out of it to have read it (cp.async.bulk.wait_group.read).  After
//     the walk it writes the partials past n, which all equal the final
//     accumulator plus +0.0.  Without partials the walker frees each stage
//     itself.
// __syncthreads() is used once after the barriers are initialised and once
// after the walk (to hand the final accumulator to the store warp).
//
// C interface for ctypes: pointers and the stream are void*; the entry point
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 96;     // warp 0: the walker; warp 1: the producer; warp 2: stores
constexpr int kMaxBlock = 8192;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448; // 227 KB, the most a block may use on an H100

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The producer's arrival, announcing the bytes the stage's copy will deliver.
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

__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// A 16-byte shared load that stays where the source puts it (volatile): the
// compiler would otherwise move the walker's loads next to their first use,
// and the adds would wait for them.
__device__ __forceinline__ void lds128(float4& v, const float* p) {
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
}

// One slot of a ring of mbarriers and the parity of the phase it is in.
struct Ring {
  int i = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) {
      i = 0;
      phase ^= 1u;
    }
  }
};

// p[lo, hi) = val, by the 32 lanes of a warp: float4 stores between the
// 16-byte boundaries, plain stores at either edge.
__device__ __forceinline__ void fill(float* p, int lo, int hi, float val, int lane) {
  const int skew = (int)((16 - (reinterpret_cast<uintptr_t>(p + lo) & 15)) & 15) / 4;
  const int a = min(hi, lo + skew);
  const int quads = (hi - a) / 4;
  for (int i = lo + lane; i < a; i += 32) p[i] = val;
  float4* q = reinterpret_cast<float4*>(p + a);
  for (int i = lane; i < quads; i += 32) q[i] = make_float4(val, val, val, val);
  for (int i = a + 4 * quads + lane; i < hi; i += 32) p[i] = val;
}

// Slots [from, to) of a group added in order into acc; with p, every
// accumulator after a slot into p[0..8) (slots outside add nothing).  The
// walker and the store warp both add an edge group through this.
__device__ __forceinline__ float add_slots(float acc, const float4& a, const float4& b,
                                           int from, int to, float* p) {
  const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= from && k < to) acc = __fadd_rn(acc, e[k]);
    if (p) p[k] = acc;
  }
  return acc;
}

// The walking thread's state, in groups of 8 staged positions: group g
// lies in input tile g / gpt (stage t % stages) and its checkpoint (the
// accumulator before it) in checkpoint tile g / gpt (slot t % ctiles).
// Every member is inlined into walk(), so the state stays in registers.
template <bool kPartials>
struct Walker {
  const float* xs;
  float* cs;
  uint64_t *full, *empty, *cfull, *cempty;
  int stages, ctiles, gpt, ring, cring;  // gpt: groups per tile
  float acc;
  int lo = 0, co = 0;                    // ring offsets of the next fetch and checkpoint
  int fetched = 0, added = 0;            // groups fetched, groups added
  int arrived = 0, released = 0;         // input tiles waited for, input stages freed
  int cfree = 0, handed = 0;             // checkpoint tiles waited free, handed over

  __device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) { bar_wait(bar, parity); }

  // input tiles until group g may be read
  __device__ __forceinline__ void await_input(int g) {
    for (; arrived * gpt <= g; ++arrived) wait(full + arrived % stages, (arrived / stages) & 1);
  }
  // checkpoint tiles until group g's may be written
  __device__ __forceinline__ void await_checkpoints(int g) {
    if (kPartials)
      for (; cfree * gpt <= g; ++cfree) wait(cempty + cfree % ctiles, ((cfree / ctiles) & 1) ^ 1);
  }
  // hand over the tiles whose every group is added: with partials, to the
  // store warp (which frees the input stage once it has used it), else
  // back to the producer
  __device__ __forceinline__ void settle() {
    if (kPartials) {
      for (; (handed + 1) * gpt <= added; ++handed) hand_over();
    } else {
      for (; (released + 1) * gpt <= added; ++released) bar_arrive(empty + released % stages);
    }
  }
  __device__ __forceinline__ void hand_over() { bar_arrive(cfull + handed % ctiles); }

  // the next group's 8 staged values, its tile known to have arrived
  __device__ __forceinline__ void fetch(float4& a, float4& b) {
    lds128(a, xs + lo);
    lds128(b, xs + lo + 4);
    lo = lo + 8 == ring ? 0 : lo + 8;
  }
  __device__ __forceinline__ void fetch_checked(float4& a, float4& b) {
    await_input(fetched++);
    fetch(a, b);
  }

  // the accumulator before the next group, its checkpoint tile known free
  __device__ __forceinline__ void checkpoint() {
    if (kPartials) {
      cs[co] = acc;
      co = co + 1 == cring ? 0 : co + 1;
    }
  }

  // the next group added in order
  __device__ __forceinline__ void add8(const float4& a, const float4& b) {
    checkpoint();
    acc = __fadd_rn(acc, a.x);
    acc = __fadd_rn(acc, a.y);
    acc = __fadd_rn(acc, a.z);
    acc = __fadd_rn(acc, a.w);
    acc = __fadd_rn(acc, b.x);
    acc = __fadd_rn(acc, b.y);
    acc = __fadd_rn(acc, b.z);
    acc = __fadd_rn(acc, b.w);
  }
  __device__ __forceinline__ void add8_checked(const float4& a, const float4& b) {
    await_checkpoints(added);
    add8(a, b);
    ++added;
    settle();
  }

  // a group of which only slots [from, to) are elements of the row
  __device__ __forceinline__ void add_edge(int from, int to) {
    float4 a, b;
    fetch_checked(a, b);
    await_checkpoints(added);
    checkpoint();
    acc = add_slots(acc, a, b, from, to, nullptr);
    ++added;
    settle();
  }
};

// The walk: staged positions [head, end) of the row (element i at staged
// position head + i) added in order into acc.
template <bool kPartials>
__device__ __forceinline__ float walk(const float* xs, float* cs, uint64_t* full,
                                      uint64_t* empty, uint64_t* cfull, uint64_t* cempty,
                                      int stages, int ctiles, int block, int head, int end,
                                      float acc, int tiles) {
  Walker<kPartials> w{xs,     cs,     full,      empty,          cfull, cempty,
                      stages, ctiles, block / 8, stages * block, ctiles * (block / 8), acc};
  // group 0 holds the skipped head; groups [first, whole) are whole
  const int first = head > 0 ? 1 : 0;
  const int whole = max(first, end / 8);
  if (head > 0) w.add_edge(head, min(8, end));
  float4 r0a, r0b, r1a, r1b, r2a, r2b, r3a, r3b;
  int j = first;                        // groups j, j + 1, j + 2 are in register groups 0-2
  if (j < whole) w.fetch_checked(r0a, r0b);
  if (j + 1 < whole) w.fetch_checked(r1a, r1b);
  if (j + 2 < whole) w.fetch_checked(r2a, r2b);
  while (j + 8 <= whole) {
    // one step adds groups j..j+3 and fetches j+3..j+6: run as many as the
    // tiles waited for allow, with nothing else in the loop
    w.settle();
    w.await_input(j + 6);
    w.await_checkpoints(j + 6);
    const int ready = kPartials ? min(w.arrived, w.cfree) * w.gpt : w.arrived * w.gpt;
    const int steps = (min(ready - 7, whole - 8) - j) / 4 + 1;
    for (int k = 0; k < steps; ++k) {
      w.fetch(r3a, r3b);
      w.add8(r0a, r0b);
      w.fetch(r0a, r0b);
      w.add8(r1a, r1b);
      w.fetch(r1a, r1b);
      w.add8(r2a, r2b);
      w.fetch(r2a, r2b);
      w.add8(r3a, r3b);
    }
    j += 4 * steps;
    w.added = j;
    w.fetched = j + 3;
  }
  w.settle();
  if (j + 4 <= whole) {                 // the last whole groups: fetch only what exists
    w.add8_checked(r0a, r0b);
    w.fetch_checked(r3a, r3b);
    w.add8_checked(r1a, r1b);
    if (j + 4 < whole) w.fetch_checked(r0a, r0b);
    w.add8_checked(r2a, r2b);
    if (j + 5 < whole) w.fetch_checked(r1a, r1b);
    w.add8_checked(r3a, r3b);
    if (j + 6 < whole) w.fetch_checked(r2a, r2b);
    j += 4;
  }
  if (j < whole) w.add8_checked(r0a, r0b);
  if (j + 1 < whole) w.add8_checked(r1a, r1b);
  if (j + 2 < whole) w.add8_checked(r2a, r2b);
  if (end % 8 != 0 && end / 8 >= first) w.add_edge(0, end % 8);
  if (kPartials)                        // the last tile ended early
    for (; w.handed < tiles; ++w.handed) w.hand_over();
  return w.acc;
}

// The store warp: each tile's partials recomputed from its checkpoints (lane
// q adds group q of the tile from the accumulator before it, exactly as the
// walker did), written to one of two shared partial tiles and from there to
// device memory; then the input stage and the checkpoint slots are freed.
__device__ __forceinline__ void store_partials(const float* xs, const float* cs, float* ps,
                                               uint64_t* empty, uint64_t* cfull,
                                               uint64_t* cempty, int stages, int ctiles,
                                               int block, int head, int end, int tiles,
                                               float* pr, int lane) {
  // staged slot s of tile t is element t * block - head + s
  const bool bulk = (int)((reinterpret_cast<uintptr_t>(pr) & 15) >> 2) == head;
  const int gpt = block / 8;
  for (int t = 0; t < tiles; ++t) {
    bar_wait(cfull + t % ctiles, (t / ctiles) & 1);
    float* tile = ps + (size_t)(t & 1) * block;
    if (lane == 0 && t >= 2)            // tile t - 2's copy has read this buffer
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncwarp();
    const float* xt = xs + (size_t)(t % stages) * block;
    const float* ct = cs + (size_t)(t % ctiles) * gpt;
    const int lo = t == 0 ? head : 0;
    const int hi = min(block, end - t * block);
    for (int q = lane; 8 * q < hi; q += 32) {
      float4 a, b;
      lds128(a, xt + 8 * q);
      lds128(b, xt + 8 * q + 4);
      float p[8];
      add_slots(ct[q], a, b, max(0, lo - 8 * q), min(8, hi - 8 * q), p);
      *reinterpret_cast<float4*>(tile + 8 * q) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(tile + 8 * q + 4) = make_float4(p[4], p[5], p[6], p[7]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      bar_arrive(empty + t % stages);
      bar_arrive(cempty + t % ctiles);
    }
    float* dst = pr + (long long)t * block - head;
    int a = lo, b = lo;                 // [a, b): one bulk copy
    if (bulk) {
      a = min(hi, (lo + 3) & ~3);
      b = max(a, hi & ~3);
      if (lane == 0 && b > a) bulk_store(dst + a, tile + a, 4u * (unsigned)(b - a));
    }
    if (lane == 0) asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    for (int s = lo + lane; s < a; s += 32) dst[s] = tile[s];
    for (int s = b + lane; s < hi; s += 32) dst[s] = tile[s];
  }
}

template <bool kPartials>
__global__ void __launch_bounds__(kThreads)
    fadda_rows_kernel(const float* __restrict__ x, long long ld, const int* __restrict__ n_rows,
                      const float* __restrict__ init, float* __restrict__ partials,
                      float* __restrict__ out, int v, int block, int stages, int ctiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int gpt = block / 8;
  float* xs = reinterpret_cast<float*>(smem);          // stages input tiles
  float* ps = xs + (size_t)stages * block;              // 2 partial tiles, with partials
  float* cs = ps + (kPartials ? 2 * (size_t)block : 0); // ctiles checkpoint tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + (((size_t)ctiles * gpt + 3) & ~(size_t)3));
  uint64_t* empty = full + stages;
  uint64_t* cfull = empty + stages;
  uint64_t* cempty = cfull + ctiles;
  __shared__ float final_acc;

  const int row = blockIdx.x;
  const int warp = (int)threadIdx.x / 32, lane = (int)threadIdx.x % 32;
  const float* xr = x + (long long)row * ld;
  const int head = (int)((reinterpret_cast<uintptr_t>(xr) & 15) >> 2);
  const float* xa = xr - head;                          // 16-byte aligned
  const int len = max(0, min(n_rows[row], v));          // the active prefix: whilelt(0, n)
  const int end = len > 0 ? head + len : 0;             // staged positions [head, end)
  const int tiles = (end + block - 1) / block;
  float* pr = kPartials ? partials + (long long)row * v : nullptr;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, 1);
    }
    for (int i = 0; i < ctiles; ++i) {
      bar_init(cfull + i, 1);
      bar_init(cempty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0) {
      float acc = init[row];
      if (tiles > 0)
        acc = walk<kPartials>(xs, cs, full, empty, cfull, cempty, stages, ctiles, block, head,
                              end, acc, tiles);
      final_acc = acc;
    }
  } else if (warp == 1) {
    if (lane == 0) {
      Ring r;
      for (int t = 0; t < tiles; ++t) {
        bar_wait(empty + r.i, r.phase ^ 1u);
        const int m = min(block, end - t * block);
        const unsigned bytes = 4u * (unsigned)((m + 3) & ~3);
        bar_arrive_tx(full + r.i, bytes);
        bulk_load(xs + (size_t)r.i * block, xa + (long long)t * block, bytes, full + r.i);
        r.next(stages);
      }
    }
  } else if (kPartials) {
    store_partials(xs, cs, ps, empty, cfull, cempty, stages, ctiles, block, head, end, tiles,
                   pr, lane);
  }
  __syncthreads();
  // inactive elements each add +0.0: after the first, acc + 0.0 is a fixed point
  const float fin = len < v ? __fadd_rn(final_acc, 0.0f) : final_acc;
  if (threadIdx.x == 0) out[row] = fin;
  if (kPartials && warp == 2) {
    fill(pr, len, v, fin, lane);
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The shared memory the kernel takes (kernel.plan_fadda computes the same).
int smem_bytes(bool partials, int block, int stages, int ctiles) {
  return 4 * (stages + (partials ? 2 : 0)) * block + 4 * ((ctiles * (block / 8) + 3) & ~3) +
         16 * (stages + ctiles);
}

template <bool kPartials>
int launch(const float* x, long long ld, const int* n, const float* init, float* partials,
           float* out, int rows, int v, int block, int stages, int ctiles, cudaStream_t st) {
  const int smem = smem_bytes(kPartials, block, stages, ctiles);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;        // the dynamic shared memory this kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fadda_rows_kernel<kPartials>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  fadda_rows_kernel<kPartials><<<rows, kThreads, smem, st>>>(x, ld, n, init, partials, out, v,
                                                             block, stages, ctiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, ld) f32 with rows of v elements; n (rows,) int32; init (rows,)
// f32; out (rows,) f32; partials (rows, v) f32 or null.  block (the VL) is a
// multiple of 8 in [8, 8192]; stages input tiles and ctiles checkpoint tiles
// (0 without partials) of shared memory, as kernel.plan_fadda gives them.
extern "C" int fadda_rows(const float* x, long long ld, const int* n, const float* init,
                          float* partials, float* out, int rows, int v, int block, int stages,
                          int ctiles, void* stream) {
  const bool want = ctiles > 0;
  if (rows < 1 || v < 0 || ld < v || block < 8 || block % 8 != 0 || block > kMaxBlock ||
      stages < 2 || stages > kMaxStages || (stages - 1) * (block / 8) < 7 ||
      (want && (ctiles < 2 || ctiles > kMaxStages || (ctiles - 1) * (block / 8) < 7 ||
                (v > 0 && partials == nullptr))) ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 || reinterpret_cast<uintptr_t>(partials) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return want ? launch<true>(x, ld, n, init, partials, out, rows, v, block, stages, ctiles, st)
              : launch<false>(x, ld, n, init, nullptr, out, rows, v, block, stages, 0, st);
}
