// MoE dispatch ranks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel moe_positions_pallas
// (src/repro/kernels/moe_dispatch/kernel.py, body _dispatch_kernel).
//
// What it computes.  ids (T, K) int32 -> pos (T, K) int32 and counts (E,)
// int32.  Flatten ids token-major, slot-minor into n = T * K assignments;
// pos[g] is the number of earlier assignments g' < g with ids[g'] == ids[g],
// and counts[e] the number of assignments to expert e.  An id outside
// [0, E) ranks nothing: its pos is 0 and it counts nowhere (as the plain
// version; the TPU kernel's one-hot also ranks ids in [E, round_up(E, 128))).
// Results are integers and equal the plain version exactly.
//
// What bounds it on an H100.  It reads 4 bytes and writes 4 bytes per
// assignment and does a few integer operations on them: the bound is bytes,
// under a microsecond at the serving path's sizes (olmoe prefill: 61,632
// assignments; decode: 64).  At those sizes what binds it is the launch.
//
// What this design does about it.  The TPU kernel walks tiles in order and
// carries the (1, E) counts from tile to tile in VMEM.  Blocks run in no
// order here; instead of a carry through device memory (a second and third
// launch, or flags that one block spins on), each block learns the counts
// of the tiles before its own from its thread block cluster: one launch, no
// state in device memory, the same result whatever order the blocks run in,
// and nothing to reset between calls (a CUDA graph can capture it as it
// is).  The grid is cut into tiles of rounds * 32 * warps assignments, one
// per block, in clusters of kCluster blocks.  In each block:
//   1. each warp loads its assignments (all its rounds at once), then walks
//      its rounds of 32 in order: __match_any_sync groups the lanes with the
//      same expert, the popcount of the lower lanes of that group is the
//      rank in the round, the warp's running count per expert (shared
//      memory) is the rank before the round, and the group's lowest lane
//      adds the group's size to it.  No atomic decides a rank: the ranks
//      follow the flattened order exactly.
//   2. every thread counts, with shared-memory atomics (counting is
//      order-free), the block's 1/kCluster share of the assignments of the
//      clusters before its own: together the cluster reads them once, and
//      the last block reads n / kCluster ids, not n.
//   3. one warp per expert scans the warps' counts (shuffles): each warp's
//      offset in the tile, and the tile's total.
//   4. each block writes its share of step 2 and its tile's total into
//      every block of its cluster (distributed shared memory), then passes
//      one cluster barrier.  Writing to the peers and not reading from
//      them leaves nothing to wait for after the barrier: no block's shared
//      memory is touched once it may have exited.  (That every peer has
//      started, which a write into it needs, is the arrival each block
//      makes on entry, waited for just before the writes.)
//   5. each block sums, per expert, every peer's share and the tiles of
//      the peers before it: the count of every earlier tile.  The last
//      block also writes the counts.
//   6. each assignment writes that count plus its warp's offset plus its
//      rank.
// With one block of one warp (decode: up to 128 assignments) steps 2-5 fall
// away: no cluster, and the warp synchronises only with itself.
//
// C interface for ctypes: pointers and the stream are void*; the entry
// point returns cudaGetLastError() as an int (0 = launched).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 16;
constexpr int kMaxRounds = 4;           // rounds of 32 assignments a warp ranks
constexpr int kCluster = 8;             // blocks that share the counting of earlier tiles
constexpr int kMaxExperts = 1024;       // (warps + 3 + 2 kCluster, E) ints of shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void count(int* hist, int id, int e) {
  if ((unsigned)id < (unsigned)e) atomicAdd(hist + id, 1);
}

// hist[id] += 1 for every valid id of ids[from, from + len), by the block
__device__ __forceinline__ void count_ids(const int* __restrict__ ids, long long from,
                                          long long len, int* hist, int e, int vec) {
  if (vec) {                            // from and len are multiples of 32 assignments
    const int4* q = reinterpret_cast<const int4*>(ids + from);
    const long long nq = len / 4;
    const int step = blockDim.x;
    long long i = threadIdx.x;
    for (; i + 3 * step < nq; i += 4 * step) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(q + i + u * step);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        count(hist, v[u].x, e);
        count(hist, v[u].y, e);
        count(hist, v[u].z, e);
        count(hist, v[u].w, e);
      }
    }
    for (; i < nq; i += step) {
      const int4 v = __ldg(q + i);
      count(hist, v.x, e);
      count(hist, v.y, e);
      count(hist, v.z, e);
      count(hist, v.w, e);
    }
  } else {
    for (long long i = threadIdx.x; i < len; i += blockDim.x) count(hist, __ldg(ids + from + i), e);
  }
}

// A tile of rounds * 32 * warps assignments per block.  kOneWarp: one block
// of one warp; else launched in clusters of kCluster blocks.
template <bool kOneWarp>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    moe_positions_kernel(const int* __restrict__ ids, int* __restrict__ pos,
                         int* __restrict__ counts, int n, int e, int rounds, int vec) {
  extern __shared__ int smem[];
  // a peer's shared memory may be written only once the peer has started:
  // arrive now, wait before step 4
  if constexpr (!kOneWarp) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int warps = (int)blockDim.x / kWarp;
  const int warp = (int)threadIdx.x / kWarp, lane = (int)threadIdx.x % kWarp;
  const long long tile = (long long)rounds * blockDim.x;
  const long long w0 = (long long)blockIdx.x * tile + (long long)warp * rounds * kWarp;
  int id_r[kMaxRounds], rank_r[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const long long g = w0 + r * kWarp + lane;
    id_r[r] = r < rounds && g < n ? __ldg(ids + g) : -1;
  }
  int* wcnt = smem;                     // (warps, e): running counts, then offsets
  int* tot = wcnt + warps * e;          // (e,): the tile's counts
  int* share = tot + e;                 // (e,): step 2's counts
  int* pre = share + e;                 // (e,): the counts of every earlier tile
  int* in = pre + e;                    // (2, kCluster, e): every peer's share and tile total
  for (int i = threadIdx.x; i < (warps + (kOneWarp ? 0 : 3)) * e; i += blockDim.x) smem[i] = 0;
  if (kOneWarp)
    __syncwarp();
  else
    __syncthreads();

  // 1. the warp's rounds, in order
  int* run = wcnt + warp * e;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r < rounds) {
      int id = id_r[r];
      if ((unsigned)id >= (unsigned)e) id = -1;   // all invalid lanes form one group
      const unsigned peers = __match_any_sync(kFull, id);
      const int below = __popc(peers & ((1u << lane) - 1u));
      const int prior = id >= 0 ? run[id] : 0;
      __syncwarp();
      if (id >= 0 && below == 0) run[id] = prior + __popc(peers);
      __syncwarp();
      id_r[r] = id;
      rank_r[r] = prior + below;
    }
  }

  if constexpr (kOneWarp) {
    for (int x = lane; x < e; x += kWarp) counts[x] = run[x];
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      const long long g = w0 + r * kWarp + lane;
      if (r < rounds && g < n) pos[g] = id_r[r] >= 0 ? rank_r[r] : 0;
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int q = (int)cluster.block_rank();
    // 2. this block's share of the clusters before this one
    const long long part = (long long)(blockIdx.x - q) * tile / kCluster;
    count_ids(ids, q * part, part, share, e, vec);
    __syncthreads();

    // 3. per expert, an exclusive scan over the warps: lane w holds warp w's count
    for (int x = warp; x < e; x += warps) {
      const int c = lane < warps ? wcnt[lane * e + x] : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < warps) wcnt[lane * e + x] = incl - c;
      if (lane == kWarp - 1) tot[x] = incl;
    }
    __syncthreads();

    // 4. this block's share and tile total to every block of the cluster
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int i = threadIdx.x; i < kCluster * e; i += blockDim.x) {
      int* peer = cluster.map_shared_rank(in, i / e);
      const int x = i % e;
      peer[q * e + x] = share[x];
      peer[(kCluster + q) * e + x] = tot[x];
    }
    cluster.sync();

    // 5. the earlier tiles: every peer's share, and the tiles of the peers before this one
    const bool last = blockIdx.x == gridDim.x - 1;
    for (int x = threadIdx.x; x < e; x += blockDim.x) {
      int c = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        c += in[r * e + x];
        if (r < q) c += in[(kCluster + r) * e + x];
      }
      pre[x] = c;
      if (last) counts[x] = c + tot[x];
    }
    __syncthreads();

    // 6. earlier tiles, earlier warps, earlier lanes and rounds
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      const long long g = w0 + r * kWarp + lane;
      const int id = id_r[r];
      if (r < rounds && g < n) pos[g] = id >= 0 ? pre[id] + run[id] + rank_r[r] : 0;
    }
  }
}

template <bool kOneWarp>
int launch(const int* ids, int* pos, int* counts, int n, int e, int warps, int rounds, int grid,
           cudaStream_t st) {
  const int smem = (int)sizeof(int) * (warps + (kOneWarp ? 0 : 3 + 2 * kCluster)) * e;
  static int allowed = 48 * 1024;       // the dynamic shared memory this kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_positions_kernel<kOneWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const int vec = reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(warps * kWarp);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kOneWarp ? 0 : 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, moe_positions_kernel<kOneWarp>, ids, pos, counts, n, e, rounds, vec);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// ids (n,) int32 -> pos (n,) int32, counts (e,) int32, in one launch of grid
// blocks of warps warps, each warp ranking rounds rounds of 32 assignments
// (kernel.plan_positions): one block of one warp, or a whole number of
// clusters of kCluster blocks whose last cluster holds the last assignment.
extern "C" int moe_positions(const int* ids, int* pos, int* counts, int n, int e, int warps,
                             int rounds, int grid, void* stream) {
  const long long tile = (long long)rounds * kWarp * warps;
  const long long tiles = n > 0 ? (n + tile - 1) / tile : 1;
  if (n < 0 || e < 1 || e > kMaxExperts || warps < 1 || warps > kMaxWarps || rounds < 1 ||
      rounds > kMaxRounds ||
      (warps == 1 ? grid != 1 || tiles != 1
                  : grid % kCluster != 0 || grid < tiles || grid >= tiles + kCluster))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return warps == 1 ? launch<true>(ids, pos, counts, n, e, warps, rounds, grid, st)
                    : launch<false>(ids, pos, counts, n, e, warps, rounds, grid, st);
}
