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
// assignments; decode: 64).  At those sizes it is bound by launch latency.
//
// What this design does about it.  The TPU kernel walks tiles in order and
// carries the (1, E) counts from tile to tile in VMEM.  Blocks run in no
// order here, so the carry becomes an exclusive prefix across tiles, in
// three passes (one when everything fits in one tile, as at decode):
//   1. tile_ranks: one block per tile of kTile assignments, one assignment
//      per thread.  Within a warp, __match_any_sync groups the lanes with the
//      same expert and the popcount of the lower lanes of that group is the
//      rank in the warp; the group's lowest lane writes the group's size to
//      the warp's row of a (warps, E) table in shared memory; an exclusive
//      prefix over the warps, per expert, gives each warp's base.  No atomic
//      decides a rank, so the ranks follow the flattened order exactly.
//      The tile's in-tile rank goes to pos, its per-expert total to scratch.
//   2. tile_bases: one block per expert scans the tiles' totals (warp
//      shuffles, a carry across chunks of kTile tiles) into exclusive bases
//      in place, and writes counts.
//   3. add_bases: each assignment adds its tile's base for its expert.
// Nothing is padded: the tail of the last tile is masked from n.
//
// C interface for ctypes: pointers and the stream are void*; the entry
// point returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kTile = kWarp * kWarps;   // assignments per block, one per thread
constexpr int kMaxExperts = 1024;       // (kWarps, E) ints of shared memory
constexpr unsigned kFull = 0xffffffffu;

// Pass 1: in-tile ranks to pos, the tile's per-expert totals to row
// blockIdx.x of totals.  With one tile in all, the ranks are final and the
// totals are the counts.
__global__ void __launch_bounds__(kTile)
    tile_ranks(const int* __restrict__ ids, int* __restrict__ pos, int* __restrict__ totals,
               int n, int e) {
  extern __shared__ int wcnt[];         // (kWarps, e): per-warp counts, then bases
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int i = threadIdx.x; i < kWarps * e; i += blockDim.x) wcnt[i] = 0;
  __syncthreads();

  const long long g = (long long)blockIdx.x * kTile + threadIdx.x;
  int id = g < n ? ids[g] : -1;
  const bool valid = id >= 0 && id < e;
  if (!valid) id = -1;                  // all invalid lanes form one group
  const unsigned peers = __match_any_sync(kFull, id);
  const int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (valid && in_warp == 0) wcnt[warp * e + id] = __popc(peers);
  __syncthreads();

  for (int x = threadIdx.x; x < e; x += blockDim.x) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * e + x];
      wcnt[w * e + x] = run;
      run += c;
    }
    totals[(size_t)blockIdx.x * e + x] = run;
  }
  __syncthreads();
  if (g < n) pos[g] = valid ? wcnt[warp * e + id] + in_warp : 0;
}

// Pass 2: block x scans column x of totals (n_tiles, e) into exclusive
// bases, in place, and writes counts[x].
__global__ void __launch_bounds__(kTile)
    tile_bases(int* __restrict__ totals, int* __restrict__ counts, int n_tiles, int e) {
  __shared__ int warp_sums[kWarps];
  const int x = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int carry = 0;                        // the same value in every thread
  for (int t0 = 0; t0 < n_tiles; t0 += kTile) {
    const int t = t0 + threadIdx.x;
    const int c = t < n_tiles ? totals[(size_t)t * e + x] : 0;
    int v = c;                          // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    if (lane == kWarp - 1) warp_sums[warp] = v;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sums[w];
      if (w < warp) before += s;
      total += s;
    }
    if (t < n_tiles) totals[(size_t)t * e + x] = carry + before + v - c;
    carry += total;
    __syncthreads();                    // warp_sums is rewritten next chunk
  }
  if (threadIdx.x == 0) counts[x] = carry;
}

// Pass 3: add each tile's base for the assignment's expert.
__global__ void __launch_bounds__(kTile)
    add_bases(const int* __restrict__ ids, int* __restrict__ pos,
              const int* __restrict__ bases, int n, int e) {
  const long long g = (long long)blockIdx.x * kTile + threadIdx.x;
  if (g >= n) return;
  const int id = ids[g];
  if (id >= 0 && id < e) pos[g] += bases[(size_t)blockIdx.x * e + id];
}

}  // namespace

// ids (n,) int32 -> pos (n,) int32, counts (e,) int32.  scratch holds
// ceil(n / 256) * e ints (at least e).
extern "C" int moe_positions(const int* ids, int* pos, int* counts, int* scratch, int n,
                             int e, void* stream) {
  if (n < 0 || e < 1 || e > kMaxExperts) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    const cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * e, st);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  const int n_tiles = (n + kTile - 1) / kTile;
  const size_t smem = sizeof(int) * kWarps * e;
  if (n_tiles == 1) {                   // one tile: its totals are the counts
    tile_ranks<<<1, kTile, smem, st>>>(ids, pos, counts, n, e);
    return (int)cudaGetLastError();
  }
  tile_ranks<<<n_tiles, kTile, smem, st>>>(ids, pos, scratch, n, e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_bases<<<e, kTile, 0, st>>>(scratch, counts, n_tiles, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_bases<<<n_tiles, kTile, 0, st>>>(ids, pos, scratch, n, e);
  return (int)cudaGetLastError();
}
