"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from the sources in the checkout:
   one ``nvcc`` per library (flash attention's forward source as four
   libraries, one per group of entry points), all started together.
2. Holds each kernel against its plain PyTorch version on the card (flash
   attention in f32 at atol = rtol = 1e-5; in bf16 each body on the cases
   its plan routes to it: the split-KV body, dense and paged over bf16,
   int8 and fp8 pools, to one bf16 rounding step (atol 1e-5, rtol 2^-7),
   the tensor-core body at ``TOL["tensor_core"]`` with its ratio to that
   limit printed per case; f32 over int8/fp8 pools at 1e-4 as the widened
   values differ from the plain path's by rounding; the SSD scan per body,
   chosen by ``plan_ssd`` (bf16 on the 16-grid on the tensor-core body,
   f32 and off-grid bf16 on the CUDA-core body): f32 at 1e-4 as its exp and
   cumsum run in another order, bf16 h_final at 1e-4 and bf16 y at
   ``SSD_Y_TOL`` with its ratio to that limit printed per case; the MoE
   dispatch ranks, the ordered
   ``fadda`` sums and scans and ``daxpy`` exactly, bit for bit; every flash
   body at head dims up to 160, stablelm-12b's), holds bf16
   paged decode equal to dense decode bit for bit and each lane's bf16
   decode equal alone and in the batch (head dims 80 and 160), checks the
   threefry bits on the card against the CPU's, and times each kernel at
   the shapes its path gives it (the flash kernels also at stablelm-12b's
   D-160 shapes), beside its plain version, its bound and, where one
   exists, one PyTorch library call (``moe_positions`` and ``fadda`` also
   beside the launch floor: the time of one empty kernel).
3. Serves 8 greedy requests through ``ServeEngine.generate`` at the full
   width of stablelm-3b (dense family), zamba2-1.2b (hybrid), mamba2-130m
   (ssm) and olmoe-1b-7b (moe), the first, second and fourth at about half
   depth (``SERVE_DEPTH``; the scheduler's legs too), random weights from
   seed 0, with the dense
   and (where the family pages) the paged KV cache, full precision and
   int8/fp8, then one mixed batch (4 greedy, 4 stochastic lanes) on the
   dense cache, counting kernel launches in each run, and checks the
   outputs: finite logits, launch counts (each flash kernel's per body),
   the paged runs' tokens equal to the dense run's, first-step logits
   against the plain path, across cache layouts, and of quantized native
   decode against the gather oracle over the same pool bytes and against a
   truncating oracle; in a teacher-forced decode of the dense run's
   tokens, every split-KV call (dense, paged, int8/fp8 pages) against the
   plain attention on its inputs (bf16 weights) and the paged cache's
   logits equal to the dense cache's at every step (bf16 and f32 weights);
   the mixed batch's greedy lanes against the all-greedy run and its
   stochastic lanes' first tokens against the keep set of the plain path.
   ``generate`` decodes through one CUDA graph per shape bucket: each run
   is held bit for bit (tokens, n_generated, active, every cache tensor)
   against the same ``generate`` through the eager body, with equal launch
   counts (the graph's counted once per replay), and every lane of both
   decodes its whole budget in vocab ids; two faulty copies of the body
   (no carry written back; the merge kept on ``tok`` in a gated step) must
   fail that check; each graph's nodes hold the port's kernels as their
   wrappers counted; a graphed generate reads one device value per burst;
   two buckets share one static carry, a new prompt width evicts the old
   shapes' graphs, and a returned cache is a copy; and the scheduler's page
   and lane movers restore pools and resume a spilled lane bit for bit.
   Each model and cache is timed in turns (eager, graph, graph), with each
   bucket's capture seconds, graph-pool and static-carry bytes, and 20
   replayed bursts timed, two of them profiled, beside the eager step of
   ``profile_decode``.  The moe_positions and fadda checks also run inside
   a CUDA graph.
   Then the continuous-batching scheduler (``serve_scheduler``): 32
   requests (prompts 128–1024, budgets 16–64, 8 at step 0 then one every 4
   decode steps, requests 4k+2 and 4k+3 sampled) on 8 lanes, bursts of 8,
   compaction below half occupancy, through ``ContinuousBatchingScheduler``
   at full width: stablelm-3b with the dense cache (the first 8 requests
   held to ``generate`` of their 8 prompts bit for bit, the first 12 held
   fused == unfused and traced == untraced bit for bit with equal
   dispatches and host syncs, the trace exported and validated), the same
   with ``overlap=True`` (every request's tokens held to the dense leg's,
   one host sync a round), paged (prefix sharing, the host-swap tier,
   chunked prefill of 256, requests 16–23 second turns of earlier
   requests: session hits held, no page leaked, the requests with no
   prefix hit and no chunk held to the dense leg bit for bit, narrowed
   bursts included, and every request's first-token logits to the dense
   leg's or the whole prompt's bit for bit), the control plane (the first
   16 requests and 4 second turns on a 192-page pool with overlap,
   priorities, a bounded queue, deadlines and a seeded chaos schedule, run
   twice: every mechanism fired, no page leaked, every finished request's
   tokens held to the dense leg's, the two runs equal), zamba2-1.2b paged
   int8 with chunked prefill and olmoe-1b-7b dense.  Each leg runs twice (the first run captures its graphs), both
   runs held to every budget in vocab ids and to the same tokens, the warm
   run's launches per kernel and body held; it prints tokens per second,
   TTFT, the decode step, a round's anatomy (admission and compaction
   cost, the splices' ms and bytes), captures and, for stablelm dense, the
   device's idle share over 10 profiled rounds.
   Then the cross-attention models and gemma3 (``serve_cross``), random
   bf16 weights from seed 0 at full width: seamless-m4t-large-v2 (encdec;
   8 requests, encoder inputs of 256–1024 frames, decoder prompts of 8–64
   tokens; dense, paged, int8), llama-3.2-vision-11b (the 8 prompts above
   with image embeddings of (8, 1024, 4096); dense, paged) and gemma3-27b
   (24 of its 62 layers; the 8 prompts, lanes 0 and 4 past its 1024-key
   window; dense, paged), each through ``generate`` with the row checks,
   graphed == eager, paged == dense and the launches per body held; and
   seamless through the scheduler (``serve_encdec_scheduler``: 16
   requests, ``src_len`` 1024, dense whole prefills against 16-token pages
   with prefill chunks of 32, bit for bit).  The flash kernels are also
   held in those models' roles (``check_cross_roles``: non-causal, Sq !=
   Skv both ways, kv_lens down to 1, the split-KV body over 1024 keys) and
   timed there (``time_cross``).
   Then stablelm-12b (``serve_stablelm_12b``: 40 x d 5120, 32 heads over 8
   KV heads of D 160, random bf16 weights from seed 0) through the same
   checks as the models above (dense, paged, int8), with its first step
   through the kernels held to the plain path (bf16 and f32 weights on 8
   of its 40 layers; bf16 at full depth reported), and speculative
   decoding on it (``serve_speculative``: 8 lanes, 32 tokens, k 4; the
   target as its own draft and a 2-layer draft, greedy, both committing
   the target's greedy ``generate`` tokens bit for bit; the mixed batch
   twice, the same tokens).
4. Runs the port's quickstart (daxpy, Fig. 2; fadda, §2.4) on the card.
5. Trains (``repro_torch.train``): holds the flash backward
   (``flash_attention_bwd.cu``: its tensor-core body for bf16, its
   CUDA-core body for f32) and the forward's lse against the plain
   versions over the mask matrix, head dims 64/80/128/160 and GQA groups
   1 and 4 (``check_flash_bwd``: f32, bf16 at ``TOL["bwd"]``, fully masked
   rows 0, two calls equal bit for bit), then holds and times it at
   stablelm-3b's and stablelm-12b's training shapes beside the plain and
   SDPA backwards (``time_flash_bwd``); holds
   one train step of the VLM, encdec and MoE at reduced dims on the card
   against the CPU (``check_train_families``); trains stablelm-3b at full
   width (``train_stablelm_3b``: seq 4096 x batch 2, remat full, 5 steps,
   the loss falling, launches per layer and step; at 4 layers two first
   steps and remat full == none bit for bit, the plain path at seq 512),
   and mamba2-130m through ``repro_torch.launch.train`` with an injected
   step fault (``train_mamba2_130m``: the final loss bit for bit against an
   uninterrupted run); one profiled step each.
6. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Any failed phase raises, and the script exits non-zero without a result.
It needs CUDA; without it, or without the repo's ``src/`` beside it, it
fails.

    python3 chip_smoke.py --scheduler

builds the kernels and runs only the continuous-batching phase.

    python3 chip_smoke.py --train

builds the kernels and runs only the training phases (5. above), after
ptxas's registers and spills of the flash libraries (the serving groups,
the training forward's lse instances, the backward).

    python3 chip_smoke.py --cross

builds the kernels and runs only the cross-attention roles' check and
times, ``serve_cross`` for seamless, llama-vision and gemma3, and the
encdec scheduler leg.

    python3 chip_smoke.py --spec

builds the kernels and runs only this slice's phases: ptxas's registers
and spills for every flash instance, the flash checks (every head dim up
to 160), the D-160 kernel times (``time_head160``), ``serve_stablelm_12b``
and ``serve_speculative``.

    python3 chip_smoke.py --chunk-probe

builds the kernels and holds chunked against whole-prompt prefill of
stablelm-3b on the card (``chunk_probe``), through the kernels and the
plain attention, and the dense kernel alone at a short last chunk's
shapes: a bf16 prefill's logits move with its GEMMs' row count.

    python3 chip_smoke.py --gemm-probe

builds the kernels and shows which row counts give a row the same bits
(``gemm_probe``): every projection shape of stablelm-3b, zamba2-1.2b and
mamba2-130m and, from their configs (``shape_probe``), of
seamless-m4t-large-v2, llama-3.2-vision-11b, gemma3-27b,
command-r-plus-104b and stablelm-12b with their unembeddings, and their
row reductions,
with 16 probe rows inside calls of 1 to 8192 rows (what the per-shape
floors of ``layers.ROW_FLOORS`` cost: ``table_cost``), and at model level one decode step at widths 1/2/4/8 and one
prompt prefilled alone, in a batch and in chunks, at several row floors.

    python3 chip_smoke.py --ssd-probes

builds the kernels and runs only the measurements behind the SSD scan's
tensor-core body (``ssd_probes``): faulty copies of the body that its check
must fail, the body with the accurate ``expf`` timed against the shipped
one, and the card's ``mma.sync`` rate.

    python3 chip_smoke.py --fadda-probes [--parent DIR]

builds the kernels and runs only the measurements behind the ``fadda`` and
``moe_positions`` bodies (``fadda_probes``): the latency of a dependent f32
add, faulty copies of the fadda body that ``check_fadda`` must fail, the
walker's cycles per element by phase (clock64() stamps), the price of the
moe_positions blocks' redundant counting and its rounds per warp.  With
``--parent DIR``, a tree holding the kernels before their redesign (e.g.
``git archive <commit> src/repro_torch/kernels | tar -x -C DIR``), also the
old fadda body's phases and both trees' kernels timed in turns, with the
host's enqueue time per ``moe_positions_cuda`` call.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SRC_SSD = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SRC_MOE = "src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu"
SRC_FADDA = "src/repro_torch/kernels/fadda/csrc/fadda.cu"
SRC_DAXPY = "src/repro_torch/kernels/daxpy/csrc/daxpy.cu"
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
FADD_CYCLES = 4                 # latency of a dependent f32 add on Hopper
N_REQ, MAX_NEW, PAGE_SIZE = 8, 64, 16


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def card() -> str:
    return smi("name,power.limit")


def max_sm_clock_hz() -> float:
    """The SM clock the chain bound of ``fadda`` is computed at."""
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events, with the 50 MB L2
    flushed before each call (the serving path reads each layer's K/V once,
    cold).  A spin kernel holds the stream until the host has enqueued every
    call, so the events time the device and not Python's launch overhead."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for spin in (10 ** 7 * 4 ** i for i in range(6)):     # clock cycles
        held = torch.cuda.Event()
        torch.cuda._sleep(spin)
        held.record()
        marks = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            marks.append((start, end))
        enqueued_in_time = not held.query()
        torch.cuda.synchronize()
        if enqueued_in_time:
            return statistics.median(s.elapsed_time(e) for s, e in marks)
    raise RuntimeError("the host could not enqueue the timed calls within "
                       "the spin: device time is not isolated")


def time_wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median time of one call between CUDA events with no spin and no L2
    flush: for a plain version whose host issues thousands of launches and
    allocations (``time_ms``'s spin cannot hold the stream long enough), so
    it includes the host's time where the host is slower than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


@functools.lru_cache(maxsize=None)
def empty_library():
    return _probe_library("launch_floor", EMPTY_KERNEL,
                          {"launch_empty": [ctypes.c_void_p]})


def launch_floor_ms() -> float:
    """Device time of one launch of an empty kernel (one block of one
    warp) by ``time_ms``: what no one-launch call can go below."""
    from repro_torch.kernels._build import raise_on

    lib = empty_library().get()
    stream = torch.cuda.current_stream().cuda_stream
    return time_ms(lambda: raise_on(lib.launch_empty(stream), "launch_empty"), 50)


def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check(ok, what) -> None:
    """Fail the run (not an ``assert``: ``python -O`` would drop it)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def kernel_wrappers():
    """Each kernel's name -> its wrapper, which holds the launch count."""
    from repro_torch.kernels.daxpy import kernel as DK
    from repro_torch.kernels.fadda import kernel as FK
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK
    return {"flash_attention_dense": K.flash_dense_cuda,
            "flash_attention_paged": K.flash_paged_cuda,
            "flash_attention_paged_quant": K.flash_paged_quant_cuda,
            "flash_attention_bwd": K.flash_bwd_cuda,
            "ssd_scan": SK.ssd_scan_cuda,
            "moe_positions": MK.moe_positions_cuda,
            "fadda": FK.fadda_rows_cuda,
            "daxpy": DK.daxpy_cuda}


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK
    for fn in kernel_wrappers().values():
        fn.launches = 0
    K.reset_flash_counts()
    SK.reset_ssd_counts()


FLASH = ("flash_attention_dense", "flash_attention_paged",
         "flash_attention_paged_quant")
WITH_BODIES = FLASH + ("ssd_scan",)


def read_bodies() -> dict:
    """Each flash wrapper's and the SSD scan's launches per body since the
    last reset."""
    w = kernel_wrappers()
    return {name: dict(w[name].body_launches) for name in WITH_BODIES}


def _nonzero(bodies) -> dict:
    return {k: {b: n for b, n in v.items() if n} for k, v in bodies.items()
            if any(v.values())}


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


# ---------------------------------------------------------------------------
# phase 1: build every kernel library, one nvcc per source, in parallel
# ---------------------------------------------------------------------------

def build_all():
    from repro_torch.kernels.daxpy import kernel as DK
    from repro_torch.kernels.fadda import kernel as FK
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK

    libs = {**{f"flash_attention{lib.defines[0].removeprefix('FLASH_BUILD')
                                    .lower()}": lib for lib in K.LIBRARIES},
            "flash_attention_bwd": K.BWD_LIBRARY,
            "ssd_scan": SK.LIBRARY,
            "moe_dispatch": MK.LIBRARY, "fadda": FK.LIBRARY,
            "daxpy": DK.LIBRARY, "launch_floor": empty_library()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(lib.build) for name, lib in libs.items()}
        paths = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        lib.get()          # loads it: every entry point of its group is there
        b = lib.last_build
        what = (f"{b['cmd']} ({b['seconds']:.1f} s)" if b
                else f"cached: {paths[name]}")
        print(f"[build] {name}: {what}", flush=True)
        print(f"[build] {name} -> {paths[name].relative_to(ROOT)}", flush=True)
    print(f"[build] all kernels in {time.perf_counter() - t0:.1f} s "
          "(parallel)", flush=True)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

# Dense cases (b, hkv, group, sq, skv, causal, window) and the body each
# takes in bf16 (f32 always takes the CUDA-core body).  Split-KV decode with
# 1, 2, 4, 8 and 12 rows per KV head (every row-count instance), over
# caches of 77 keys (one split of the fixed 128-key grid), 600 (5), 1024
# (8) and 4097 (33), causal with q_offset > 0 and a window; tensor-core
# prefill with partial row blocks (37, 65, 963 rows), GQA, a window,
# non-causal rows and rows past a lane's kv_len.  Lanes hold kv_lens (skv,
# skv // 2, 0, 5): ragged, one empty lane, and one with fewer live keys
# than one tile (the grid's other splits empty).
DENSE_CASES = (
    ((3, 2, 1, 1, 77, False, None), "split_kv"),
    ((3, 2, 2, 6, 77, True, None), "split_kv"),
    ((1, 1, 1, 1, 1024, False, None), "split_kv"),
    ((4, 1, 2, 1, 1024, True, 100), "split_kv"),
    ((2, 1, 8, 1, 600, False, None), "split_kv"),
    ((4, 1, 4, 2, 1024, True, None), "split_kv"),
    ((3, 2, 1, 1, 4097, False, None), "split_kv"),
    ((3, 2, 4, 1, 4097, True, 300), "split_kv"),
    ((3, 2, 2, 37, 90, True, 9), "tensor_core"),
    ((2, 1, 1, 40, 40, False, None), "tensor_core"),
    ((3, 2, 1, 65, 200, True, None), "tensor_core"),
    ((2, 1, 2, 963, 1027, True, None), "tensor_core"),
)
# every tensor-core instance; 144, 150 and 160 (stablelm-12b's) also take
# the split-KV body's third pass of 64 head dims and the CUDA-core body's
# fifth head dim per lane
DENSE_HEAD_DIMS = (16, 32, 37, 64, 80, 96, 100, 128, 144, 150, 160)
# Paged cases (b, hkv, group, sq, ps, n_pages) and the body each takes in
# bf16 (f32 always takes the CUDA-core body): the split-KV body at every
# row-count instance (1, 2, 4, 6 and 16 rows per KV head), page sizes 8 and
# 16, one and several splits (1120 keys: 5); stablelm-12b's 8 KV heads of
# group 4 over 1120 keys; a chunk of 24 rows on the CUDA-core body.  Lanes hold kv_lens (skv, skv // 2 + 1, 0, 5) with stale
# ids past the second lane's strip; each case runs non-causal, causal, and
# causal with a window.
PAGED_CASES = (
    ((4, 2, 1, 1, 16, 70), "split_kv"),
    ((4, 2, 2, 1, 8, 9), "split_kv"),
    ((4, 1, 4, 1, 16, 5), "split_kv"),
    ((4, 2, 2, 3, 8, 9), "split_kv"),
    ((4, 1, 4, 4, 16, 20), "split_kv"),
    ((4, 1, 8, 2, 8, 40), "split_kv"),
    ((4, 8, 4, 1, 16, 70), "split_kv"),
    ((2, 2, 2, 12, 16, 4), "cuda_core"),
)
PAGED_MASKS = ((False, None), (True, None), (True, 37))
# Limits against the plain version (atol, rtol).  The split-KV body and the
# plain version both sum in f32 and round once to bf16, so they may differ
# by one bf16 rounding step (at most 2^-7 of the value).  The tensor-core
# body keeps P to ~16 bits (hi + lo bf16 halves) and is held to the same
# step: on an H100 its cases read at most 0.9974 of it (the ratios are
# printed per case), and a kernel that drops one 64-key tile fails it.  The
# paged CUDA-core body in bf16 (chunks of more than 16 rows) is held as
# since it was written.
# The backward (``check_flash_bwd``, ``time_flash_bwd``) in bf16: its
# tensor-core body computes in f32 from the same bf16 values as the plain
# backward (P and dS enter its products as hi + lo bf16 halves) and rounds
# each gradient once to bf16, so they may differ by one bf16 step (2^-7 of
# the value) plus the f32 sums' disagreement near 0 (atol).
TOL = {"f32": (1e-5, 1e-5), "tensor_core": (1e-5, 2 ** -7),
       "split_kv": (1e-5, 2 ** -7), "paged_cuda_core": (2e-2, 2e-2),
       "bwd": (1e-3, 2 ** -7)}


def tol_ratio(got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 where assert_close
    with these limits holds."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _paged_inputs(gen, b, hkv, group, sq, ps, n_pages, d, dtype):
    """q, bf16/f32 pools and a shuffled table with stale ids past the
    second lane's strip; kv_lens (skv, skv // 2 + 1, 0, 5)."""
    n_pool = b * n_pages + 3
    q = torch.randn(b, hkv * group, sq, d, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(n_pool, hkv, ps, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(n_pool, hkv, ps, d, generator=gen, device="cuda").to(dtype)
    table = torch.randperm(n_pool, generator=gen, device="cuda")[
        :b * n_pages].reshape(b, n_pages).to(torch.int32)
    skv = n_pages * ps
    kv_lens = torch.tensor([skv, skv // 2 + 1, 0, 5][:b], dtype=torch.int32,
                           device="cuda")
    table[1, (skv // 2 + 1 + ps - 1) // ps:] = 10 ** 6   # stale ids
    return q, kp, vp, table, kv_lens


def check_kernels(flash_attention):
    """Dense at ``DENSE_HEAD_DIMS`` over ``DENSE_CASES`` and paged over
    ``PAGED_CASES`` (every mask of ``PAGED_MASKS``), each routed to the body
    its plan names (held by the per-body launch counts).  Every block-shape
    branch of the kernels is hit: the CUDA-core body's 1-4, 5-8 and >8 rows
    per block and several row chunks, the tensor-core body's partial and
    several row blocks and edge tiles (causal diagonal with q_offset > 0,
    window, kv_len tail) at every padded head dim, the split-KV body at
    every row-count instance, dense and paged, with one split and many,
    empty splits and lanes; and both ways of staging K/V: 16-byte copies
    (D a multiple of 8 bf16 or 4 f32 elements, aligned rows) and element
    loads (D = 37, D = 100 in bf16, and K/V that start off a 16-byte
    boundary).  Prints the tensor-core body's ``tol_ratio`` per case."""
    from repro_torch.kernels.flash_attention import kernel as K

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"f32": 0.0, "tensor_core": 0.0, "split_kv": 0.0, "paged": 0.0}
    ratio = dict.fromkeys(TOL, 0.0)
    tc_ratio = {}
    splits = set()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        # K/V one element past an aligned start: rows off 16-byte boundaries
        for sq in (5, 40):
            q = torch.randn(2, 4, sq, 80, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(2 * 2 * 33 * 80 + 1, generator=gen, device="cuda")
                    .to(dtype)[1:].view(2, 2, 33, 80) for _ in range(2))
            kw = dict(kv_lens=torch.tensor([33, 9], dtype=torch.int32,
                                           device="cuda"), causal=True)
            got = flash_attention(q, k, v, impl="kernel", **kw)
            want = flash_attention(q, k, v, impl="naive", **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        for d in DENSE_HEAD_DIMS:
            for (b, hkv, group, sq, skv, causal, window), body in DENSE_CASES:
                q = torch.randn(b, hkv * group, sq, d, generator=gen,
                                device="cuda").to(dtype)
                k = torch.randn(b, hkv, skv, d, generator=gen,
                                device="cuda").to(dtype)
                v = torch.randn(b, hkv, skv, d, generator=gen,
                                device="cuda").to(dtype)
                kv_lens = torch.tensor([skv, skv // 2, 0, min(5, skv)][:b],
                                       dtype=torch.int32, device="cuda")
                q_off = (kv_lens - sq).clamp_min(0) if causal else kv_lens * 0
                kw = dict(kv_lens=kv_lens, causal=causal, window=window,
                          q_offset=q_off, decode=body == "split_kv")
                K.reset_flash_counts()
                got = flash_attention(q, k, v, impl="kernel", **kw)
                want = flash_attention(q, k, v, impl="naive", **kw)
                torch.cuda.synchronize()
                kind = body if dtype == torch.bfloat16 else "f32"
                atol, rtol = TOL[kind]
                where = f"dense {dtype} d={d} {(b, hkv, group, sq, skv)}"
                torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                                           msg=lambda m: f"{where}: {m}")
                if b >= 3:
                    check(not got[2].any(), "an empty lane reads 0")
                want_body = body if dtype == torch.bfloat16 else "cuda_core"
                check(K.flash_dense_cuda.body_launches[want_body] == 1,
                      f"{where} took the {want_body} body: "
                      f"{K.flash_dense_cuda.body_launches}")
                if want_body == "split_kv":
                    splits.add(K.plan_dense(dtype, b, hkv * group, hkv, sq,
                                            skv, d, decode=True).splits)
                r = tol_ratio(got, want, atol, rtol)
                if kind == "tensor_core":
                    tc_ratio[(b, hkv, group, sq, skv, d)] = r
                worst[kind] = max(worst[kind],
                                  float((got.float() - want.float()).abs().max()))
                ratio[kind] = max(ratio[kind], r)
            for (b, hkv, group, sq, ps, n_pages), body in PAGED_CASES:
                q, kp, vp, table, kv_lens = _paged_inputs(
                    gen, b, hkv, group, sq, ps, n_pages, d, dtype)
                q_off = (kv_lens - sq).clamp_min(0)
                kind = ("f32" if dtype == torch.float32 else
                        "split_kv" if body == "split_kv" else "paged_cuda_core")
                want_body = "cuda_core" if dtype == torch.float32 else body
                atol, rtol = TOL[kind]
                for causal, window in PAGED_MASKS:
                    kw = dict(kv_lens=kv_lens, causal=causal, window=window,
                              q_offset=q_off, page_table=table,
                              decode=body == "split_kv")
                    K.reset_flash_counts()
                    got = flash_attention(q, kp, vp, impl="kernel", **kw)
                    want = flash_attention(q, kp, vp, impl="naive", **kw)
                    torch.cuda.synchronize()
                    where = (f"paged {dtype} d={d} {(b, hkv, group, sq, ps, n_pages)} "
                             f"causal={causal} window={window}")
                    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                                               msg=lambda m: f"{where}: {m}")
                    if b >= 3:
                        check(not got[2].any(), f"{where}: an empty lane reads 0")
                    check(K.flash_paged_cuda.body_launches[want_body] == 1,
                          f"{where} took the {want_body} body: "
                          f"{K.flash_paged_cuda.body_launches}")
                    worst["paged"] = max(worst["paged"], float(
                        (got.float() - want.float()).abs().max()))
                    ratio[kind] = max(ratio[kind], tol_ratio(got, want, atol, rtol))
    for case in sorted({c[:5] for c in tc_ratio}):
        print(f"[kernels] tensor_core (b, hkv, group, sq, skv) {case}: "
              "tol_ratio at ({:g}, {:g}) by head dim ".format(*TOL["tensor_core"])
              + ", ".join(f"{c[5]}: {r:.4f}" for c, r in tc_ratio.items()
                          if c[:5] == case), flush=True)
    print(f"[kernels] checked against the plain versions "
          f"({len(DENSE_CASES)} dense cases x {len(DENSE_HEAD_DIMS)} head dims "
          f"and {len(PAGED_CASES)} paged cases x {len(PAGED_MASKS)} masks, each "
          f"on its planned body): max |err| "
          + ", ".join(f"{k} {worst[k]:.3g}" for k in worst)
          + "; max |err| / (atol + rtol |ref|) "
          + ", ".join(f"{k} {ratio[k]:.3g} (limits {TOL[k][0]:g}, {TOL[k][1]:g})"
                      for k in ratio), flush=True)
    check(splits == {1, 5, 8, 33}, f"split-KV cases planned grids of "
          f"{sorted(splits)} splits, expected 1, 5, 8 and 33")
    return worst


# The flash kernels in the roles of the cross-attention models, (b, hkv,
# group, sq, skv, d) and the body: non-causal prefill with fewer query rows
# than keys (a decoder prompt over seamless' 1024 encoder frames, D 64;
# over llama-vision's 1024 image tokens, D 128), with more (an encoder's
# 300 frames over 128 keys), and square (seamless' encoder over 1024
# frames); the split-KV body non-causal over 1024 keys (cross decode).
# Lanes hold kv_lens (skv, skv // 2 + 3, 1, 7): ragged down to one key.
CROSS_CASES = (
    ((4, 16, 1, 64, 1024, 64), "tensor_core"),
    ((4, 8, 4, 100, 1024, 128), "tensor_core"),
    ((4, 16, 1, 300, 128, 64), "tensor_core"),
    ((4, 8, 4, 300, 128, 128), "tensor_core"),
    ((2, 16, 1, 1024, 1024, 64), "tensor_core"),
    ((4, 16, 1, 1, 1024, 64), "split_kv"),
    ((4, 8, 4, 1, 1024, 128), "split_kv"),
)


def check_cross_roles(flash_attention) -> dict:
    """Each of ``CROSS_CASES`` non-causal in bf16 on its planned body and in
    f32 on the CUDA-core body, against the plain version at ``TOL``, with
    the launches counted per body (held: one a call, on the planned body).
    Prints each case's ``tol_ratio``.  Returns the launches per body."""
    from repro_torch.kernels.flash_attention import kernel as K

    gen = torch.Generator(device="cuda").manual_seed(22)
    bodies = collections.Counter()
    lines = []
    for (b, hkv, group, sq, skv, d), body in CROSS_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(b, hkv * group, sq, d, generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn(b, hkv, skv, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            kv_lens = torch.tensor([skv, skv // 2 + 3, 1, 7][:b],
                                   dtype=torch.int32, device="cuda")
            kw = dict(kv_lens=kv_lens, causal=False,
                      decode=body == "split_kv")
            K.reset_flash_counts()
            got = flash_attention(q, k, v, impl="kernel", **kw)
            torch.cuda.synchronize()
            launched = dict(K.flash_dense_cuda.body_launches)
            want = flash_attention(q, k, v, impl="naive", **kw)
            kind = body if dtype == torch.bfloat16 else "f32"
            want_body = body if dtype == torch.bfloat16 else "cuda_core"
            where = f"cross role {dtype} {(b, hkv, group, sq, skv, d)}"
            check(launched[want_body] == 1 and sum(launched.values()) == 1,
                  f"{where} took the {want_body} body: {launched}")
            bodies[want_body] += 1
            atol, rtol = TOL[kind]
            r = tol_ratio(got, want, atol, rtol)
            check(r <= 1 and bool(torch.isfinite(got).all()),
                  f"{where}: {r} times its limit from the plain version")
            lines.append(f"{(b, hkv, group, sq, skv, d)} {kind} {r:.4f}")
    print(f"[kernels] the cross-attention roles, non-causal, kv_lens down to "
          f"1, against the plain version (held at TOL), tol_ratio per case: "
          + "; ".join(lines) + f"; launches per body {dict(bodies)}",
          flush=True)
    return dict(bodies)


def _quant_pools(gen, n_pool, hkv, ps, d, page_dtype):
    """Random K or V pages truncated to ``page_dtype`` by the port's own
    quantize_block: (narrow pool, f32 scale pool)."""
    from repro_torch.core import paging as PG
    return PG.quantize_block(
        torch.randn(n_pool, hkv, ps, d, generator=gen, device="cuda") * 2.0,
        PG.resolve_page_dtype(page_dtype))


# Quantized paged cases (d, ps, group, sq, window) and the body each takes
# with bf16 q (f32 q always takes the CUDA-core body): the split-KV body at
# every row-count instance (1, 2, 4, 6 and 16 rows per KV head), page sizes
# 8 and 16, head dims 48, 64, 80, 128 and 160 (stablelm-12b's, group 4),
# with and without a window; chunks of 20 rows on the CUDA-core body.
QUANT_CASES = (
    ((64, 16, 1, 1, None), "split_kv"),
    ((80, 16, 2, 1, None), "split_kv"),
    ((80, 8, 4, 1, 29), "split_kv"),
    ((128, 8, 2, 3, 11), "split_kv"),
    ((48, 8, 4, 4, None), "split_kv"),
    ((64, 16, 8, 2, 50), "split_kv"),
    ((160, 16, 4, 1, None), "split_kv"),
    ((160, 8, 4, 4, 40), "split_kv"),
    ((80, 16, 4, 5, None), "cuda_core"),
    ((160, 16, 4, 5, None), "cuda_core"),
)


def check_quant_kernel(flash_attention):
    """The paged kernel over int8 and fp8 pools against the plain path
    (extending gather, then the reference) over ``QUANT_CASES``: bf16 q on
    the split-KV body to one bf16 rounding step (``TOL["split_kv"]``), f32
    q on the CUDA-core body at 1e-4 (the widened values differ from the
    plain path's by rounding), bf16 chunks of more than 16 rows at 2e-2;
    ragged kv_lens (full, half, 0 and 5 keys) with stale out-of-strip table
    entries, causal, and the body held by the launch counts.  A head dim
    that is not a multiple of 16 is refused."""
    from repro_torch.kernels.flash_attention import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"f32": 0.0, "split_kv": 0.0, "paged_cuda_core": 0.0}
    ratio = dict(worst)
    n_cases = 0
    tols = {"f32": (1e-4, 1e-4), "split_kv": TOL["split_kv"],
            "paged_cuda_core": TOL["paged_cuda_core"]}
    for dtype in (torch.float32, torch.bfloat16):
        for page_dtype in ("int8", "fp8"):
            for (d, ps, group, sq, window), body in QUANT_CASES:
                b, hkv, n_pages = 4, 2, 6 if ps == 16 else 12
                n_pool = b * n_pages + 5
                skv = n_pages * ps
                kp, ks = _quant_pools(gen, n_pool, hkv, ps, d, page_dtype)
                vp, vs = _quant_pools(gen, n_pool, hkv, ps, d, page_dtype)
                q = torch.randn(b, hkv * group, sq, d, generator=gen,
                                device="cuda").to(dtype)
                table = torch.randperm(n_pool, generator=gen, device="cuda")[
                    :b * n_pages].reshape(b, n_pages).to(torch.int32)
                kv_lens = torch.tensor([skv, skv // 2 + 1, 0, 5], dtype=torch.int32,
                                       device="cuda")
                table[1, (skv // 2 + 1 + ps - 1) // ps:] = 10 ** 6   # stale ids
                kw = dict(kv_lens=kv_lens, causal=True, window=window,
                          q_offset=(kv_lens - sq).clamp_min(0), page_table=table,
                          k_scale=ks, v_scale=vs, decode=body == "split_kv")
                K.reset_flash_counts()
                got = flash_attention(q, kp, vp, impl="kernel", **kw)
                want = flash_attention(q, kp, vp, impl="naive", **kw)
                torch.cuda.synchronize()
                kind = ("f32" if dtype == torch.float32 else
                        "split_kv" if body == "split_kv" else "paged_cuda_core")
                want_body = "cuda_core" if dtype == torch.float32 else body
                where = (f"paged {page_dtype} q {dtype} (d, ps, group, sq, window) "
                         f"{(d, ps, group, sq, window)}")
                atol, rtol = tols[kind]
                torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                                           msg=lambda m: f"{where}: {m}")
                check(not got[2].any(), f"{where}: an empty lane reads 0")
                check(K.flash_paged_quant_cuda.body_launches[want_body] == 1,
                      f"{where} took the {want_body} body: "
                      f"{K.flash_paged_quant_cuda.body_launches}")
                worst[kind] = max(worst[kind],
                                  float((got.float() - want.float()).abs().max()))
                ratio[kind] = max(ratio[kind], tol_ratio(got, want, atol, rtol))
                n_cases += 1
    kp, ks = _quant_pools(gen, 4, 1, 8, 40, "int8")
    q = torch.zeros(1, 1, 1, 40, device="cuda")
    ints = [torch.zeros(n, dtype=torch.int32, device="cuda") for n in (1, 1, 1)]
    for qd in (torch.float32, torch.bfloat16):
        try:
            K.flash_paged_quant_cuda(q.to(qd), kp, kp, ks, ks, torch.zeros(
                1, 1, dtype=torch.int32, device="cuda"), *ints, causal=False,
                scale=1.0)
        except ValueError as e:
            check("multiple of 16" in str(e), f"head dim 40 refused: {e}")
        else:
            check(False, "a quantized pool of head dim 40 must be refused")
    print(f"[kernels] flash_attention_paged_quant checked against the plain "
          f"path ({n_cases} cases, int8 and fp8 pools, each on its planned "
          f"body): max |err| " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + "; max |err| / (atol + rtol |ref|) "
          + ", ".join(f"{k} {ratio[k]:.3g} (limits {tols[k][0]:g}, {tols[k][1]:g})"
                      for k in ratio), flush=True)
    return worst


def _pages_of(k, v, ps, gen):
    """The dense (B, Hkv, Skv, D) K/V laid out as pools (P, Hkv, ps, D)
    through a shuffled table (3 pages of the pool unused)."""
    import torch.nn.functional as F
    b, hkv, skv, d = k.shape
    n_pages = -(-skv // ps)
    pad = n_pages * ps - skv
    n_pool = b * n_pages + 3
    table = torch.randperm(n_pool, generator=gen, device="cuda")[
        :b * n_pages].reshape(b, n_pages).to(torch.int32)
    pools = []
    for t in (k, v):
        pool = torch.zeros(n_pool, hkv, ps, d, dtype=t.dtype, device="cuda")
        pool[table.flatten().long()] = (F.pad(t, (0, 0, 0, pad))
                                        .view(b, hkv, n_pages, ps, d)
                                        .transpose(1, 2).reshape(-1, hkv, ps, d))
        pools.append(pool)
    return pools[0], pools[1], table


def check_paged_equals_dense(flash_attention):
    """bf16 decode through a paged cache equals decode through the dense
    cache over the same keys bit for bit (``torch.equal``): the split-KV
    body is one template for both.  The smoke run's ragged lanes (kv_len
    320 to 1027) and an empty lane, page sizes 8 and 16, one row and 16 rows
    per KV head, causal, with and without a window, head dims 64, 80, 128
    and 160 (stablelm-12b's 8 KV heads of group 4, 4 and 16 rows)."""
    from repro_torch.kernels.flash_attention import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(13)
    lens = torch.tensor([812, 687, 757, 320, 963, 891, 835, 0], dtype=torch.int32,
                        device="cuda") + 1
    n_cases = 0
    for d, hkv, group, sq in ((80, 32, 1, 1), (64, 4, 4, 4), (128, 16, 1, 1),
                              (160, 8, 4, 1), (160, 8, 4, 4)):
        q = torch.randn(8, hkv * group, sq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(8, hkv, 1027, d, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        for ps in (8, 16):
            kp, vp, table = _pages_of(k, v, ps, gen)
            for window in (None, 200):
                kw = dict(kv_lens=lens, causal=True, window=window,
                          q_offset=(lens - sq).clamp_min(0), decode=True)
                K.reset_flash_counts()
                dense = flash_attention(q, k, v, impl="kernel", **kw)
                paged = flash_attention(q, kp, vp, impl="kernel", page_table=table,
                                        **kw)
                torch.cuda.synchronize()
                check(K.flash_dense_cuda.body_launches["split_kv"] == 1
                      and K.flash_paged_cuda.body_launches["split_kv"] == 1,
                      "dense and paged calls on the split-KV body")
                check(torch.equal(dense, paged),
                      f"bf16 paged == dense bit for bit at d={d}, hkv={hkv}, "
                      f"rows {group * sq}, ps={ps}, window={window}: max |d| "
                      f"{float((dense.float() - paged.float()).abs().max()):.3g}")
                n_cases += 1
    print(f"[kernels] bf16 paged decode equals dense decode bit for bit "
          f"(torch.equal): {n_cases} cases (d 64, 80, 128, 160; ps 8, 16; 1, 4 "
          f"and 16 rows per KV head; window none and 200)", flush=True)


def check_prefill_rows(flash_attention):
    """A bf16 prefill row takes the tensor-core body at any row count and
    its bits do not depend on the call (held, ``torch.equal``): the rows of
    a 521-row causal prefill at stablelm's heads equal the same rows
    computed as chunks of 256, 256 and 9 rows (each at its ``q_offset``),
    as one row alone, and inside a batch of 3 lanes padded to 1024 rows;
    head dims 64 and 80, GQA group 1 and 4."""
    from repro_torch.kernels.flash_attention import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(15)
    n, skv, n_cases = 521, SCHED_MAX_LEN, 0
    for d, hkv, group in ((80, 32, 1), (64, 8, 4)):
        q = torch.randn(1, hkv * group, n, d, generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn(1, hkv, skv, d, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        call = lambda qq, off, kv, **kw: flash_attention(
            qq, kv[0], kv[1], impl="kernel", causal=True,
            kv_lens=torch.tensor([off + qq.shape[2]] * qq.shape[0],
                                 dtype=torch.int32, device="cuda"),
            q_offset=torch.tensor([off] * qq.shape[0], dtype=torch.int32,
                                  device="cuda"), **kw)
        K.reset_flash_counts()
        whole = call(q, 0, (k, v))
        parts = [(0, 256), (256, 512), (512, n), (n - 1, n)]
        for lo, hi in parts:
            got = call(q[:, :, lo:hi].contiguous(), lo, (k, v))
            check(torch.equal(got, whole[:, :, lo:hi]),
                  f"prefill rows {lo}:{hi} (d={d}, group {group}) alone equal "
                  f"the whole call's")
        qb = torch.randn(3, hkv * group, 1024, d, generator=gen,
                         device="cuda").bfloat16()
        qb[1, :, :n] = q[0]
        kb, vb = (torch.randn(3, hkv, skv, d, generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        kb[1], vb[1] = k[0], v[0]
        lens = torch.tensor([1024, n, 700], dtype=torch.int32, device="cuda")
        got = flash_attention(qb, kb, vb, impl="kernel", causal=True,
                              kv_lens=lens, q_offset=torch.zeros_like(lens))
        torch.cuda.synchronize()
        check(torch.equal(got[1, :, :n], whole[0]),
              f"prefill rows in a batch of 3 (d={d}) equal the prompt's alone")
        check(K.flash_dense_cuda.body_launches["tensor_core"] == len(parts) + 2
              and K.flash_dense_cuda.launches == len(parts) + 2,
              f"every prefill call on the tensor-core body: "
              f"{K.flash_dense_cuda.body_launches}")
        n_cases += len(parts) + 1
    print(f"[kernels] bf16 prefill rows on the tensor-core body equal bit for "
          f"bit alone, in chunks of 256 / 256 / 9 rows, as one row and in a "
          f"batch ({n_cases} cases, d 64 and 80, group 1 and 4)", flush=True)


def check_batch_independence(flash_attention):
    """Each lane's bf16 decode output, dense and paged, is bit for bit the
    same alone in a short cache (its own keys, rounded up to a page) as
    among the 8 lanes of the smoke batch in the 1027-key cache: the split
    grid follows from the lane's own keys only.  At stablelm-3b's heads (32
    of D 80) and stablelm-12b's (32 over 8 KV heads of D 160)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    lens = torch.tensor([812, 687, 757, 320, 963, 891, 835, 487], dtype=torch.int32,
                        device="cuda") + 1
    ps = PAGE_SIZE
    kw = lambda ln: dict(kv_lens=ln, causal=True, q_offset=ln - 1, decode=True)
    for d, hkv, group in ((80, 32, 1), (160, 8, 4)):
        q = torch.randn(8, hkv * group, 1, d, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(8, hkv, 1027, d, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        kp, vp, table = _pages_of(k, v, ps, gen)
        batch = {"dense": flash_attention(q, k, v, impl="kernel", **kw(lens)),
                 "paged": flash_attention(q, kp, vp, impl="kernel",
                                          page_table=table, **kw(lens))}
        for i, n in enumerate(lens.tolist()):
            short = -(-n // ps) * ps
            ki = k[i:i + 1, :, :short].contiguous()
            vi = v[i:i + 1, :, :short].contiguous()
            kpi, vpi, ti = _pages_of(ki, vi, ps, gen)
            li = lens[i:i + 1]
            alone = {"dense": flash_attention(q[i:i + 1], ki, vi, impl="kernel",
                                              **kw(li)),
                     "paged": flash_attention(q[i:i + 1], kpi, vpi, impl="kernel",
                                              page_table=ti, **kw(li))}
            torch.cuda.synchronize()
            for cache in alone:
                check(torch.equal(alone[cache][0], batch[cache][i]),
                      f"lane {i} ({n} keys, d={d}) {cache}: alone in a "
                      f"{short}-key cache equals its row in the batch of 8 at "
                      "1027 keys, bit for bit")
    print(f"[kernels] bf16 decode is batch-composition independent: each of the "
          f"8 lanes (kv_len {lens.min().item()}-{lens.max().item()}) alone in a "
          f"short cache equals its row in the batch of 8 over 1027 keys, dense "
          f"and paged, d 80 (32 heads) and 160 (32 over 8 KV heads), bit for "
          f"bit", flush=True)


def moe_cases():
    """(T, K, E) cases of ``check_moe_positions`` with how their ids are
    drawn: T*K not a multiple of a tile, one tile and many, -1 ids and ids
    >= E, K = 2, 6 and 8, the olmoe decode (8, 8) and prefill (7704, 8)
    shapes and 20001 x 8; n at a tile boundary of the plan and one either
    side of it (K = 1: the one-warp block's 128 assignments, a many-warp
    block's tile and a cluster of tiles); E = 1
    and E = 1024; every id the same expert; every id invalid."""
    from repro_torch.kernels.moe_dispatch import kernel as MK

    tile = MK.plan_positions(10 ** 5, 64, 132)["tile"]
    cases = [((8, 8, 64), "mixed"), ((5, 2, 4), "mixed"),
             ((1000, 6, 64), "mixed"), ((7704, 8, 64), "mixed"),
             ((20001, 8, 64), "mixed"), ((333, 2, 4), "mixed")]
    for n in (MK.WARP * MK.DECODE_ROUNDS, tile, MK.CLUSTER * tile):
        cases += [((m, 1, 64), "mixed") for m in (n - 1, n, n + 1)]
    cases += [((777, 3, 1), "mixed"), ((7704, 8, 1024), "mixed"),
              ((3000, 8, 64), "same"), ((3000, 8, 64), "invalid"),
              ((8, 8, 64), "same"), ((8, 8, 64), "invalid")]
    return cases


def moe_case_ids(gen, t, k, e, how):
    """Seeded ids: uniform with 5% -1 and 3% >= E ("mixed"), every id
    expert e // 2 ("same"), or every id invalid ("invalid": -1 and >= E)."""
    ids = torch.randint(0, e, (t, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    odd = torch.rand((t, k), generator=gen, device="cuda")
    if how == "same":
        return torch.full((t, k), e // 2, dtype=torch.int32, device="cuda")
    if how == "invalid":
        return torch.where(odd < 0.5, -1, e + (ids % 7)).to(torch.int32)
    ids = torch.where(odd < 0.05, -1, ids)
    return torch.where(odd > 0.97, e + (ids % 7), ids).to(torch.int32).contiguous()


def check_moe_positions(run=None):
    """The dispatch-rank kernel against ``moe_positions_ref``, exactly, on
    every case of ``moe_cases``, one launch per call.  With ``run`` (e.g.
    ``graphed``) each kernel call goes through it."""
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch import moe_positions

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = moe_cases()
    for (t, k, e), how in cases:
        ids = moe_case_ids(gen, t, k, e, how)
        before = MK.moe_positions_cuda.launches
        got = (run or (lambda f: f()))(
            lambda: moe_positions(ids, e, impl="kernel"))
        want = moe_positions(ids, e, impl="naive")
        torch.cuda.synchronize()
        check(MK.moe_positions_cuda.launches == before + 1,
              "one moe_positions call, one launch")
        for g, w, what in zip(got, want, ("pos", "counts")):
            check(g.dtype == w.dtype == torch.int32 and torch.equal(g, w),
                  f"moe_positions {what} equal to the plain version at "
                  f"T={t} K={k} E={e} ({how} ids)")
    print(f"[kernels] moe_positions checked against moe_positions_ref "
          f"(exact){' inside a CUDA graph' if run else ''}: {len(cases)} "
          f"cases, (T, K, E) in "
          f"{[c for c, _ in cases]}, ids mixed / all one expert / all "
          f"invalid", flush=True)


def _same_bits(got, want) -> bool:
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.contiguous().view(torch.int32),
                            want.contiguous().view(torch.int32)))


def sorted_probs(gen, rows, v):
    """Rows of softmax probabilities sorted descending, as the top-p scan
    sees them (logits with a spread like a language model's)."""
    logits = torch.randn(rows, v, generator=gen, device="cuda") * 3.0
    return torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                      descending=True).values.contiguous()


_PLAIN_SCANS: dict = {}


def plain_scan(x, n, init):
    """``fadda_scan_plain`` (a host loop over the columns, seconds at V =
    50304), each result kept by its inputs' bytes, so that ``check_fadda``
    inside a graph holds the kernel to the same plain results without
    computing them again."""
    from repro_torch.kernels.fadda.ref import fadda_scan_plain

    key = tuple((tuple(t.shape), str(t.dtype), t.cpu().numpy().tobytes())
                if torch.is_tensor(t) else repr(t) for t in (x, n, init))
    if key not in _PLAIN_SCANS:
        _PLAIN_SCANS[key] = fadda_scan_plain(x, n, init)
    return _PLAIN_SCANS[key]


def fadda_cases(run=None):
    """The cases of ``check_fadda``: (name, call) pairs, each call True when
    the kernel's bits equal the plain loop's (``plain_scan``) and, for
    the op, the numpy scalar loop's.  Op cases: n not a multiple of the
    block, n past the length, blocks 8 to 8192, rows that start 4, 8 and 12
    bytes off a 16-byte boundary; the adversarial sequence of §2.4 at blocks
    128 and 512; init = -0.0 with n = 0 and a row of -0.0 with n < V (masked
    lanes add +0.0) and an empty row (init kept); the (8, 50304) row scan of
    sorted softmax probabilities with every partial at blocks 128, 512 and
    8192, with ragged n, per-row init and n past V; rows of V = 1001 (V % 4
    != 0: every row starts elsewhere modulo 16 bytes) with partials; and
    rows whose base is 4, 8 and 12 bytes off a 16-byte boundary, with
    partials (x and the partials then disagree modulo 16 bytes).  With
    ``run`` (e.g. ``graphed``) each kernel call goes through it."""
    from repro_torch.core.reductions import pairwise_sum
    from repro_torch.kernels.fadda import fadda, fadda_rows
    from repro_torch.kernels.fadda.ref import fadda_ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    run = run or (lambda f: f())

    def op(xv, n, block):
        got = run(lambda: fadda(xv, n, block=block))
        want = plain_scan(xv[None], n, 0.0)[0, -1]
        ref = fadda_ref(xv.cpu().numpy(), n)
        return (_same_bits(got, want) and
                np.float32(got.item()).tobytes() == ref.tobytes())

    def rows(x, n, init, block):
        n = x.shape[1] if n is None else n
        init = 0.0 if init is None else init
        out, part = run(lambda: fadda_rows(x, n, init, partials=True,
                                           block=block))
        want = plain_scan(x, n, init)
        return _same_bits(part, want) and _same_bits(out, want[:, -1])

    for length, n, block in ((600, 600, 128), (600, 421, 128), (1024, 1024, 512),
                             (3, 3, 512), (4096, 4095, 1024), (5000, 4097, 8),
                             (600, 700, 128), (20000, 19999, 8192),
                             (9000, 9000, 8192)):
        x = torch.randn(length + 3, generator=gen, device="cuda")
        for off in (0, 1, 2, 3):        # 0, 4, 8 and 12 bytes off 16
            cases.append((f"op ({length}, n={n}, block={block}) at +{4 * off} B",
                          lambda xv=x[off:off + length], n=n, b=block: op(xv, n, b)))
    adv = torch.tensor([1e8, 1.0, -1e8, 1.0] * 64, device="cuda")
    want_adv = fadda_ref(adv.cpu().numpy())
    check(np.float32(pairwise_sum(adv).item()) != want_adv,
          "the adversarial sum differs from the tree sum")
    for block in (128, 512):
        cases.append((f"adversarial at block {block}", lambda b=block: np.float32(
            run(lambda: fadda(adv, block=b)).item()).tobytes() == want_adv.tobytes()))

    def zero_n():
        x = torch.randn(2, 16, generator=gen, device="cuda")
        out, part = run(lambda: fadda_rows(x, n=0, init=-0.0, partials=True))
        want = plain_scan(x, 0, -0.0)
        return (_same_bits(part, want) and _same_bits(out, want[:, -1])
                and not torch.signbit(out).any())

    def neg_zero_row():
        x = torch.full((3, 40), -0.0, device="cuda")
        n = torch.tensor([40, 17, 0], dtype=torch.int32, device="cuda")
        out, part = run(lambda: fadda_rows(x, n, init=-0.0, partials=True,
                                           block=16))
        want = plain_scan(x, n, -0.0)
        return (_same_bits(part, want) and _same_bits(out, want[:, -1])
                and torch.signbit(out).tolist() == [True, False, False])

    def empty_row():
        out, _ = run(lambda: fadda_rows(torch.empty(1, 0, device="cuda"), n=0,
                                        init=-0.0, partials=True))
        return bool(torch.signbit(out).all())
    cases += [("init -0.0, n = 0: every masked lane adds +0.0", zero_n),
              ("rows of -0.0 from -0.0, n = V, V - 23, 0", neg_zero_row),
              ("an empty row keeps init -0.0", empty_row)]
    sp = sorted_probs(gen, 8, 50304)
    for block in (128, 512, 8192):
        cases.append((f"(8, 50304) probability scan at block {block}",
                      lambda b=block: rows(sp, None, None, b)))
    ragged = torch.tensor([50304, 50303, 1, 0, 4096, 777, 60000, 30000],
                          dtype=torch.int32, device="cuda")
    init = torch.linspace(-1, 1, 8, device="cuda")
    cases.append(("(8, 50304) scan, ragged n (one past V), per-row init",
                  lambda: rows(sp, ragged, init, 512)))
    x = torch.randn(5, 1001, generator=gen, device="cuda")
    n5 = torch.tensor([1001, 1000, 998, 3, 2000], dtype=torch.int32, device="cuda")
    for block in (8, 136, 512):
        cases.append((f"(5, 1001) rows (V % 4 = 1), ragged n, block {block}",
                      lambda b=block: rows(x, n5, init[:5], b)))
    buf = torch.randn(6 * 2048 + 3, generator=gen, device="cuda")
    for off in (1, 2, 3):
        xo = buf[off:off + 6 * 2048].view(6, 2048)
        n6 = torch.tensor([2048, 2047, 5, 1000, 0, 3000], dtype=torch.int32,
                          device="cuda")
        cases.append((f"(6, 2048) rows at +{4 * off} B, ragged n",
                      lambda xo=xo, n6=n6: rows(xo, n6, init[:6], 512)))
    return cases


def check_fadda(run=None):
    """The ordered kernel against the plain loop, bit for bit, on every
    case of ``fadda_cases`` (each kernel call through ``run`` when given)."""
    cases = fadda_cases(run)
    for name, call in cases:
        ok = call()
        torch.cuda.synchronize()
        check(ok, f"fadda {name} equal to the plain loop")
    print(f"[kernels] fadda checked against the plain loop, bit for bit"
          f"{' inside a CUDA graph' if run else ''}: "
          f"{len(cases)} cases (op with n past the length and rows 4, 8, 12 "
          f"bytes off 16, blocks 8 to 8192; the adversarial sequence; -0.0; "
          f"the (8, 50304) probability scan at blocks 128, 512 and 8192, "
          f"ragged n; V % 4 != 0 rows; misaligned rows with partials)",
          flush=True)


def check_daxpy():
    """The daxpy kernel against ``daxpy_ref`` on the card, bit for bit, in
    f32 and bf16: n inside the array (the merged tail equal to y), n = len,
    n past len, lengths that are not a multiple of the 16-byte chunk, blocks
    128 to 16384, and x, y one element off a 16-byte boundary; and the edges
    of the span a CTA takes (``kernel.cta_span``): n on a span boundary and
    one element either side of it, n = 0, an array shorter than one span,
    and n past the length."""
    from repro_torch.kernels.daxpy import daxpy
    from repro_torch.kernels.daxpy import kernel as DK
    from repro_torch.kernels.daxpy.ref import daxpy_ref

    gen = torch.Generator(device="cuda").manual_seed(9)
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(1000, 777, 128), (1000, 1000, 256), (50, 10, 128),
                 (2 ** 20 + 3, 2 ** 20 - 5, 2048), (4099, 5000, 512)]
        for block in (128, 2048, 16384):
            span = DK.cta_span(block, dtype)
            cases += [(3 * span + 5, n, block)
                      for n in (span, span - 1, span + 1, 2 * span, 0,
                                3 * span + 100)]
            cases += [(span // 2 + 3, span // 4 + 1, block),
                      (span // 2 + 3, span, block)]
        for length, n, block in cases:
            x = torch.randn(length + 1, generator=gen, device="cuda").to(dtype)
            y = torch.randn(length + 1, generator=gen, device="cuda").to(dtype)
            for xv, yv in ((x[:length], y[:length]), (x[1:], y[1:])):
                got = daxpy(xv, yv, 1.7, n, block=block)
                want = daxpy_ref(xv, yv, torch.tensor(1.7, dtype=dtype), n)
                check(got.dtype == dtype and torch.equal(got, want)
                      and torch.equal(got[n:], yv[n:]),
                      f"daxpy {dtype} ({length}, n={n}, block={block}) equal "
                      "to the plain version, tail unchanged")
                n_cases += 1
    print(f"[kernels] daxpy checked against daxpy_ref, bit for bit: {n_cases} "
          "cases in f32 and bf16 (CTA-span edges included)", flush=True)


def mixed_specs():
    """Lanes 0-3 greedy, lanes 4-7 stochastic with their own seeds."""
    from repro_torch.sample import SamplingParams
    return [None] * 4 + [
        SamplingParams(temperature=0.8, top_k=50, top_p=0.9, min_p=0.05,
                       repetition_penalty=1.1, seed=100 + i, greedy=False)
        for i in range(4)]


def check_prng(v: int = 50304):
    """The threefry of ``sample.prng`` on the card against the same code on
    the CPU for the mixed batch's keys: lane keys, three steps of the key
    chain, the random bits and uniforms of a (8, V) draw, bit for bit; the
    Gumbel noise (two ``log``s, whose last bit may differ between the two
    devices) is reported."""
    from repro_torch.sample import lane_state, prng, split_keys

    st = {d: lane_state(mixed_specs(), N_REQ, device=d) for d in ("cuda", "cpu")}
    check(torch.equal(st["cuda"]["key"].cpu(), st["cpu"]["key"]), "lane keys")
    worst_g = 0.0
    for _ in range(3):
        (st["cuda"], sub_c), (st["cpu"], sub_h) = (split_keys(st["cuda"]),
                                                  split_keys(st["cpu"]))
        check(torch.equal(sub_c.cpu(), sub_h) and
              torch.equal(st["cuda"]["key"].cpu(), st["cpu"]["key"]),
              "split keys on the card equal the CPU's")
        check(torch.equal(prng.random_bits(sub_c, (v,)).cpu(),
                          prng.random_bits(sub_h, (v,))), "random bits")
        check(_same_bits(prng.uniform(sub_c, (v,)).cpu(), prng.uniform(sub_h, (v,))),
              "uniforms")
        worst_g = max(worst_g, float((prng.gumbel(sub_c, (v,)).cpu()
                                      - prng.gumbel(sub_h, (v,))).abs().max()))
    print(f"[kernels] threefry on the card equals the CPU bit for bit (keys, 3 "
          f"splits, bits and uniforms of ({N_REQ}, {v})); Gumbel noise max "
          f"|card - CPU| {worst_g:.3g} (reported)", flush=True)


# ---------------------------------------------------------------------------
# phase 2b: time each kernel at the serving path's shapes
# ---------------------------------------------------------------------------

# The dense kernel's times at the stablelm-3b smoke shapes before its bf16
# bodies (the CUDA-core design, f32 products, on NVIDIA H100 80GB HBM3 at
# 700.00 W): prefill q (8,32,963,80), dense-cache decode q (8,32,1,80).
PREVIOUS_DENSE_MS = {"dense_prefill": 5.3184, "dense_decode": 0.0703}
# The paged kernel's decode-call times at stablelm-3b's shape on its
# CUDA-core design (flash_fwd, before the split-KV body took bf16 q; on
# NVIDIA H100 80GB HBM3 at 700.00 W): bf16, int8 and fp8 pools.
PREVIOUS_PAGED_MS = {"paged_decode": 0.0835, "paged_decode_int8": 0.0907,
                     "paged_decode_fp8": 0.0911}
# Split spans timed beside the shipped SPLIT_KEYS (split_span_sweep).
SWEEP_SPLIT_KEYS = (128, 256, 512)


def time_dense(name, b, h, hkv, d, lens_t, max_len, gen):
    """The dense kernel's two calls on one model's attention shapes: the
    prefill call (tensor-core body) and the dense-cache decode call
    (split-KV body), each beside the plain version, its bound and SDPA."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW
    import torch.nn.functional as F

    s = int(lens_t.max())
    bf, item = torch.bfloat16, 2
    win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    rows = {}
    # prefill: q (B,Hq,S,D) over the (B,Hkv,max_len,D) cache, causal from
    # position 0, ragged kv_lens = prompt lengths
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(bf)
    k = torch.randn(b, hkv, max_len, d, generator=gen, device="cuda").to(bf)
    v = torch.randn(b, hkv, max_len, d, generator=gen, device="cuda").to(bf)
    zero = torch.zeros(b, dtype=torch.int32, device="cuda")
    kern = lambda: K.flash_dense_cuda(q, k, v, lens_t, zero, win, causal=True,
                                      scale=scale)
    plain = lambda: R.mha_ref(q, k, v, kv_lens=lens_t, causal=True,
                              q_offset=zero)
    mask = R.attention_mask(s, max_len, kv_lens=lens_t, causal=True,
                            q_offset=zero)                  # (B,S,Skv)
    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None],
                                                 scale=scale, enable_gqa=h != hkv)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=TOL["tensor_core"][0],
                               rtol=TOL["tensor_core"][1])
    print(f"[time] dense_prefill{name}: tol_ratio at ({TOL['tensor_core'][0]:g}, "
          f"{TOL['tensor_core'][1]:g}) "
          f"{tol_ratio(out_k, out_p, *TOL['tensor_core']):.4f}", flush=True)
    pairs = int(mask.sum())
    rows[f"dense_prefill{name}"] = dict(
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
        body=K.plan_dense(bf, b, h, hkv, s, max_len, d, decode=False).body,
        ms=time_ms(kern, 20), plain_ms=time_ms(plain, 5), library_ms=time_ms(lib, 20),
        flops=4 * h * d * pairs,
        bytes=item * (2 * q.numel() + 2 * hkv * d * int(lens_t.sum())),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    del out_k, out_p, mask

    # decode against the dense cache: q (B,Hq,1,D)
    kv1 = lens_t + 1
    q1 = q[:, :, :1].contiguous()
    kern = lambda: K.flash_dense_cuda(q1, k, v, kv1, lens_t, win, causal=False,
                                      scale=scale, decode=True)
    plain = lambda: R.mha_ref(q1, k, v, kv_lens=kv1, q_offset=lens_t)
    mask1 = R.attention_mask(1, max_len, kv_lens=kv1, q_offset=lens_t)
    lib = lambda: F.scaled_dot_product_attention(q1, k, v, attn_mask=mask1[:, None],
                                                 scale=scale, enable_gqa=h != hkv)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=TOL["split_kv"][0],
                               rtol=TOL["split_kv"][1])
    live = int(kv1.sum())
    plan = K.plan_dense(bf, b, h, hkv, 1, max_len, d, decode=True)
    rows[f"dense_decode{name}"] = dict(
        shape=f"q {tuple(q1.shape)} k/v {tuple(k.shape)} bf16, {plan.splits} splits",
        body=plan.body, ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20),
        library_ms=time_ms(lib, 50), flops=4 * h * d * live,
        bytes=item * (2 * q1.numel() + 2 * hkv * d * live),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    return rows, (q1, k, v, kv1)


def time_cross(gpu) -> dict:
    """The dense kernel in the cross-attention models' roles, non-causal, at
    their shapes (bf16): seamless' encoder (q and k/v (8, 16, 1024, 64),
    ragged frame counts), its cross-attention prefill (a 64-token decoder
    prompt over the frames) and decode (one row), llama-vision's
    cross-attention prefill (1024 prompt rows, 32 heads over 8 KV heads of
    D 128, all 1024 image tokens) and decode.  Each beside its plain
    version, its bound (operations on the live query-key pairs, or the
    bytes of q, out and the live K/V) and ``scaled_dot_product_attention``
    with the same mask (``enable_gqa`` where the heads are grouped)."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(23)
    bf, item = torch.bfloat16, 2
    win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        256, 1025, N_REQ).astype(np.int32)).cuda()
    full = torch.full((N_REQ,), 1024, dtype=torch.int32, device="cuda")
    cases = (("seamless encoder", 16, 16, 64, 1024, frames, False),
             ("seamless cross prefill", 16, 16, 64, 64, frames, False),
             ("seamless cross decode", 16, 16, 64, 1, frames, True),
             ("llama-vision cross prefill", 32, 8, 128, 1024, full, False),
             ("llama-vision cross decode", 32, 8, 128, 1, full, True))
    rows = {}
    for name, h, hkv, d, sq, lens_t, decode in cases:
        q = torch.randn(N_REQ, h, sq, d, generator=gen, device="cuda").to(bf)
        k, v = (torch.randn(N_REQ, hkv, 1024, d, generator=gen,
                            device="cuda").to(bf) for _ in range(2))
        zero = torch.zeros(N_REQ, dtype=torch.int32, device="cuda")
        kern = lambda: K.flash_dense_cuda(q, k, v, lens_t, zero, win,
                                          causal=False, scale=d ** -0.5,
                                          decode=decode)
        plain = lambda: R.mha_ref(q, k, v, kv_lens=lens_t, q_offset=zero)
        mask = R.attention_mask(sq, 1024, kv_lens=lens_t, q_offset=zero)
        lib = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None], scale=d ** -0.5,
            enable_gqa=h != hkv)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        body = K.plan_dense(bf, N_REQ, h, hkv, sq, 1024, d, decode=decode).body
        atol, rtol = TOL[body]
        r = tol_ratio(out_k, out_p, atol, rtol)
        check(r <= 1, f"{name}: {r} times its limit from the plain version")
        pairs = int(mask.sum())
        row = dict(shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
                   "non-causal", body=body, ms=time_ms(kern, 20),
                   plain_ms=time_ms(plain, 5), library_ms=time_ms(lib, 20),
                   flops=4 * h * d * pairs,
                   bytes=item * (2 * q.numel() + 2 * hkv * d * int(lens_t.sum())),
                   max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
        _bound(row)
        rows[name] = row
        print(f"[time] {name} ({row['body']}, {row['shape']}): "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention {row['library_ms']:.4f} ms; "
              f"tol_ratio {r:.4f}  [{gpu}]", flush=True)
        del q, k, v, out_k, out_p, mask
    return rows


def split_span_sweep(calls, gpu):
    """The decode calls of ``calls`` (name -> a call of a wrapper) timed at
    each split span of ``SWEEP_SPLIT_KEYS``: the wrappers read
    ``kernel.SPLIT_KEYS`` at call time, so each span plans its own grid and
    scratch.  The shipped span is restored after."""
    from repro_torch.kernels.flash_attention import kernel as K

    shipped = K.SPLIT_KEYS
    times = {}
    try:
        for span in SWEEP_SPLIT_KEYS:
            K.SPLIT_KEYS = span
            for name, fn in calls.items():
                times[(name, span)] = time_ms(fn, 50)
    finally:
        K.SPLIT_KEYS = shipped
    for name in calls:
        print(f"[time] split span sweep, {name} decode call at stablelm-3b's "
              f"shape: " + ", ".join(f"{span} keys {times[(name, span)]:.4f} ms"
                                     for span in SWEEP_SPLIT_KEYS)
              + f" (shipped: {shipped})  [{gpu}]", flush=True)


def time_paged(rows, name, q1, k, v, kv1, lens_t, max_len, h, hkv, d,
               quant=()) -> dict:
    """The paged kernel's decode call over the dense K/V of ``time_dense``
    laid out as pages (identity tables over (B*n_pages, Hkv, ps, D)),
    held to the plain version and to the dense call bit for bit, into
    ``rows`` as ``paged_decode{name}``; then over the same pages truncated
    to each type of ``quant`` by the port's quantize_block, with their
    scale pools (``paged_decode{name}_{type}``).  No one PyTorch call reads
    K/V through a page table: the rows' library time is null, and the
    print gives ``scaled_dot_product_attention`` over the dense K/V beside
    them as a yardstick.  Returns each call, by cache, for the split-span
    sweep."""
    from repro_torch.core import paging as PG
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW
    import torch.nn.functional as F

    b, bf, item, scale = q1.shape[0], torch.bfloat16, 2, d ** -0.5
    win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
    live = int(kv1.sum())
    n_pages = PG.pages_needed(max_len, PAGE_SIZE)
    kp = torch.zeros(b * n_pages, hkv, PAGE_SIZE, d, dtype=bf, device="cuda")
    vp = torch.zeros_like(kp)
    tab = (torch.arange(b, device="cuda")[:, None] * n_pages
           + torch.arange(n_pages, device="cuda")[None]).to(torch.int32)
    pad = n_pages * PAGE_SIZE - max_len
    for pool, t in ((kp, k), (vp, v)):
        pool.view(b, n_pages, hkv, PAGE_SIZE, d).copy_(
            F.pad(t, (0, 0, 0, pad)).view(b, hkv, n_pages, PAGE_SIZE, d)
            .transpose(1, 2))
    tab_c = torch.where(PG.page_whilelt(kv1, n_pages, PAGE_SIZE), tab, 0)
    kern = lambda: K.flash_paged_cuda(q1, kp, vp, tab_c, kv1, lens_t, win,
                                      causal=False, scale=scale, decode=True)
    plain = lambda: R.mha_ref(q1, PG.gather_pages(kp, tab_c),
                              PG.gather_pages(vp, tab_c), kv_lens=kv1,
                              q_offset=lens_t)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=TOL["split_kv"][0],
                               rtol=TOL["split_kv"][1])
    dense_out = K.flash_dense_cuda(q1, k, v, kv1, lens_t, win, causal=False,
                                   scale=scale, decode=True)
    torch.cuda.synchronize()
    check(torch.equal(out_k, dense_out), f"paged decode{name} equals the dense "
          "call bit for bit")
    calls = {"paged bf16": kern}
    rows[f"paged_decode{name}"] = dict(
        shape=f"q {tuple(q1.shape)} pools {tuple(kp.shape)} ps {PAGE_SIZE} bf16",
        ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20), library_ms=None,
        flops=4 * h * d * live,
        bytes=item * (2 * q1.numel() + 2 * hkv * d * live) + 4 * tab_c.numel(),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    for page_dtype in quant:
        qdt = PG.resolve_page_dtype(page_dtype)
        (kq, ksc), (vq, vsc) = PG.quantize_block(kp, qdt), PG.quantize_block(vp, qdt)
        kern = lambda kq=kq, vq=vq, ksc=ksc, vsc=vsc: K.flash_paged_quant_cuda(
            q1, kq, vq, ksc, vsc, tab_c, kv1, lens_t, win, causal=False,
            scale=scale, decode=True)
        plain = lambda: R.mha_ref(q1, PG.gather_pages(kq, tab_c, scale=ksc),
                                  PG.gather_pages(vq, tab_c, scale=vsc),
                                  kv_lens=kv1, q_offset=lens_t)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_p, atol=TOL["split_kv"][0],
                                   rtol=TOL["split_kv"][1])
        calls[f"paged {page_dtype}"] = kern
        rows[f"paged_decode{name}_{page_dtype}"] = dict(
            shape=f"q {tuple(q1.shape)} pools {tuple(kq.shape)} {page_dtype} "
                  f"+ scales {tuple(ksc.shape)} f32, ps {PAGE_SIZE}, q bf16",
            ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20), library_ms=None,
            flops=4 * h * d * live,
            bytes=(item * 2 * q1.numel() + 2 * hkv * d * live
                   + 4 * 2 * hkv * live + 4 * tab_c.numel()),
            max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    return calls


def print_rows(rows, gpu) -> None:
    """Each timed row with its bound (``_bound``) and, beside a paged row,
    the dense decode row's ``scaled_dot_product_attention`` time of the
    same shapes."""
    for name, r in rows.items():
        _bound(r)
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = f" ({r['body']} body)" if "body" in r else ""
        if name in PREVIOUS_DENSE_MS:
            extra += (f", previous design {PREVIOUS_DENSE_MS[name]:.4f} ms, "
                      f"{'no slower' if r['ms'] <= r['library_ms'] else 'SLOWER'}"
                      f" than the library call")
        if name in PREVIOUS_PAGED_MS:
            extra += (f" (split_kv body), previous design (CUDA-core, "
                      f"flash_fwd) {PREVIOUS_PAGED_MS[name]:.4f} ms")
        dense = rows.get(name.replace("paged_decode", "dense_decode")
                         .replace("_int8", "").replace("_fp8", ""))
        if name.startswith("paged_decode") and dense:
            extra += (f"; scaled_dot_product_attention over the dense K/V "
                      f"{dense['library_ms']:.4f} ms")
        print(f"[time] {name}: {r['shape']}: kernel {r['ms']:.4f} ms{extra}, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
              f"{r['max_abs_err']:.3g}  [{gpu}]", flush=True)


def time_head160(gpu) -> dict:
    """The flash kernels at stablelm-12b's shapes (32 query heads over 8 KV
    heads of D 160, bf16): the prefill call of the smoke's 8 prompts
    (tensor-core body), the dense-cache and paged decode calls (split-KV
    body, its third pass of 64 head dims), each beside its plain version,
    its bound and ``scaled_dot_product_attention``."""
    from repro_torch.configs import get_config

    cfg = get_config("stablelm_12b")
    lens = np.random.RandomState(0).randint(128, 1025, N_REQ).astype(np.int32)
    lens_t = torch.from_numpy(lens).cuda()
    max_len = int(lens.max()) + MAX_NEW
    gen = torch.Generator(device="cuda").manual_seed(24)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows, (q1, k, v, kv1) = time_dense("_stablelm_12b", N_REQ, h, hkv, d,
                                       lens_t, max_len, gen)
    time_paged(rows, "_stablelm_12b", q1, k, v, kv1, lens_t, max_len, h, hkv, d,
               ("int8",))
    print_rows(rows, gpu)
    return rows


def time_kernels(cfg, lens, max_len, gpu):
    """Each flash kernel at the serving path's shapes: the dense kernel's
    prefill and decode calls at stablelm-3b's heads (D 80, 32 heads; its row
    in the ``kernels`` line), zamba2-1.2b's (D 64, 32 heads) and
    olmoe-1b-7b's (D 128, 16 heads); the paged kernels' decode calls at
    stablelm-3b's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, d = len(lens), cfg.n_heads, cfg.resolved_head_dim
    hkv = cfg.n_kv_heads
    win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows, (q1, k, v, kv1) = time_dense("", b, h, hkv, d, lens_t, max_len, gen)
    for arch in ("zamba2_1_2b", "olmoe_1b_7b"):
        c = get_config(arch)
        rows.update(time_dense(f"_{arch}", b, c.n_heads, c.n_kv_heads,
                               c.resolved_head_dim, lens_t, max_len, gen)[0])

    sweep = {"dense": lambda: K.flash_dense_cuda(q1, k, v, kv1, lens_t, win,
                                                 causal=False, scale=scale,
                                                 decode=True)}
    sweep.update(time_paged(rows, "", q1, k, v, kv1, lens_t, max_len, h, hkv,
                            d, ("int8", "fp8")))
    split_span_sweep(sweep, gpu)
    del sweep
    print_rows(rows, gpu)
    return rows


def time_moe_positions(lens, gpu, floor_ms):
    """The dispatch-rank kernel at olmoe's shapes: the prefill call ranks
    every position of the padded (8, S) batch (T = 8 * S, K = 8, E = 64),
    the decode call one token per lane (T = 8), beside the plain version,
    the byte bound (4 bytes read and 4 written per assignment, 4 per
    count; the integer operations are a few per assignment) and the launch
    floor (an empty kernel, ``launch_floor_ms``), which the byte bound, under
    a nanosecond at decode, says nothing about; and the host's enqueue
    time per call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch.ref import moe_positions_ref

    cfg = get_config("olmoe_1b_7b")
    e, k = cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for name, t in (("prefill", len(lens) * int(max(lens))), ("decode", len(lens))):
        ids = torch.randint(0, e, (t, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        kern = lambda: MK.moe_positions_cuda(ids, e)
        plain = lambda: moe_positions_ref(ids, e)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"moe_positions at ({t}, {k}) equal to the plain version")
        rows[name] = dict(shape=f"ids ({t}, {k}) int32, E {e}",
                          ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20),
                          library_ms=None, flops=0, bytes=8 * t * k + 4 * e,
                          max_abs_err=0.0, launch_floor_ms=floor_ms,
                          host_us=host_enqueue_us(kern))
        _bound(rows[name])
    p, d = rows["prefill"], rows["decode"]
    print(f"[time] moe_positions prefill {p['shape']}: kernel {p['ms']:.4f} ms "
          f"(one launch), plain {p['plain_ms']:.4f} ms, bound "
          f"{p['bound_ms']:.6f} ms ({p['bound_by']}); decode {d['shape']}: kernel "
          f"{d['ms']:.4f} ms (one launch), plain "
          f"{d['plain_ms']:.4f} ms, bound {d['bound_ms']:.6f} ms ({d['bound_by']}); "
          f"launch floor {floor_ms:.4f} ms (an empty kernel); host enqueue "
          f"{p['host_us']:.2f} / {d['host_us']:.2f} us per call; library null "
          f"(no one PyTorch call computes the ranks), exact  [{gpu}]", flush=True)
    return rows


def time_fadda(v, gpu, floor_ms):
    """The ordered kernel at its two calls: the top-p scan of (8, V) sorted
    probabilities with every partial (once per stochastic sampling step),
    and the ``fadda`` op at n = 4096.  Beside the plain loop and the bound:
    the larger of the bytes at the memory rate and the dependency chain,
    n dependent adds of FADD_CYCLES at the card's maximum SM clock.  No
    PyTorch call promises this order, so the library column is null; the
    time of ``torch.cumsum``, a different function, is printed for context."""
    from repro_torch.kernels.fadda import kernel as FK
    from repro_torch.kernels.fadda.ref import fadda_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(10)
    clock = max_sm_clock_hz()
    rows = {}
    sp = sorted_probs(gen, N_REQ, v)
    x = torch.randn(1, 4096, generator=gen, device="cuda")
    for name, xs, partials in (("scan", sp, True), ("op", x, False)):
        r, c = xs.shape
        n_t = torch.full((r,), c, dtype=torch.int32, device="cuda")
        init = torch.zeros(r, device="cuda")
        kern = lambda: FK.fadda_rows_cuda(xs, n_t, init, partials=partials,
                                          block=512)
        out, part = kern()
        # the plain loop is c host launches of (r,) adds: time the one call
        # that the check needs (check_fadda ran the same loop before)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = fadda_scan_plain(xs, c, 0.0)
        end.record()
        torch.cuda.synchronize()
        check(_same_bits(out, want[:, -1]) and
              (part is None or _same_bits(part, want)),
              f"fadda {name} at ({r}, {c}) equal to the plain loop")
        chain_ms = c * FADD_CYCLES / clock * 1e3
        nbytes = 4 * xs.numel() * (2 if partials else 1) + 4 * r * 3
        rows[name] = dict(
            shape=f"x ({r}, {c}) f32{', every partial' if partials else ''}",
            ms=time_ms(kern, 50), plain_ms=start.elapsed_time(end),
            library_ms=None, cumsum_ms=time_ms(lambda: torch.cumsum(xs, -1), 50),
            bytes=nbytes, chain_ms=chain_ms, max_abs_err=0.0,
            launch_floor_ms=floor_ms)
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        rows[name].update(bound_ms=max(chain_ms, bytes_ms),
                          bound_by="operations" if chain_ms >= bytes_ms else "bytes")
    for name, r in rows.items():
        print(f"[time] fadda {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library null (no PyTorch call promises "
              f"this order; torch.cumsum, a different function: "
              f"{r['cumsum_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: chain of {FADD_CYCLES}-cycle adds at "
              f"{clock / 1e9:.3f} GHz {r['chain_ms']:.4f} ms, bytes "
              f"{r['bytes'] / PEAK_BYTES * 1e3:.4f} ms), launch floor "
              f"{floor_ms:.4f} ms, exact  [{gpu}]", flush=True)
    return rows


# daxpy at n = 2^26 - 3 in f32 on its grid-stride design, before the span
# design (NVIDIA H100 80GB HBM3, 700.00 W).
PREVIOUS_DAXPY_MS = 0.2812
SWEEP_DAXPY_BLOCKS = (2048, 4096, 8192, 16384)


def time_daxpy(gpu):
    """The daxpy kernel at n = 2^26 - 3 in f32 (the whole array active, its
    length not a multiple of the 16-byte chunk) at the op's default block,
    beside the plain version, the bound (12 bytes an element at the memory
    rate; 2 f32 operations an element at the f32 peak) and one library
    call, ``add_(alpha=)`` in place on a copy of y, timed in turns with the
    kernel (library, kernel, kernel, library; the mean of each pair); and
    the kernel at each block of ``SWEEP_DAXPY_BLOCKS`` (the chunks a thread
    has in flight follow from the block)."""
    from repro_torch.kernels.daxpy import kernel as DK
    from repro_torch.kernels.daxpy.ops import DEFAULT_BLOCK
    from repro_torch.kernels.daxpy.ref import daxpy_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    n = 2 ** 26 - 3
    x = torch.randn(n, generator=gen, device="cuda")
    y = torch.randn(n, generator=gen, device="cuda")
    y_lib = y.clone()
    a = torch.tensor(2.5)
    kern = lambda: DK.daxpy_cuda(x, y, 2.5, n, block=DEFAULT_BLOCK)
    plain = lambda: daxpy_ref(x, y, a, n)
    lib = lambda: y_lib.add_(x, alpha=2.5)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "daxpy at 2^26 - 3 equal to the plain version")
    del got, want
    lib_ms, k_ms, k2_ms, lib2_ms = (time_ms(f, 30) for f in (lib, kern, kern, lib))
    sweep = {blk: time_ms(lambda: DK.daxpy_cuda(x, y, 2.5, n, block=blk), 30)
             for blk in SWEEP_DAXPY_BLOCKS}
    r = dict(shape=f"x, y ({n},) f32, block {DEFAULT_BLOCK}", ms=(k_ms + k2_ms) / 2,
             plain_ms=time_ms(plain, 10), library_ms=(lib_ms + lib2_ms) / 2,
             bytes=12 * n, max_abs_err=0.0)
    t_ops = 2 * n / PEAK_F32_FLOPS * 1e3
    t_bytes = r["bytes"] / PEAK_BYTES * 1e3
    r.update(bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"[time] daxpy: {r['shape']}: kernel {r['ms']:.4f} ms ({k_ms:.4f}, "
          f"{k2_ms:.4f}; previous design {PREVIOUS_DAXPY_MS:.4f} ms), plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
          f"(add_(alpha=); {lib_ms:.4f}, {lib2_ms:.4f}; the kernel is "
          f"{'no slower' if r['ms'] <= r['library_ms'] else 'SLOWER'}), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB), "
          f"exact  [{gpu}]", flush=True)
    print(f"[time] daxpy by block (chunks in flight a thread): "
          + ", ".join(f"{blk} ({-(-blk // 4 // DK.CTA_THREADS)}) {ms:.4f} ms"
                      for blk, ms in sweep.items()) + f"  [{gpu}]", flush=True)
    return {"f32": r}


def _ssd_inputs(gen, bz, s, h, p, n, dtype):
    """Random SSD inputs at the scales of the JAX package's tests."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    return dict(x=r(bz, s, h, p).to(dtype), dt=r(bz, s, h).abs() * 0.1 + 0.01,
                A=-(r(h).abs() + 0.1), B=(r(bz, s, n) * 0.3).to(dtype),
                C=(r(bz, s, n) * 0.3).to(dtype), D=r(h),
                h0=r(bz, h, p, n) * 0.5)


# SSD cases (bz, s, h, p, n, chunk), the body each takes in bf16 (f32
# always takes the CUDA-core body) and whether it runs at every slice width
# of the tensor-core body: zamba2's (P 64, N 64, 64 heads) and mamba2's
# (P 64, N 128, 24 heads) heads, N = P = 16 with a ragged last chunk, a
# sequence shorter than one chunk; off the 16-grid a chunk of 40 and P = 8.
# Lanes are ragged (seq_lens s and s // 2 + 1) from a non-zero h0, and S is
# no multiple of the chunk.
SSD_CASES = (
    ((2, 300, 64, 64, 64, 128), "tensor_core", True),
    ((2, 300, 24, 64, 128, 128), "tensor_core", True),
    ((2, 100, 3, 16, 16, 16), "tensor_core", False),
    ((1, 5, 2, 16, 16, 64), "tensor_core", False),
    ((2, 77, 3, 64, 128, 40), "cuda_core", False),
    ((1, 5, 2, 8, 16, 64), "cuda_core", False),
)
# bf16 y against the plain path: one bf16 rounding step (atol 1e-5, rtol
# 2^-7), the split-KV flash body's limit; h_final at 1e-4 in both types.
SSD_Y_TOL = (1e-5, 2 ** -7)
SSD_H_TOL = 1e-4


@contextlib.contextmanager
def ssd_plan(body=None, slice_=None):
    """Within the block the SSD-scan kernel runs ``body`` (the CUDA-core
    body forced onto shapes the tensor-core body would take) and slices of
    ``slice_`` head dims: smoke-only, to time one body against the other on
    the same inputs.  Nothing on the main path reads it."""
    from repro_torch.kernels.ssd_scan import kernel as SK

    plan, width = SK.plan_ssd, SK.SLICE
    if slice_ is not None:
        SK.SLICE = slice_
    if body == SK.CUDA_CORE:
        SK.plan_ssd = lambda dtype, bz, s, h, p, n, chunk: SK.Plan(
            SK.CUDA_CORE, p, (h, bz, 1), SK.smem_bytes(chunk, p, n))
    try:
        yield
    finally:
        SK.plan_ssd, SK.SLICE = plan, width


def _ssd_held(got, want, dtype, what):
    """Hold (y, h_final) of the kernel against the plain path's; return
    y's ratio to its limit (bf16) or max |d| (f32)."""
    (y, h), (y_p, h_p) = got, want
    torch.testing.assert_close(h, h_p, atol=SSD_H_TOL, rtol=SSD_H_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_p, atol=1e-4, rtol=1e-4)
        return float((y - y_p).abs().max())
    ratio = tol_ratio(y, y_p, *SSD_Y_TOL)
    check(ratio <= 1, f"ssd_scan {what}: bf16 y at {ratio:.4g} times its "
          f"limit (atol {SSD_Y_TOL[0]:g}, rtol 2^-7)")
    return ratio


def check_ssd():
    """The SSD-scan kernel against ``ssd_chunked_ref`` through the op (which
    pads the plain path and predicates dt past ``seq_lens``), each case on
    the body ``plan_ssd`` names (held by the per-body launch counts), the
    serving shapes at every slice width of the tensor-core body.  f32 runs
    with the D skip; bf16 without, since the skip rounds y to bf16 a second
    time in both paths and a one-step difference in y can then exceed one
    step of the smaller sum."""
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst_f32, ratios = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for (bz, s, h, p, n, q), body, every_slice in SSD_CASES:
            if dtype == torch.float32:
                body, every_slice = SK.CUDA_CORE, False
            for width in SK.SLICES if every_slice else (None,):
                a = _ssd_inputs(gen, bz, s, h, p, n, dtype)
                lens = torch.tensor([s, s // 2 + 1][:bz], device="cuda")
                D = a["D"] if dtype == torch.float32 else None
                args = (a["x"], a["dt"], a["A"], a["B"], a["C"], D)
                kw = dict(seq_lens=lens, h0=a["h0"], chunk=q)
                before = dict(SK.ssd_scan_cuda.body_launches)
                with ssd_plan(slice_=width):
                    got = ssd_scan(*args, impl="kernel", **kw)
                want = ssd_scan(*args, impl="naive", **kw)
                torch.cuda.synchronize()
                ran = {k: v - before[k] for k, v in
                       SK.ssd_scan_cuda.body_launches.items()}
                check(ran[body] == 1 and sum(ran.values()) == 1,
                      f"ssd_scan case {(bz, s, h, p, n, q)} {dtype} ran "
                      f"{ran}, expected one {body} launch")
                what = f"{(bz, s, h, p, n, q)} {body}" + (
                    f" slice {width}" if width else "")
                r = _ssd_held(got, want, dtype, what)
                if dtype == torch.float32:
                    worst_f32 = max(worst_f32, r)
                else:
                    ratios[what] = r
    print(f"[kernels] ssd_scan checked against ssd_chunked_ref: f32 "
          f"(cuda_core) atol=rtol=1e-4, max |err| {worst_f32:.3g}; bf16 "
          f"h_final atol=rtol={SSD_H_TOL:g}, y at atol {SSD_Y_TOL[0]:g}, "
          f"rtol 2^-7: ratio to the limit per case "
          + ", ".join(f"{k}: {v:.4f}" for k, v in ratios.items()), flush=True)
    return ratios


def time_ssd(lens, gpu):
    """The SSD-scan kernel at the prefill shapes of the smoke run: x (8, S,
    H, 64) bf16 with S the longest prompt, dt predicated past each prompt's
    length, chunk 128, beside the plain op and the bound.  The tensor-core
    body and the CUDA-core body (forced) run on the same inputs, timed in
    turns (CUDA-core, tensor-core, tensor-core, CUDA-core), then the
    tensor-core body at each slice width."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for arch in ("zamba2_1_2b", "mamba2_130m"):
        cfg = get_config(arch)
        b, s = len(lens), int(max(lens))
        h, p, n, q = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
        a = _ssd_inputs(gen, b, s, h, p, n, torch.bfloat16)
        pos = torch.arange(s, device="cuda")[None, :, None]
        lens_t = torch.tensor(lens, device="cuda")
        dt = torch.where(pos < lens_t[:, None, None], a["dt"], 0.0).contiguous()
        kern = lambda: SK.ssd_scan_cuda(a["x"], dt, a["A"], a["B"], a["C"],
                                        a["h0"], chunk=q)
        plain = lambda: ssd_scan(a["x"], dt, a["A"], a["B"], a["C"],
                                 h0=a["h0"], chunk=q, impl="naive")
        check(SK.plan_ssd(torch.bfloat16, b, s, h, p, n, q).body
              == SK.TENSOR_CORE, f"{arch}: the serving shape's plan")
        want = plain()
        got = kern()
        with ssd_plan(SK.CUDA_CORE):
            got_cc = kern()
        torch.cuda.synchronize()
        ratio = _ssd_held(got, want, torch.bfloat16, f"{arch} tensor_core")
        ratio_cc = _ssd_held(got_cc, want, torch.bfloat16, f"{arch} cuda_core")
        chunks = -(-s // q)
        flops = (2 * q * q * n + 2 * q * q * p + 4 * q * p * n) * b * h * chunks
        nbytes = (2 * a["x"].numel() * 2 + dt.numel() * 4
                  + (a["B"].numel() + a["C"].numel()) * 2
                  + 2 * a["h0"].numel() * 4)
        turns = []
        for body in (SK.CUDA_CORE, SK.TENSOR_CORE, SK.TENSOR_CORE, SK.CUDA_CORE):
            with ssd_plan(body if body == SK.CUDA_CORE else None):
                turns.append(time_ms(kern, 20))
        sweep = {}
        for width in SK.SLICES:
            with ssd_plan(slice_=width):
                _ssd_held(kern(), want, torch.bfloat16, f"{arch} slice {width}")
                sweep[width] = time_ms(kern, 20)
        rows[arch] = dict(
            shape=f"x {tuple(a['x'].shape)} bf16, N {n}, chunk {q}",
            ms=(turns[1] + turns[2]) / 2, ms_turns=turns[1:3],
            cuda_core_ms=(turns[0] + turns[3]) / 2,
            cuda_core_turns=[turns[0], turns[3]], slice_sweep=sweep,
            # 2 calls: the plain op is ~260 small kernels, and more calls held
            # behind the spin kernel fill the device's launch queue, which
            # blocks the host
            plain_ms=time_ms(plain, 2), library_ms=None,
            flops=flops, bytes=nbytes, y_ratio=ratio, y_ratio_cc=ratio_cc,
            max_abs_err=float((got[0].float() - want[0].float()).abs().max()))
        del got, got_cc, want
    for name, r in rows.items():
        _bound(r)
        print(f"[time] ssd_scan {name}: {r['shape']}: tensor-core body "
              f"{r['ms']:.4f} ms (turns {r['ms_turns'][0]:.4f}, "
              f"{r['ms_turns'][1]:.4f}; {r['bound_ms'] / r['ms']:.1%} of the "
              f"bound), CUDA-core body {r['cuda_core_ms']:.4f} ms (turns "
              f"{r['cuda_core_turns'][0]:.4f}, {r['cuda_core_turns'][1]:.4f}; "
              f"{r['bound_ms'] / r['cuda_core_ms']:.1%} of the bound), "
              f"{r['cuda_core_ms'] / r['ms']:.2f}x; plain {r['plain_ms']:.4f} "
              f"ms, library null (no one PyTorch call computes the scan), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bytes']:.3g} B, {r['flops']:.3g} FLOP), max|err| "
              f"{r['max_abs_err']:.3g}, y at {r['y_ratio']:.4f} / "
              f"{r['y_ratio_cc']:.4f} of its limit  [{gpu}]", flush=True)
        print(f"[time] ssd_scan {name} tensor-core body by slice width: "
              + ", ".join(f"{w}: {ms:.4f} ms" for w, ms in
                          r["slice_sweep"].items())
              + f" (shipped: {SK.SLICE})  [{gpu}]", flush=True)
    return rows


def _bound(r) -> None:
    """The least time for the call: its bytes at the memory rate or its
    operations at the bf16 peak, whichever is longer."""
    t_ops = r["flops"] / PEAK_BF16_FLOPS * 1e3
    t_bytes = r["bytes"] / PEAK_BYTES * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# phase 3: full-width serving through ServeEngine.generate
# ---------------------------------------------------------------------------

# the published widths each served model is checked against
WIDTHS = {
    "stablelm_3b": dict(n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
                        resolved_head_dim=80, d_ff=6912, vocab_size=50304),
    "zamba2_1_2b": dict(n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
                        resolved_head_dim=64, d_ff=8192, vocab_size=32000,
                        ssm_state=64, ssm_headdim=64, shared_attn_period=6),
    "mamba2_130m": dict(n_layers=24, d_model=768, vocab_size=50280,
                        padded_vocab=50304, ssm_state=128, ssm_headdim=64),
    "olmoe_1b_7b": dict(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
                        resolved_head_dim=128, d_ff=1024, n_experts=64,
                        top_k=8, vocab_size=50304),
}
# the depth each model runs at in ``serve_model`` and ``serve_scheduler``:
# about half its published layers (zamba2: 3 of its 6 shared-attention
# groups and its 2-layer tail), so that the whole script ends inside its
# time limit on a slower host; widths, heads and vocab stay published
SERVE_DEPTH = {"stablelm_3b": 16, "zamba2_1_2b": 20, "olmoe_1b_7b": 8}


def served_config(arch):
    """``arch``'s config at its published widths (held to ``WIDTHS``), its
    depth cut to ``SERVE_DEPTH``."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    widths = WIDTHS[arch]
    got = {k: getattr(cfg, k) for k in widths}
    check(got == widths, f"{arch} widths {got}, published {widths}")
    return cfg.replace(n_layers=SERVE_DEPTH.get(arch, cfg.n_layers))


# the caches each model is served with: (run, page_size, page_dtype)
RUNS = {
    "stablelm_3b": (("dense", None, None), ("paged", PAGE_SIZE, None),
                    ("int8", PAGE_SIZE, "int8"), ("fp8", PAGE_SIZE, "fp8")),
    "zamba2_1_2b": (("dense", None, None), ("paged", PAGE_SIZE, None),
                    ("int8", PAGE_SIZE, "int8")),
    "mamba2_130m": (("dense", None, None),),
    "olmoe_1b_7b": (("dense", None, None), ("paged", PAGE_SIZE, None),
                    ("int8", PAGE_SIZE, "int8")),
}
# first-step logits, kernel path against plain path (quantized native decode
# included: both read the same pool bytes) and quantized native decode
# against the gather oracle: checked on f32 weights from the same seed (bf16
# rounding grows through random layers), with the bf16 figures reported
# beside; the dense family's bf16 kernel-vs-plain figure is also checked, as
# since it was first served.  Native decode attends to the new token's
# truncated K/V, the gather oracle (as the JAX engine's) to its full-precision
# K/V: at fp8's 3 mantissa bits that one token moves the logits by more than
# LIMIT_F32, so the fp8 native-vs-gather figure is reported, not checked.
# Both narrow types are also held against a truncating oracle: the gather
# oracle whose dense decode truncates the new token's K/V on store, as native
# decode does (``truncating_kv_store``), which faults in the native store
# (bytes, scales, type) would move.
# The MoE plain path ranks with the kernel too (its ranks are integers, held
# exactly equal above)
LIMIT_BF16, LIMIT_F32 = 2e-2, 1e-3
# Teacher-forced decode of the dense run's tokens: the paged cache's logits
# equal the dense cache's bit for bit at every step, with the served bf16
# weights (both caches decode on the split-KV body) and with f32 weights
# (both on the CUDA-core body).
PLAIN = dict(attn_impl="naive", ssd_impl="naive")


@contextlib.contextmanager
def truncating_kv_store(page_dtype):
    """Within the block, a dense decode truncates the new token's K/V to
    ``page_dtype`` by ``quantize_block`` and widens them again before it
    stores them: the K/V that native quantized decode attends to."""
    from repro_torch.core import paging as PG
    from repro_torch.models import layers as L

    dtype = PG.resolve_page_dtype(page_dtype)
    store = L.update_kv_cache
    trunc = lambda x: PG.dequantize(*PG.quantize_block(x, dtype)).to(x.dtype)
    L.update_kv_cache = lambda kc, vc, k, v, pos: store(kc, vc, trunc(k),
                                                        trunc(v), pos)
    try:
        yield
    finally:
        L.update_kv_cache = store


@contextlib.contextmanager
def plain_fadda():
    """Within the block, ``core.reductions`` runs its ordered sums by the
    plain loop (``fadda_scan_plain``) on the card instead of the kernel: the
    plain path of the sampler."""
    from repro_torch.core import reductions as R
    from repro_torch.kernels.fadda.ref import fadda_scan_plain

    kernel = R.fadda_rows

    def plain(rows, n=None, init=0.0, *, partials):
        scan = fadda_scan_plain(rows, rows.shape[1] if n is None else n, init)
        return scan[:, -1], (scan if partials else None)
    R.fadda_rows = plain
    try:
        yield
    finally:
        R.fadda_rows = kernel


def _attn_calls(cfg) -> tuple:
    """The flash calls of one model: (a whole prefill's, a decode step's
    self-attention ones through the cache, a decode step's cross-attention
    ones over the dense per-lane cross K/V).  encdec's prefill runs the
    encoder's and each decoder layer's self- and cross-attention; the vlm's
    its self layers and one cross layer a group."""
    if cfg.family == "encdec":
        n = cfg.n_dec_layers
        return cfg.n_enc_layers + 2 * n, n, n
    if cfg.cross_attn_group:
        groups = cfg.n_layers // cfg.cross_attn_group
        n_self = cfg.n_layers - groups
        return n_self + groups, n_self, groups
    n = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
         "hybrid": cfg.n_layers // cfg.shared_attn_period}[cfg.family]
    return n, n, 0


def _attn_layers(cfg) -> int:
    """The attention layers a decode step runs through the cache."""
    return _attn_calls(cfg)[1]


def _want_launches(cfg, page_size, page_dtype, steps, stochastic=False):
    """Each kernel's launches in one ``generate`` of the smoke workload (a
    stochastic batch runs one ordered top-p scan per sampled token)."""
    pre, attn, cross = _attn_calls(cfg)
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention_dense"] = pre + cross * steps  # prefill, cross decode
    decode = ("flash_attention_dense" if page_size is None else
              "flash_attention_paged_quant" if page_dtype else
              "flash_attention_paged")
    want[decode] += attn * steps
    if cfg.family in ("ssm", "hybrid"):
        want["ssd_scan"] = cfg.n_layers                   # prefill
    if cfg.family == "moe":
        want["moe_positions"] = (cfg.n_layers - cfg.first_k_dense) * (1 + steps)
    if stochastic:
        want["fadda"] = 1 + steps
    return want


def _want_bodies(cfg, page_size, page_dtype, steps):
    """Each flash wrapper's and the SSD scan's launches per body in one bf16
    ``generate``: every prefill call on the dense kernel's tensor-core body,
    every decode call on the split-KV body of the dense or the paged kernel,
    every prefill scan of a Mamba layer on the SSD scan's tensor-core body,
    none on a CUDA-core body.  Cross-attention decode runs the dense
    kernel's split-KV body over the lane's cross K/V."""
    pre, attn, cross = _attn_calls(cfg)
    want = {"flash_attention_dense": {"tensor_core": pre,
                                      "split_kv": cross * steps,
                                      "cuda_core": 0},
            "flash_attention_paged": {"split_kv": 0, "cuda_core": 0},
            "flash_attention_paged_quant": {"split_kv": 0, "cuda_core": 0}}
    decode = ("flash_attention_dense" if page_size is None else
              "flash_attention_paged_quant" if page_dtype else
              "flash_attention_paged")
    want[decode]["split_kv"] += attn * steps
    scans = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    want["ssd_scan"] = {"tensor_core": scans, "cuda_core": 0}    # prefill
    return want


def engine_classes():
    """``ServeEngine`` and three subclasses for the checks (the engine has no
    switch of its own): ``Eager`` decodes through the eager burst, the body
    the graph captures, run as it is; ``NoWriteBack`` is a faulty graph body
    that copies no carry back, so every replay restarts from the first
    one's inputs; ``KeepMerge`` a faulty gated step that keeps the merge on
    ``tok``, so a step that is not live turns each lane's last token into
    the stop token."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _unflatten

    class Eager(ServeEngine):
        def _decode_chunk(self, *args, **kw):
            with torch.inference_mode():
                return self._burst(*args, **kw)

    class NoWriteBack(ServeEngine):
        def _graph_body(self, static, kw):
            cache, out_buf, tok, p, n_gen, sstate, _ = _unflatten(static)
            self._burst(cache, out_buf, tok, p, n_gen, static["lane_budget"],
                        sstate, **kw)

    class KeepMerge(ServeEngine):
        def _step(self, *args, **kw):
            *carry, live = super()._step(*args, **kw)
            # a live step's tok is its merged token; a gated step's merged
            # token is the stop token on every lane
            carry[2] = torch.where(live, carry[2],
                                   torch.full_like(carry[2], self.stop_token))
            return (*carry, live)
    return ServeEngine, Eager, NoWriteBack, KeepMerge


def bursts(steps: int) -> int:
    """The bursts ``generate`` runs for ``steps`` live decode steps."""
    from repro_torch.serve.engine import BURST
    return -(-steps // BURST)


def _bits(t):
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def graph_differs(a, b) -> list:
    """What two ``generate`` results disagree on, bit for bit: tokens,
    n_generated, active, and every tensor of the cache (the final pos, and
    the K/V below pos and past it)."""
    bad = [k for k in ("tokens", "n_generated", "active")
           if not torch.equal(a[k], b[k])]
    for k, t in a["cache"].items():
        u = b["cache"][k]
        if t.shape != u.shape or not torch.equal(_bits(t), _bits(u)):
            bad.append(f"cache[{k!r}]")
    return bad


def timed(fn, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def served(cfg, eng, batch, name, **gen_kw):
    """One ``generate`` with every kernel's launches counted (across the
    graphs' replays): its result, timed, with the launches per kernel and
    per body.  Every lane must decode its whole budget (the stop token is
    -1) into token ids of the vocab (held)."""
    reset_counts()
    res, secs = timed(eng.generate, batch, **gen_kw)
    counts, bodies = read_counts(), read_bodies()
    n_gen = res["n_generated"].cpu().numpy()
    toks = res["tokens"].cpu().numpy()
    check((n_gen == MAX_NEW).all(), f"{cfg.name} {name}: n_generated {n_gen}")
    check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
          f"{cfg.name} {name}: token ids in the vocab")
    return res, secs, counts, bodies


def served_graphed(cfg, eng, eager, batch, name, gen_kw, turns=True) -> dict:
    """One ``generate`` through the graphs (its first burst captures the
    bucket), the same through the eager body, each held to its whole budget
    in vocab ids (``served``), and the two held equal bit for bit
    (``graph_differs``) with equal launch counts; then, with ``turns``, the
    graphs timed twice more (turns eager, graph, graph: the eager run is
    the one held)."""
    res, first_s, counts, bodies = served(cfg, eng, batch, name, **gen_kw)
    res_e, eager_s, counts_e, bodies_e = served(cfg, eager, batch,
                                                f"{name} eager", **gen_kw)
    check(counts_e == counts and bodies_e == bodies,
          f"{cfg.name} {name}: the eager body's launches {counts_e} equal "
          f"the graph's counted across replays {counts}")
    bad = graph_differs(res, res_e)
    check(not bad, f"{cfg.name} {name}: graphed generate differs from the "
          f"eager body in {bad}")
    del res_e
    times = [eager_s] + [timed(eng.generate, batch, **gen_kw)[1]
                         for _ in range(2 if turns else 1)]
    graphs = list(eng.graphs.values())
    check(len(graphs) == 1, f"{cfg.name} {name}: one bucket, {len(graphs)} graphs")
    print(f"[graph] {cfg.name} {name}: graphed generate equals the eager body "
          f"bit for bit (tokens, n_generated, active, every cache tensor: held), "
          f"launches equal (held), every lane its {MAX_NEW} tokens in the vocab "
          f"(held, both); first generate {first_s:.2f} s with the capture",
          flush=True)
    return dict(tokens=res["tokens"].cpu().numpy(), cache=res["cache"],
                counts=counts, bodies=bodies, engine=eng, gen_kw=gen_kw,
                total_s=statistics.mean(times[1:]), eager_s=eager_s,
                turns=times, order="e, g, g" if turns else "e, g",
                capture_s=graphs[0].capture_s, pool_bytes=graphs[0].pool_bytes,
                carry_bytes=eng.carry_bytes,
                n_generated=res["n_generated"].cpu().numpy())


def check_buckets(cfg, runs, batch, specs):
    """The graphs' buckets on the card, stablelm-3b dense: the all-greedy
    run's engine serves the mixed batch (the same carry shapes, a second
    bucket: two graphs over one shared carry) with the tokens of the mixed
    run on its own engine, and the cache the first run returned is not
    overwritten (generate returns a copy of the carry); then a batch padded
    to a wider prompt (new carry shapes) captures anew and evicts the old
    shapes' graphs and carry (held)."""
    eng = runs["dense"]["engine"]
    kept = {k: v.clone() for k, v in runs["dense"]["cache"].items()}
    res = served(cfg, eng, batch, "mixed on the greedy run's engine",
                 sampling=specs)[0]
    graphs = list(eng.graphs.values())
    check(len(graphs) == 2 and graphs[0].static is graphs[1].static,
          f"{cfg.name}: two buckets over one carry, {len(graphs)} graphs")
    check(np.array_equal(res["tokens"].cpu().numpy(), runs["mixed"]["tokens"]),
          f"{cfg.name}: the mixed batch on the greedy run's engine differs "
          f"from the mixed run")
    same = all(torch.equal(_bits(kept[k]), _bits(v))
               for k, v in runs["dense"]["cache"].items())
    check(same, f"{cfg.name}: a later generate overwrote a returned cache")
    del res, kept
    carry = eng.carry_bytes
    wide = dict(batch, tokens=torch.nn.functional.pad(batch["tokens"], (0, 8),
                                                      value=1))
    res, secs, _, _ = served(cfg, eng, wide, "prompts padded by 8")
    graphs = list(eng.graphs.values())
    check(len(graphs) == 1 and graphs[0].kw["stochastic"] is False,
          f"{cfg.name}: the wider batch's graphs {[g.kw for g in graphs]}")
    g = graphs[0]
    same = np.array_equal(res["tokens"].cpu().numpy(), runs["dense"]["tokens"])
    print(f"[graph] {cfg.name} buckets: the mixed batch on the all-greedy run's "
          f"engine shares its carry ({carry / 2**20:.1f} MiB) in a second "
          f"graph and equals the mixed run's tokens, and the first run's "
          f"returned cache is intact (held); prompts padded by 8 columns: a new "
          f"carry ({eng.carry_bytes / 2**20:.1f} MiB), the old shapes' two graphs "
          f"evicted (held), generate {secs:.2f} s with the capture "
          f"({g.capture_s:.2f} s), tokens equal to the unpadded run: {same} "
          f"(reported)", flush=True)
    del res


def faulty_copies(cfg, model, batch, dense_run):
    """Two faulty copies of the graph body must fail ``graph_differs``
    against the eager body's result: one that copies no carry back, and one
    whose gated step keeps the merge on ``tok`` (the last of 8 bursts has
    one gated step: the lanes that ran out of budget read inactive)."""
    _, Eager, NoWriteBack, KeepMerge = engine_classes()
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-1)
    want = Eager(cfg, model, **kw).generate(batch)
    for cls, must in ((NoWriteBack, "tokens"), (KeepMerge, "active")):
        got = cls(cfg, model, **kw).generate(batch)
        bad = graph_differs(got, want)
        check(must in bad, f"{cfg.name}: the faulty copy {cls.__name__} passed "
              f"the graphed == eager check (differs in {bad})")
        print(f"[graph] {cfg.name} faulty copy {cls.__name__}: differs from the "
              f"eager body in {bad} (the check fails it, as it must)", flush=True)
        del got


def host_waits(cfg, eng, batch, gpu):
    """Host calls that wait for the device in one graphed ``generate``
    (torch.profiler): one read of a device value per burst (the loop's stop
    check), one for the all-greedy check, and one graph launch per burst
    (held)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(batch)
        torch.cuda.synchronize()
    waits = collections.Counter(
        (e.name, e.cpu_parent.name if e.cpu_parent else None)
        for e in prof.events() if e.device_type == DeviceType.CPU
        and ("Synchronize" in e.name or e.name == "cudaMemcpy"))
    replays = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
                  and e.name == "cudaGraphLaunch")
    n = bursts(MAX_NEW - 1)
    reads = waits[("cudaStreamSynchronize", "aten::_local_scalar_dense")]
    check(replays == n and reads == n + 1, f"{cfg.name}: {replays} replays and "
          f"{reads} reads of a device value in a generate of {n} bursts")
    print(f"[graph] {cfg.name} host waits in one graphed generate of {n} "
          f"bursts: {sum(waits.values())} (by call and caller: {dict(waits)}): "
          f"{reads} reads of a device value, one stop check per burst and the "
          f"greedy check (held), the lane state's host-to-device copies and "
          f"the synchronizes around the run; {replays} graph launches  [{gpu}]",
          flush=True)


@torch.inference_mode()
def check_movers(cfg, runs, batch):
    """The scheduler's movers on the card, stablelm-3b: ``_gather_blocks``
    then ``_scatter_blocks`` over clobbered pages restores every pool and
    scale pool bit for bit (bf16, int8, fp8 pages); spill, clobber, a burst
    with the lane out, page-in and resume equals the uninterrupted graphed
    run bit for bit (tokens and n_generated of every lane, paged bf16)."""
    from repro_torch.serve.engine import BURST

    for name in ("paged", "int8", "fp8"):
        eng, cache = runs[name]["engine"], runs[name]["cache"]
        pids = torch.cat([cache["page_table"][1], cache["page_table"][5]])
        blocks = eng._gather_blocks(cache, pids)
        before = {k: v.clone() for k, v in blocks.items()}
        saved = {k: cache[k].clone() for k in blocks}
        for k in blocks:                        # clobber those pages
            cache[k].view(torch.uint8)[:, pids.long()] = 0x5A
        eng._scatter_blocks(cache, pids, blocks)
        same = all(torch.equal(_bits(cache[k]), _bits(saved[k])) and
                   torch.equal(_bits(blocks[k]), _bits(before[k])) for k in blocks)
        check(same, f"{cfg.name} {name}: gather, clobber, scatter restores the pools")
        del saved, before, blocks
    eng = runs["paged"]["engine"]
    cache, out, tok, p, n_gen, budget, s, stoch = eng._start(
        batch, page_size=PAGE_SIZE)
    burst = lambda c, o, t, p, n, s: eng._decode_chunk(
        c, o, t, p, n, budget, s, n_steps=BURST, stochastic=stoch)[:6]
    from repro_torch.serve.engine import BURST
    c, o, t, p, n, s = burst(cache, out, tok, p, n_gen, s)
    lane = 3
    dense, row, srow = eng._spill_lane(c, o, t, n, budget, s, lane)
    table = c["page_table"][lane].clone()
    blocks = eng._gather_blocks(c, table)
    blocks = {k: v.clone() for k, v in blocks.items()}
    for k in blocks:                            # clobber the lane's pages
        c[k][:, table.long()] = 0
    p = p.clone()
    p[lane] = False
    c, o, t, p, n, s = burst(c, o, t, p, n, s)
    eng._scatter_blocks(c, table, blocks)
    c, o, t, p, n, budget, s = eng._resume_lane(c, o, t, p, n, budget, s, lane,
                                                dense, row, srow, table)
    extra = 0
    while bool(p.any()):
        c, o, t, p, n, s = burst(c, o, t, p, n, s)
        extra += 1
    same = (np.array_equal(o.cpu().numpy(), runs["paged"]["tokens"]) and
            np.array_equal(n.cpu().numpy(), runs["paged"]["n_generated"]))
    check(same, f"{cfg.name} paged: spill, clobber, resume equals the "
          f"uninterrupted run")
    print(f"[graph] {cfg.name} movers: gather, clobber, scatter restores the "
          f"bf16, int8 and fp8 pools bit for bit (held); lane {lane} spilled "
          f"after one burst, its {table.numel()} pages clobbered, a burst "
          f"without it, paged back in and resumed ({2 + extra} bursts in all): "
          f"every lane's tokens and n_generated equal the uninterrupted run's "
          f"(held)", flush=True)


def profile_burst(cfg, name, eng, batch, gen_kw, gpu, reps: int = 20,
                  window: int = 2):
    """Replayed bursts of ``eng``'s graph (from the state after one burst of
    a fresh ``generate``): the wall per step on the host clock over ``reps``
    replays in a row; the device's busy time per step (the union of its
    kernels, and of all its events) over a profiled window of ``window``
    replays, and the idle share, one minus busy over wall, as
    ``profile_decode`` reads it (that method's eager step gives the eager
    side).  The graph's nodes (libcuda)
    hold each of the port's kernels as often as its wrapper counted at
    capture (held: the libraries' launches, made through their own CUDA
    runtime, land in the capture); the kernels the profiler sees per
    replay against the graph's kernel nodes (reported: the profiler can
    miss events of a large burst)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import BURST

    state = eng._start(batch, **gen_kw)
    kw = dict(n_steps=BURST, stochastic=state[7], width=None)
    # one burst, every lane live (it captures anew if the engine's carry
    # has other shapes by now)
    eng._decode_chunk(*state[:7], **kw)
    (g,) = [g for g in eng.graphs.values() if g.kw == kw]
    del state
    n = BURST
    g.graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        g.graph.replay()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps / n
    # device events only: the host's ops would cost the profiler minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            g.graph.replay()
        torch.cuda.synchronize()
        wall_window = (time.perf_counter() - t0) * 1e3 / window / n
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[profile] {cfg.name} {name} burst: wall {wall:.2f} ms/step "
              f"replayed; device time not measured (the profiler saw no "
              f"device events)  [{gpu}]", flush=True)
        return
    # copies and sets: the runtime's, and the kernels CUDA runs for a
    # graph's memcpy nodes (``memcpy32_post``)
    kern = [e for e in dev
            if not e.name.lower().startswith(("memcpy", "memset"))]
    busy = busy_ms(kern) / window / n
    busy_all = busy_ms(dev) / window / n
    # the port's libraries launch through their own CUDA runtime: every
    # launch the wrappers counted at capture is a node of the graph
    nodes = graph_nodes(g.graph)
    want = collections.Counter()
    for fn, (calls, by_body) in g.counts.items():
        name_ = fn.__name__
        if name_.startswith("flash"):
            want["flash_split"] += by_body.get("split_kv", 0)
            want["flash_split_merge"] += by_body.get("split_kv", 0)
            want["flash_dense_tc"] += by_body.get("tensor_core", 0)
            want["flash_fwd"] += by_body.get("cuda_core", 0)
        elif calls:
            want[{"moe_positions_cuda": "moe_positions_kernel",
                  "fadda_rows_cuda": "fadda_rows_kernel"}[name_]] += calls
    got = {k: nodes[k] for k in PORT_KERNELS if nodes[k] or want[k]}
    check(got == {k: want[k] for k in got}, f"{cfg.name} {name}: the graph's "
          f"nodes of the port's kernels {got}, its wrappers counted {dict(want)}")
    kernel_nodes = sum(v for k, v in nodes.items() if k not in ("memcpy", "memset"))
    seen = len(kern) / window
    print(f"[profile] {cfg.name} {name} burst of {n}: replayed {wall:.2f} ms/step "
          f"wall (mean of {reps} replays in a row; {wall_window:.2f} in the "
          f"profiled window of {window}), device {busy:.2f} ms/step busy in "
          f"kernels ({busy_all:.2f} with the copies and sets), idle "
          f"{1 - busy / wall:.1%} ({1 - busy_all / wall:.1%}) against the "
          f"{reps}-replay wall; "
          f"{seen / n:.3f} kernels + {(len(dev) / window - seen) / n:.3f} "
          f"copies/sets per step seen by the profiler, against the graph's "
          f"{kernel_nodes / n:.3f} kernel nodes per step ({seen - kernel_nodes:+.1f} "
          f"per replay, reported); the graph's nodes {dict(nodes)}, the port's "
          f"kernels among them as its wrappers counted at capture (held)  "
          f"[{gpu}]", flush=True)


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
        ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


# the port's kernels, by a part of their (mangled) names, in the order they
# are matched: the merge before the split body it contains
PORT_KERNELS = ("flash_split_merge", "flash_split", "flash_dense_tc",
                "flash_fwd", "ssd_tc", "ssd_fwd", "moe_positions_kernel",
                "fadda_rows_kernel", "daxpy")


def graph_nodes(graph) -> collections.Counter:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (kept with
    ``keep_graph=True``), read through libcuda: copies and sets by
    type, kernels of the port's libraries by ``PORT_KERNELS`` name, and
    every other kernel as ``"other kernel"``."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    for fn in (lib.cuFuncGetName, lib.cuKernelGetName):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    out, kind = collections.Counter(), ctypes.c_int()
    for node in nodes:
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
              == 0, "cuGraphNodeGetType")
        if kind.value != 0:                      # CU_GRAPH_NODE_TYPE_KERNEL
            out[{1: "memcpy", 2: "memset"}.get(kind.value, f"type {kind.value}")] += 1
            continue
        prm, name = _KernelNodeParams(), ctypes.c_char_p()
        check(lib.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                ctypes.byref(prm)) == 0,
              "cuGraphKernelNodeGetParams")
        err = (lib.cuFuncGetName(ctypes.byref(name), prm.func) if prm.func
               else lib.cuKernelGetName(ctypes.byref(name), prm.kern))
        check(err == 0, "cuFuncGetName / cuKernelGetName")
        text = name.value.decode()
        out[next((k for k in PORT_KERNELS if k in text), "other kernel")] += 1
    return out


def busy_ms(events) -> float:
    """The device's busy time over profiler ``events``: the union of their
    intervals (kernels of a graph may overlap), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def graphed(fn):
    """``fn()`` captured in a CUDA graph (after a warm-up call on the side
    stream, not counted) and replayed once; its launches counted once, as a
    replay.  Returns what the capture returned, filled by the replay."""
    from repro_torch import kernels as KN

    before = KN.read_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    KN.set_counts(before)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    delta = KN.counts_since(before)
    KN.set_counts(before)
    graph.replay()
    KN.add_counts(delta)
    torch.cuda.synchronize()
    return out


def serve_model(arch, gpu):
    """One model at its published widths through ``ServeEngine.generate``:
    8 prompts, 64 new tokens each, with each cache of ``RUNS[arch]``, graphed
    and held against the eager body (``served_graphed``); every kernel's
    launches counted in each run."""
    from repro_torch.models import get_model, paged_view, to_paged
    from repro_torch.sample import greedy_tokens
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import BURST

    cfg = served_config(arch)
    fam = get_model(cfg)
    widths = WIDTHS[arch]
    pages = bool(fam.paged_cache_spec(cfg))
    quant = [dt for _, _, dt in RUNS[arch] if dt]
    seed0 = lambda: torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = fam.init(cfg, seed0(), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[full] {cfg.name} ({cfg.family}): "
          + " ".join(f"{k}={getattr(cfg, k)}" for k in widths)
          + f" (of {widths['n_layers']} layers)"
          + f" {cfg.compute_dtype}: {n_params / 1e9:.3f}B params, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, N_REQ).astype(np.int32)
    s = int(lens.max())
    tokens = rng.randint(1, cfg.vocab_size, (N_REQ, s))
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "lens": torch.from_numpy(lens).cuda()}
    max_len = s + MAX_NEW
    eng_warm = ServeEngine(cfg, model, max_new_tokens=2, stop_token=-1)
    eng_warm.generate({"tokens": batch["tokens"][:2, :16]})    # cuBLAS warm-up
    torch.cuda.synchronize()
    if cfg.family != "moe":
        check_rows(fam, model, cfg, gpu)

    runs = {}
    steps = MAX_NEW - 1
    # the steps each generate runs: whole bursts, the last one's tail gated
    slots = bursts(steps) * BURST
    Engine, Eager, *_ = engine_classes()
    for name, page_size, page_dtype in RUNS[arch]:
        # stop token -1: argmax never emits it, so every lane decodes its budget
        kw = dict(max_new_tokens=MAX_NEW, stop_token=-1, page_dtype=page_dtype)
        eng, eager = Engine(cfg, model, **kw), Eager(cfg, model, **kw)
        run = served_graphed(cfg, eng, eager, batch, name,
                             dict(page_size=page_size))
        want = _want_launches(cfg, page_size, page_dtype, slots)
        check(run["counts"] == want,
              f"{arch} {name} launches {run['counts']}, expected {want}")
        want = _want_bodies(cfg, page_size, page_dtype, slots)
        check(run["bodies"] == want,
              f"{arch} {name} bodies {run['bodies']}, expected {want}")
        runs[name] = run
        print(f"[full] {cfg.name} generate {name}: launches "
              f"{ {k: v for k, v in run['counts'].items() if v} }, bodies "
              f"{ _nonzero(run['bodies']) } (as expected, counted across "
              f"replays; the eager body's the same)", flush=True)

    # one mixed batch on the dense cache: lanes 0-3 greedy, 4-7 stochastic
    # (stablelm twice, the second on a fresh engine: a seeded batch must
    # repeat its tokens)
    specs = mixed_specs()
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-1)
    eng, eager = Engine(cfg, model, **kw), Eager(cfg, model, **kw)
    run = served_graphed(cfg, eng, eager, batch, "mixed",
                         dict(sampling=specs), turns=False)
    runs["mixed"] = run
    mixed = [("mixed", run["counts"], run["bodies"], run["tokens"])]
    if cfg.family == "dense":
        res, _, counts, bodies = served(cfg, Engine(cfg, model, **kw), batch,
                                        "mixed again", sampling=specs)
        mixed.append(("mixed again", counts, bodies,
                      res["tokens"].cpu().numpy()))
        del res
    for name, counts, bodies, toks in mixed:
        want = _want_launches(cfg, None, None, slots, stochastic=True)
        check(counts == want, f"{arch} {name} launches {counts}, expected {want}")
        check(bodies == _want_bodies(cfg, None, None, slots),
              f"{arch} {name} bodies {bodies}")
        check((toks[:4] == runs["dense"]["tokens"][:4]).all(),
              f"{cfg.name} {name}: greedy lanes equal the all-greedy run")
        print(f"[full] {cfg.name} generate {name} (lanes 0-3 greedy, 4-7 "
              f"stochastic): launches { {k: v for k, v in counts.items() if v} } "
              f"on the tensor-core and split-KV bodies (as expected); greedy "
              f"lanes equal the all-greedy run (held)", flush=True)
    if len(mixed) == 2:
        check((mixed[0][3] == mixed[1][3]).all(),
              f"{cfg.name}: the seeded mixed batch repeats its tokens")
        print(f"[full] {cfg.name} mixed batch run twice, the second on a fresh "
              f"engine: identical tokens (held)", flush=True)
    if cfg.family == "dense":
        faulty_copies(cfg, model, batch, runs["dense"])
        host_waits(cfg, runs["dense"]["engine"], batch, gpu)
        check_movers(cfg, runs, batch)
        check_buckets(cfg, runs, batch, specs)
    first_token_keep_set(fam, model, cfg, batch, eng.make_cache(N_REQ, max_len),
                         runs["mixed"]["tokens"][:, 0], gpu)

    # prefill alone, timed apart from the runs above (same inputs); a model
    # with Mamba layers also with the SSD scan's CUDA-core body forced, in
    # turns (tensor-core, CUDA-core, CUDA-core, tensor-core)
    def prefill():
        return fam.prefill(model, cfg, batch, eng.make_cache(N_REQ, max_len))

    def prefill_once(body=None):
        with ssd_plan(body):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
    with torch.inference_mode():
        prefill()
        torch.cuda.synchronize()
        prefill_s = prefill_once()
        if cfg.family in ("ssm", "hybrid"):
            cc = [prefill_once("cuda_core"), prefill_once("cuda_core")]
            tc = [prefill_s, prefill_once()]
            print(f"[full] {cfg.name} prefill alone by SSD-scan body: "
                  f"tensor-core {tc[0] * 1e3:.1f} / {tc[1] * 1e3:.1f} ms, "
                  f"CUDA-core (forced) {cc[0] * 1e3:.1f} / {cc[1] * 1e3:.1f} ms "
                  f"(turns tc, cc, cc, tc)  [{gpu}]", flush=True)
    for name, r in runs.items():
        decode_ms = (r["total_s"] - prefill_s) * 1e3 / steps
        r.update(prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_ms,
                 tokens_per_s=N_REQ * MAX_NEW / r["total_s"])
        eager_ms = (r["eager_s"] - prefill_s) * 1e3 / steps
        turns = " / ".join(f"{t * 1e3:.1f}" for t in r["turns"])
        print(f"[full] {cfg.name} {name}: generate {r['total_s'] * 1e3:.1f} ms "
              f"graphed, {r['eager_s'] * 1e3:.1f} ms eager, for {N_REQ}x{MAX_NEW} "
              f"tokens, prompts {lens.min()}-{lens.max()} (turns {r['order']}: "
              f"{turns} ms): prefill {r['prefill_ms']:.1f} ms (timed alone), "
              f"decode {decode_ms:.2f} ms/step graphed, {eager_ms:.2f} eager, "
              f"{r['tokens_per_s']:.1f} tokens/s graphed; capture "
              f"{r['capture_s']:.3f} s, graph pool {r['pool_bytes'] / 2**20:.1f} "
              f"MiB, static carry {r['carry_bytes'] / 2**20:.1f} MiB  [{gpu}]",
              flush=True)
    if pages:
        # dense and paged decode run one split-KV body over the same keys:
        # the same logits bit for bit, so the same greedy tokens
        same = float((runs["dense"]["tokens"] == runs["paged"]["tokens"]).mean())
        print(f"[full] {cfg.name} identical tokens dense vs paged: {same:.4f} "
              "(held at 1)", flush=True)
        check(same == 1.0, f"{cfg.name}: paged tokens equal the dense run's")
    for dt in quant:
        same = float((runs[dt]["tokens"] == runs["paged"]["tokens"]).mean())
        print(f"[full] {cfg.name} tokens of the {dt} pages equal to the "
              f"full-precision paged run: {same:.4f} (reported: quantization "
              "may change tokens)", flush=True)
    mixed_ms, greedy_ms = runs["mixed"]["decode_ms_per_step"], runs["dense"]["decode_ms_per_step"]
    print(f"[full] {cfg.name} decode step, dense cache: mixed batch {mixed_ms:.2f} ms, "
          f"all greedy {greedy_ms:.2f} ms ({mixed_ms - greedy_ms:+.2f} ms for "
          f"sampling)  [{gpu}]", flush=True)
    for name, r in runs.items():
        profile_decode(model, cfg, name, r.pop("cache"), r["tokens"][:, -1], gpu,
                       sampling=specs if name == "mixed" else None)
        profile_burst(cfg, name, r.pop("engine"), batch, r.pop("gen_kw"), gpu)
    profile_sampler(cfg, gpu)

    # first decode step: kernel path vs plain path, dense vs paged cache, and
    # quantized native decode vs the gather oracle over the same pool bytes
    def first_step(m, c, tok=None):
        cache = fam.make_cache(c, N_REQ, max_len, device="cuda")
        lp, cache = fam.prefill(m, c, batch, cache)
        tok = greedy_tokens(lp) if tok is None else tok
        step = {"token": tok[:, None]}
        out = {"prefill": lp, "tok": tok}
        clone = lambda d: {k: v.clone() for k, v in d.items()}
        if pages:      # decode writes the cache in place: page a copy
            paged = to_paged(c, clone(cache), page_size=PAGE_SIZE)
            out["paged"], _ = fam.decode(m, c, step, paged)
            del paged
        for dt in quant:
            qc = to_paged(c, clone(cache), page_size=PAGE_SIZE, page_dtype=dt)
            view = paged_view(c, clone(qc))       # widened before decode writes
            trunc = clone(view)
            out[f"{dt} native"], _ = fam.decode(m, c, step, qc)
            out[f"{dt} gather"], _ = fam.decode(m, c, step, view)
            with truncating_kv_store(dt):
                out[f"{dt} truncating"], _ = fam.decode(m, c, step, trunc)
            del qc, view, trunc
        out["decode"], _ = fam.decode(m, c, step, cache)
        for t in (v for k, v in out.items() if k != "tok"):
            check(t.shape == (N_REQ, cfg.padded_vocab)
                  and bool(torch.isfinite(t).all()),
                  "first-step logits of the expected shape, all finite")
        return out

    def errs(fast, slow):
        # over the real vocab: padded slots hold the -1e30 mask
        v = cfg.vocab_size
        err = lambda a, b: rel_err(a[:, :v], b[:, :v])
        e = {"prefill kernel vs plain": err(fast["prefill"], slow["prefill"]),
             "decode kernel vs plain": err(fast["decode"], slow["decode"])}
        if pages:
            e["decode paged vs dense"] = err(fast["paged"], fast["decode"])
        for dt in quant:
            e[f"decode {dt} native kernel vs plain"] = err(
                fast[f"{dt} native"], slow[f"{dt} native"])
            e[f"decode {dt} native vs gather oracle"] = err(
                fast[f"{dt} native"], fast[f"{dt} gather"])
            e[f"decode {dt} native vs truncating oracle"] = err(
                fast[f"{dt} native"], fast[f"{dt} truncating"])
        return e

    forced = {}       # teacher-forced decode: (split-KV record, paged == dense)
    with torch.inference_mode():
        fast = first_step(model, cfg)
        bf16 = errs(fast, first_step(model, cfg.replace(**PLAIN), fast["tok"]))
        del fast
        if _attn_layers(cfg):
            forced["bf16 weights"] = teacher_forced(
                fam, model, cfg, batch, max_len, runs["dense"]["tokens"], pages,
                quant)
        del model, eng, eager, eng_warm
        torch.cuda.empty_cache()
        cfg32 = cfg.replace(compute_dtype="float32")
        model32 = fam.init(cfg32, seed0(), "cuda")
        fast = first_step(model32, cfg32)
        f32 = errs(fast, first_step(model32, cfg32.replace(**PLAIN), fast["tok"]))
        if pages:
            forced["f32 weights"] = teacher_forced(
                fam, model32, cfg32, batch, max_len, runs["dense"]["tokens"], pages,
                ())
        del model32, fast
        torch.cuda.empty_cache()
    checks = [({k: v for k, v in f32.items() if "fp8 native vs gather" not in k},
               LIMIT_F32, "f32 weights")]
    if cfg.family == "dense":
        checks.append(({k: bf16[k] for k in ("prefill kernel vs plain",
                                             "decode kernel vs plain")},
                       LIMIT_BF16, "bf16 weights"))
    for errs_, limit, kind in checks:
        for what, e in errs_.items():
            print(f"[full] {cfg.name} first-step logits {what}: max|d|/max|ref| "
                  f"= {e:.3g} (limit {limit:g}, {kind})", flush=True)
            check(e <= limit, f"{cfg.name} first-step logits {what} ({kind}): "
                  f"{e} > {limit}")
    reported = [(f32, "f32 weights"), (bf16, "bf16 weights")]
    for errs_, kind in reported:
        held = [e for e, _, k in checks if k == kind]
        for what, e in errs_.items():
            if not any(what in h for h in held):
                print(f"[full] {cfg.name} first-step logits {what}: max|d|/max|ref| "
                      f"= {e:.3g} ({kind}, reported, not checked)", flush=True)
    for kind, (held, same) in forced.items():
        what = f"{cfg.name} teacher-forced decode of {steps} steps, {kind}"
        if kind == "bf16 weights":
            calls = _attn_layers(cfg) * steps
            want = {"flash_attention_dense": calls,
                    **({"flash_attention_paged": calls} if pages else {}),
                    **({"flash_attention_paged_quant": calls * len(quant)}
                       if quant else {})}
            check(held["calls"] == want, f"{what}: split-KV calls held "
                  f"{held['calls']}, expected {want}")
            print(f"[full] {what}: each split-KV call against the plain "
                  f"attention on its inputs ({held['calls']}): max |d| / (atol "
                  f"+ rtol |ref|) = {held['ratio']} (limit 1 at atol "
                  f"{TOL['split_kv'][0]:g}, rtol 2^-7), max |d| "
                  f"{held['abs']}", flush=True)
            check(max(held["ratio"].values()) <= 1, f"{what}: a split-KV call "
                  f"is {held['ratio']} times its limit from the plain attention")
        if pages:
            print(f"[full] {what}: logits of the paged cache equal the dense "
                  f"cache's bit for bit at every step: {same} (held)", flush=True)
            check(same, f"{what}: paged logits differ from the dense cache's")
    return cfg, lens, max_len, runs


# ---------------------------------------------------------------------------
# the cross-attention models and gemma3 through ``generate``
# ---------------------------------------------------------------------------

CROSS_ARCHS = ("seamless_m4t_large_v2", "llama_3_2_vision_11b", "gemma3_27b")
CROSS_WIDTHS = {
    "seamless_m4t_large_v2": dict(
        n_enc_layers=24, n_dec_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, resolved_head_dim=64, d_ff=8192, vocab_size=256206,
        padded_vocab=256256),
    "llama_3_2_vision_11b": dict(
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        resolved_head_dim=128, d_ff=14336, vocab_size=128256,
        cross_attn_group=5, n_cross_tokens=1024),
    "gemma3_27b": dict(
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
        resolved_head_dim=128, d_ff=21504, vocab_size=262144,
        local_window=1024, local_global_period=6),
    # served by serve_stablelm_12b through serve_cross_model's checks
    "stablelm_12b": dict(
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        resolved_head_dim=160, d_ff=13824, vocab_size=100352),
}
CROSS_RUNS = {
    "seamless_m4t_large_v2": (("dense", None, None), ("paged", PAGE_SIZE, None),
                              ("int8", PAGE_SIZE, "int8")),
    "llama_3_2_vision_11b": (("dense", None, None), ("paged", PAGE_SIZE, None)),
    "gemma3_27b": (("dense", None, None), ("paged", PAGE_SIZE, None)),
    "stablelm_12b": (("dense", None, None), ("paged", PAGE_SIZE, None),
                     ("int8", PAGE_SIZE, "int8")),
}
# depth cuts: gemma3-27b's 62 layers (57 GB of bf16 weights) leave the
# 80 GB card too little for the graphed and eager runs' caches side by
# side; 24 layers keep 4 of its 5:1 local:global periods (~25 GB)
CROSS_DEPTH = {"gemma3_27b": dict(n_layers=24)}
# gemma3: lanes 0 and 4 get 300 more prompt tokens, so that they hold more
# than its 1024-key local window in prefill and in decode
GEMMA3_LONGER = (0, 4)


def cross_batch(cfg) -> tuple:
    """The phase's batch of 8 and its prompt lengths.  seamless: source
    frames N(0, 1) of ``RandomState(0).randint(256, 1025, 8)`` rows (zeros
    past each row's length), decoder prompts of ``randint(8, 65, 8)``
    tokens; llama-vision and gemma3: the smoke's prompts
    (``randint(128, 1025, 8)`` tokens; gemma3's lanes ``GEMMA3_LONGER``
    300 longer), llama-vision with image embeddings N(0, 1) of (8, 1024,
    4096).  The embeddings come from a card generator seeded with 0."""
    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {}
    if cfg.family == "encdec":
        src = rng.randint(256, 1025, N_REQ).astype(np.int32)
        lens = rng.randint(8, 65, N_REQ).astype(np.int32)
        emb = torch.randn(N_REQ, int(src.max()), cfg.d_model, generator=gen,
                          device="cuda")
        emb *= (torch.arange(emb.shape[1], device="cuda")[None, :, None]
                < torch.from_numpy(src).cuda()[:, None, None])
        batch.update(src_emb=emb, src_lens=torch.from_numpy(src).cuda())
    else:
        lens = rng.randint(128, 1025, N_REQ).astype(np.int32)
        if cfg.local_window:
            lens[list(GEMMA3_LONGER)] += 300
        if cfg.cross_attn_group:
            batch["cross_emb"] = torch.randn(N_REQ, cfg.n_cross_tokens,
                                             cfg.d_model, generator=gen,
                                             device="cuda")
    tokens = rng.randint(1, cfg.vocab_size, (N_REQ, int(lens.max())))
    batch.update(tokens=torch.from_numpy(tokens).cuda(),
                 lens=torch.from_numpy(lens).cuda())
    return batch, lens


def init_full(arch):
    """(cfg, family module, model) of one model of ``CROSS_WIDTHS`` at its
    published widths (depth cut by ``CROSS_DEPTH``), random bf16 weights
    from seed 0 on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(arch)
    widths = CROSS_WIDTHS[arch]
    got = {k: getattr(cfg, k) for k in widths}
    check(got == widths, f"{arch} widths {got}, published {widths}")
    cfg = cfg.replace(**CROSS_DEPTH.get(arch, {}))
    fam = get_model(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = fam.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[full] {cfg.name} ({cfg.family}): "
          + " ".join(f"{k}={v}" for k, v in widths.items())
          + (f", depth cut to {CROSS_DEPTH[arch]}" if arch in CROSS_DEPTH
             else "")
          + f" {cfg.compute_dtype}: {n_params / 1e9:.3f}B params, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, fam, model


def serve_cross(arch, gpu) -> dict:
    """``serve_cross_model`` of one model of ``CROSS_ARCHS`` (``init_full``),
    which is freed after."""
    cfg, fam, model = init_full(arch)
    runs = serve_cross_model(arch, cfg, fam, model, gpu)
    del model
    torch.cuda.empty_cache()
    return runs


def serve_cross_model(arch, cfg, fam, model, gpu) -> dict:
    """One model of ``CROSS_WIDTHS`` at its published widths through ``ServeEngine.generate``,
    the batch of ``cross_batch``, 64 new tokens: the row checks
    (``check_rows``: lane 0's decode logits at widths 1/2/4/8, a prompt
    alone == in a batch == in chunks), then each cache of ``CROSS_RUNS``
    graphed and held against the eager body bit for bit with equal
    launches, held to ``_want_launches`` per kernel and body; paged tokens
    equal the dense run's (held), int8's reported; prefill timed alone, the
    graphed decode step and tokens per second printed.  Returns each run's
    launches and bodies, and its tokens."""
    from repro_torch.serve.engine import BURST

    batch, lens = cross_batch(cfg)
    max_len = int(lens.max()) + MAX_NEW
    Engine, Eager, *_ = engine_classes()
    small = {k: v[:2, :16] if k == "tokens" else v[:2]
             for k, v in batch.items() if k != "lens"}
    Engine(cfg, model, max_new_tokens=2, stop_token=-1).generate(small)
    torch.cuda.synchronize()                           # cuBLAS warm-up
    check_rows(fam, model, cfg, gpu)

    runs = {}
    steps = MAX_NEW - 1
    slots = bursts(steps) * BURST
    for name, page_size, page_dtype in CROSS_RUNS[arch]:
        kw = dict(max_new_tokens=MAX_NEW, stop_token=-1, page_dtype=page_dtype)
        eng, eager = Engine(cfg, model, **kw), Eager(cfg, model, **kw)
        run = served_graphed(cfg, eng, eager, batch, name,
                             dict(page_size=page_size), turns=False)
        want = _want_launches(cfg, page_size, page_dtype, slots)
        check(run["counts"] == want,
              f"{arch} {name} launches {run['counts']}, expected {want}")
        want = _want_bodies(cfg, page_size, page_dtype, slots)
        check(run["bodies"] == want,
              f"{arch} {name} bodies {run['bodies']}, expected {want}")
        del run["cache"], run["engine"], eng, eager
        torch.cuda.empty_cache()
        runs[name] = run
        print(f"[full] {cfg.name} generate {name}: launches "
              f"{ {k: v for k, v in run['counts'].items() if v} }, bodies "
              f"{ _nonzero(run['bodies']) } (as expected, counted across "
              f"replays; the eager body's the same)", flush=True)
    with torch.inference_mode():
        prefill = lambda: fam.prefill(model, cfg, batch,
                                      make_cache(fam, cfg, N_REQ, max_len, batch))
        prefill()
        _, prefill_s = timed(prefill)
    for name, r in runs.items():
        r.update(prefill_ms=prefill_s * 1e3,
                 decode_ms_per_step=(r["total_s"] - prefill_s) * 1e3 / steps,
                 eager_ms_per_step=(r["eager_s"] - prefill_s) * 1e3 / steps,
                 tokens_per_s=N_REQ * MAX_NEW / r["total_s"])
        print(f"[full] {cfg.name} {name}: generate {r['total_s'] * 1e3:.1f} ms "
              f"graphed, {r['eager_s'] * 1e3:.1f} ms eager, for {N_REQ}x{MAX_NEW} "
              f"tokens, prompts {lens.min()}-{lens.max()}: prefill "
              f"{r['prefill_ms']:.1f} ms (timed alone), decode "
              f"{r['decode_ms_per_step']:.2f} ms/step graphed, "
              f"{r['eager_ms_per_step']:.2f} eager, {r['tokens_per_s']:.1f} "
              f"tokens/s graphed; capture {r['capture_s']:.3f} s, graph pool "
              f"{r['pool_bytes'] / 2**20:.1f} MiB, static carry "
              f"{r['carry_bytes'] / 2**20:.1f} MiB  [{gpu}]", flush=True)
    same = float((runs["dense"]["tokens"] == runs["paged"]["tokens"]).mean())
    print(f"[full] {cfg.name} identical tokens dense vs paged: {same:.4f} "
          "(held at 1)", flush=True)
    check(same == 1.0, f"{cfg.name}: paged tokens equal the dense run's")
    if "int8" in runs:
        same = float((runs["int8"]["tokens"] == runs["paged"]["tokens"]).mean())
        print(f"[full] {cfg.name} tokens of the int8 pages equal to the "
              f"full-precision paged run: {same:.4f} (reported: quantization "
              "may change tokens)", flush=True)
    return runs


# stablelm-12b's first-step checks run on a depth cut to this many layers,
# in bf16 and in f32 (48 GB of f32 weights at full depth do not fit beside
# the 24 GB bf16 model the phase keeps for speculative decoding); at full
# depth the bf16 figure is reported: bf16 rounding grows through 40 random
# layers (0.0202 of the 2e-2 limit on an H100, every D-160 body within one
# bf16 rounding step of its plain version in ``check_kernels``)
CUT_DEPTH_12B = 8
# speculative decoding on the stablelm-12b target: new tokens per lane and
# draft tokens per round
SPEC_TOKENS, SPEC_K = 32, 4


def first_step_errs(fam, model, cfg, batch, max_len) -> dict:
    """One prefill and one decode step of the smoke batch through the
    kernels and through the plain path (``PLAIN``, on the kernel path's
    first token), and the step on a paged copy of the cache: the relative
    errors over the real vocab (logits of the expected shape, finite), and
    whether paged decode equals dense decode bit for bit."""
    from repro_torch.models import to_paged
    from repro_torch.sample import greedy_tokens

    def run(c, tok=None):
        cache = fam.make_cache(c, N_REQ, max_len, device="cuda")
        lp, cache = fam.prefill(model, c, batch, cache)
        tok = greedy_tokens(lp) if tok is None else tok
        step = {"token": tok[:, None]}
        paged = to_paged(c, {k: v.clone() for k, v in cache.items()},
                         page_size=PAGE_SIZE)
        lpg, _ = fam.decode(model, c, step, paged)
        ld, _ = fam.decode(model, c, step, cache)
        for t in (lp, ld, lpg):
            check(t.shape == (N_REQ, cfg.padded_vocab)
                  and bool(torch.isfinite(t).all()),
                  f"{c.name} first-step logits of the expected shape, finite")
        return lp, ld, lpg, tok

    with torch.inference_mode():
        fast = run(cfg)
        slow = run(cfg.replace(**PLAIN), fast[3])
    v = cfg.vocab_size
    return {"prefill kernel vs plain": rel_err(fast[0][:, :v], slow[0][:, :v]),
            "decode kernel vs plain": rel_err(fast[1][:, :v], slow[1][:, :v]),
            "paged == dense": torch.equal(fast[2], fast[1])}


def serve_stablelm_12b(gpu) -> dict:
    """stablelm-12b (head dim 160) at its published widths through
    ``serve_cross_model`` (row checks, dense / paged / int8 caches graphed
    == eager, paged == dense, launches per body), then its first step
    through the kernels against the plain path: held at ``LIMIT_BF16`` with
    bf16 weights and at ``LIMIT_F32`` with f32 weights on ``CUT_DEPTH_12B``
    layers, reported with bf16 weights at full depth; paged decode == dense
    decode bit for bit in all three.  Returns the runs, and the bf16 model
    for ``serve_speculative``."""
    arch = "stablelm_12b"
    cfg, fam, model = init_full(arch)
    runs = serve_cross_model(arch, cfg, fam, model, gpu)
    batch, lens = cross_batch(cfg)
    max_len = int(lens.max()) + MAX_NEW
    seed0 = lambda: torch.Generator(device="cuda").manual_seed(0)
    cut = f"depth cut to {CUT_DEPTH_12B} of {cfg.n_layers} layers"
    firsts = [(lambda: model, cfg, None, "bf16 weights, full depth")]
    for dt, limit in (("bfloat16", LIMIT_BF16), ("float32", LIMIT_F32)):
        c = cfg.replace(compute_dtype=dt, n_layers=CUT_DEPTH_12B)
        firsts.append((lambda c=c: fam.init(c, seed0(), "cuda"), c, limit,
                       f"{dt} weights, {cut}"))
    for make, c, limit, kind in firsts:
        m = make()
        errs = first_step_errs(fam, m, c, batch, max_len)
        del m
        torch.cuda.empty_cache()
        check(errs.pop("paged == dense"), f"{c.name} ({kind}): paged decode "
              "equals dense decode bit for bit")
        for what, e in errs.items():
            held = (f"limit {limit:g}" if limit is not None
                    else "reported, not held")
            print(f"[full] {cfg.name} first-step logits {what}: max|d|/max|ref| "
                  f"= {e:.3g} ({held}, {kind}); paged decode == dense decode "
                  f"bit for bit (held)  [{gpu}]", flush=True)
            check(limit is None or e <= limit, f"{cfg.name} first-step logits "
                  f"{what} ({kind}): {e} > {limit}")
    return dict(cfg=cfg, fam=fam, model=model, runs=runs)


def serve_speculative(s12, gpu) -> list:
    """``serve.speculative_decode`` on the full-width stablelm-12b target of
    ``serve_stablelm_12b``: the smoke's 8 prompts, ``SPEC_TOKENS`` new
    tokens a lane, ``SPEC_K`` draft tokens a round.  Greedy with the target
    as its own draft (every window accepted: mean_accepted == k, held) and
    with stablelm-12b's config cut to 2 layers, weights from seed 1, as the
    draft: both commit the target's own greedy ``generate`` tokens (the
    dense run of ``serve_stablelm_12b``) bit for bit (held).  Then the
    mixed batch (lanes 0-3 greedy, 4-7 stochastic) with the target as its
    draft, twice: the same tokens both times, and its greedy lanes the
    greedy tokens (held).  Prints each leg's rounds, mean_accepted and wall
    time; returns each leg's launches and bodies."""
    from repro_torch.serve import speculative_decode

    cfg, fam, model = s12["cfg"], s12["fam"], s12["model"]
    want = s12["runs"]["dense"]["tokens"][:, :SPEC_TOKENS]
    batch, _ = cross_batch(cfg)
    dcfg = cfg.replace(n_layers=2)
    draft = fam.init(dcfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    legs = (("greedy, the target as its draft", cfg, model, None),
            ("greedy, a 2-layer draft", dcfg, draft, None),
            ("mixed, the target as its draft", cfg, model, mixed_specs()),
            ("mixed again", cfg, model, mixed_specs()))
    out, toks = [], {}
    for name, c, m, specs in legs:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, stats = speculative_decode(
            cfg, model, c, m, batch["tokens"], lens=batch["lens"],
            n_tokens=SPEC_TOKENS, k_draft=SPEC_K, sampling=specs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks[name] = got.cpu().numpy()
        counts, bodies = read_counts(), read_bodies()
        out.append(dict(counts=counts, bodies=bodies))
        check(toks[name].shape == (N_REQ, SPEC_TOKENS)
              and (stats["n_generated"] == SPEC_TOKENS).all()
              and ((toks[name] >= 0) & (toks[name] < cfg.vocab_size)).all(),
              f"speculative {name}: every lane its {SPEC_TOKENS} tokens in the "
              "vocab")
        rows = slice(None) if specs is None else slice(0, 4)
        same = bool((toks[name][rows] == want[rows]).all())
        check(same, f"speculative {name}: the greedy lanes commit the target's "
              "greedy generate tokens")
        print(f"[spec] {cfg.name} target, {name}: {len(stats['accept_counts'])} "
              f"rounds, mean_accepted {stats['mean_accepted']:.4f} of k = "
              f"{SPEC_K}, {wall:.2f} s wall for {N_REQ}x{SPEC_TOKENS} tokens "
              f"({N_REQ * SPEC_TOKENS / wall:.1f} tokens/s); greedy lanes equal "
              f"the target's greedy generate tokens (held); launches "
              f"{ {k: v for k, v in counts.items() if v} }, bodies "
              f"{_nonzero(bodies)}  [{gpu}]", flush=True)
        if specs is None and c is cfg:
            check(stats["mean_accepted"] == SPEC_K, f"speculative {name}: a "
                  f"perfect draft accepts every window ({stats['mean_accepted']})")
    check((toks["mixed again"] == toks["mixed, the target as its draft"]).all(),
          "the seeded mixed speculative batch repeats its tokens")
    print(f"[spec] {cfg.name}: the seeded mixed batch run twice draws the same "
          f"tokens (held)", flush=True)
    del draft
    torch.cuda.empty_cache()
    return out


def encdec_workload(cfg) -> list:
    """The encdec scheduler leg's 16 requests from ``RandomState(22)``:
    source frames 256–1024, decoder prompts 8–64 tokens, budgets 16–64,
    then each prompt and its frames N(0, 1); the first 8 at step 0, then
    one every 4 decode steps; all greedy."""
    rs = np.random.RandomState(22)
    n = ENCDEC_REQ
    frames = rs.randint(256, 1025, n)
    plens = rs.randint(8, 65, n)
    budgets = rs.randint(16, 65, n)
    return [{"prompt": rs.randint(1, cfg.vocab_size, int(m)).astype(np.int32),
             "extras": {"src_emb": rs.standard_normal(
                 (int(f), cfg.d_model)).astype(np.float32)},
             "budget": int(b), "arrival": 0.0 if i < 8 else 4.0 * (i - 7),
             "sampling": None}
            for i, (f, m, b) in enumerate(zip(frames, plens, budgets))]


ENCDEC_REQ, ENCDEC_SRC_LEN, ENCDEC_CHUNK = 16, 1024, 32


def serve_encdec_scheduler(gpu) -> dict:
    """seamless-m4t-large-v2 through ``ContinuousBatchingScheduler`` at full
    width: ``encdec_workload`` on 8 lanes, bursts of 8, ``src_len`` 1024,
    on the dense cache with whole prefills and on a paged cache (16-token
    pages) with prefill chunks of 32 (the first chunk runs the encoder,
    the rest read the cached cross K/V); each leg twice (``sched_leg``:
    the warm run repeats the first run's tokens, launches held per body),
    the paged leg's tokens held to the dense leg's bit for bit, and each
    leg's tokens/s, TTFT and decode step printed.  Returns the warm runs'
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config("seamless_m4t_large_v2")
    model = get_model(cfg).init(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "cuda")
    work = encdec_workload(cfg)
    launches = {}
    legs = (("dense, whole prefills", {}),
            (f"paged, chunks of {ENCDEC_CHUNK}",
             dict(page_size=PAGE_SIZE, prefill_chunk=ENCDEC_CHUNK)))
    out = {}
    for name, kw in legs:
        eng, sched, res, log, st, counts, caps = sched_leg(
            cfg, model, work, gpu, name, src_len=ENCDEC_SRC_LEN, **kw)
        launches[f"{cfg.name} {name}"] = counts
        out[name] = res
        sched_report(cfg, name, work, res, log, sched, caps, gpu)
        if "page_size" in kw:
            check(st["prefill_chunks"] > 0, f"{cfg.name} {name}: chunked")
        del eng, sched
        torch.cuda.empty_cache()
    (a, ra), (b, rb) = out.items()
    bad = same_tokens(rb, ra)
    check(not bad, f"{cfg.name}: {b} tokens differ from {a} (requests {bad})")
    print(f"[sched] {cfg.name}: every request's tokens on the {b} leg equal "
          f"the {a} leg's bit for bit (held)", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def split_kv_held(record):
    """Inside the block every split-KV call of the dense and the paged
    kernels is also computed by the plain attention on the same inputs (the
    paged ones after the extending gather): ``record`` counts the calls per
    wrapper and keeps the largest max |d| and ``tol_ratio`` at
    ``TOL["split_kv"]``.  The attention op reaches the kernels through its
    ``_kernel`` module; the block gives it a copy whose wrappers are the
    ones below."""
    from repro_torch.core import paging as PG
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops as O
    from repro_torch.kernels.flash_attention import ref as R

    def hold(name, out, q, k, v, kv_lens, q_offset, window, causal, scale):
        want = R.mha_ref(q, k, v, kv_lens=kv_lens, causal=causal,
                         window=window, q_offset=q_offset, scale=scale)
        record["calls"][name] = record["calls"].get(name, 0) + 1
        record["abs"][name] = max(record["abs"].get(name, 0.0),
                                  float((out.float() - want.float()).abs().max()))
        record["ratio"][name] = max(record["ratio"].get(name, 0.0),
                                    tol_ratio(out, want, *TOL["split_kv"]))

    def dense(q, k, v, kv_lens, q_offset, window, *, causal, scale, decode):
        out = K.flash_dense_cuda(q, k, v, kv_lens, q_offset, window,
                                 causal=causal, scale=scale, decode=decode)
        b, hq, sq, d = q.shape
        if K.plan_dense(q.dtype, b, hq, k.shape[1], sq, k.shape[2],
                        d, decode=decode).body == K.SPLIT_KV:
            hold("flash_attention_dense", out, q, k, v, kv_lens, q_offset,
                 window, causal, scale)
        return out

    def paged(q, kp, vp, *rest, causal, scale, decode):
        quant = len(rest) == 6
        ks, vs = rest[:2] if quant else (None, None)
        table, kv_lens, q_offset, window = rest[-4:]
        fn = K.flash_paged_quant_cuda if quant else K.flash_paged_cuda
        out = fn(q, kp, vp, *rest, causal=causal, scale=scale, decode=decode)
        b, hq, sq, d = q.shape
        if K.plan_paged(q.dtype, kp.dtype, b, hq, kp.shape[1], sq,
                        table.shape[1], kp.shape[2], d,
                        decode=decode).body == K.SPLIT_KV:
            hold("flash_attention_paged_quant" if quant else
                 "flash_attention_paged", out, q, PG.gather_pages(kp, table, scale=ks),
                 PG.gather_pages(vp, table, scale=vs), kv_lens, q_offset,
                 window, causal, scale)
        return out

    O._kernel = types.SimpleNamespace(**{
        **vars(K), "flash_dense_cuda": dense, "flash_paged_cuda": paged,
        "flash_paged_quant_cuda": paged})
    try:
        yield record
    finally:
        O._kernel = K


def teacher_forced(fam, model, cfg, batch, max_len, tokens, pages, quant):
    """Teacher-forced decode of ``tokens`` (B, T) through the dense cache,
    where the family pages through a paged copy of the same prefill, and
    through a paged copy in each page dtype of ``quant``; every split-KV
    call held against the plain attention on its inputs
    (``split_kv_held``).  Returns (the split-KV record, whether the paged
    cache's logits equal the dense cache's bit for bit at every one of the
    T - 1 steps)."""
    from repro_torch.models import to_paged

    same = True
    record = {"calls": {}, "abs": {}, "ratio": {}}
    cache = fam.make_cache(cfg, N_REQ, max_len, device="cuda")
    _, cache = fam.prefill(model, cfg, batch, cache)
    copy = lambda dt: to_paged(cfg, {k: t.clone() for k, t in cache.items()},
                               page_size=PAGE_SIZE, page_dtype=dt)
    paged = copy(None) if pages else None
    narrow = {dt: copy(dt) for dt in quant}
    for t in range(tokens.shape[1] - 1):
        step = {"token": torch.as_tensor(tokens[:, t], device="cuda")[:, None]}
        with split_kv_held(record):
            dense_lg, cache = fam.decode(model, cfg, step, cache)
            if pages:
                paged_lg, paged = fam.decode(model, cfg, step, paged)
                same = same and torch.equal(paged_lg, dense_lg)
            for dt in quant:
                _, narrow[dt] = fam.decode(model, cfg, step, narrow[dt])
    return record, same


def first_token_keep_set(fam, model, cfg, batch, cache, first, gpu):
    """The stochastic lanes' first tokens (sampled from the prefill logits
    with the kernel) against the plain path on the same logits: each lies
    in the keep set that the plain path computes (held), and equals the
    plain path's own draw with the same keys (reported: the two scans are
    bitwise equal, so only a different prefill could move it)."""
    from repro_torch import sample as S

    with torch.inference_mode():
        logits, _ = fam.prefill(model, cfg, batch, cache)
        state = S.lane_state(mixed_specs(), N_REQ, device="cuda")
        split, sub = S.split_keys(state)
        with plain_fadda():
            masked = S.process_logits(logits, split)
        keep = masked > float("-inf")
        draw = S.gumbel_argmax(masked, sub)
    rows = torch.arange(N_REQ, device="cuda")
    first_t = torch.as_tensor(first, device="cuda").long()
    in_keep = keep[rows, first_t].cpu().numpy()
    check(in_keep[4:].all(), f"{cfg.name}: first tokens of the stochastic lanes "
          f"in the plain path's keep set ({in_keep.tolist()})")
    same = (draw.cpu().numpy() == np.asarray(first))[4:]
    sizes = keep[4:].sum(dim=-1).tolist()
    print(f"[full] {cfg.name} mixed batch: stochastic first tokens in the plain "
          f"path's keep set (held; keep sets of {sizes} tokens), equal to the "
          f"plain path's draw: {same.tolist()} (reported)", flush=True)


def profile_sampler(cfg, gpu, steps: int = 4):
    """One sampling step of the mixed batch at (8, padded_vocab) bf16 logits,
    with penalties over 32 generated tokens, beside the greedy argmax and
    split into its parts: device launches and time (torch.profiler), and
    wall time on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import sample as S
    from repro_torch.sample import processors as PR
    from repro_torch.sample import prng

    gen = torch.Generator(device="cuda").manual_seed(12)
    v = cfg.padded_vocab
    logits = (torch.randn(N_REQ, v, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    state = S.lane_state(mixed_specs(), N_REQ, device="cuda")
    out_buf = torch.randint(0, cfg.vocab_size, (N_REQ, MAX_NEW), generator=gen,
                            device="cuda", dtype=torch.int32)
    n_gen = torch.full((N_REQ,), MAX_NEW // 2, dtype=torch.int32, device="cuda")
    scaled = PR.temperature_scale(logits, state["temperature"])
    parts = {
        "stochastic sample": lambda: S.sample(logits, state, out_buf, n_gen),
        "greedy argmax": lambda: S.greedy_tokens(logits),
        "  threefry: split + gumbel": lambda: prng.gumbel(
            S.split_keys(state)[1], (v,)),
        "  penalties": lambda: PR.apply_penalties(
            logits, out_buf, n_gen, state["repetition_penalty"],
            state["presence_penalty"]),
        "  keep_pred (softmax, argsort, fadda scan)": lambda: PR.keep_pred(
            scaled, state["top_k"], state["top_p"], state["min_p"]),
    }
    with torch.inference_mode():
        for name, fn in parts.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    fn()
                torch.cuda.synchronize()
            dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
            what = (f"{len(dev) / steps:.0f} launches, device {dev_ms:.3f} ms" if dev
                    else "device time not measured (the profiler saw no device "
                         "events)")
            print(f"[profile] {cfg.name} sampling step, {name}: {what}, wall "
                  f"{wall_ms:.3f} ms  [{gpu}]", flush=True)


def profile_decode(model, cfg, name, cache, last_tok, gpu, steps: int = 4,
                   sampling=None):
    """Where a decode step's time goes: its wall time (host clock, no
    profiler) against the device time of the kernels it launches
    (torch.profiler), and the kernels that take most of that.  With
    ``sampling`` each step also samples its tokens with that lane state, as
    a stochastic batch's decode loop does (penalties over 32 tokens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import sample as S
    from repro_torch.models import get_model

    decode = get_model(cfg).decode
    step = {"token": torch.as_tensor(last_tok, device="cuda")[:, None]}
    if sampling is not None:
        state = S.lane_state(sampling, N_REQ, device="cuda")
        out_buf = torch.as_tensor(np.asarray(last_tok), device="cuda").to(
            torch.int32)[:, None].repeat(1, MAX_NEW)
        n_gen = torch.full((N_REQ,), MAX_NEW // 2, dtype=torch.int32, device="cuda")

    def run():
        c = cache
        for _ in range(steps):
            logits, c = decode(model, cfg, step, c)
            if sampling is not None:
                S.sample(logits, state, out_buf, n_gen)
        torch.cuda.synchronize()

    with torch.inference_mode():
        run()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    by_name = {}
    # host calls that wait for the device (one is run()'s own synchronize)
    syncs = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
                and ("Synchronize" in e.name or e.name == "cudaMemcpy"))
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        print(f"[profile] {cfg.name} {name} decode step: wall {wall_ms:.2f} ms; device "
              f"time not measured (the profiler saw no device events)  [{gpu}]",
              flush=True)
        return
    dev_ms = sum(us for _, us in by_name.values()) / 1e3 / steps
    n_kern = sum(n for n, _ in by_name.values()) / steps
    print(f"[profile] {cfg.name} {name} decode step: wall {wall_ms:.2f} ms, device "
          f"kernels {dev_ms:.2f} ms ({n_kern:.0f} launches), device idle "
          f"{1 - dev_ms / wall_ms:.1%}, {syncs} host waits in {steps} steps  "
          f"[{gpu}]", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for kname, (n, us) in top:
        print(f"[profile]   {us / 1e3 / steps:8.3f} ms/step {n // steps:5d}x "
              f"{kname[:90]}", flush=True)


# ---------------------------------------------------------------------------
# phase 3b: continuous batching through ContinuousBatchingScheduler
# ---------------------------------------------------------------------------

# the phase's traffic: 32 requests on 8 lanes, bursts of 8 decode steps,
# compaction below half occupancy, lanes of 1088 tokens
SCHED_REQ, SCHED_CAP, SCHED_CHUNK, SCHED_MAX_LEN = 32, 8, 8, 1088
# first-token logits across prefill layouts: one bf16 rounding step
SCHED_LOGIT_TOL = (1e-5, 2 ** -7)
# the paged leg's host-swap store, in pages of 16 tokens (5.2 MB each at
# stablelm-3b): 16384 tokens.  A second turn waits in the queue behind the
# requests that arrived before it, and those spill their pages meanwhile:
# a store of 64 pages had evicted its first turn's pages by then and held
# no session
SCHED_SWAP_PAGES = 1024


def sched_workload(vocab: int) -> list:
    """The phase's requests, one dict each: prompt lengths and budgets from
    ``np.random.RandomState(20)`` (lengths 128–1024, then budgets 16–64),
    then the prompts from the same generator; the first 8 arrive at step 0,
    the rest one every 4 decode steps; requests 4k+2 and 4k+3 sample
    (``mixed_specs``' distribution, seed 100 + i), the rest are greedy."""
    import dataclasses
    rs = np.random.RandomState(20)
    lens = rs.randint(128, 1025, SCHED_REQ)
    budgets = rs.randint(16, 65, SCHED_REQ)
    spec = mixed_specs()[4]
    return [{"prompt": rs.randint(1, vocab, int(n)).astype(np.int32),
             "budget": int(b), "arrival": 0.0 if i < 8 else 4.0 * (i - 7),
             "sampling": (dataclasses.replace(spec, seed=100 + i)
                          if i % 4 in (2, 3) else None)}
            for i, (n, b) in enumerate(zip(lens, budgets))]


class _PrefillRecorder:
    """A family module whose ``prefill`` counts its calls and, when
    ``keep``, keeps each call's tokens, lens, pos0 and logits on the card
    (no host read); every other name is the family's."""

    def __init__(self, fam, keep: bool):
        self.fam, self.keep, self.calls, self.rows = fam, keep, 0, []
        self.enc_calls = 0                  # calls that ran an encoder

    def __getattr__(self, name):
        return getattr(self.fam, name)

    def prefill(self, model, cfg, batch, cache):
        logits, cache = self.fam.prefill(model, cfg, batch, cache)
        self.calls += 1
        self.enc_calls += "src_emb" in batch
        if self.keep:
            toks = batch["tokens"]
            pos0 = batch.get("pos0")
            self.rows.append((toks.clone(), batch["lens"].clone(),
                              torch.zeros_like(batch["lens"]) if pos0 is None
                              else pos0.clone(), logits.float()))
        return logits, cache

    def first_logits(self, prompt):
        """The logits of the first prefill row kept that ended on
        ``prompt``'s last token (the whole prompt, the suffix after a
        shared prefix, or the last chunk) and its call's tokens' shape, or
        (None, None)."""
        n = len(prompt)
        for toks, lens, pos0, logits in self.rows:
            lens_h, pos0_h = lens.cpu().numpy(), pos0.cpu().numpy()
            for r in np.flatnonzero(lens_h + pos0_h == n):
                a, m = int(pos0_h[r]), int(lens_h[r])
                if np.array_equal(toks[r, :m].cpu().numpy(), prompt[a:a + m]):
                    return logits[r], tuple(toks.shape)
        return None, None


def sched_engine(cfg, model, keep=False, **kw):
    """A ServeEngine for the phase (stop token -1: every request decodes
    its whole budget), its family module wrapped in ``_PrefillRecorder`` and its bursts
    counted (``bursts``, with each one's lane width in ``widths``)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1, **kw)
    eng.model = _PrefillRecorder(eng.model, keep)
    burst, eng.bursts, eng.widths = eng._decode_chunk, 0, []

    def counted(*args, **kwargs):
        eng.bursts += 1
        eng.widths.append(kwargs.get("width") or SCHED_CAP)
        return burst(*args, **kwargs)
    eng._decode_chunk = counted
    return eng


def new_sched(eng, **kw):
    from repro_torch.serve import ContinuousBatchingScheduler
    return ContinuousBatchingScheduler(
        eng, capacity=SCHED_CAP, max_len=SCHED_MAX_LEN, chunk=SCHED_CHUNK,
        compact_threshold=0.5, **kw)


_ROUND_KEYS = ("decode_steps", "prefill_chunks", "compactions",
               "prefill_tokens", "dispatches", "host_syncs")


def drive(sched, work, follow=None, window=None, monkey=None):
    """Serve ``work`` through ``sched`` until drained.  Every request is
    submitted at the start with its arrival (and its ``priority`` and
    ``deadline`` where the entry has them), except each ``follow`` entry
    ``i: (j, extra)``: request i, the second turn of request j (j's prompt,
    its output and ``extra``), submitted once j's result is in, arriving
    then.  With ``monkey`` (a ``ChaosMonkey`` installed on ``sched``) its
    between-round faults run after every round; an overlap stash is flushed
    at the end.  Each round is timed on the host clock (a round ends with its
    harvest's read of the device) with its stats' deltas.  A request
    arrives at the end of the round after which the scheduler's clock has
    passed its arrival, and its first token is stamped at the end of the
    round that committed it (after that round's sync) — under overlap at
    the end of the next round, whose sync waits for it: TTFT is the
    difference.  ``window`` (first, last) rounds run under torch.profiler
    (device events).  Returns the results by request index and the log."""
    from torch.profiler import ProfilerActivity, profile
    follow = follow or {}
    rid_of, arrived, prompts = {}, {}, {}

    def submit(i, prompt, arrival):
        w = work[i]
        prompts[i] = prompt
        rid_of[i] = sched.submit(prompt, max_new_tokens=w["budget"],
                                 arrival=arrival, sampling=w["sampling"],
                                 priority=w.get("priority", 0),
                                 deadline=w.get("deadline"),
                                 extras=w.get("extras"))

    for i, w in enumerate(work):
        if i not in follow:
            submit(i, w["prompt"], w["arrival"])
    st = sched.stats
    log = {"rounds": [], "first": {}, "prompts": prompts, "done": set()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, req in sched._live_req.items():
        if req.arrival <= sched.now:
            arrived[rid] = t0
    prof, k, late, late_seen = None, 0, [], set()
    while sched.queue or sched._preempted or (sched.lane_rid >= 0).any():
        if window is not None and k == window[0]:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            tp = time.perf_counter()
        before = [st[q] for q in _ROUND_KEYS]
        resident = set(sched.lane_rid[sched.lane_rid >= 0].tolist())
        nb = len(sched.engine.widths)
        ts = time.perf_counter()
        sched.step()
        if monkey is not None:
            monkey.on_round(sched)
        te = time.perf_counter()
        d = {q: st[q] - b for q, b in zip(_ROUND_KEYS, before)}
        resident |= set(sched.lane_rid[sched.lane_rid >= 0].tolist())
        resident |= {rid for rid in sched.results if rid not in log["done"]}
        log["done"].update(sched.results)
        d.update(ms=(te - ts) * 1e3, admit=bool(sched._round_admitted)
                 or d["prefill_chunks"] > 0, resident=resident,
                 narrow=any(w < SCHED_CAP for w in sched.engine.widths[nb:]))
        log["rounds"].append(d)
        for rid in late:                        # overlap: synced this round
            log["first"][rid] = te
        late = []
        for rid, t in sched.req_times.items():
            if "first_token" in t and rid not in log["first"] \
                    and rid not in late_seen:
                if sched.overlap:
                    late.append(rid)
                    late_seen.add(rid)
                else:
                    log["first"][rid] = te
        for i, (j, extra) in follow.items():
            if i not in rid_of and rid_of.get(j) in sched.results:
                prev = sched.results[rid_of[j]]["tokens"]
                submit(i, np.concatenate([prompts[j], prev, extra]).astype(
                    np.int32), max(work[i]["arrival"], sched.now))
        for rid, req in sched._live_req.items():
            if rid not in arrived and req.arrival <= sched.now:
                arrived[rid] = te
        k += 1
        if prof is not None and (k == window[1] or not (
                sched.queue or (sched.lane_rid >= 0).any())):
            torch.cuda.synchronize()
            log["window_ms"] = (time.perf_counter() - tp) * 1e3
            prof.__exit__(None, None, None)
            log["prof"], log["window_rounds"], prof = prof, k - window[0], None
    sched._flush_stash()
    te = time.perf_counter()
    for rid in late:
        log["first"][rid] = te
    log["wall_s"] = te - t0
    res = {i: sched.results[rid] for i, rid in rid_of.items()}
    log["ttft_ms"] = sorted((log["first"][rid] - arrived[rid]) * 1e3
                            for rid in rid_of.values()
                            if rid in log["first"] and rid in arrived)
    log["rid_of"] = rid_of
    narrowed = set().union(*(r["resident"] for r in log["rounds"]
                             if r["narrow"]))
    log["narrowed"] = {i for i, rid in rid_of.items() if rid in narrowed}
    return res, log


def sched_served(cfg, work, res, name) -> None:
    """Every request decoded its whole budget (stop token -1) into token ids
    of the vocab (held)."""
    for i, r in sorted(res.items()):
        check(r["n_generated"] == work[i]["budget"]
              and r["finish_reason"].value == "done",
              f"{cfg.name} {name}: request {i} n_generated {r['n_generated']}"
              f" of {work[i]['budget']} ({r['finish_reason'].value})")
        t = r["tokens"]
        check(((t >= 0) & (t < cfg.vocab_size)).all(),
              f"{cfg.name} {name}: request {i} token ids in the vocab")


def same_tokens(a, b, idx=None) -> list:
    """Request indices whose tokens differ between two results."""
    idx = sorted(a) if idx is None else idx
    return [i for i in idx if a[i]["tokens"].tobytes() != b[i]["tokens"].tobytes()
            or a[i]["n_generated"] != b[i]["n_generated"]]


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def round_anatomy(log) -> dict:
    """A run's rounds by kind: the decode step's ms in rounds that only
    decode (round wall over the steps they ran), and what an admission and
    a compaction round cost above their decode steps at that rate."""
    rounds = log["rounds"]
    dec = [r for r in rounds if r["dispatches"] and not r["admit"]
           and not r["compactions"]]
    adm = [r for r in rounds if r["admit"]]
    comp = [r for r in rounds if r["compactions"]]
    steps = sum(r["decode_steps"] for r in dec)
    step_ms = sum(r["ms"] for r in dec) / steps if steps else float("nan")
    extra = lambda rs: [r["ms"] - r["decode_steps"] * step_ms for r in rs]
    n = len(rounds)
    return {"rounds": n, "decode_rounds": len(dec), "step_ms": step_ms,
            "admit_rounds": len(adm),
            "admit_ms": statistics.mean(extra(adm)) if adm else 0.0,
            "admit_tokens": (statistics.mean(r["prefill_tokens"] for r in adm)
                             if adm else 0.0),
            "compact_rounds": len(comp),
            "compact_ms": statistics.mean(extra(comp)) if comp else 0.0,
            "syncs_per_round": sum(r["host_syncs"] for r in rounds) / n,
            "dispatches": sum(r["dispatches"] for r in rounds)}


def window_profile(log) -> dict:
    """The device's idle share over the profiled rounds (one minus the
    union of its events' intervals over the window's wall) and its
    host-to-device copies per round."""
    from torch.autograd import DeviceType
    if "prof" not in log:
        return {}
    dev = [e for e in log["prof"].events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"idle": None}
    n = log["window_rounds"]
    return {"idle": 1 - busy_ms(dev) / log["window_ms"],
            "h2d_per_round": sum("HtoD" in e.name for e in dev) / n,
            "window_rounds": n, "window_ms": log["window_ms"]}


def splice_costs(cfg, eng, sched, gpu) -> dict:
    """The device side of an admission round's splices and of a
    compaction, at the scheduler's cache: ms by CUDA events of the one-row
    sub-cache's zeros, ``slot_update`` of one lane, the copy into the
    graphs' carry that the next burst makes, and ``gather_lanes`` of a
    compaction; bytes each moves by its definition (every tensor read and
    written once, ``set_lanes`` copying the tensor twice)."""
    from repro_torch.models import gather_lanes, slot_update
    cache = sched.cache
    axes = eng.model.cache_batch_axes(cfg)
    lane_keys = [k for k in cache if k in axes and k != "page_table"]
    big = sum(cache[k].numel() * cache[k].element_size() for k in lane_keys)
    sub = eng.make_cache(1, sched.max_len)
    sub_b = sum(sub[k].numel() * sub[k].element_size() for k in lane_keys)
    lanes = torch.tensor([3], device="cuda")
    perm = torch.tensor([1, 0] + list(range(2, SCHED_CAP)), device="cuda")
    dst = {k: cache[k].clone() for k in lane_keys}

    def event_ms(fn, reps=3):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    with torch.inference_mode():
        zeros_ms = event_ms(lambda: eng.make_cache(1, sched.max_len))
        splice_ms = event_ms(lambda: slot_update(cfg, cache, lanes, sub))
        carry_ms = event_ms(lambda: [dst[k].copy_(cache[k]) for k in lane_keys])
        gather_ms = event_ms(lambda: gather_lanes(cfg, cache, perm))
    out = {"cache_bytes": big, "zeros_ms": zeros_ms, "zeros_bytes": sub_b,
           "splice_ms": splice_ms, "splice_bytes": 4 * big + 2 * sub_b,
           "carry_ms": carry_ms, "carry_bytes": 2 * big,
           "gather_ms": gather_ms, "gather_bytes": 2 * big}
    del dst, sub
    torch.cuda.empty_cache()
    return out


def _want_sched(cfg, eng) -> tuple:
    """Each kernel's launches in a bf16 scheduler run, and the bodies that
    can be stated: every prefill call (an admission or a chunk, counted by
    ``_PrefillRecorder``) launches the dense flash kernel once per attention
    layer on its tensor-core body, whatever its row count, and the SSD scan
    once per Mamba layer on its tensor-core body; every burst (counted by
    ``sched_engine``) runs ``SCHED_CHUNK`` steps, each launching the decode
    kernel's split-KV body once per attention layer; MoE layers rank once
    per prefill call and decode step; no call runs a CUDA-core body.
    ``fadda`` depends on the sampled steps and is not stated.  encdec runs
    its encoder only in the prefill calls that carry ``src_emb`` (an
    admission, a request's first chunk), and each decode step's cross
    attention on the dense kernel's split-KV body.  Returns (launches,
    decode kernel, its decode launches, the cross decode launches)."""
    pre, attn, cross = _attn_calls(cfg)
    calls = eng.model.calls
    steps = SCHED_CHUNK * eng.bursts
    decode = ("flash_attention_dense" if eng.paged is None else
              "flash_attention_paged_quant" if eng.page_dtype else
              "flash_attention_paged")
    want = dict.fromkeys(kernel_wrappers(), 0)
    if cfg.family == "encdec":
        want["flash_attention_dense"] = ((pre - cfg.n_enc_layers) * calls
                                         + cfg.n_enc_layers * eng.model.enc_calls)
    else:
        want["flash_attention_dense"] = pre * calls
    want["flash_attention_dense"] += cross * steps
    want[decode] += attn * steps
    if cfg.family in ("ssm", "hybrid"):
        want["ssd_scan"] = cfg.n_layers * calls
    if cfg.family == "moe":
        want["moe_positions"] = (cfg.n_layers - cfg.first_k_dense) * (
            calls + steps)
    return want, decode, attn * steps, cross * steps


def _held_bodies(bodies, want, decode, decode_launches, cross=0) -> bool:
    """The bodies ``_want_sched`` states: no CUDA-core body; every prefill
    call of the dense kernel on the tensor-core body; the decode kernel's
    split-KV launches those of the bursts, and the dense kernel's the
    cross-attention decode's; the SSD scan all on its tensor-core body."""
    if any(b.get("cuda_core", 0) for b in bodies.values()):
        return False
    dense = bodies["flash_attention_dense"]
    own = decode_launches if decode == "flash_attention_dense" else 0
    return (dense["tensor_core"] == want["flash_attention_dense"] - own - cross
            and dense["split_kv"] == own + cross
            and bodies[decode]["split_kv"] == decode_launches + (
                cross if decode == "flash_attention_dense" else 0)
            and bodies["ssd_scan"]["tensor_core"] == want["ssd_scan"])


def sched_report(cfg, name, work, res, log, sched, captures, gpu, extra=""):
    """The leg's numbers on one line (host clock unless named), and the
    host time in each span of its trace."""
    a = round_anatomy(log)
    st = sched.stats
    toks = sum(r["n_generated"] for r in res.values())
    occ = st["occupancy_trace"]
    print(f"[sched] {cfg.name} {name}: {len(res)} requests, {toks} tokens in "
          f"{log['wall_s']:.3f} s = {toks / log['wall_s']:.1f} tokens/s (wall, "
          f"prefill included, graphs warm); TTFT p50 {_pct(log['ttft_ms'], 50):.1f}"
          f" / p90 {_pct(log['ttft_ms'], 90):.1f} ms (stamped after the round's "
          f"sync); decode {a['step_ms']:.3f} ms/step in the {a['decode_rounds']} "
          f"rounds without admission; {a['rounds']} rounds, {st['dispatches']} "
          f"dispatches, {st['host_syncs']} host syncs ({a['syncs_per_round']:.2f}"
          f" a round); mean occupancy {sum(occ) / max(len(occ), 1):.3f}, "
          f"{st['compactions']} compactions, {st['prefix_hits']} prefix hits, "
          f"{st['session_hits']} session hits, {st['prefill_chunks']} prefill "
          f"chunks; {a['admit_rounds']} admission rounds at +{a['admit_ms']:.2f}"
          f" ms above their decode steps ({a['admit_tokens']:.0f} prefill tokens"
          f" each), {a['compact_rounds']} compaction rounds at "
          f"+{a['compact_ms']:.2f} ms; {len(captures)} captures, "
          f"{sum(s for _, s in captures):.2f} s ({captures}){extra}  [{gpu}]",
          flush=True)
    if sched.obs.tracing:
        print(f"[sched] {cfg.name} {name}: host ms in each span over the run "
              f"(traced): {span_ms(sched.obs)}  [{gpu}]", flush=True)
    return a


def sched_leg(cfg, model, work, gpu, name, *, keep=False, follow=None,
              engine_kw=None, obs=None, **sched_kw):
    """One leg: a first run (its bursts capture their graphs), then the
    same traffic again on warm graphs (traced into ``obs``, a fresh tracer
    by default), counted and timed; both held to their budgets in vocab
    ids, and to the same tokens.  Returns the engine, the warm run's scheduler, results,
    log, stats, counts and the captures."""
    from repro_torch.obs import Obs, Tracer
    eng = sched_engine(cfg, model, keep=keep, **(engine_kw or {}))
    eng.paged = sched_kw.get("page_size")
    res1, _ = drive(new_sched(eng, **sched_kw), work, follow)
    sched_served(cfg, work, res1, f"{name} (first run)")
    captures = [((g.kw["stochastic"], g.kw["width"] or SCHED_CAP),
                 round(g.capture_s, 3)) for g in eng.graphs.values()]
    eng.model.calls = eng.bursts = eng.model.enc_calls = 0
    obs = obs if obs is not None else Obs(tracer=Tracer())
    sched = new_sched(eng, obs=obs, **sched_kw)
    reset_counts()
    res, log = drive(sched, work, follow)
    counts, bodies = read_counts(), read_bodies()
    sched_served(cfg, work, res, name)
    bad = same_tokens(res, res1)
    check(not bad, f"{cfg.name} {name}: the warm run repeats the first run's "
          f"tokens (requests {bad} differ)")
    st = dict(sched.stats)
    want, decode, decode_launches, cross = _want_sched(cfg, eng)
    print(f"[sched] {cfg.name} {name}: launches "
          f"{ {k: v for k, v in counts.items() if v} }, bodies "
          f"{_nonzero(bodies)} ({eng.model.calls} prefill calls, "
          f"{eng.bursts} bursts of {SCHED_CHUNK}); the warm run repeats the "
          f"first run's tokens (held)", flush=True)
    check({k: v for k, v in counts.items() if k != "fadda"}
          == {k: v for k, v in want.items() if k != "fadda"}
          and _held_bodies(bodies, want, decode, decode_launches, cross),
          f"{cfg.name} {name}: launches {counts} bodies {_nonzero(bodies)}, "
          f"expected {want} ({decode_launches} of {decode} by the bursts)")
    if any(w["sampling"] is not None for w in work):
        check(counts["fadda"] > 0, f"{cfg.name} {name}: sampled lanes ran fadda")
    if sched.page_size is not None:
        check(sched.allocator.live_pages == 0
              and (sched.allocator.refcount == 0).all(),
              f"{cfg.name} {name}: no page leaked")
    return eng, sched, res, log, st, counts, captures


# the control-plane leg: the phase's first 16 requests and 4 second turns
# (the paged leg's 16-19) on a pool of 192 pages of 16 tokens, a fifth of
# what 8 lanes of 1088 tokens hold, so pages run short; every 3rd request
# at priority 5, every 4th from 1 with a finish deadline of its arrival
# plus half its budget, a queue of at most 14 (the last 2 of the 16 are
# shed at submit) and a seeded chaos schedule
CP_REQ, CP_POOL, CP_MAX_QUEUE = 16, 192, 14
CP_CHAOS = dict(seed=21, alloc_fail_rate=0.05, cancel_rate=0.004,
                swap_corrupt_rate=0.5)


def overlap_leg(cfg, eng, work, dense_res, dense_log, dense_a, gpu) -> dict:
    """The dense leg's traffic with ``overlap=True`` on the dense leg's
    engine (its graphs warm): a first run (a width the dense leg never ran
    captures its graph), then a warm run, traced as the dense leg's was,
    counted and timed.  Held: both runs' tokens equal the non-overlap dense
    leg's for every request, bit for bit; one counted host sync a round
    (the harvest of the round before) plus the final flush; the launches
    per kernel and body.  Prints its numbers beside the dense leg's.
    Returns the warm run's launches."""
    from repro_torch.obs import Obs, Tracer
    before = set(eng.graphs)
    res1, _ = drive(new_sched(eng, overlap=True), work)
    captures = [((g.kw["stochastic"], g.kw["width"] or SCHED_CAP),
                 round(g.capture_s, 3)) for k, g in eng.graphs.items()
                if k not in before]
    eng.model.calls = eng.bursts = 0
    sched = new_sched(eng, overlap=True, obs=Obs(tracer=Tracer()))
    reset_counts()
    res, log = drive(sched, work)
    counts, bodies = read_counts(), read_bodies()
    sched_served(cfg, work, res, "dense overlap")
    bad1, bad = same_tokens(res1, dense_res), same_tokens(res, dense_res)
    check(not bad1 and not bad, f"{cfg.name} overlap == non-overlap, bit for "
          f"bit (first run: requests {bad1} differ; warm run: {bad})")
    st = sched.stats
    check(st["host_syncs"] == st["dispatches"] <= st["steps"] + 1,
          f"{cfg.name} overlap: one host sync a round plus the flush "
          f"({st['host_syncs']} syncs, {st['dispatches']} dispatches, "
          f"{st['steps']} rounds)")
    want, decode, decode_launches, cross = _want_sched(cfg, eng)
    check({k: v for k, v in counts.items() if k != "fadda"}
          == {k: v for k, v in want.items() if k != "fadda"}
          and _held_bodies(bodies, want, decode, decode_launches, cross),
          f"{cfg.name} overlap: launches {counts} bodies {_nonzero(bodies)}, "
          f"expected {want}")
    a = sched_report(cfg, "dense overlap", work, res, log, sched, captures,
                     gpu)
    toks = sum(r["n_generated"] for r in res.values())
    toks_d = sum(r["n_generated"] for r in dense_res.values())
    print(f"[sched] {cfg.name} overlap against the dense leg (same call, "
          f"host clock): {toks / log['wall_s']:.1f} against "
          f"{toks_d / dense_log['wall_s']:.1f} tokens/s; TTFT p50 "
          f"{_pct(log['ttft_ms'], 50):.1f} / p90 {_pct(log['ttft_ms'], 90):.1f}"
          f" against {_pct(dense_log['ttft_ms'], 50):.1f} / "
          f"{_pct(dense_log['ttft_ms'], 90):.1f} ms; decode "
          f"{a['step_ms']:.3f} against {dense_a['step_ms']:.3f} ms a step; "
          f"{st['host_syncs']} host syncs in {st['steps']} rounds; every "
          f"request's tokens equal the dense leg's (held)  [{gpu}]",
          flush=True)
    return counts


def control_plane_work(work, follow):
    """The control-plane leg's requests and second turns (``CP_REQ``)."""
    out = []
    for i, w in enumerate(work[:CP_REQ + 4]):
        w = dict(w)
        if i % 3 == 0:
            w["priority"] = 5
        if i % 4 == 1:
            w["deadline"] = w["arrival"] + w["budget"] // 2
        out.append(w)
    return out, {i: follow[i] for i in range(CP_REQ, CP_REQ + 4)}


def control_plane_leg(cfg, model, work, follow, dense_res, paged_res,
                      paged_log, gpu) -> dict:
    """The request control plane on the card: stablelm-3b paged (pages of
    16, prefix sharing, host swap, prefill chunks of 256), ``overlap=True``,
    the ``control_plane_work`` traffic under ``CP_CHAOS``, run twice from
    the same seed.  Held: preemptions, sheds, cancels, deadline misses and
    swap checksum failures all > 0; no page leaked; every request has a
    finish reason; every request that finished done or preempted_resumed
    has the dense leg's tokens bit for bit (a second turn the paged leg's,
    where its prompt is that leg's), and a cancelled or deadline request a
    prefix of them; the two runs' results, stats and faults equal; the
    launches per kernel and body.  Returns the second run's launches."""
    from repro_torch.obs import Obs, Tracer
    from repro_torch.serve.chaos import ChaosConfig, ChaosMonkey
    work_c, follow_c = control_plane_work(work, follow)
    eng = sched_engine(cfg, model)
    eng.paged = PAGE_SIZE
    kw = dict(page_size=PAGE_SIZE, pool_pages=CP_POOL,
              host_swap_pages=SCHED_SWAP_PAGES, prefill_chunk=256,
              overlap=True, max_queue=CP_MAX_QUEUE)
    runs = []
    for k in range(2):
        eng.model.calls = eng.bursts = 0
        sched = new_sched(eng, obs=Obs(tracer=Tracer()), **kw)
        monkey = ChaosMonkey(ChaosConfig(**CP_CHAOS)).install(sched)
        reset_counts()
        res, log = drive(sched, work_c, follow_c, monkey=monkey)
        runs.append((sched, monkey, res, log, read_counts(), read_bodies()))
    (s1, m1, r1, _, _, _), (sched, monkey, res, log, counts, bodies) = runs
    st = dict(sched.stats)
    fired = {k: st[k] for k in ("preemptions", "shed", "cancelled",
                                "deadline_misses", "swap_checksum_failures")}
    check(all(fired.values()), f"{cfg.name} control plane: every mechanism "
          f"fired ({fired})")
    check(sched.allocator.live_pages == 0
          and (sched.allocator.refcount == 0).all(),
          f"{cfg.name} control plane: no page leaked")
    reasons = {i: r["finish_reason"].value for i, r in res.items()}
    check(sorted(res) == sorted(range(len(work_c))),
          f"{cfg.name} control plane: every request has a result ({reasons})")
    ref = {i: dense_res[i] for i in res if i < CP_REQ}
    ref.update({i: paged_res[i] for i in res if i >= CP_REQ and np.array_equal(
        log["prompts"][i], paged_log["prompts"][i])})
    whole = [i for i in ref if reasons[i] in ("done", "preempted_resumed")]
    bad = [i for i in whole if res[i]["tokens"].tobytes()
           != ref[i]["tokens"].tobytes()]
    cut = [i for i in ref if reasons[i] in ("cancelled", "deadline")]
    bad_cut = [i for i in cut if res[i]["tokens"].tobytes()
               != ref[i]["tokens"][:res[i]["n_generated"]].tobytes()]
    check(not bad and not bad_cut, f"{cfg.name} control plane: requests "
          f"{bad} (whole) and {bad_cut} (partial) left the reference tokens")
    check(not same_tokens(res, r1)
          and {i: r["finish_reason"] for i, r in r1.items()}
          == {i: r["finish_reason"] for i, r in res.items()}
          and dict(s1.stats) == st
          and (m1.alloc_failures, m1.cancels, m1.corruptions)
          == (monkey.alloc_failures, monkey.cancels, monkey.corruptions),
          f"{cfg.name} control plane: two runs from one seed agree")
    want, decode, decode_launches, cross = _want_sched(cfg, eng)
    check({k: v for k, v in counts.items() if k != "fadda"}
          == {k: v for k, v in want.items() if k != "fadda"}
          and _held_bodies(bodies, want, decode, decode_launches, cross),
          f"{cfg.name} control plane: launches {counts} bodies "
          f"{_nonzero(bodies)}, expected {want}")
    resumed = [i for i in whole if reasons[i] == "preempted_resumed"]
    print(f"[sched] {cfg.name} control plane: {len(work_c)} requests "
          f"({CP_REQ} + 4 second turns) on a pool of {CP_POOL} pages, overlap, "
          f"max_queue {CP_MAX_QUEUE}, chaos {CP_CHAOS}: {fired}, "
          f"{st['resume_page_ins']} pages resumed, {st['page_waits']} page "
          f"waits; faults injected: {monkey.alloc_failures} alloc failures, "
          f"{monkey.cancels} cancels, {monkey.corruptions} corruptions; "
          f"finish reasons {reasons}; {len(whole)} whole requests ({resumed} "
          f"resumed) equal their reference tokens and {len(cut)} cut ones a "
          f"prefix of them, bit for bit; {len(res) - len(ref)} second turns "
          f"without a reference prompt; no page leaked; two runs from one "
          f"seed agree (all held); {len(log['rounds'])} rounds in "
          f"{log['wall_s']:.3f} s, {st['host_syncs']} host syncs  [{gpu}]",
          flush=True)
    del eng, runs
    torch.cuda.empty_cache()
    return counts


def span_ms(obs) -> dict:
    """Host milliseconds in each span of a tracer's serve-loop track, by
    name, summed over the run (a span includes the spans nested in it)."""
    out, stack = collections.Counter(), []
    for e in obs.tracer.events:
        if e.get("pid") != 1:
            continue
        if e["ph"] == "B":
            stack.append((e["name"], e["ts"]))
        elif e["ph"] == "E" and stack:
            name, ts = stack.pop()
            out[name] += (e["ts"] - ts) / 1e3
    return {k: round(v, 1) for k, v in out.items()}


def _events_by_rid(obs) -> dict:
    """Each request's lifecycle events in a tracer: rid -> [(name, args)]."""
    out = collections.defaultdict(list)
    for e in obs.tracer.events:
        if e.get("pid") == 2 and e.get("ph") == "i":
            out[e["tid"]].append((e["name"], e.get("args", {})))
    return out


def serve_scheduler(gpu) -> dict:
    """The continuous-batching scheduler on the card at full width (depth
    cut to ``SERVE_DEPTH``): the
    ``sched_workload`` traffic through four legs (stablelm-3b dense and
    paged with prefix sharing, host swap and chunked prefill, zamba2-1.2b
    paged int8 with chunked prefill, olmoe-1b-7b dense), each held to its
    budgets in vocab ids, its launches per body, and its numbers printed.
    Returns each leg's launches (its warm run's)."""
    from repro_torch.models import get_model
    from repro_torch.obs import Obs, Tracer, validate_trace

    seed0 = lambda: torch.Generator(device="cuda").manual_seed(0)
    launches = {}
    t0 = time.perf_counter()
    lap = lambda what: print(f"[sched] {what} at {time.perf_counter() - t0:.1f}"
                             f" s into the phase", flush=True)

    # ---- stablelm-3b, dense cache ----
    cfg = served_config("stablelm_3b")
    model = get_model(cfg).init(cfg, seed0(), "cuda")
    work = sched_workload(cfg.vocab_size)
    eng, sched, res, log, st, counts, caps = sched_leg(
        cfg, model, work, gpu, "dense", keep=True)
    lap("stablelm-3b dense leg done")
    launches["stablelm_3b dense"] = counts
    dense_res, dense_eng, dense_log = res, eng, log
    # the first 8 requests against generate of their 8 prompts, padded to
    # the width admission pads them to (the next power of two)
    from repro_torch.serve import ServeEngine
    first8 = work[:8]
    width = 1 << (max(len(w["prompt"]) for w in first8) - 1).bit_length()
    toks = np.zeros((8, width), np.int32)
    for i, w in enumerate(first8):
        toks[i, :len(w["prompt"])] = w["prompt"]
    g_eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1)
    g = g_eng.generate({"tokens": torch.from_numpy(toks).cuda(),
                        "lens": torch.tensor([len(w["prompt"]) for w in first8],
                                             device="cuda")},
                       max_len=SCHED_MAX_LEN,
                       sampling=[w["sampling"] for w in first8])
    g_toks = g["tokens"].cpu().numpy()
    lap("generate of the first 8 done")
    diff_g = [i for i in range(8) if not np.array_equal(
        res[i]["tokens"], g_toks[i, :work[i]["budget"]])]
    del g_eng, g
    # the first 12 requests: untraced (10 rounds profiled), traced, unfused
    work12 = work[:12]
    off, log_off = drive(new_sched(eng), work12, window=(2, 12))
    obs = Obs(tracer=Tracer(), annotations=True)
    s_on = new_sched(eng, obs=obs)
    on, log_on = drive(s_on, work12)
    s_unf = new_sched(eng, fused=False)
    unf, log_unf = drive(s_unf, work12)
    for r_, nm in ((off, "untraced"), (on, "traced"), (unf, "unfused")):
        sched_served(cfg, work12, r_, f"dense 12 {nm}")
    path = ROOT / "build" / "sched_trace.json"
    path.parent.mkdir(exist_ok=True)
    n_ev = obs.export(str(path))
    errs = validate_trace(json.loads(path.read_text())["traceEvents"])
    check(not errs, f"{cfg.name}: the exported trace validates ({errs[:3]})")
    st_off = {q: sum(r[q] for r in log_off["rounds"])
              for q in ("dispatches", "host_syncs")}
    st_on = {q: s_on.stats[q] for q in ("dispatches", "host_syncs")}
    diff_on, diff_unf = same_tokens(on, off), same_tokens(unf, off)
    lap("first-12 runs done")
    prof = window_profile(log_off)
    unprof_ms = sum(r["ms"] for r in log_on["rounds"][2:12])
    costs = splice_costs(cfg, eng, sched, gpu)
    a = sched_report(cfg, "dense", work, res, log, sched, caps, gpu)
    print(f"[sched] {cfg.name} dense round anatomy: an admission round's "
          f"splices on the device: the sub-cache's zeros {costs['zeros_ms']:.3f}"
          f" ms ({costs['zeros_bytes'] / 1e9:.3f} GB), slot_update of one lane "
          f"{costs['splice_ms']:.3f} ms ({costs['splice_bytes'] / 1e9:.3f} GB "
          f"by definition), the copy into the carry {costs['carry_ms']:.3f} ms "
          f"({costs['carry_bytes'] / 1e9:.3f} GB); a compaction's gather "
          f"{costs['gather_ms']:.3f} ms ({costs['gather_bytes'] / 1e9:.3f} GB) "
          f"plus that copy; the K/V cache {costs['cache_bytes'] / 1e9:.3f} GB "
          f"(CUDA events)  [{gpu}]", flush=True)
    print(f"[sched] {cfg.name} dense, first 12 requests: profiled rounds 2-11 "
          f"of the untraced run: idle "
          + (f"{prof['idle']:.1%}, {prof['h2d_per_round']:.1f} host-to-device "
             f"copies a round over {prof['window_rounds']} rounds "
             f"({prof['window_ms']:.1f} ms profiled; the same rounds of the "
             f"traced run, not profiled: {unprof_ms:.1f} ms)"
             if prof.get("idle") is not None
             else "not measured (the profiler saw no device events)")
          + f"; traced {st_on}, untraced {st_off} dispatches/host syncs; "
          f"{n_ev} trace events exported, valid (held)  [{gpu}]", flush=True)
    soft = {"generate (first 8)": diff_g, "traced == untraced": diff_on,
            "unfused == fused": diff_unf}
    lap("the dense leg's checks done")
    launches["stablelm_3b dense overlap"] = overlap_leg(
        cfg, eng, work, dense_res, dense_log, a, gpu)
    lap("stablelm-3b overlap leg done")
    check(st_on == st_off, f"{cfg.name}: tracing moved dispatches/host syncs "
          f"{st_on} against {st_off}")
    print(f"[sched] bit-for-bit comparisons, dense (requests that differ): "
          f"{soft}", flush=True)
    del s_on, s_unf, off, on, unf, log_off, log_on, log_unf

    # ---- stablelm-3b, paged: prefix sharing, host swap, chunked prefill ----
    lap("splice costs done")
    rs = np.random.RandomState(21)
    follow, used = {}, set()
    for i in range(16, 24):
        j = next(j for j in range(16) if j not in used and
                 len(work[j]["prompt"]) + work[j]["budget"] + 64
                 + work[i]["budget"] <= SCHED_MAX_LEN)
        used.add(j)
        follow[i] = (j, rs.randint(1, cfg.vocab_size, 64).astype(np.int32))
    obs_p = Obs(tracer=Tracer())
    eng_p, sched_p, res_p, log_p, st_p, counts, caps = sched_leg(
        cfg, model, work, gpu, "paged", keep=True, follow=follow,
        engine_kw=None, page_size=PAGE_SIZE, host_swap_pages=SCHED_SWAP_PAGES,
        prefill_chunk=256, obs=obs_p)
    launches["stablelm_3b paged"] = counts
    ev = _events_by_rid(obs_p)
    lap("stablelm-3b paged leg done")
    rid_of = log_p["rid_of"]
    hit, chunked = set(), set()
    for i, rid in rid_of.items():
        for nm, args in ev[rid]:
            if nm == "admitted" and (args.get("shared_pages")
                                     or args.get("swapped_pages")):
                hit.add(i)
            if nm == "prefill_start":
                chunked.add(i)
    fam = get_model(cfg)

    @torch.inference_mode()
    def replay(prompt, size=256):
        """``prompt`` prefilled on a fresh one-lane cache in the chunks a
        partial takes (``size`` tokens, each padded to a power of two)."""
        cache, start, n = eng_p.make_cache(1, SCHED_MAX_LEN), 0, len(prompt)
        while start < n:
            m = min(size, n - start)
            width = min(1 << (m - 1).bit_length(), SCHED_MAX_LEN - start)
            toks = torch.zeros((1, width), dtype=torch.int32, device="cuda")
            toks[0, :m] = torch.from_numpy(prompt[start:start + m])
            logits, cache = fam.prefill(
                model, cfg, {"tokens": toks,
                             "lens": torch.tensor([m], device="cuda"),
                             "pos0": torch.tensor([start], device="cuda")},
                cache)
            start += m
        return logits[0].float()

    # requests with no prefix hit and no chunk: tokens held to the dense
    # leg's, narrowed bursts included (a row's bits do not depend on the
    # burst's width: ``layers.ROW_FLOOR``)
    plain_idx = [i for i in range(SCHED_REQ)
                 if i not in follow and i not in hit and i not in chunked]
    shapes = {i: (eng_p.model.first_logits(work[i]["prompt"])[1],
                  dense_eng.model.first_logits(work[i]["prompt"])[1])
              for i in plain_idx}
    narrowed = sorted((set(log_p["narrowed"]) | set(dense_log["narrowed"]))
                      & set(plain_idx))
    diff_p = same_tokens(res_p, dense_res, plain_idx)
    # chunked requests with no hit: first-token logits held bit for bit to
    # the same chunks replayed through the family's prefill
    replay_bad = [i for i in sorted(chunked - hit) if not torch.equal(
        eng_p.model.first_logits(work[i]["prompt"])[0],
        replay(work[i]["prompt"]))]
    # every request: first-token logits against the dense leg's (a
    # whole-prompt prefill alone for a second turn), bit for bit
    rels, logit_bad = {}, []
    for i in sorted(hit | chunked | set(plain_idx)):
        prompt = log_p["prompts"][i]
        got = eng_p.model.first_logits(prompt)[0]
        want = (dense_eng.model.first_logits(prompt)[0] if i not in follow
                else None)
        if want is None:
            with torch.inference_mode():
                want, _ = fam.prefill(
                    model, cfg, {"tokens": torch.from_numpy(prompt)[None].cuda(),
                                 "lens": torch.tensor([len(prompt)],
                                                      device="cuda")},
                    eng_p.make_cache(1, SCHED_MAX_LEN))
            want = want[0].float()
        rels[i] = rel_err(got, want)
        if not torch.equal(got, want):
            logit_bad.append(i)
    sched_report(cfg, "paged", work, res_p, log_p, sched_p, caps, gpu,
                 f"; prefix hits on requests {sorted(hit)}, chunked "
                 f"{sorted(chunked)}; swap out {st_p['swap_out_pages']} / in "
                 f"{st_p['swap_in_pages']} pages; no page leaked, checksum "
                 f"failures 0 (held)")
    print(f"[sched] {cfg.name} paged against dense: requests {plain_idx} (no "
          f"prefix hit, no chunk; admission call shapes paged/dense "
          f"{shapes}; in a narrowed burst {narrowed}) differ in {diff_p}; the "
          f"chunked requests' first-token logits against the same chunks "
          f"replayed: {replay_bad} differ; first-token logits of "
          f"{len(rels)} requests (prefix hits, chunked, second turns, plain) "
          f"against the dense leg's or the whole prompt's: {logit_bad} "
          f"differ (relative error "
          f"{ {i: float(f'{r:.3e}') for i, r in rels.items() if r} })  "
          f"[{gpu}]", flush=True)
    check(st_p["session_hits"] > 0 and st_p["swap_checksum_failures"] == 0,
          f"{cfg.name} paged: session hits {st_p['session_hits']}, checksum "
          f"failures {st_p['swap_checksum_failures']}")
    soft["paged == dense (plain requests, narrowed or not)"] = diff_p
    soft["chunked == replayed chunks"] = replay_bad
    soft["paged first-token logits == dense / whole prompt"] = logit_bad
    launches["stablelm_3b control plane"] = control_plane_leg(
        cfg, model, work, follow, dense_res, res_p, log_p, gpu)
    lap("stablelm-3b control-plane leg done")
    del eng_p, sched_p, eng, sched, dense_eng, model
    torch.cuda.empty_cache()
    print(f"[sched] held comparisons (requests that differ, none may): "
          f"{soft}", flush=True)
    bad = {k: v for k, v in soft.items() if v}
    check(not bad, f"stablelm-3b scheduler comparisons failed: {bad}")

    # ---- zamba2-1.2b, paged int8, chunked prefill on the SSD grid ----
    cfg = served_config("zamba2_1_2b")
    model = get_model(cfg).init(cfg, seed0(), "cuda")
    work = sched_workload(cfg.vocab_size)
    eng, sched, res, log, st, counts, caps = sched_leg(
        cfg, model, work, gpu, "paged int8", engine_kw=dict(page_dtype="int8"),
        page_size=PAGE_SIZE, prefill_chunk=256)
    launches["zamba2_1_2b paged int8"] = counts
    lap("zamba2-1.2b leg done")
    sched_report(cfg, "paged int8", work, res, log, sched, caps, gpu)
    del eng, sched, model
    torch.cuda.empty_cache()

    # ---- olmoe-1b-7b, dense cache (full-width bursts) ----
    cfg = served_config("olmoe_1b_7b")
    model = get_model(cfg).init(cfg, seed0(), "cuda")
    work = sched_workload(cfg.vocab_size)
    eng, sched, res, log, st, counts, caps = sched_leg(cfg, model, work, gpu,
                                                       "dense")
    launches["olmoe_1b_7b dense"] = counts
    lap("olmoe-1b-7b leg done")
    check(all(w == SCHED_CAP for (_, w), _ in caps),
          f"{cfg.name}: MoE bursts never narrow ({caps})")
    sched_report(cfg, "dense", work, res, log, sched, caps, gpu)
    del eng, sched, model
    torch.cuda.empty_cache()
    return launches, soft


@torch.inference_mode()
def chunk_probe(gpu) -> None:
    """Chunked prefill on the card against whole-prompt prefill, stablelm-3b:
    the scheduler's chunks of 256 with a short last chunk (the paged leg's
    requests 5, 6 and 30: 521, 532 and 781 tokens), each chunk through the
    kernels and through the plain attention (``PLAIN``), and the dense
    kernel alone at the last chunk's shapes against its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model

    cfg = get_config("stablelm_3b")
    fam = get_model(cfg)
    model = fam.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    work = sched_workload(cfg.vocab_size)
    for i in (5, 6, 30, 0):
        prompt = torch.from_numpy(work[i]["prompt"]).cuda()
        n = len(prompt)

        def whole(c):
            cache = fam.make_cache(c, 1, SCHED_MAX_LEN, device="cuda")
            return fam.prefill(model, c, {"tokens": prompt[None],
                                          "lens": torch.tensor([n], device="cuda")},
                               cache)[0][0].float()

        def chunked(c, size=256):
            cache = fam.make_cache(c, 1, SCHED_MAX_LEN, device="cuda")
            start = 0
            while start < n:
                m = min(size, n - start)
                width = min(1 << (m - 1).bit_length(), SCHED_MAX_LEN - start)
                toks = torch.zeros((1, width), dtype=torch.int64, device="cuda")
                toks[0, :m] = prompt[start:start + m]
                logits, cache = fam.prefill(
                    model, c, {"tokens": toks,
                               "lens": torch.tensor([m], device="cuda"),
                               "pos0": torch.tensor([start], device="cuda")},
                    cache)
                start += m
            return logits[0].float()

        plain = cfg.replace(**PLAIN)
        w_k, w_p, c_k, c_p = whole(cfg), whole(plain), chunked(cfg), chunked(plain)
        r = lambda a, b: tol_ratio(a, b, *SCHED_LOGIT_TOL)
        print(f"[probe] request {i} ({n} tokens, last chunk {n % 256 or 256}): "
              f"chunked/whole kernel {r(c_k, w_k):.3f}, plain {r(c_p, w_p):.3f}; "
              f"kernel/plain whole {r(w_k, w_p):.3f}, chunked {r(c_k, c_p):.3f}; "
              f"argmax whole {int(w_k.argmax())} chunked {int(c_k.argmax())}  "
              f"[{gpu}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for sq, m, off in ((16, 9, 512), (16, 13, 768), (32, 20, 512),
                       (16, 16, 512), (64, 40, 512), (256, 256, 256)):
        q = torch.randn(1, 32, sq, 80, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(1, 32, SCHED_MAX_LEN, 80, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        kw = dict(kv_lens=torch.tensor([off + m], dtype=torch.int32,
                                       device="cuda"),
                  q_offset=torch.tensor([off], dtype=torch.int32, device="cuda"),
                  causal=True)
        got = flash_attention(q, k, v, impl="kernel", **kw)[:, :, :m].float()
        want = flash_attention(q, k, v, impl="naive", **kw)[:, :, :m].float()
        print(f"[probe] dense kernel sq {sq} ({m} live rows) at q_offset {off}"
              f" over {SCHED_MAX_LEN} keys: ratio {tol_ratio(got, want, *TOL['split_kv']):.3f}"
              f", max abs err {float((got - want).abs().max()):.3e}", flush=True)


# ---------------------------------------------------------------------------
# ``--gemm-probe``: which row counts give a row the same bits
# ---------------------------------------------------------------------------

# row counts of the probe's calls: a burst's widths, a short last chunk's
# padded widths, whole prompts and a batch of 8 of them
PROBE_MS = (1, 2, 3, 4, 5, 8, 9, 13, 16, 20, 32, 64, 128, 227, 256, 300, 512,
            963, 1024, 2048, 4096, 8192)
PROBE_ARCHS = ("stablelm_3b", "zamba2_1_2b", "mamba2_130m")
# archs probed by their shapes alone (no model is built: command-r-plus
# does not fit the card): projections, unembedding and row reductions
PROBE_SHAPE_ARCHS = ("seamless_m4t_large_v2", "llama_3_2_vision_11b",
                     "gemma3_27b", "command_r_plus_104b", "stablelm_12b")
# (projection floor, norm floor) pairs: none, the shipped pair, and the
# projections' floor for both
PROBE_FLOORS = ((1, 1), (256, 16), (256, 256))


def rows_in(rnd, probe):
    """``make`` for ``_row_classes``: a call of M random rows shaped like
    ``probe``'s, its first k probe rows at ``at``."""
    def make(m, at, k):
        x = rnd(m, *probe.shape[1:], dt=probe.dtype)
        x[at:at + k] = probe[:k]
        return x
    return make


def _row_classes(make, fn, ms=PROBE_MS):
    """16 probe rows inside calls of each row count M of ``ms`` (at the
    call's start, middle and end; the first M of them below 16 rows), the
    rest of the call filler: ``make(m, at, k)`` builds the call's inputs
    with the probe rows at ``at:at + k``, ``fn`` maps them to a tuple of
    outputs with rows first.  Returns ``(classes, floor)``: the row counts
    grouped by row 0's bits, and the least M from which every call of the
    list gives every probe row the bits of M = ``ms[-1]``, at every place."""
    out = {}
    for m in ms:
        k = min(16, m)
        for pos, at in (("start", 0), ("middle", (m - k) // 2), ("end", m - k)):
            res = fn(make(m, at, k))
            out[(m, pos)] = tuple(r[at:at + k].clone() for r in res)
    ref = out[(ms[-1], "start")]
    same = {m: all(all(torch.equal(a, b[:a.shape[0]])
                       for a, b in zip(out[(m, pos)], ref))
                   for pos in ("start", "middle", "end")) for m in ms}
    floor = None
    for m in reversed(ms):
        if not same[m]:
            break
        floor = m
    classes = collections.OrderedDict()
    for m in ms:
        key = b"".join(_bits(r[:1]).cpu().numpy().tobytes()
                       for r in out[(m, "start")])
        classes.setdefault(key, []).append(m)
    return list(classes.values()), floor


def _probe_weights(cfg, model) -> list:
    """The projections of a model as (name, in, out, transposed): each
    distinct shape of its matmul weights, and the tied unembedding (the
    embedding table read transposed)."""
    seen, out = set(), []
    for name, p in model.named_parameters():
        if p.dim() != 2 or name.endswith(("embed.tok", "conv_w")):
            continue
        if tuple(p.shape) not in seen:
            seen.add(tuple(p.shape))
            out.append((name, p.shape[0], p.shape[1], False))
    if cfg.tie_embeddings:
        out.append(("embed.tok (tied unembed)", cfg.d_model, cfg.padded_vocab,
                    True))
    return out


def _cfg_projections(cfg) -> list:
    """``_probe_weights`` from the config alone: each distinct (in, out) of
    an attention, MLP and unembedding weight of a dense or encdec model."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qo, kvo = cfg.n_heads * hd, cfg.n_kv_heads * hd
    named = [("attn.wq", d, qo), ("attn.wk", d, kvo), ("attn.wo", qo, d),
             ("mlp.w_up", d, cfg.d_ff), ("mlp.w_down", cfg.d_ff, d)]
    if not cfg.tie_embeddings:
        named.append(("embed.unembed", d, cfg.padded_vocab))
    seen, out = set(), []
    for name, k_in, n_out in named:
        if (k_in, n_out) not in seen:
            seen.add((k_in, n_out))
            out.append((name, k_in, n_out, False))
    if cfg.tie_embeddings:
        out.append(("embed.tok (tied unembed)", d, cfg.padded_vocab, True))
    return out


def shape_probe(gpu, gen, rnd, found) -> None:
    """Part 1 of ``gemm_probe`` for ``PROBE_SHAPE_ARCHS``, from their
    configs: every projection shape with its unembedding, the block norm
    over d_model and (qk-norm) the rms norm over the head dim, each with
    the least M from which a row's bits agree, and whether that M is above
    the floor ``layers`` gives the shape (``layers.row_floor``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    for arch in PROBE_SHAPE_ARCHS:
        cfg = get_config(arch)
        for name, k_in, n_out, tied in _cfg_projections(cfg):
            w = rnd(n_out, k_in).t() if tied else rnd(k_in, n_out)
            classes, floor = _row_classes(rows_in(rnd, rnd(16, k_in)),
                                          lambda x, w=w: (x @ w,))
            found[(arch, name)] = floor
            have = L.row_floor(k_in, n_out)
            print(f"[gemm] {arch} {name} ({k_in}, {n_out}){' tied' if tied else ''}"
                  f": row counts by a row's bits {classes}; every call from "
                  f"M = {floor} on gives M = {PROBE_MS[-1]}'s bits; layers "
                  f"floor {have}: {'ok' if floor is not None and floor <= have else 'ABOVE'}"
                  f"  [{gpu}]", flush=True)
            del w
            torch.cuda.empty_cache()
        d = cfg.d_model
        if cfg.norm == "layernorm":
            norm = lambda x: ((x - x.mean(-1, keepdim=True)) * torch.rsqrt(
                x.var(-1, keepdim=True, unbiased=False) + 1e-5),)
        else:
            norm = lambda x: (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                              + 1e-5),)
        classes, floor = _row_classes(
            rows_in(rnd, rnd(16, d, dt=torch.float32)), norm)
        found[(arch, cfg.norm)] = floor
        print(f"[gemm] {arch} f32 {cfg.norm} over {d}: {classes}; from M = "
              f"{floor} on; layers floor {L.NORM_ROW_FLOOR}  [{gpu}]",
              flush=True)
        if cfg.qk_norm:
            hd = cfg.resolved_head_dim
            qk = lambda x: (L._rms_headdim(x),)
            for dt in (torch.bfloat16, torch.float32):
                classes, floor = _row_classes(
                    rows_in(rnd, rnd(16, hd, dt=dt)), qk)
                found[(arch, f"qk-norm {dt}")] = floor
                print(f"[gemm] {arch} qk-norm (rms over head dim {hd}, {dt}) "
                      f"as ``layers._rms_headdim`` runs it: {classes}; from M "
                      f"= {floor} on  [{gpu}]", flush=True)
    table_cost(gpu, rnd)


def table_cost(gpu, rnd) -> None:
    """What each shape of ``layers.ROW_FLOORS`` pays for its floor above
    ``ROW_FLOOR``: one decode burst's projection of 8 rows padded to
    ``ROW_FLOOR`` rows and to the shape's own floor, in turns (256, own,
    own, 256), CUDA events around 50 calls in a row."""
    from repro_torch.models import layers as L

    def event_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return round(start.elapsed_time(end) / reps, 4)

    for (k_in, n_out), own in L.ROW_FLOORS.items():
        w, x = rnd(k_in, n_out), rnd(8, k_in)
        out = {}
        for floor in (L.ROW_FLOOR, own, own, L.ROW_FLOOR):
            out.setdefault(floor, []).append(event_ms(
                lambda f=floor: L.per_row(lambda r: r @ w, x, f)))
        print(f"[gemm] row floor of ({k_in}, {n_out}): 8 rows padded to "
              f"{L.ROW_FLOOR} rows {out[L.ROW_FLOOR]} ms, to {own} rows "
              f"{out[own]} ms a call, in turns (CUDA events)  [{gpu}]",
              flush=True)
        del w, x


@torch.inference_mode()
def gemm_probe(gpu) -> dict:
    """Which row counts give a row the same bits, at the full width of
    stablelm-3b, zamba2-1.2b and mamba2-130m (and first, from their configs
    alone, of ``PROBE_SHAPE_ARCHS``: ``shape_probe``).

    1. Every projection shape (``x @ w``, bf16, ``(in, out)`` weights; the
       tied unembedding through the transposed table) and the f32 row
       reductions (the block norm, the gated out norm) and the SSM decode
       step's conv and recurrence, with 16 probe rows inside calls of each
       of ``PROBE_MS`` rows: the classes of row counts by a row's bits and
       the least M from which all agree (``_row_classes``).
    2. The models: one bf16 decode step at widths 1, 2, 4 and 8, lane 0's
       logits compared, and (stablelm-3b) one prompt's first-token logits
       prefilled alone, inside a batch of 8 and in chunks of 256 ending in
       a short chunk, each with ``layers.ROW_FLOOR`` and
       ``NORM_ROW_FLOOR`` at each pair of ``PROBE_FLOORS`` (1: no floor),
       the sampler's draw at those widths too; and what the shipped floors
       cost stablelm-3b (``floor_cost``).  Prints what it finds; holds
       nothing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ops import ssd_decode_step
    from repro_torch.models import get_model
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *shape, dt=torch.bfloat16: torch.randn(
        *shape, generator=gen, device="cuda").to(dt)
    shipped = L.ROW_FLOOR, L.NORM_ROW_FLOOR
    found = {}
    shape_probe(gpu, gen, rnd, found)
    for arch in PROBE_ARCHS:
        cfg = get_config(arch)
        fam = get_model(cfg)
        model = fam.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
        # ---- 1. the ops, by row count ----
        for name, k_in, n_out, tied in _probe_weights(cfg, model):
            w = rnd(n_out, k_in).t() if tied else rnd(k_in, n_out)
            classes, floor = _row_classes(rows_in(rnd, rnd(16, k_in)),
                                          lambda x, w=w: (x @ w,))
            found[(arch, name)] = floor
            print(f"[gemm] {arch} {name} ({k_in}, {n_out}){' tied' if tied else ''}"
                  f": row counts by a row's bits {classes}; every call from "
                  f"M = {floor} on gives M = {PROBE_MS[-1]}'s bits  [{gpu}]",
                  flush=True)
        d = cfg.d_model
        rms = lambda x: (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                         + 1e-5),)
        classes, floor = _row_classes(
            rows_in(rnd, rnd(16, d, dt=torch.float32)), rms)
        found[(arch, "norm")] = floor
        print(f"[gemm] {arch} f32 rms norm over {d}: {classes}; from M = "
              f"{floor} on  [{gpu}]", flush=True)
        layer = lambda x: ((x - x.mean(-1, keepdim=True)) * torch.rsqrt(
            x.var(-1, keepdim=True, unbiased=False) + 1e-5),)
        classes, floor = _row_classes(
            rows_in(rnd, rnd(16, d, dt=torch.float32)), layer)
        found[(arch, "layernorm")] = floor
        print(f"[gemm] {arch} f32 layer norm over {d}: {classes}; from M = "
              f"{floor} on  [{gpu}]", flush=True)
        if cfg.family in ("ssm", "hybrid"):
            from repro_torch.models.ssm import conv_dim
            di, n, h, pd = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                            cfg.ssm_headdim)
            classes, floor = _row_classes(
                rows_in(rnd, rnd(16, di, dt=torch.float32)), rms)
            found[(arch, "gated norm")] = floor
            print(f"[gemm] {arch} f32 rms norm over d_inner {di}: {classes}; "
                  f"from M = {floor} on  [{gpu}]", flush=True)
            c, wd = conv_dim(cfg), cfg.ssm_conv_width
            cw = rnd(wd, c)
            classes, floor = _row_classes(
                rows_in(rnd, rnd(16, wd, c)),
                lambda win: (torch.einsum("bwc,wc->bc", win, cw),),
                ms=PROBE_MS[:15])
            found[(arch, "conv einsum")] = floor
            print(f"[gemm] {arch} decode conv einsum (W={wd}, C={c}): "
                  f"{classes}; from M = {floor} on  [{gpu}]", flush=True)
            A = -torch.rand(h, generator=gen, device="cuda")
            Dv = rnd(h, dt=torch.float32)
            st = [rnd(16, h, pd), torch.rand(16, h, generator=gen, device="cuda"),
                  rnd(16, n), rnd(16, n), rnd(16, h, pd, n, dt=torch.float32)]

            def make_ssd(m, at, k):
                ins = [rnd(m, h, pd), torch.rand(m, h, generator=gen,
                                                 device="cuda"),
                       rnd(m, n), rnd(m, n), rnd(m, h, pd, n, dt=torch.float32)]
                for a, b in zip(ins, st):
                    a[at:at + k] = b[:k]
                return ins
            classes, floor = _row_classes(
                make_ssd, lambda ins: ssd_decode_step(*ins[:2], A, *ins[2:4],
                                                      ins[4], D=Dv),
                ms=PROBE_MS[:15])
            found[(arch, "ssd decode step")] = floor
            print(f"[gemm] {arch} ssd_decode_step (H={h}, P={pd}, N={n}): "
                  f"{classes}; from M = {floor} on  [{gpu}]", flush=True)
        # ---- 2. the model, by burst width and prefill layout ----
        rs = np.random.RandomState(7)
        for floor in PROBE_FLOORS:
            L.ROW_FLOOR, L.NORM_ROW_FLOOR = floor
            same, diff = lane_widths(fam, model, cfg)
            msg = (f"[gemm] {arch} floors {floor}: one decode step, lane 0's "
                   f"logits at widths 1/2/4/8 equal width 1's: {same} (max "
                   f"|diff| {diff:.3e})")
            if arch != "mamba2_130m":
                lay = prefill_layouts(fam, model, cfg, rs)
                msg += (f"; prefill of {lay['n']} tokens: in a batch of 8 == "
                        f"alone {lay['batch']}, chunks of 256 (last "
                        f"{lay['n'] % 256}) == alone {lay['chunks']} (max "
                        f"|diff| {lay['diff']:.3e})")
            if arch == "stablelm_3b":
                msg += (f"; the sampler's lane-0 draw and state equal at "
                        f"widths 1/2/4/8: {sampler_widths(fam, model, cfg)}")
            print(msg + f"  [{gpu}]", flush=True)
        L.ROW_FLOOR, L.NORM_ROW_FLOOR = shipped
        if arch == "stablelm_3b":
            floor_cost(fam, model, cfg, L, gpu)
        del model
        torch.cuda.empty_cache()
    return found


def model_extras(cfg, b: int, seed: int, src_len: int = 256) -> dict:
    """The second sequence a model's attention reads, N(0, 1) from
    ``seed``, on the card: encdec's encoder frames (``src_emb`` (b,
    src_len, d), all ``src_len`` valid) or the vlm's image embeddings
    (``cross_emb`` (b, n_cross_tokens, d)); nothing for the others."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "encdec":
        return {"src_emb": torch.randn(b, src_len, cfg.d_model, generator=gen,
                                       device="cuda"),
                "src_lens": torch.full((b,), src_len, dtype=torch.int32,
                                       device="cuda")}
    if cfg.cross_attn_group:
        return {"cross_emb": torch.randn(b, cfg.n_cross_tokens, cfg.d_model,
                                         generator=gen, device="cuda")}
    return {}


def make_cache(fam, cfg, b, max_len, extras):
    """``fam.make_cache`` sized for ``extras`` (encdec's cross memory)."""
    kw = ({"src_len": extras["src_emb"].shape[1]} if "src_emb" in extras
          else {})
    return fam.make_cache(cfg, b, max_len, **kw, device="cuda")


def _probe_cache(fam, model, cfg):
    """8 lanes prefilled with 64 random tokens each (seed 7; with the
    model's extras, seed 7) and their first tokens."""
    rs = np.random.RandomState(7)
    prompts = torch.from_numpy(rs.randint(1, cfg.vocab_size, (8, 64))
                               .astype(np.int32)).cuda()
    extras = model_extras(cfg, 8, 7)
    cache = make_cache(fam, cfg, 8, 128, extras)
    logits, cache = fam.prefill(model, cfg, {"tokens": prompts, **extras},
                                cache)
    return cache, logits


def lane_widths(fam, model, cfg):
    """One bf16 decode step of the same 8 lanes at widths 1, 2, 4 and 8 (the
    first w lanes, as a narrowed burst takes them): whether lane 0's logits
    equal width 1's at each width, and the largest difference."""
    from repro_torch.models import gather_lanes
    cache, logits = _probe_cache(fam, model, cfg)
    tok = logits.argmax(-1).to(torch.int32)
    lane0 = []
    for w in (1, 2, 4, 8):
        idx = torch.arange(w, device="cuda")
        sub = {k: v.clone() for k, v in gather_lanes(cfg, cache, idx).items()}
        lg, _ = fam.decode(model, cfg, {"token": tok[:w, None]}, sub)
        lane0.append(lg[0].float())
    return ([torch.equal(lane0[0], x) for x in lane0],
            max(float((x - lane0[0]).abs().max()) for x in lane0))


def sampler_widths(fam, model, cfg):
    """The sampler's lane-0 draw and new state at widths 1, 2, 4 and 8 of
    one stochastic spec: whether each equals width 1's."""
    from repro_torch import sample as S
    _, logits = _probe_cache(fam, model, cfg)
    state = S.lane_state([mixed_specs()[4]] * 8, 8, device="cuda")
    draws = []
    for w in (1, 2, 4, 8):
        t, st = S.sample(logits[:w], S.gather_lanes(
            state, torch.arange(w, device="cuda")))
        draws.append((t[0].clone(), {k: v[0].clone() for k, v in st.items()}))
    return [torch.equal(t, draws[0][0]) and all(
        torch.equal(v, draws[0][1][k]) for k, v in st.items())
        for t, st in draws]


def prefill_layouts(fam, model, cfg, rs) -> dict:
    """One 521-token prompt's first-token logits prefilled alone, inside a
    batch of 8 and in chunks of 256 ending in a 9-token chunk (each padded
    to a power of two, as the scheduler pads them): whether the batch's and
    the chunks' equal the prompt's alone, and the chunks' largest
    difference.  With the model's extras (``model_extras``, row 3 the
    prompt's own): encdec's encoder input rides the first chunk only, the
    vlm's image embeddings every chunk."""
    n = 521
    prompt = torch.from_numpy(rs.randint(1, cfg.vocab_size, n).astype(
        np.int32)).cuda()
    extras = model_extras(cfg, 8, 9)
    own = {k: v[3:4] for k, v in extras.items()}
    alone = fam.prefill(model, cfg, {"tokens": prompt[None], **own},
                        make_cache(fam, cfg, 1, SCHED_MAX_LEN, own))[0][0]
    toks = torch.from_numpy(rs.randint(1, cfg.vocab_size, (8, 1024)).astype(
        np.int32)).cuda()
    lens = torch.from_numpy(rs.randint(128, 1025, 8).astype(np.int32)).cuda()
    toks[3, :n] = prompt
    lens[3] = n
    batch = fam.prefill(model, cfg, {"tokens": toks, "lens": lens, **extras},
                        make_cache(fam, cfg, 8, SCHED_MAX_LEN, extras))[0][3]
    cache, start = make_cache(fam, cfg, 1, SCHED_MAX_LEN, own), 0
    while start < n:
        m = min(256, n - start)
        width = 1 << (m - 1).bit_length()
        t = torch.zeros((1, width), dtype=torch.int32, device="cuda")
        t[0, :m] = prompt[start:start + m]
        ride = own if start == 0 or "cross_emb" in own else {}
        lg, cache = fam.prefill(model, cfg, {
            "tokens": t, "lens": torch.tensor([m], device="cuda"),
            "pos0": torch.tensor([start], device="cuda"), **ride}, cache)
        start += m
    return {"n": n, "batch": torch.equal(batch, alone),
            "chunks": torch.equal(lg[0], alone),
            "diff": float((lg[0].float() - alone.float()).abs().max())}


@torch.inference_mode()
def check_rows(fam, model, cfg, gpu) -> None:
    """A row's bits do not depend on the call's row count, at model level
    (held): one bf16 decode step gives lane 0 the same logits at widths 1,
    2, 4 and 8; the sampler draws lane 0's token and state alike at those
    widths; and (families that prefill in chunks on the attention path) one
    prompt's first-token logits are the same prefilled alone, inside a batch
    of 8 and in chunks of 256 ending in a short chunk."""
    from repro_torch.models import layers as L
    same, diff = lane_widths(fam, model, cfg)
    check(all(same), f"{cfg.name}: lane 0's decode logits at widths 1/2/4/8 "
          f"equal bit for bit ({same}, max |diff| {diff:.3e})")
    msg = "lane 0's decode logits equal at widths 1/2/4/8"
    if cfg.family == "dense":
        eq = sampler_widths(fam, model, cfg)
        check(all(eq), f"{cfg.name}: the sampler's lane-0 draw at widths "
              f"1/2/4/8 ({eq})")
        msg += ", the sampler's lane-0 draw and state too"
    if cfg.family in ("dense", "hybrid", "encdec"):
        lay = prefill_layouts(fam, model, cfg, np.random.RandomState(7))
        check(lay["batch"] and lay["chunks"],
              f"{cfg.name}: first-token logits alone == in a batch of 8 "
              f"({lay['batch']}) == in chunks of 256 ({lay['chunks']}, max "
              f"|diff| {lay['diff']:.3e})")
        msg += (f"; a {lay['n']}-token prompt's first-token logits equal "
                f"alone, in a batch of 8 and in chunks of 256 ending in a "
                f"{lay['n'] % 256}-token chunk")
    print(f"[rows] {cfg.name}: {msg}, bit for bit (held; layers.ROW_FLOOR "
          f"= {L.ROW_FLOOR}, NORM_ROW_FLOOR = {L.NORM_ROW_FLOOR})  [{gpu}]",
          flush=True)


def floor_cost(fam, model, cfg, L, gpu) -> None:
    """What the row floors cost stablelm-3b, in turns within this call
    (no floors, the shipped floors, the shipped floors, no floors): one decode
    step of 8 lanes over a 1088-key cache captured as a CUDA graph and
    replayed (the floor adds a pad kernel to each projection and norm) and
    one eager prefill of 8 prompts of 1024 tokens, each by CUDA events
    around several runs in a row."""
    rs = np.random.RandomState(8)
    toks = torch.from_numpy(rs.randint(1, cfg.vocab_size, (8, 1024)).astype(
        np.int32)).cuda()
    cache = fam.make_cache(cfg, 8, SCHED_MAX_LEN, device="cuda")
    logits, cache = fam.prefill(model, cfg, {"tokens": toks}, cache)
    step = {"token": logits.argmax(-1).to(torch.int32)[:, None]}

    def decode():
        fam.decode(model, cfg, step, {k: v for k, v in cache.items()})

    def prefill():
        fam.prefill(model, cfg, {"tokens": toks},
                    fam.make_cache(cfg, 8, SCHED_MAX_LEN, device="cuda"))
    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return round(start.elapsed_time(end) / reps, 3)

    def graphed_ms(fn, reps):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        ms = event_ms(graph.replay, reps)
        del graph
        return ms

    shipped, out = (L.ROW_FLOOR, L.NORM_ROW_FLOOR), collections.defaultdict(list)
    for floor in ((1, 1), shipped, shipped, (1, 1)):
        L.ROW_FLOOR, L.NORM_ROW_FLOOR = floor
        out[("decode", floor)].append(graphed_ms(decode, 50))
        out[("prefill", floor)].append(event_ms(prefill, 3))
    L.ROW_FLOOR, L.NORM_ROW_FLOOR = shipped
    none = (1, 1)
    print(f"[gemm] stablelm_3b cost of the row floors, in turns (CUDA events): "
          f"graphed decode step of 8 lanes "
          f"{out[('decode', none)]} ms without, {out[('decode', shipped)]} ms "
          f"with (ROW_FLOOR, NORM_ROW_FLOOR) = {shipped}; prefill of 8 x 1024 "
          f"tokens {out[('prefill', none)]} ms without, "
          f"{out[('prefill', shipped)]} ms with  [{gpu}]", flush=True)


def run_quickstart() -> dict:
    """The port's quickstart (``repro_torch.launch.quickstart``) on the card:
    Fig. 2's daxpy at three VLs and §2.4's fadda, each held against its
    plain version inside, and Figs. 4-6 (``ldff``, strlen, the list XOR)
    held to their scalar answers; its kernel launches, counted from 0."""
    from repro_torch.launch import quickstart

    reset_counts()
    quickstart.main([])
    torch.cuda.synchronize()
    counts = read_counts()
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update(daxpy=len(quickstart.VLS), fadda=len(quickstart.VLS))
    check(counts == want, f"quickstart launches {counts}, expected {want}")
    print(f"[quickstart] launches { {k: v for k, v in counts.items() if v} } "
          "(as expected)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# ``--ssd-probes``: how the SSD scan's tensor-core body was measured
# ---------------------------------------------------------------------------

# Copies of the tensor-core body with one fault each, built into build/:
# the bf16 checks of ``check_ssd`` must fail every one of them.
SSD_MUTANTS = (
    ("drop the lo half of h_prev", "for (int hl = 0; hl < 2; ++hl) {",
     "for (int hl = 0; hl < 1; ++hl) {"),
    ("skip chunk 1's inter term", "        if (kk < nk) {\n          unsigned hb",
     "        if (kk < nk && c != 1) {\n          unsigned hb"),
)
# The same body with the accurate expf per element of att in place of
# ex2.approx of the log2-scaled difference.
SSD_EXPF = ("s[nt][e1] *= ex2(l0 - kj.x) * kj.y;\n"
            "            s[nt][2 + e1] *= ex2(l1 - kj.x) * kj.y;",
            "s[nt][e1] *= expf((l0 - kj.x) * 0.6931471805599453f) * kj.y;\n"
            "            s[nt][2 + e1] *= expf((l1 - kj.x) * 0.6931471805599453f) "
            "* kj.y;")
MMA_BENCH = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__global__ void chains8(float* out, int iters) {
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) mma(c[k], a, i, i + k);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_bench(float* out, int blocks, int threads, int iters, void* stream) {
  chains8<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _probe_library(name: str, text: str, signatures: dict):
    """A library built from the CUDA source ``text`` under build/
    (git-ignored)."""
    from repro_torch.kernels._build import BUILD_DIR, Library

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"probe_{name}.cu"
    path.write_text(text)
    return Library(path, signatures)


def _mutate(src: str, old: str, new: str) -> str:
    body = src.index("template <int PB>\n__global__")
    check(src.count(old) == 1, f"one {old!r} in the source")
    j = src.index(old, body)
    return src[:j] + new + src[j + len(old):]


def ssd_probes(gpu):
    """Measurements behind the tensor-core body's design, apart from the
    smoke run: each mutant of ``SSD_MUTANTS`` against the bf16
    tensor-core cases of ``check_ssd`` (each must fail its limits; the
    counts and the multiples of the limits are printed, beside the limits
    ``check_ssd`` held before, 2e-2), the body with the accurate expf per
    element timed against the shipped one in turns at both serving shapes,
    and the ``mma.sync`` m16n8k16 bf16 rate of this card (8 independent
    chains a warp, 8 warps a block, 4 blocks an SM)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import raise_on
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan

    src = SK.SOURCE.read_text()
    sig = SK.LIBRARY.signatures
    libs = {f"mutant{i}": _probe_library(f"ssd_mutant{i}",
                                         _mutate(src, old, new), sig)
            for i, (_, old, new) in enumerate(SSD_MUTANTS)}
    libs["expf"] = _probe_library("ssd_expf", _mutate(src, *SSD_EXPF), sig)
    libs["mma_bench"] = _probe_library("mma_bench", MMA_BENCH, {
        "mma_bench": [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]})
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    shipped = SK.LIBRARY
    try:
        for i, (what, _, _) in enumerate(SSD_MUTANTS):
            SK.LIBRARY = libs[f"mutant{i}"]
            gen = torch.Generator(device="cuda").manual_seed(3)
            fails, old_fails, total = [], 0, 0
            for (bz, s, h, p, n, q), body, every_slice in SSD_CASES:
                if body != SK.TENSOR_CORE:
                    continue
                for width in SK.SLICES if every_slice else (None,):
                    a = _ssd_inputs(gen, bz, s, h, p, n, torch.bfloat16)
                    lens = torch.tensor([s, s // 2 + 1][:bz], device="cuda")
                    args = (a["x"], a["dt"], a["A"], a["B"], a["C"], None)
                    kw = dict(seq_lens=lens, h0=a["h0"], chunk=q)
                    with ssd_plan(slice_=width):
                        y, hT = ssd_scan(*args, impl="kernel", **kw)
                    y_p, h_p = ssd_scan(*args, impl="naive", **kw)
                    ry = tol_ratio(y, y_p, *SSD_Y_TOL)
                    rh = tol_ratio(hT, h_p, SSD_H_TOL, SSD_H_TOL)
                    old = max(tol_ratio(y, y_p, 2e-2, 2e-2), rh)
                    total += 1
                    old_fails += old > 1
                    if ry > 1 or rh > 1:
                        fails.append(f"{(bz, s, h, p, n, q)} slice {width}: "
                                     f"y {ry:.3g}x, h_final {rh:.3g}x")
            print(f"[probe] ssd_scan mutant '{what}': fails {len(fails)} of "
                  f"{total} tensor-core cases of check_ssd ("
                  + "; ".join(fails) + f"); at the former bf16 limit 2e-2 "
                  f"it fails {old_fails}  [{gpu}]", flush=True)
            check(fails, f"the mutant '{what}' passes check_ssd's limits")
        SK.LIBRARY = shipped
        gen = torch.Generator(device="cuda").manual_seed(4)
        for arch in ("zamba2_1_2b", "mamba2_130m"):
            cfg = get_config(arch)
            h, p, n, q = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
            a = _ssd_inputs(gen, 8, 963, h, p, n, torch.bfloat16)
            call = lambda: SK.ssd_scan_cuda(a["x"], a["dt"], a["A"], a["B"],
                                            a["C"], a["h0"], chunk=q)
            turns = []
            for name in ("shipped", "expf", "expf", "shipped"):
                SK.LIBRARY = shipped if name == "shipped" else libs[name]
                turns.append(time_ms(call, 20))
            print(f"[probe] ssd_scan {arch} x (8, 963, {h}, {p}) N {n}: ex2 "
                  f"of the log2-scaled difference {turns[0]:.4f} / "
                  f"{turns[3]:.4f} ms, accurate expf {turns[1]:.4f} / "
                  f"{turns[2]:.4f} ms (turns)  [{gpu}]", flush=True)
    finally:
        SK.LIBRARY = shipped
    lib = libs["mma_bench"].get()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(n_sm * 4 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    run = lambda: raise_on(lib.mma_bench(out.data_ptr(), n_sm * 4, 256,
                                         iters, stream), "mma_bench")
    ms = time_ms(run, 5)
    flops = 2 * 16 * 8 * 16 * iters * 8 * 8 * n_sm * 4
    print(f"[probe] mma.sync m16n8k16 bf16 -> f32, 8 chains a warp, 8 warps a "
          f"block, 4 blocks an SM: {flops / ms / 1e9:.1f} TFLOP/s  [{gpu}]",
          flush=True)


# ---------------------------------------------------------------------------
# ``--fadda-probes``: how the fadda and moe_positions bodies were measured
# ---------------------------------------------------------------------------

# One dependent add after another in one thread: add.rn.f32, the
# instruction __fadd_rn is, as volatile asm so that nothing moves across the
# clock64() reads.
FADD_CHAIN = r"""
#include <cuda_runtime.h>
__global__ void fadd_chain(float* out, long long* cycles, float y, int iters) {
  float acc = out[0];
  const long long c0 = clock64();
  for (int i = 0; i < iters; i += 64) {
#pragma unroll
    for (int k = 0; k < 64; ++k) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(acc) : "f"(y));
  }
  const long long c1 = clock64();
  out[0] = acc;
  cycles[0] = c1 - c0;
}
extern "C" int fadd_chain_run(float* out, long long* cycles, float y, int iters, void* stream) {
  fadd_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, cycles, y, iters);
  return (int)cudaGetLastError();
}
"""
# Copies of the shipped fadda body with one fault each: ``check_fadda``
# must fail every one.
FADDA_MUTANTS = (
    ("the first pair of every whole group of 8 added as acc + (a + b)",
     "    acc = __fadd_rn(acc, a.x);\n    acc = __fadd_rn(acc, a.y);\n",
     "    acc = __fadd_rn(acc, __fadd_rn(a.x, a.y));\n"),
    ("the masked lanes' +0.0 skipped",
     "const float fin = len < v ? __fadd_rn(final_acc, 0.0f) : final_acc;",
     "const float fin = final_acc;"),
)
# A cluster barrier's price: blocks of 1024 threads in clusters of 8, one
# wave of 64 blocks, each passing `syncs` cluster barriers.
CLUSTER_BENCH = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void __cluster_dims__(8, 1, 1) cluster_syncs(int syncs, int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < syncs; ++i) cluster.sync();
  if (threadIdx.x == 0 && syncs < 0) out[blockIdx.x] = 1;
}
extern "C" int cluster_bench(int syncs, int* out, void* stream) {
  cluster_syncs<<<64, 1024, 0, static_cast<cudaStream_t>(stream)>>>(syncs, out);
  return (int)cudaGetLastError();
}
"""
# clock64() stamps of the walking thread, per row: [0] cycles to the first
# tile, [1] cycles waiting after it (block barriers in the old body,
# mbarriers in the new), [2] the walk from its start to its last add, [3]
# its start; [4] and [5] the ends of the threads that write out and the
# partials past n.
PROBE_HEAD = "__device__ long long g_probe[64][8];\n"
PROBE_TAIL = r"""
extern "C" int probe_read(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}
extern "C" int probe_reset() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_probe);
  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_probe)));
}
"""
FADDA_STAMPS = {
    "new": (
        ("  __device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) "
         "{ bar_wait(bar, parity); }",
         "  long long probe_t0 = 0, probe_first = -1, probe_wait = 0;\n"
         "  __device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {\n"
         "    const long long c0 = clock64();\n    bar_wait(bar, parity);\n"
         "    const long long c1 = clock64();\n"
         "    if (probe_first < 0) probe_first = c1 - probe_t0; else probe_wait += c1 - c0;\n"
         "  }"),
        ("  // group 0 holds the skipped head; groups [first, whole) are whole",
         "  w.probe_t0 = clock64();\n"
         "  // group 0 holds the skipped head; groups [first, whole) are whole"),
        ("  return w.acc;\n}",
         "  g_probe[blockIdx.x][0] = w.probe_first;\n  g_probe[blockIdx.x][1] = w.probe_wait;\n"
         "  g_probe[blockIdx.x][2] = clock64() - w.probe_t0;\n"
         "  g_probe[blockIdx.x][3] = w.probe_t0;\n  return w.acc;\n}"),
        ("  if (threadIdx.x == 0) out[row] = fin;",
         "  if (threadIdx.x == 0) { out[row] = fin; g_probe[row][4] = clock64(); }"),
        ('    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");',
         '    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n'
         "    if (lane == 0) g_probe[row][5] = clock64();"),
    ),
    "old": (
        ("  float acc = init[row];\n  for (int t = 0; t < tiles; ++t) {",
         "  const long long probe_t0 = clock64();\n"
         "  long long probe_first = -1, probe_wait = 0, probe_c = 0;\n"
         "  float acc = init[row];\n  for (int t = 0; t < tiles; ++t) {"),
        ("    __syncthreads();\n    if (threadIdx.x == 0) {\n      acc = walk_tile",
         "    probe_c = clock64();\n    __syncthreads();\n    if (threadIdx.x == 0) {\n"
         "      if (t == 0) probe_first = clock64() - probe_t0;\n"
         "      else probe_wait += clock64() - probe_c;\n      acc = walk_tile"),
        ("  if (threadIdx.x == 0) final_acc = acc;",
         "  if (threadIdx.x == 0) {\n    final_acc = acc;\n"
         "    g_probe[row][0] = probe_first;\n    g_probe[row][1] = probe_wait;\n"
         "    g_probe[row][2] = clock64() - probe_t0;\n    g_probe[row][3] = probe_t0;\n  }"),
        ("  if (threadIdx.x == 0) out[row] = fin;",
         "  if (threadIdx.x == 0) { out[row] = fin; g_probe[row][4] = clock64(); }"),
    ),
}
# globaltimer stamps (ns) by thread 0 of every block of the shipped
# moe_positions body, at its entry and after each step: [0] entry, [1] the
# shared tables zeroed, [2] the ranks, [3] the share counted, [4] the warps
# scanned, [5] the peers written and the cluster barrier passed, [6] the
# earlier tiles summed and the positions written.
MOE_STAMPS = (
    ("  extern __shared__ int smem[];\n",
     "  extern __shared__ int smem[];\n  probe_stamp(0);\n"),
    ("  // 1. the warp's rounds, in order\n",
     "  probe_stamp(1);\n  // 1. the warp's rounds, in order\n"),
    ("  if constexpr (kOneWarp) {\n", "  probe_stamp(2);\n  if constexpr (kOneWarp) {\n"),
    ("    // 3. per expert, an exclusive scan", "    probe_stamp(3);\n    // 3. per expert, an exclusive scan"),
    ("    // 4. this block's share", "    probe_stamp(4);\n    // 4. this block's share"),
    ("    // 5. the earlier tiles", "    probe_stamp(5);\n    // 5. the earlier tiles"),
    ("      if (r < rounds && g < n) pos[g] = id >= 0 ? pre[id] + run[id] + rank_r[r] : 0;\n    }\n",
     "      if (r < rounds && g < n) pos[g] = id >= 0 ? pre[id] + run[id] + rank_r[r] : 0;\n    }\n"
     "    probe_stamp(6);\n"),
)
MOE_PROBE_HEAD = r"""
__device__ unsigned long long g_probe[1024][8];
__device__ __forceinline__ void probe_stamp(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) g_probe[blockIdx.x][k] = t;
}
"""
# The shipped moe_positions body without step 2 (each block's share of the
# earlier clusters' ids counted): wrong, and timed only to price that
# counting.
# A variant of the shipped moe_positions body, timed against it in turns:
# the peers of a lane found by one ballot per bit of the id (the invalid ids
# as id E) in place of __match_any_sync.
MOE_VARIANTS = (
    ("peers by ballots", "      const unsigned peers = __match_any_sync(kFull, id);\n",
     "      unsigned peers = kFull;\n"
     "      const int key = id < 0 ? e : id;\n"
     "      for (int bit = 1; bit <= e; bit <<= 1) {\n"
     "        const unsigned on = __ballot_sync(kFull, key & bit);\n"
     "        peers &= (key & bit) ? on : ~on;\n"
     "      }\n"),
)
MOE_NO_PREFIX = ("    count_ids(ids, q * part, part, share, e, vec);\n", "")


def ptxas_report(sources) -> None:
    """What ptxas says of each kernel of ``sources`` (source paths, or
    ``Library`` objects, built with their defines) (registers, spills,
    stack), from a build with ``-Xptxas -v`` into build/, where the
    library's SASS (cuobjdump) is also written, beside it."""
    from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    def so_of(item):
        tag = "".join(f"_{d.lower()}" for d in getattr(item, "defines", ()))
        return BUILD_DIR / f"ptxas_{Path(getattr(item, 'source', item)).stem}{tag}.so"

    def one(item):
        src = getattr(item, "source", item)
        flags = item.flags() if hasattr(item, "flags") else []
        res = subprocess.run([nvcc_path(), *NVCC_FLAGS, *flags, "-Xptxas", "-v",
                              "-o", str(so_of(item)), str(src)],
                             capture_output=True, text=True)
        return item, res.stdout + res.stderr
    with ThreadPoolExecutor(len(sources)) as pool:
        for item, text in pool.map(one, sources):
            src, so = getattr(item, "source", item), so_of(item)
            sass = subprocess.run([str(Path(nvcc_path()).parent / "cuobjdump"),
                                   "-sass", str(so)], capture_output=True, text=True)
            so.with_suffix(".sass").write_text(sass.stdout + sass.stderr)
            lines = [ln.strip() for ln in text.splitlines()
                     if "Compiling entry" in ln or "registers" in ln
                     or "spill" in ln or "stack frame" in ln]
            name = " ".join([Path(src).name, *getattr(item, "flags", list)()])
            for ln in lines:
                print(f"[probe] ptxas {name}: {ln}", flush=True)


def _replace_once(src: str, old: str, new: str) -> str:
    check(src.count(old) == 1, f"one {old!r} in the source")
    return src.replace(old, new)


def _load_module(path: Path, name: str):
    """The module at ``path`` (a kernel module of another tree), imported
    under ``name``: it builds its own source into build/."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_enqueue_us(fn, calls: int = 1000) -> float:
    """Host time per call: perf_counter over ``calls`` calls between two
    synchronises."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def fadda_phase_split(FK, lib, gpu, what):
    """clock64() stamps of a stamped copy ``lib`` of a fadda body, swapped
    into the kernel module ``FK``: cycles per element by phase at the top-p
    scan (8, 50304) with every partial and the op (1, 4096), block 512."""
    from repro_torch.kernels._build import raise_on

    gen = torch.Generator(device="cuda").manual_seed(13)
    shipped = FK.LIBRARY
    FK.LIBRARY = lib
    stamps = np.zeros((64, 8), np.int64)
    try:
        for name, xs, partials in (("scan (8, 50304), every partial",
                                    sorted_probs(gen, 8, 50304), True),
                                   ("op (1, 4096)", torch.randn(
                                       1, 4096, generator=gen, device="cuda"), False)):
            r, c = xs.shape
            n_t = torch.full((r,), c, dtype=torch.int32, device="cuda")
            init = torch.zeros(r, device="cuda")
            for _ in range(3):                  # the last of three calls
                raise_on(lib.get().probe_reset(), "probe_reset")
                FK.fadda_rows_cuda(xs, n_t, init, partials=partials, block=512)
                torch.cuda.synchronize()
            raise_on(lib.get().probe_read(stamps.ctypes.data_as(ctypes.c_void_p)),
                     "probe_read")
            st = stamps[:r].astype(np.float64)
            first, waits, span = st[:, 0], st[:, 1], st[:, 2]
            tail = np.maximum(st[:, 4], st[:, 5]) - (st[:, 3] + span)
            walking = span - first - waits
            per = lambda a: float(a.mean() / c)
            print(f"[probe] fadda {what} body, {name}, cycles per element: "
                  f"walking {per(walking):.3f}, waiting after the first tile "
                  f"{per(waits):.3f}, first tile {per(first):.3f}, tail "
                  f"{per(tail):.3f}; in all {per(span + tail):.3f} (mean of "
                  f"{r} rows; {float(first.mean()):.0f} cycles to the first "
                  f"tile)  [{gpu}]", flush=True)
    finally:
        FK.LIBRARY = shipped


def _tree_calls(old, FK, MK, ids, e, k):
    """name -> {"old": call, "new": call}: the top-p scan, the op, and
    moe_positions at prefill and decode, on the old and the new bodies."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    sp = sorted_probs(gen, N_REQ, 50304)
    x1 = torch.randn(1, 4096, generator=gen, device="cuda")
    calls = {}
    for name, xs, partials in (("fadda scan (8, 50304), every partial", sp, True),
                               ("fadda op (1, 4096)", x1, False)):
        n_t = torch.full((xs.shape[0],), xs.shape[1], dtype=torch.int32, device="cuda")
        init = torch.zeros(xs.shape[0], device="cuda")
        calls[name] = {tree: (lambda m=m, xs=xs, n_t=n_t, init=init, p=partials:
                              m.fadda_rows_cuda(xs, n_t, init, partials=p, block=512))
                       for tree, m in (("old", old["fadda"]), ("new", FK))}
    for name, t in (("prefill", 7704), ("decode", 8)):
        calls[f"moe_positions {name} ({t}, {k})"] = {
            tree: (lambda m=m, x=ids[name]: m.moe_positions_cuda(x, e))
            for tree, m in (("old", old["moe"]), ("new", MK))}
    return calls


def moe_phase_split(MK, lib, ids, e, gpu):
    """globaltimer stamps of the stamped moe_positions body (``MOE_STAMPS``)
    swapped into ``MK``, at ``ids``: the span from the first block's entry
    to the last block's end, and each step's time in the median block and
    in the last block."""
    from repro_torch.kernels._build import raise_on

    shipped = MK.LIBRARY
    stamps = np.zeros((1024, 8), np.uint64)
    MK.LIBRARY = lib
    try:
        for _ in range(3):
            raise_on(lib.get().probe_reset(), "probe_reset")
            MK.moe_positions_cuda(ids, e)
            torch.cuda.synchronize()
        raise_on(lib.get().probe_read(stamps.ctypes.data_as(ctypes.c_void_p)),
                 "probe_read")
    finally:
        MK.LIBRARY = shipped
    grid = MK.plan_positions(ids.numel(), e, _sm_count())["grid"]
    st = stamps[:grid, :7].astype(np.float64)
    steps = np.diff(st, axis=1)
    names = ("zero", "rank", "count share", "scan", "push to peers + cluster barrier",
             "sum + write")
    med = np.median(steps, axis=0)
    print(f"[probe] moe_positions {tuple(ids.shape)} by step (globaltimer, ns; "
          f"grid {grid}): first entry to last end {st[:, 6].max() - st[:, 0].min():.0f}, "
          f"entries spread over {st[:, 0].max() - st[:, 0].min():.0f}; median block: "
          + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, med))
          + "; last block: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, steps[-1]))
          + f"  [{gpu}]", flush=True)


def fadda_probes(gpu, parent=None):
    """Measurements behind the redesigned ``fadda`` and ``moe_positions``,
    apart from the smoke run: the latency of a dependent f32 add (a chain
    of 2^20, clock64()), the faulty copies of ``FADDA_MUTANTS`` against
    the cases of ``check_fadda`` (each must fail some), the phase split of
    the shipped fadda body by clock64() stamps, the price of the
    moe_positions blocks' redundant counting and a sweep of its rounds per
    warp at olmoe's prefill.  With ``parent`` (a tree holding the kernels
    before the redesign, e.g. unpacked by ``git archive``), the same
    stamps in the old fadda body, and both trees' kernels timed in turns
    (old, new, new, old) at the smoke run's shapes, with the host's
    enqueue time per ``moe_positions_cuda`` call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import raise_on
    from repro_torch.kernels.fadda import kernel as FK
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch.ref import moe_positions_ref

    src = FK.SOURCE.read_text()
    libs = {f"mutant{i}": _probe_library(f"fadda_mutant{i}",
                                         _replace_once(src, old, new),
                                         FK.LIBRARY.signatures)
            for i, (_, old, new) in enumerate(FADDA_MUTANTS)}
    probe_sig = {"probe_read": [ctypes.c_void_p], "probe_reset": []}

    def stamped(text, which, signatures):
        for old, new in FADDA_STAMPS[which]:
            text = _replace_once(text, old, new)
        text = _replace_once(text, "#include <cstdint>\n",
                             "#include <cstdint>\n" + PROBE_HEAD) + PROBE_TAIL
        return _probe_library(f"fadda_stamped_{which}", text,
                              {**signatures, **probe_sig})
    libs["stamped_new"] = stamped(src, "new", FK.LIBRARY.signatures)
    libs["moe_no_prefix"] = _probe_library(
        "moe_no_prefix", _replace_once(MK.SOURCE.read_text(), *MOE_NO_PREFIX),
        MK.LIBRARY.signatures)
    for i, (_, old_text, new_text) in enumerate(MOE_VARIANTS):
        libs[f"moe_variant{i}"] = _probe_library(
            f"moe_variant{i}", _replace_once(MK.SOURCE.read_text(), old_text, new_text),
            MK.LIBRARY.signatures)
    moe_text = MK.SOURCE.read_text()
    for a, b in MOE_STAMPS:
        moe_text = _replace_once(moe_text, a, b)
    moe_text = _replace_once(moe_text, "namespace {\n", MOE_PROBE_HEAD + "namespace {\n")
    libs["moe_stamped"] = _probe_library(
        "moe_stamped", moe_text + PROBE_TAIL,
        {**MK.LIBRARY.signatures, **probe_sig})
    libs["cluster_bench"] = _probe_library("cluster_bench", CLUSTER_BENCH, {
        "cluster_bench": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]})
    libs["fadd_chain"] = _probe_library("fadd_chain", FADD_CHAIN, {
        "fadd_chain_run": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                           ctypes.c_int, ctypes.c_void_p]})
    old = {}
    if parent is not None:
        kdir = Path(parent) / "src" / "repro_torch" / "kernels"
        old["fadda"] = _load_module(kdir / "fadda" / "kernel.py", "parent_fadda")
        old["moe"] = _load_module(kdir / "moe_dispatch" / "kernel.py", "parent_moe")
        libs["stamped_old"] = stamped(old["fadda"].SOURCE.read_text(), "old",
                                      old["fadda"].LIBRARY.signatures)
        libs["old_fadda"] = old["fadda"].LIBRARY
        libs["old_moe"] = old["moe"].LIBRARY
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    stream = torch.cuda.current_stream().cuda_stream
    ptxas_report([FK.SOURCE, MK.SOURCE])

    # the latency of one dependent add
    out = torch.zeros(1, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    iters = 2 ** 20
    for _ in range(3):
        raise_on(libs["fadd_chain"].get().fadd_chain_run(
            out.data_ptr(), cyc.data_ptr(), 1e-7, iters, stream), "fadd_chain")
    torch.cuda.synchronize()
    print(f"[probe] dependent add.rn.f32 (__fadd_rn) latency: "
          f"{cyc.item() / iters:.3f} cycles (clock64() over a chain of 2^20; "
          f"FADD_CYCLES = {FADD_CYCLES})  [{gpu}]", flush=True)

    cfg = get_config("olmoe_1b_7b")
    e, k = cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(14)
    ids = {name: torch.randint(0, e, (t, k), generator=gen, device="cuda",
                               dtype=torch.int32)
           for name, t in (("prefill", 7704), ("decode", 8))}
    if old:
        # the old bodies alone, before the new ones run
        fadda_phase_split(old["fadda"], libs["stamped_old"], gpu, "old")
        calls = _tree_calls(old, FK, MK, ids, e, k)
        floor = launch_floor_ms()
        for name, fns in calls.items():
            fns["old"]()
            torch.cuda.synchronize()
            print(f"[probe] {name}: old body alone {time_ms(fns['old'], 50):.4f} ms; "
                  f"launch floor {floor:.4f} ms  [{gpu}]", flush=True)
        dec = calls[f"moe_positions decode (8, {k})"]["old"]
        print(f"[probe] moe_positions_cuda host enqueue per call at (8, {k}), old "
              f"body alone: {host_enqueue_us(dec):.2f} us  [{gpu}]", flush=True)
    check_fadda()
    check_moe_positions()

    # the faulty copies against check_fadda's cases
    shipped = FK.LIBRARY
    try:
        for i, (what, _, _) in enumerate(FADDA_MUTANTS):
            FK.LIBRARY = libs[f"mutant{i}"]
            cases = fadda_cases()
            failed = [name for name, call in cases if not call()]
            print(f"[probe] fadda mutant '{what}': fails {len(failed)} of "
                  f"{len(cases)} cases of check_fadda ({'; '.join(failed)})  "
                  f"[{gpu}]", flush=True)
            check(failed, f"the mutant '{what}' passes check_fadda")
    finally:
        FK.LIBRARY = shipped

    # where the walker's cycles go
    fadda_phase_split(FK, libs["stamped_new"], gpu, "new")
    # moe_positions: the redundant counting, and rounds per warp
    pre = ids["prefill"]
    call = lambda: MK.moe_positions_cuda(pre, e)
    shipped_moe, turns = MK.LIBRARY, []
    try:
        for lib in (shipped_moe, libs["moe_no_prefix"], libs["moe_no_prefix"],
                    shipped_moe):
            MK.LIBRARY = lib
            turns.append(time_ms(call, 50))
    finally:
        MK.LIBRARY = shipped_moe
    print(f"[probe] moe_positions prefill (7704, 8): shipped {turns[0]:.4f} / "
          f"{turns[3]:.4f} ms, without counting the earlier tiles {turns[1]:.4f} "
          f"/ {turns[2]:.4f} ms (turns): the counting costs "
          f"{(turns[0] + turns[3] - turns[1] - turns[2]) / 2 * 1e3:.2f} us  "
          f"[{gpu}]", flush=True)
    for i, (what, _, _) in enumerate(MOE_VARIANTS):
        for name, x in ids.items():
            turns = []
            try:
                for lib in (shipped_moe, libs[f"moe_variant{i}"],
                            libs[f"moe_variant{i}"], shipped_moe):
                    MK.LIBRARY = lib
                    want = moe_positions_ref(x, e)
                    got = MK.moe_positions_cuda(x, e)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"moe variant '{what}' exact")
                    turns.append(time_ms(lambda: MK.moe_positions_cuda(x, e), 50))
            finally:
                MK.LIBRARY = shipped_moe
            print(f"[probe] moe_positions {name} {tuple(x.shape)}: shipped "
                  f"{turns[0]:.4f} / {turns[3]:.4f} ms, {what} {turns[1]:.4f} / "
                  f"{turns[2]:.4f} ms (turns)  [{gpu}]", flush=True)
    moe_phase_split(MK, libs["moe_stamped"], ids["prefill"], e, gpu)
    bench = libs["cluster_bench"].get()
    sink = torch.zeros(64, dtype=torch.int32, device="cuda")
    per = {k: time_ms(lambda k=k: raise_on(bench.cluster_bench(k, sink.data_ptr(), stream),
                                           "cluster_bench"), 50) for k in (0, 2, 8)}
    print(f"[probe] 64 blocks of 1024 threads in clusters of 8: {per[0]:.4f} ms with no "
          f"cluster barrier, {per[2]:.4f} ms with 2, {per[8]:.4f} ms with 8: "
          f"{(per[8] - per[0]) / 8 * 1e3:.3f} us a barrier  [{gpu}]", flush=True)
    sweep, shipped_min = {}, MK.MIN_ROUNDS
    try:
        for r in (1, 2, 4):
            MK.MIN_ROUNDS = r
            MK.plan_positions.cache_clear()
            sweep[r] = (time_ms(lambda: MK.moe_positions_cuda(pre, e), 50),
                        MK.plan_positions(pre.numel(), e, _sm_count())["grid"])
    finally:
        MK.MIN_ROUNDS = shipped_min
        MK.plan_positions.cache_clear()
    print("[probe] moe_positions prefill (7704, 8) by rounds per warp: "
          + ", ".join(f"{r}: {ms:.4f} ms (grid {g})" for r, (ms, g) in sweep.items())
          + f" (shipped: {MK.plan_positions(pre.numel(), e, _sm_count())['rounds']})"
          f"  [{gpu}]", flush=True)

    if not old:
        return
    # both trees' kernels in turns, by the same time_ms
    floor = launch_floor_ms()
    calls = _tree_calls(old, FK, MK, ids, e, k)
    for name, fns in calls.items():
        for tree in ("old", "new"):
            fns[tree]()
        torch.cuda.synchronize()
        t = [time_ms(fns[tree], 50) for tree in ("old", "new", "new", "old")]
        print(f"[probe] {name}: old body {t[0]:.4f} / {t[3]:.4f} ms, new body "
              f"{t[1]:.4f} / {t[2]:.4f} ms (turns); launch floor {floor:.4f} ms"
              f"  [{gpu}]", flush=True)
    dec = calls[f"moe_positions decode (8, {k})"]
    us = [host_enqueue_us(dec[tree]) for tree in ("old", "new", "new", "old")]
    print(f"[probe] moe_positions_cuda host enqueue per call at (8, {k}): old "
          f"{us[0]:.2f} / {us[3]:.2f} us, new {us[1]:.2f} / {us[2]:.2f} us "
          f"(turns; perf_counter over 1,000 calls between two synchronises)  "
          f"[{gpu}]", flush=True)


# ---------------------------------------------------------------------------
# training (--train, and in the full run): the flash backward, stablelm-3b's
# train step at full width, and mamba2-130m through the training launcher
# ---------------------------------------------------------------------------

SRC_BWD = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
# The backward's cases (b, hkv, group, sq, skv, causal, window, q_offset),
# each at every head dim of BWD_HEAD_DIMS: causal square (suffix alignment,
# the training shape), a ragged last tile, causal with a window and Sq < Skv
# (suffix aligned), non-causal with Sq < Skv (a decoder over encoder
# frames, an image) and Sq > Skv (an encoder over fewer keys), and an
# explicit q_offset (lane 1 starts 5 rows before key 0: its first 5 rows
# attend no key).  Lanes hold kv_lens (skv, skv // 2, 0): ragged and one
# empty lane (every row fully masked).
BWD_CASES = (
    (2, 2, 1, 64, 64, True, None, None),
    (3, 1, 4, 100, 100, True, None, None),
    (3, 2, 1, 37, 90, True, 9, None),
    (3, 1, 4, 70, 130, False, None, None),
    (2, 2, 1, 300, 128, False, None, None),
    (3, 1, 4, 50, 200, True, None, (150, -5, 0)),
)
BWD_HEAD_DIMS = (64, 80, 128, 160)
# The backward against the plain backward in f32 (both sum in f32 in other
# orders; bf16 at TOL["bwd"]), and the forward's lse, f32 and bf16 alike:
# both forwards sum the same products of the same (bf16) values and their
# exponentials in f32, in other orders
BWD_F32_TOL, LSE_TOL = (1e-4, 1e-4), (1e-5, 1e-5)


def _bwd_inputs(gen, b, hkv, group, sq, skv, d, dtype, causal, q_off):
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(b, hkv * group, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
    dout = rnd(b, hkv * group, sq, d)
    kv_lens = torch.tensor([skv, skv // 2, 0][:b], dtype=torch.int32, device="cuda")
    if q_off is None:
        q_off = [skv - sq if causal else 0] * b
    q_off = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    return q, k, v, dout, kv_lens, q_off


def check_flash_bwd() -> dict:
    """The CUDA backward (``flash_bwd_cuda``) and the forward's lse
    (``flash_dense_lse_cuda``) against the plain ``ref.flash_bwd`` /
    ``ref.flash_fwd_lse`` on the same inputs over ``BWD_CASES`` x
    ``BWD_HEAD_DIMS``, f32 and bf16: f32 at ``BWD_F32_TOL``, bf16 at
    ``TOL["bwd"]`` with each case's ratio printed, the lse at ``LSE_TOL``
    (f32 and bf16); fully masked rows' gradients exactly 0 and every
    gradient finite; two calls equal bit for bit.  Then the autograd route
    (``flash_attention`` on tensors that require grad) against autograd
    through the plain attention."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW

    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = {"f32": 0.0, "bwd": 0.0, "lse f32": 0.0, "lse bf16": 0.0}
    ratios = {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        kind = "f32" if dtype == torch.float32 else "bwd"
        atol, rtol = BWD_F32_TOL if kind == "f32" else TOL["bwd"]
        for d in BWD_HEAD_DIMS:
            for (b, hkv, group, sq, skv, causal, window, q_off) in BWD_CASES:
                q, k, v, dout, kv_lens, qo = _bwd_inputs(
                    gen, b, hkv, group, sq, skv, d, dtype, causal, q_off)
                win = torch.tensor([NO_WINDOW if window is None else window],
                                   dtype=torch.int32, device="cuda")
                scale = d ** -0.5
                where = f"bwd {dtype} d={d} {(b, hkv, group, sq, skv, causal, window, q_off)}"
                out, lse = K.flash_dense_lse_cuda(q, k, v, kv_lens, qo, win,
                                                  causal=causal, scale=scale)
                kw = dict(kv_lens=kv_lens, q_offset=qo, window=window,
                          causal=causal, scale=scale)
                out_p, lse_p = R.flash_fwd_lse(q, k, v, **kw)
                torch.testing.assert_close(lse, lse_p, atol=LSE_TOL[0],
                                           rtol=LSE_TOL[1],
                                           msg=lambda m: f"{where} lse: {m}")
                lkey = "lse f32" if dtype == torch.float32 else "lse bf16"
                worst[lkey] = max(worst[lkey], float((lse - lse_p).abs().max()))
                # both backwards on the same (kernel) forward
                K.reset_flash_counts()
                got = K.flash_bwd_cuda(q, k, v, out, dout, lse, kv_lens, qo, win,
                                       causal=causal, scale=scale)
                again = K.flash_bwd_cuda(q, k, v, out, dout, lse, kv_lens, qo, win,
                                         causal=causal, scale=scale)
                body = K.plan_bwd(dtype, d)
                check(K.flash_bwd_cuda.body_launches[body] == 2,
                      f"{where} took {K.flash_bwd_cuda.body_launches}, planned {body}")
                want = R.flash_bwd(q, k, v, out, dout, lse, **kw)
                torch.cuda.synchronize()
                for name, g, w, g2 in zip("qkv", got, want, again):
                    torch.testing.assert_close(
                        g, w, atol=atol, rtol=rtol,
                        msg=lambda m: f"{where} {body} d{name}: {m}")
                    check(torch.equal(g, g2), f"{where} {body}: d{name} "
                          "differs between two calls")
                    check(bool(torch.isfinite(g).all()),
                          f"{where} {body}: d{name} finite")
                    worst[kind] = max(worst[kind],
                                      float((g.float() - w.float()).abs().max()))
                    if kind == "bwd":
                        key = (b, hkv, group, sq, skv, causal, window, q_off)
                        ratios.setdefault(key, {})[(d, name)] = \
                            tol_ratio(g, w, atol, rtol)
                if b >= 3:    # lane 2: kv_len 0, every row fully masked
                    check(not got[0][2].any() and not got[1][2].any()
                          and not got[2][2].any(), f"{where} {body}: the "
                          "empty lane's gradients are 0")
                if q_off is not None:   # lane 1's first 5 rows attend no key
                    check(not got[0][1, :, :5].any(), f"{where} {body}: "
                          "rows before key 0 get dq 0")
                n += 1
    for key, rs in ratios.items():
        print(f"[train] flash bwd bf16 {key}: tol_ratio at ({TOL['bwd'][0]:g}, "
              f"{TOL['bwd'][1]:g}) by (head dim, grad) "
              + ", ".join(f"{d}{g}: {r:.3f}" for (d, g), r in rs.items()),
              flush=True)
    # the autograd route against autograd through the plain attention
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout, kv_lens, qo = _bwd_inputs(gen, 3, 2, 2, 96, 96, 80,
                                                 dtype, True, None)
        grads = []
        for impl in ("kernel", "naive"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            K.reset_flash_counts()
            out = flash_attention(*leaves, kv_lens=kv_lens, causal=True,
                                  window=40, impl=impl)
            grads.append(torch.autograd.grad(out, leaves, dout))
            if impl == "kernel":
                check(K.flash_dense_cuda.launches == 1
                      and K.flash_bwd_cuda.launches == 1
                      and K.flash_bwd_cuda.body_launches[K.plan_bwd(dtype, 80)] == 1,
                      f"the autograd route launched the forward "
                      f"{K.flash_dense_cuda.launches} and the backward "
                      f"{K.flash_bwd_cuda.launches} times, 1 each expected")
        # bf16: the two forwards' outputs already differ by a bf16 step (the
        # forward's tensor-core limit), and delta = rowsum(dO * O) carries
        # that into every dS
        lim = BWD_F32_TOL if dtype == torch.float32 else (2e-2, 2e-2)
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, atol=lim[0], rtol=lim[1])
    print(f"[train] flash backward held against the plain backward: {n} cases "
          f"({len(BWD_CASES)} masks x {len(BWD_HEAD_DIMS)} head dims x f32/bf16), "
          f"max |err| f32 {worst['f32']:.3g}, bf16 {worst['bwd']:.3g}, lse f32 "
          f"{worst['lse f32']:.3g}, lse bf16 {worst['lse bf16']:.3g}; limits f32 "
          f"{BWD_F32_TOL}, bf16 {TOL['bwd']}, lse {LSE_TOL}; deterministic, finite, fully "
          f"masked rows 0; the autograd route == autograd through the plain "
          "attention", flush=True)
    return worst


def time_flash_bwd(gpu) -> dict:
    """The backward at stablelm-3b's training shape (q/k/v (2, 32, 4096,
    80) bf16, causal) and at stablelm-12b's head dim 160 (32 query heads
    over 8 KV heads), held there against the plain backward at
    ``TOL["bwd"]`` and the forward's lse against the plain forward's at
    ``LSE_TOL`` (each ratio printed), and timed beside the plain backward
    (``time_wall_ms``: its host is the slower side), the bound (5 products of
    S x S x D over the live pairs at the bf16 peak, or the bytes: q, k, v,
    O, dO and lse read once, dQ, dK, dV written once) and the backward of
    ``scaled_dot_product_attention`` (causal) on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    for name, (b, h, hkv, s, d) in (("bwd_stablelm_3b", (2, 32, 32, 4096, 80)),
                                    ("bwd_stablelm_12b", (2, 32, 8, 4096, 160))):
        bf = torch.bfloat16
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(bf)
        q, k, v, dout = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), rnd(b, h, s, d)
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        zero = torch.zeros(b, dtype=torch.int32, device="cuda")
        win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
        scale = d ** -0.5
        out, lse = K.flash_dense_lse_cuda(q, k, v, lens, zero, win, causal=True,
                                          scale=scale)
        kern = lambda: K.flash_bwd_cuda(q, k, v, out, dout, lse, lens, zero, win,
                                        causal=True, scale=scale)
        plain = lambda: R.flash_bwd(q, k, v, out, dout, lse, kv_lens=lens,
                                    q_offset=zero, causal=True, scale=scale)
        got, want = kern(), plain()
        lse_p = R.flash_fwd_lse(q, k, v, kv_lens=lens, q_offset=zero, causal=True,
                                scale=scale)[1]
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        ratios = {f"d{n}": tol_ratio(g, w, *TOL["bwd"])
                  for n, g, w in zip("qkv", got, want)}
        ratios["lse"] = tol_ratio(lse, lse_p, *LSE_TOL)
        del got, want, lse_p
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale,
                                              enable_gqa=h != hkv)
        lib = lambda: torch.autograd.grad(sdpa, leaves, dout, retain_graph=True)
        K.reset_flash_counts()
        kern()
        launches = K.flash_bwd_cuda.launches
        body = K.plan_bwd(q.dtype, d)
        pairs = b * h * s * (s + 1) // 2
        rows[name] = dict(
            shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
            body=body, ms=time_ms(kern, 5), plain_ms=time_wall_ms(plain, 2),
            library_ms=time_ms(lib, 5), flops=2 * 5 * d * pairs,
            bytes=2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
            max_abs_err=err, launches_per_call=launches, tol_ratio=ratios)
        del sdpa, leaves, out, lse, q, k, v, dout
        torch.cuda.empty_cache()
    print_rows(rows, gpu)
    for name, r in rows.items():
        print(f"[time] {name}: {r['launches_per_call']} wrapper call = 3 kernel "
              f"launches (delta, dQ, dK/dV; 4 past D 128, dV and dK apart) on the "
              f"{r['body']} body; kernel / bound "
              f"{r['ms'] / r['bound_ms']:.1f}x, kernel / library "
              f"{r['ms'] / r['library_ms']:.1f}x; against the plain versions "
              f"tol_ratio (dq, dk, dv at {TOL['bwd']}, lse at {LSE_TOL}) "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["tol_ratio"].items())
              + f"  [{gpu}]", flush=True)
    for name, r in rows.items():
        for k, v in r["tol_ratio"].items():
            check(v <= 1.0, f"{name}: {k} against the plain version at "
                  f"{v:.3f} of its limit")
    return rows


# The training legs: stablelm-3b at full width (32 x d 2560) on the
# train_4k sequence of configs/shapes.py (4096), its global batch of 256
# cut to 2 on one card, full remat, random weights from seed 0, 5 AdamW
# steps on one repeated batch; the checks of bits and of the plain path at
# 4 of its 32 layers (the plain path at seq 512: its attention builds S x S
# scores); mamba2-130m through the training launcher at 2048 x 8.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 5
# the schedule of the 5 steps: the launcher's (make_train_step's defaults:
# peak 3e-4 after 100 warmup steps, so 3e-6 .. 1.5e-5 here).  Faster ramps
# took the random-init loss from 11.0 to ~5.9 in one step and then up
# (peak 3e-4 in 2 steps: 7.2 at step 3; peak 1e-4 in 5: 13.4 at step 5)
TRAIN_3B = dict(peak_lr=3e-4, warmup=100, total=10000)
TRAIN_CHECK_LAYERS, PLAIN_TRAIN_SEQ = 4, 512
# the first step through the kernels against the plain path (bf16 weights,
# impl="naive": autograd through the plain attention), relative: the loss,
# the gradients' global norm, and each leaf's gradient by its L2 norm
# (|g - g_plain| <= leaf * |g_plain| + floor * the global norm, the floor
# for a leaf whose gradient is near 0).  bf16 activations and gradients
# rounded to bf16 in other places; readings on an H100: loss 3.8e-5,
# global norm 1.8e-5 to 8.2e-5, the worst leaf 0.275 of its limit; held
# at a few times that
TRAIN_LIMITS = {"loss": 2e-4, "grad_norm": 3e-4, "leaf": 2e-2, "floor": 1e-4}
# the loss curve of TRAIN_STEPS steps at full depth and seq 512, through the
# kernels and through the plain path from the same state: both bf16, the
# roundings compound over the steps (AdamW's first steps move each weight
# by about lr whatever |g|, so a gradient near 0 may move it either way).
# Reading on an H100: 6.1e-5 at the first step growing to 1.3e-3 at the
# fifth; held at a few times that
CURVE_LIMIT = 5e-3
MAMBA_TRAIN = ["--arch", "mamba2_130m", "--steps", "20", "--batch", "8",
               "--seq", "2048"]
MAMBA_FAULT_STEP = 11


def _train_batch(cfg, seq, b):
    from repro_torch.data import SyntheticLM

    tokens, labels, lens = SyntheticLM(cfg.vocab_size, seq, seed=0).batch(0, b)
    return {k: torch.from_numpy(v).cuda() for k, v in
            (("tokens", tokens), ("labels", labels), ("lens", lens))}


def _same_tree(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a) and sorted(a) == sorted(b)


def _global_norm(grads) -> float:
    return float(torch.sqrt(sum(g.float().square().sum() for g in grads.values())))


def _causal_pairs(lens, s: int) -> int:
    """Live (query, key) pairs of one head under the causal mask and the
    rows' kv_lens: query i attends keys j <= i with j < len."""
    i = torch.arange(s, device=lens.device)
    return int(torch.minimum(i[None] + 1, lens[:, None].long()).sum())


# kernel name -> its part of a train step, for ``profile_train_step``
TRAIN_PARTS = (("flash backward", ("flash_bwd",)),
               ("flash forward", ("flash_dense_tc", "flash_fwd")),
               ("SSD scan", ("ssd_",)),
               ("matmuls", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")),
               ("reductions, norms, softmax", ("reduce", "norm", "softmax",
                                               "logsumexp")))


def profile_train_step(name, step, state, batch, gpu):
    """One more step under ``torch.profiler`` (device events): its wall
    time, the device's busy time (the union of its kernels' intervals) and
    idle share, and device time by part (``TRAIN_PARTS``; the rest is the
    elementwise kernels, casts and copies).  Returns the state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[profile] {name} train step: wall {wall:.1f} ms; device time not "
              f"measured (the profiler saw no device events)  [{gpu}]", flush=True)
        return state
    parts, names = collections.Counter(), collections.Counter()
    for e in dev:
        low = e.name.lower()
        part = next((p for p, keys in TRAIN_PARTS if any(k in low for k in keys)),
                    "elementwise, casts, copies")
        ms = (e.time_range.end - e.time_range.start) / 1e3
        parts[part] += ms
        names[e.name[:60]] += ms
    busy = busy_ms(dev)
    print(f"[profile] {name} train step (profiled): wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {1 - busy / wall:.1%}, {len(dev)} device events; "
          f"device ms by part "
          + ", ".join(f"{p} {ms:.1f}" for p, ms in parts.most_common())
          + "; top kernels " + "; ".join(f"{n} {ms:.1f}" for n, ms in
                                         names.most_common(6))
          + f"  [{gpu}]", flush=True)
    return state


def train_stablelm_3b(gpu) -> dict:
    """stablelm-3b's train step (``repro_torch.train``) at full width.  At 4
    of its 32 layers (seq 4096): two first steps from the same state equal
    bit for bit (metrics and every updated parameter), remat full == none
    bit for bit (loss and every gradient), and at seq 512 the first step's
    loss, gradient norm and each leaf's gradient against the plain path at
    ``TRAIN_LIMITS``.  At full depth and seq 512: ``TRAIN_STEPS`` steps'
    losses through the kernels against the plain path's from the same state
    at ``CURVE_LIMIT``.  At full depth: ``TRAIN_STEPS`` steps on one batch,
    the loss finite and
    falling, each step launching the flash forward twice per layer (the
    forward and remat's re-run, tensor-core body) and the backward once;
    the step time by CUDA events, tokens/s, the peak of
    ``max_memory_allocated`` and the model-FLOP share of the bf16 peak
    (8 N T with full remat, plus the attention's 18 D pairs a layer).
    Returns the launches of the full-depth run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.train.step import (copy_state, init_state, make_grads,
                                        make_train_step)

    cfg = get_config("stablelm_3b")
    widths = WIDTHS["stablelm_3b"]
    got = {k: getattr(cfg, k) for k in widths}
    check(got == widths, f"stablelm_3b widths {got}, published {widths}")
    cfg = cfg.replace(remat="full")
    batch = _train_batch(cfg, TRAIN_SEQ, TRAIN_BATCH)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)

    cfg4 = cfg.replace(n_layers=TRAIN_CHECK_LAYERS)
    state = init_state(cfg4, gen(), "cuda")
    twin = copy_state(state)
    step4 = make_train_step(cfg4, **TRAIN_3B)
    state, m1 = step4(state, batch)
    twin, m2 = step4(twin, batch)
    check(_same_tree(m1, m2) and _same_tree(state["params"], twin["params"])
          and _same_tree(state["opt"]["m"], twin["opt"]["m"]),
          "two first steps from one state differ")
    del twin
    params = state["params"]
    (l_full, _), g_full = make_grads(cfg4)(params, batch)
    (l_none, _), g_none = make_grads(cfg4.replace(remat="none"))(params, batch)
    check(torch.equal(l_full, l_none) and _same_tree(g_full, g_none),
          "remat full != none")
    del g_full, g_none
    short = _train_batch(cfg, PLAIN_TRAIN_SEQ, TRAIN_BATCH)
    (l_k, _), g_k = make_grads(cfg4)(params, short)
    (l_p, _), g_p = make_grads(cfg4.replace(attn_impl="naive"))(params, short)
    n_k, n_p = _global_norm(g_k), _global_norm(g_p)
    leaf = {n: float((g_k[n].float() - g_p[n].float()).norm())
            / (TRAIN_LIMITS["leaf"] * float(g_p[n].float().norm())
               + TRAIN_LIMITS["floor"] * n_p) for n in g_p}
    worst_leaf = max(leaf, key=leaf.get)
    del g_k, g_p, params, state
    err = {"loss": abs(float(l_k) - float(l_p)) / abs(float(l_p)),
           "grad_norm": abs(n_k - n_p) / n_p}
    print(f"[train] stablelm-3b at {TRAIN_CHECK_LAYERS} layers: two first steps "
          f"equal bit for bit (loss {float(m1['loss']):.6f}, grad norm "
          f"{float(m1['grad_norm']):.6f}); remat full == none bit for bit (loss "
          f"{float(l_full):.6f} and every gradient); first step at seq "
          f"{PLAIN_TRAIN_SEQ}, kernels against the plain path: loss {float(l_k):.6f} "
          f"vs {float(l_p):.6f} (rel {err['loss']:.2e}), grad norm {n_k:.6f} vs "
          f"{n_p:.6f} (rel {err['grad_norm']:.2e}), {len(leaf)} leaves' gradients "
          f"at most {leaf[worst_leaf]:.3f} of their limit ({worst_leaf}); limits "
          f"{TRAIN_LIMITS}", flush=True)
    for k in ("loss", "grad_norm"):
        check(err[k] <= TRAIN_LIMITS[k], f"stablelm-3b first-step {k} against "
              f"the plain path: rel {err[k]:.3g} > {TRAIN_LIMITS[k]}")
    check(leaf[worst_leaf] <= 1.0, f"stablelm-3b first-step gradient of "
          f"{worst_leaf} against the plain path at {leaf[worst_leaf]:.3f} of its limit")
    torch.cuda.empty_cache()

    curves = {}
    for impl, cfg_i in (("kernel", cfg), ("naive", cfg.replace(attn_impl="naive"))):
        state = init_state(cfg_i, gen(), "cuda")
        step = make_train_step(cfg_i, **TRAIN_3B)
        curves[impl] = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, short)
            curves[impl].append(float(m["loss"]))
        del state, m, step
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["kernel"], curves["naive"])]
    print(f"[train] stablelm-3b full depth, seq {PLAIN_TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps from one state: losses through the kernels "
          f"{[round(x, 4) for x in curves['kernel']]}, through the plain path "
          f"{[round(x, 4) for x in curves['naive']]}; rel {[f'{x:.1e}' for x in rel]} "
          f"(limit {CURVE_LIMIT})", flush=True)
    check(max(rel) <= CURVE_LIMIT, f"stablelm-3b loss curve through the kernels "
          f"against the plain path: rel {max(rel):.3g} > {CURVE_LIMIT}")

    t0 = time.perf_counter()
    state = init_state(cfg, gen(), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].values())
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, **TRAIN_3B)
    losses, norms, times = [], [], []
    reset_counts()
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts, bodies = read_counts(), read_bodies()
    bwd_bodies = dict(K.flash_bwd_cuda.body_launches)
    peak = torch.cuda.max_memory_allocated()
    del m
    state = profile_train_step("stablelm-3b", step, state, batch, gpu)
    del state
    torch.cuda.empty_cache()
    layers = cfg.n_layers
    ms = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = cfg.n_heads * _causal_pairs(batch["lens"], TRAIN_SEQ)
    flops = 8 * n_params * tokens + 18 * cfg.resolved_head_dim * pairs * layers
    print(f"[train] stablelm-3b full width ({layers} x d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params, f32 masters, bf16 compute, remat "
          f"full), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: init {init_s:.1f} s; "
          f"losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 4) for x in norms]}; step times ms {[round(t, 1) for t in times]}",
          flush=True)
    print(f"[train] stablelm-3b step {ms:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
          f"{tokens / ms * 1e3:.0f} tokens/s, peak max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB, model FLOPs {flops / 1e12:.1f} TFLOP a step "
          f"= {flops / (ms * 1e-3) / PEAK_BF16_FLOPS:.3f} of {PEAK_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s; launches over {TRAIN_STEPS} steps "
          f"{ {k: v for k, v in counts.items() if v} }  [{gpu}]", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"stablelm-3b losses {losses}: not finite and falling")
    want = dict.fromkeys(kernel_wrappers(), 0)
    want.update(flash_attention_dense=2 * layers * TRAIN_STEPS,
                flash_attention_bwd=layers * TRAIN_STEPS)
    check(counts == want, f"stablelm-3b training launches {counts}, expected {want}")
    check(bodies["flash_attention_dense"]["tensor_core"] == 2 * layers * TRAIN_STEPS,
          f"the training forward's bodies {bodies['flash_attention_dense']}")
    check(bwd_bodies["tensor_core"] == layers * TRAIN_STEPS,
          f"the training backward's bodies {bwd_bodies}")
    return counts


# Small f32 twins of the families whose training does not run at full width
# on one card here (the VLM branch, encdec, MoE): the launcher's reduced dims
# (launch.train.reduced), one step's loss and gradients on the card (the
# flash forward with lse and backward in f32, moe_positions on the card)
# against the same step on the CPU (the plain versions), relative to each
# leaf's largest gradient
FAMILY_TRAIN_ARCHS = ("llama_3_2_vision_11b", "seamless_m4t_large_v2", "olmoe_1b_7b")
FAMILY_TRAIN_TOL = 1e-4


def check_train_families() -> None:
    """One train step's gradients of ``FAMILY_TRAIN_ARCHS`` at reduced dims
    (f32) on the card against the CPU, the MoE router's included (the gates
    keep their graph through ``build_dispatch``, whose ranks come from the
    kernel on the card); and the launcher refusing an arch whose f32 state
    does not fit the card, naming the bytes."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.train.step import init_state, make_grads

    for arch in FAMILY_TRAIN_ARCHS:
        cfg = T.reduced(get_config(arch))
        runs = []
        for dev in ("cuda", "cpu"):
            state = init_state(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
            params = {k: v.detach().to(dev).requires_grad_() for k, v in
                      state["params"].items()}
            batch = T.make_batch_fn(cfg, SyntheticLM(cfg.vocab_size, 32, seed=0),
                                    2, 32, dev)(0)
            reset_counts()
            (loss, aux), grads = make_grads(cfg)(params, batch)
            runs.append((loss, aux, grads, read_counts()))
        (lc, ac, gc, counts), (lp, ap, gp, _) = runs
        check(counts["flash_attention_bwd"] > 0 and counts["flash_attention_dense"] > 0,
              f"{arch}: the card's step launched {counts}")
        check(abs(float(lc) - float(lp)) <= FAMILY_TRAIN_TOL * abs(float(lp)),
              f"{arch} loss {float(lc)} on the card, {float(lp)} on the CPU")
        worst = 0.0
        for n, g in gp.items():
            # a leaf whose exact gradient is 0 (a cross-attention key bias:
            # softmax ignores a shift of every key) is held to 1e-7
            lim = FAMILY_TRAIN_TOL * float(g.abs().max()) + 1e-7
            err = float((gc[n].cpu() - g).abs().max())
            worst = max(worst, err / lim)
            check(err <= lim, f"{arch} gradient {n}: {err:.3g} over {lim:.3g}")
        if "lb_loss" in ap:
            router = [n for n in gp if n.endswith("moe.router")]
            check(router and all(float(gc[n].abs().max()) > 0 for n in router),
                  f"{arch}: the router gets no gradient on the card")
        print(f"[train] {cfg.name} reduced (f32): one step's loss and every "
              f"gradient on the card against the CPU, worst {worst:.3f} of the limit "
              f"({FAMILY_TRAIN_TOL} of the leaf's largest + 1e-7); launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    cfg = get_config("olmoe_1b_7b")
    try:
        T.check_fits(cfg, torch.device("cuda"))
        check(False, "olmoe-1b-7b's f32 state was taken to fit one card")
    except RuntimeError as e:
        print(f"[train] the launcher refuses olmoe-1b-7b: {e}", flush=True)


def train_mamba2_130m(gpu) -> dict:
    """mamba2-130m through ``repro_torch.launch.train``'s main path (the
    launcher's default arch) at full width (24 x d 768), seq 2048 x batch 8:
    20 steps with ``FaultTolerantLoop``, checkpoints every 10, one injected
    step fault at step ``MAMBA_FAULT_STEP`` recovered from step 10's
    checkpoint; the final loss and every parameter equal, bit for bit, to
    an uninterrupted run's, which launches the SSD scan once per layer per
    step.  Returns the uninterrupted run's launches."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.train import make_train_step

    cfg = get_config("mamba2_130m")
    widths = WIDTHS["mamba2_130m"]
    got = {k: getattr(cfg, k) for k in widths}
    check(got == widths, f"mamba2_130m widths {got}, published {widths}")
    fired = []

    def inject(step):
        if step == MAMBA_FAULT_STEP and not fired:
            fired.append(step)
            raise RuntimeError(f"injected step fault at step {step}")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        state_f, hist_f, loop_f = T.main(MAMBA_TRAIN + ["--ckpt-dir", f"{d}/faulty"],
                                         fault_injector=inject)
        torch.cuda.synchronize()
        faulty_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        state_c, hist_c, loop_c = T.main(MAMBA_TRAIN + ["--ckpt-dir", f"{d}/clean"])
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        counts = read_counts()
        kept = sorted(os.listdir(f"{d}/clean"))
    steps = int(MAMBA_TRAIN[MAMBA_TRAIN.index("--steps") + 1])
    check(loop_f.recoveries == 1 and loop_c.recoveries == 0,
          f"recoveries {loop_f.recoveries}, {loop_c.recoveries}")
    check([s for s, _ in hist_f] == list(range(MAMBA_FAULT_STEP))
          + list(range(10, steps)), f"faulty run's steps {[s for s, _ in hist_f]}")
    check(hist_f[-1] == hist_c[-1] and _same_tree(state_f["params"], state_c["params"]),
          f"final loss {hist_f[-1]} after the fault, {hist_c[-1]} uninterrupted")
    check(hist_c[-1][1] < hist_c[0][1], f"mamba2 loss {hist_c[0][1]} -> {hist_c[-1][1]}")
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["ssd_scan"] = cfg.n_layers * steps
    check(counts == want, f"mamba2 training launches {counts}, expected {want}")
    print(f"[train] mamba2-130m through launch.train: {steps} steps of 8 x 2048, "
          f"checkpoints {kept}; a fault at step {MAMBA_FAULT_STEP} restored step "
          f"10 and the final loss {hist_f[-1][1]!r} equals the uninterrupted run's "
          f"{hist_c[-1][1]!r} bit for bit (every parameter too); loss "
          f"{hist_c[0][1]:.4f} -> {hist_c[-1][1]:.4f}; {clean_s:.1f} s "
          f"uninterrupted ({clean_s / steps * 1e3:.0f} ms a step with checkpoints), "
          f"{faulty_s:.1f} s with the fault; step EWMA "
          f"{loop_c.watchdog.ewma * 1e3:.0f} ms; launches "
          f"{ {k: v for k, v in counts.items() if v} }  [{gpu}]", flush=True)
    del state_f
    batch = T.make_batch_fn(cfg, SyntheticLM(cfg.vocab_size, 2048, seed=0), 8,
                            2048, "cuda")(steps)
    state_c = profile_train_step("mamba2-130m", make_train_step(cfg), state_c,
                                 batch, gpu)
    del state_c
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f"  torch {torch.__version__} cuda {torch.version.cuda}  [{gpu}]",
          flush=True)

    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s (at "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        return out

    args = sys.argv[1:]
    phase("build", build_all)
    if "--ssd-probes" in args:
        phase("ssd probes", ssd_probes, gpu)
        return 0
    if "--chunk-probe" in args:
        phase("chunk probe", chunk_probe, gpu)
        return 0
    if "--gemm-probe" in args:
        phase("gemm probe", gemm_probe, gpu)
        return 0
    if "--scheduler" in args:
        phase("serve scheduler", serve_scheduler, gpu)
        return 0
    if "--fadda-probes" in args:
        parent = args[args.index("--parent") + 1] if "--parent" in args else None
        phase("fadda probes", fadda_probes, gpu, parent)
        return 0
    if "--cross" in args:
        phase("check cross roles", check_cross_roles, flash_attention)
        phase("time cross", time_cross, gpu)
        for arch in CROSS_ARCHS:
            phase(f"serve {arch}", serve_cross, arch, gpu)
        phase("serve encdec scheduler", serve_encdec_scheduler, gpu)
        return 0
    if "--train" in args:
        from repro_torch.kernels.flash_attention import kernel as K
        phase("ptxas flash", ptxas_report, [*K.LIBRARIES, K.BWD_LIBRARY])
        phase("check flash bwd", check_flash_bwd)
        phase("time flash bwd", time_flash_bwd, gpu)
        phase("check train families", check_train_families)
        phase("train stablelm_3b", train_stablelm_3b, gpu)
        phase("train mamba2_130m", train_mamba2_130m, gpu)
        return 0
    if "--spec" in args:
        from repro_torch.kernels.flash_attention import kernel as K
        phase("ptxas flash", ptxas_report, [K.SOURCE])
        phase("check flash", check_kernels, flash_attention)
        phase("check flash quant", check_quant_kernel, flash_attention)
        phase("check paged == dense", check_paged_equals_dense, flash_attention)
        phase("check batch independence", check_batch_independence,
              flash_attention)
        phase("time flash d160", time_head160, gpu)
        s12 = phase("serve stablelm_12b", serve_stablelm_12b, gpu)
        phase("serve speculative", serve_speculative, s12, gpu)
        return 0
    phase("check flash", check_kernels, flash_attention)
    phase("check flash quant", check_quant_kernel, flash_attention)
    phase("check paged == dense", check_paged_equals_dense, flash_attention)
    phase("check batch independence", check_batch_independence, flash_attention)
    phase("check prefill rows", check_prefill_rows, flash_attention)
    cross_bodies = phase("check cross roles", check_cross_roles,
                         flash_attention)
    phase("check ssd", check_ssd)
    phase("check moe_positions", check_moe_positions)
    phase("check fadda", check_fadda)
    phase("check moe_positions in a graph", check_moe_positions, graphed)
    phase("check fadda in a graph", check_fadda, graphed)
    phase("check daxpy", check_daxpy)
    phase("check threefry", check_prng)
    served = {arch: phase(f"serve {arch}", serve_model, arch, gpu)
              for arch in WIDTHS}
    sched_launches, _ = phase("serve scheduler", serve_scheduler, gpu)
    cross = {arch: phase(f"serve {arch}", serve_cross, arch, gpu)
             for arch in CROSS_ARCHS}
    sched_launches.update(phase("serve encdec scheduler",
                                serve_encdec_scheduler, gpu))
    s12 = phase("serve stablelm_12b", serve_stablelm_12b, gpu)
    spec = phase("serve speculative", serve_speculative, s12, gpu)
    cross["stablelm_12b"] = s12["runs"]
    del s12
    torch.cuda.empty_cache()
    cfg, lens, max_len, _ = served["stablelm_3b"]
    rows = phase("time flash", time_kernels, cfg, lens, max_len, gpu)
    phase("time flash d160", time_head160, gpu)
    ssd_rows = phase("time ssd", time_ssd, lens, gpu)
    floor_ms = phase("launch floor", launch_floor_ms)
    moe_rows = phase("time moe_positions", time_moe_positions, lens, gpu,
                     floor_ms)
    fadda_times = phase("time fadda", time_fadda, cfg.padded_vocab, gpu,
                        floor_ms)
    daxpy_rows = phase("time daxpy", time_daxpy, gpu)
    phase("time cross", time_cross, gpu)
    quick = phase("quickstart", run_quickstart)
    torch.cuda.empty_cache()
    phase("check flash bwd", check_flash_bwd)
    bwd_rows = phase("time flash bwd", time_flash_bwd, gpu)
    phase("check train families", check_train_families)
    train_counts = [phase("train stablelm_3b", train_stablelm_3b, gpu),
                    phase("train mamba2_130m", train_mamba2_130m, gpu)]

    every_run = ([r for *_, runs in served.values() for r in runs.values()]
                 + [r for runs in cross.values() for r in runs.values()]
                 + spec)
    launches = {k: sum(r["counts"][k] for r in every_run) + quick[k]
                + sum(c[k] for c in sched_launches.values())
                + sum(c[k] for c in train_counts)
                for k in kernel_wrappers()}
    bodies = {k: {body: sum(r["bodies"][k][body] for r in every_run)
                  for body in v}
              for k, v in read_bodies().items()}
    print(f"[full] launches over every generate (the cross-attention models', "
          f"gemma3's and stablelm-12b's included), the speculative legs, the "
          f"scheduler legs' warm runs, the quickstart and the training legs' "
          f"counted runs: {launches}; the flash "
          f"kernels by body over every generate and speculative leg: {bodies}; "
          f"the cross-attention roles' check: {cross_bodies}", flush=True)
    entries = []
    for name, row, source, replaces in (
            ("flash_attention_dense", rows["dense_prefill"], SRC_CU,
             "src/repro/kernels/flash_attention/kernel.py:237"),
            ("flash_attention_paged", rows["paged_decode"], SRC_CU,
             "src/repro/kernels/flash_attention/kernel.py:165"),
            ("flash_attention_paged_quant", rows["paged_decode_int8"], SRC_CU,
             "src/repro/kernels/flash_attention/kernel.py:137"),
            ("ssd_scan", ssd_rows["zamba2_1_2b"], SRC_SSD,
             "src/repro/kernels/ssd_scan/kernel.py:80"),
            ("moe_positions", moe_rows["prefill"], SRC_MOE,
             "src/repro/kernels/moe_dispatch/kernel.py:55"),
            ("fadda", fadda_times["scan"], SRC_FADDA,
             "src/repro/kernels/fadda/kernel.py:47"),
            ("daxpy", daxpy_rows["f32"], SRC_DAXPY,
             "src/repro/kernels/daxpy/kernel.py:32"),
            ("flash_attention_bwd", bwd_rows["bwd_stablelm_3b"], SRC_BWD,
             "src/repro/kernels/flash_attention/xla_impl.py:110")):
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
            **({"launch_floor_ms": row["launch_floor_ms"]}
               if "launch_floor_ms" in row else {}),
            **({"bodies": bodies[name]} if name in bodies else {})})
    dd = rows["dense_decode"]
    print(f"[time] flash_attention_dense also runs every dense-cache decode "
          f"step: {dd['ms']:.4f} ms (bound {dd['bound_ms']:.4f} ms, "
          f"{dd['bound_by']}; plain {dd['plain_ms']:.4f}; library "
          f"{dd['library_ms']:.4f})  [{gpu}]", flush=True)
    print(json.dumps({"kernels": entries}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
