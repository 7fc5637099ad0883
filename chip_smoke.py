"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from the sources in the checkout:
   one ``nvcc`` per source, all started together.
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
   ``fadda`` sums and scans and ``daxpy`` exactly, bit for bit), holds bf16
   paged decode equal to dense decode bit for bit and each lane's bf16
   decode equal alone and in the batch, checks the threefry bits on the
   card against the CPU's, and times each kernel at the shapes its path
   gives it, beside its plain version, its bound and, where one exists,
   one PyTorch library call (``moe_positions`` and ``fadda`` also beside
   the launch floor: the time of one empty kernel).
3. Serves 8 greedy requests through ``ServeEngine.generate`` at the full
   width of stablelm-3b (dense family), zamba2-1.2b (hybrid), mamba2-130m
   (ssm) and olmoe-1b-7b (moe), random weights from seed 0, with the dense
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
4. Runs the port's quickstart (daxpy, Fig. 2; fadda, §2.4) on the card.
5. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Any failed phase raises, and the script exits non-zero without a result.
It needs CUDA; without it, or without the repo's ``src/`` beside it, it
fails.

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

    libs = {"flash_attention": K.LIBRARY, "ssd_scan": SK.LIBRARY,
            "moe_dispatch": MK.LIBRARY, "fadda": FK.LIBRARY,
            "daxpy": DK.LIBRARY, "launch_floor": empty_library()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(lib.build) for name, lib in libs.items()}
        paths = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
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
DENSE_HEAD_DIMS = (16, 32, 37, 64, 80, 96, 100, 128)   # every tensor-core instance
# Paged cases (b, hkv, group, sq, ps, n_pages) and the body each takes in
# bf16 (f32 always takes the CUDA-core body): the split-KV body at every
# row-count instance (1, 2, 4, 6 and 16 rows per KV head), page sizes 8 and
# 16, one and several splits (1120 keys: 5); a chunk of 24 rows on the
# CUDA-core body.  Lanes hold kv_lens (skv, skv // 2 + 1, 0, 5) with stale
# ids past the second lane's strip; each case runs non-causal, causal, and
# causal with a window.
PAGED_CASES = (
    ((4, 2, 1, 1, 16, 70), "split_kv"),
    ((4, 2, 2, 1, 8, 9), "split_kv"),
    ((4, 1, 4, 1, 16, 5), "split_kv"),
    ((4, 2, 2, 3, 8, 9), "split_kv"),
    ((4, 1, 4, 4, 16, 20), "split_kv"),
    ((4, 1, 8, 2, 8, 40), "split_kv"),
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
TOL = {"f32": (1e-5, 1e-5), "tensor_core": (1e-5, 2 ** -7),
       "split_kv": (1e-5, 2 ** -7), "paged_cuda_core": (2e-2, 2e-2)}


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
                          q_offset=q_off)
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
                                            skv, d).splits)
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
                              q_offset=q_off, page_table=table)
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
# 8 and 16, head dims 48, 64, 80 and 128, with and without a window; a
# chunk of 20 rows on the CUDA-core body.
QUANT_CASES = (
    ((64, 16, 1, 1, None), "split_kv"),
    ((80, 16, 2, 1, None), "split_kv"),
    ((80, 8, 4, 1, 29), "split_kv"),
    ((128, 8, 2, 3, 11), "split_kv"),
    ((48, 8, 4, 4, None), "split_kv"),
    ((64, 16, 8, 2, 50), "split_kv"),
    ((80, 16, 4, 5, None), "cuda_core"),
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
                          k_scale=ks, v_scale=vs)
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
    per KV head, causal, with and without a window, head dims 64, 80 and
    128."""
    from repro_torch.kernels.flash_attention import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(13)
    lens = torch.tensor([812, 687, 757, 320, 963, 891, 835, 0], dtype=torch.int32,
                        device="cuda") + 1
    n_cases = 0
    for d, hkv, group, sq in ((80, 32, 1, 1), (64, 4, 4, 4), (128, 16, 1, 1)):
        q = torch.randn(8, hkv * group, sq, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(8, hkv, 1027, d, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        for ps in (8, 16):
            kp, vp, table = _pages_of(k, v, ps, gen)
            for window in (None, 200):
                kw = dict(kv_lens=lens, causal=True, window=window,
                          q_offset=(lens - sq).clamp_min(0))
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
          f"(torch.equal): {n_cases} cases (d 64, 80, 128; ps 8, 16; 1 and 16 "
          f"rows per KV head; window none and 200)", flush=True)


def check_batch_independence(flash_attention):
    """Each lane's bf16 decode output, dense and paged, is bit for bit the
    same alone in a short cache (its own keys, rounded up to a page) as
    among the 8 lanes of the smoke batch in the 1027-key cache: the split
    grid follows from the lane's own keys only."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    lens = torch.tensor([812, 687, 757, 320, 963, 891, 835, 487], dtype=torch.int32,
                        device="cuda") + 1
    d, hkv, ps = 80, 32, PAGE_SIZE
    q = torch.randn(8, hkv, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(8, hkv, 1027, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    kp, vp, table = _pages_of(k, v, ps, gen)
    kw = lambda ln: dict(kv_lens=ln, causal=True, q_offset=ln - 1)
    batch = {"dense": flash_attention(q, k, v, impl="kernel", **kw(lens)),
             "paged": flash_attention(q, kp, vp, impl="kernel", page_table=table,
                                      **kw(lens))}
    for i, n in enumerate(lens.tolist()):
        short = -(-n // ps) * ps
        ki, vi = k[i:i + 1, :, :short].contiguous(), v[i:i + 1, :, :short].contiguous()
        kpi, vpi, ti = _pages_of(ki, vi, ps, gen)
        li = lens[i:i + 1]
        alone = {"dense": flash_attention(q[i:i + 1], ki, vi, impl="kernel", **kw(li)),
                 "paged": flash_attention(q[i:i + 1], kpi, vpi, impl="kernel",
                                          page_table=ti, **kw(li))}
        torch.cuda.synchronize()
        for cache in alone:
            check(torch.equal(alone[cache][0], batch[cache][i]),
                  f"lane {i} ({n} keys) {cache}: alone in a {short}-key cache "
                  "equals its row in the batch of 8 at 1027 keys, bit for bit")
    print(f"[kernels] bf16 decode is batch-composition independent: each of the "
          f"8 lanes (kv_len {lens.min().item()}-{lens.max().item()}) alone in a "
          f"short cache equals its row in the batch of 8 over 1027 keys, dense "
          f"and paged, bit for bit", flush=True)


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
                                                 scale=scale)
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
        body=K.plan_dense(bf, b, h, hkv, s, max_len, d).body,
        ms=time_ms(kern, 20), plain_ms=time_ms(plain, 5), library_ms=time_ms(lib, 20),
        flops=4 * h * d * pairs,
        bytes=item * (2 * q.numel() + 2 * hkv * d * int(lens_t.sum())),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    del out_k, out_p, mask

    # decode against the dense cache: q (B,Hq,1,D)
    kv1 = lens_t + 1
    q1 = q[:, :, :1].contiguous()
    kern = lambda: K.flash_dense_cuda(q1, k, v, kv1, lens_t, win, causal=False,
                                      scale=scale)
    plain = lambda: R.mha_ref(q1, k, v, kv_lens=kv1, q_offset=lens_t)
    mask1 = R.attention_mask(1, max_len, kv_lens=kv1, q_offset=lens_t)
    lib = lambda: F.scaled_dot_product_attention(q1, k, v, attn_mask=mask1[:, None],
                                                 scale=scale)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=TOL["split_kv"][0],
                               rtol=TOL["split_kv"][1])
    live = int(kv1.sum())
    plan = K.plan_dense(bf, b, h, hkv, 1, max_len, d)
    rows[f"dense_decode{name}"] = dict(
        shape=f"q {tuple(q1.shape)} k/v {tuple(k.shape)} bf16, {plan.splits} splits",
        body=plan.body, ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20),
        library_ms=time_ms(lib, 50), flops=4 * h * d * live,
        bytes=item * (2 * q1.numel() + 2 * hkv * d * live),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    return rows, (q1, k, v, kv1)


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


def time_kernels(cfg, lens, max_len, gpu):
    """Each flash kernel at the serving path's shapes: the dense kernel's
    prefill and decode calls at stablelm-3b's heads (D 80, 32 heads; its row
    in the ``kernels`` line), zamba2-1.2b's (D 64, 32 heads) and
    olmoe-1b-7b's (D 128, 16 heads); the paged kernels' decode calls at
    stablelm-3b's."""
    from repro_torch.configs import get_config
    from repro_torch.core import paging as PG
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, d = len(lens), cfg.n_heads, cfg.resolved_head_dim
    hkv = cfg.n_kv_heads
    bf = torch.bfloat16
    item = 2
    win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows, (q1, k, v, kv1) = time_dense("", b, h, hkv, d, lens_t, max_len, gen)
    live = int(kv1.sum())
    for arch in ("zamba2_1_2b", "olmoe_1b_7b"):
        c = get_config(arch)
        rows.update(time_dense(f"_{arch}", b, c.n_heads, c.n_kv_heads,
                               c.resolved_head_dim, lens_t, max_len, gen)[0])

    # paged kernel, decode call: identity tables over (B*n_pages,Hkv,ps,D)
    n_pages = PG.pages_needed(max_len, PAGE_SIZE)
    kp = torch.zeros(b * n_pages, hkv, PAGE_SIZE, d, dtype=bf, device="cuda")
    vp = torch.zeros_like(kp)
    tab = (torch.arange(b, device="cuda")[:, None] * n_pages
           + torch.arange(n_pages, device="cuda")[None]).to(torch.int32)
    kview = kp.view(b, n_pages, hkv, PAGE_SIZE, d)
    vview = vp.view(b, n_pages, hkv, PAGE_SIZE, d)
    pad = n_pages * PAGE_SIZE - max_len
    kview.copy_(F.pad(k, (0, 0, 0, pad)).view(b, hkv, n_pages, PAGE_SIZE, d)
                .transpose(1, 2))
    vview.copy_(F.pad(v, (0, 0, 0, pad)).view(b, hkv, n_pages, PAGE_SIZE, d)
                .transpose(1, 2))
    tab_c = torch.where(PG.page_whilelt(kv1, n_pages, PAGE_SIZE), tab, 0)
    kern = lambda: K.flash_paged_cuda(q1, kp, vp, tab_c, kv1, lens_t, win,
                                      causal=False, scale=scale)
    plain = lambda: R.mha_ref(q1, PG.gather_pages(kp, tab_c),
                              PG.gather_pages(vp, tab_c), kv_lens=kv1,
                              q_offset=lens_t)
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_p, atol=TOL["split_kv"][0],
                               rtol=TOL["split_kv"][1])
    dense_out = K.flash_dense_cuda(q1, k, v, kv1, lens_t, win, causal=False,
                                   scale=scale)
    torch.cuda.synchronize()
    check(torch.equal(out_k, dense_out), "paged decode at stablelm's shape "
          "equals the dense call bit for bit")
    sweep = {"dense": lambda: K.flash_dense_cuda(q1, k, v, kv1, lens_t, win,
                                                 causal=False, scale=scale),
             "paged bf16": kern}
    rows["paged_decode"] = dict(
        shape=f"q {tuple(q1.shape)} pools {tuple(kp.shape)} ps {PAGE_SIZE} bf16",
        ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20), library_ms=None,
        flops=4 * h * d * live,
        bytes=item * (2 * q1.numel() + 2 * hkv * d * live) + 4 * tab_c.numel(),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    del kview, vview

    # the quantized paged kernel, decode call: the same pages truncated to
    # int8 and to fp8 by the port's quantize_block, with their scale pools
    for page_dtype in ("int8", "fp8"):
        qdt = PG.resolve_page_dtype(page_dtype)
        (kq, ksc), (vq, vsc) = PG.quantize_block(kp, qdt), PG.quantize_block(vp, qdt)
        kern = lambda kq=kq, vq=vq, ksc=ksc, vsc=vsc: K.flash_paged_quant_cuda(
            q1, kq, vq, ksc, vsc, tab_c, kv1, lens_t, win, causal=False,
            scale=scale)
        plain = lambda: R.mha_ref(q1, PG.gather_pages(kq, tab_c, scale=ksc),
                                  PG.gather_pages(vq, tab_c, scale=vsc),
                                  kv_lens=kv1, q_offset=lens_t)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_p, atol=TOL["split_kv"][0],
                                   rtol=TOL["split_kv"][1])
        sweep[f"paged {page_dtype}"] = kern
        rows[f"paged_decode_{page_dtype}"] = dict(
            shape=f"q {tuple(q1.shape)} pools {tuple(kq.shape)} {page_dtype} "
                  f"+ scales {tuple(ksc.shape)} f32, ps {PAGE_SIZE}, q bf16",
            ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20), library_ms=None,
            flops=4 * h * d * live,
            bytes=(item * 2 * q1.numel() + 2 * hkv * d * live
                   + 4 * 2 * hkv * live + 4 * tab_c.numel()),
            max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    split_span_sweep(sweep, gpu)
    del sweep
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
        print(f"[time] {name}: {r['shape']}: kernel {r['ms']:.4f} ms{extra}, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
              f"{r['max_abs_err']:.3g}  [{gpu}]", flush=True)
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


def _attn_layers(cfg) -> int:
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // cfg.shared_attn_period}[cfg.family]


def _want_launches(cfg, page_size, page_dtype, steps, stochastic=False):
    """Each kernel's launches in one ``generate`` of the smoke workload (a
    stochastic batch runs one ordered top-p scan per sampled token)."""
    attn = _attn_layers(cfg)
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention_dense"] = attn                 # prefill
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
    none on a CUDA-core body."""
    attn = _attn_layers(cfg)
    want = {"flash_attention_dense": {"tensor_core": attn, "split_kv": 0,
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
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, paged_view, to_paged
    from repro_torch.sample import greedy_tokens
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import BURST

    cfg = get_config(arch)
    fam = get_model(cfg)
    widths = WIDTHS[arch]
    got = {k: getattr(cfg, k) for k in widths}
    check(got == widths, f"{arch} widths {got}, published {widths}")
    pages = bool(fam.paged_cache_spec(cfg))
    quant = [dt for _, _, dt in RUNS[arch] if dt]
    seed0 = lambda: torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = fam.init(cfg, seed0(), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[full] {cfg.name} ({cfg.family}): "
          + " ".join(f"{k}={v}" for k, v in widths.items())
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

    def dense(q, k, v, kv_lens, q_offset, window, *, causal, scale):
        out = K.flash_dense_cuda(q, k, v, kv_lens, q_offset, window,
                                 causal=causal, scale=scale)
        b, hq, sq, d = q.shape
        if K.plan_dense(q.dtype, b, hq, k.shape[1], sq, k.shape[2],
                        d).body == K.SPLIT_KV:
            hold("flash_attention_dense", out, q, k, v, kv_lens, q_offset,
                 window, causal, scale)
        return out

    def paged(q, kp, vp, *rest, causal, scale):
        quant = len(rest) == 6
        ks, vs = rest[:2] if quant else (None, None)
        table, kv_lens, q_offset, window = rest[-4:]
        fn = K.flash_paged_quant_cuda if quant else K.flash_paged_cuda
        out = fn(q, kp, vp, *rest, causal=causal, scale=scale)
        b, hq, sq, d = q.shape
        if K.plan_paged(q.dtype, kp.dtype, b, hq, kp.shape[1], sq,
                        table.shape[1], kp.shape[2], d).body == K.SPLIT_KV:
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


def run_quickstart() -> dict:
    """The port's quickstart (``repro_torch.launch.quickstart``) on the card:
    Fig. 2's daxpy at three VLs and §2.4's fadda, each held against its
    plain version inside; its kernel launches, counted from 0."""
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
    """What ptxas says of each kernel of ``sources`` (registers, spills,
    stack), from a build with ``-Xptxas -v`` into build/, where the
    library's SASS (cuobjdump) is also written, beside it."""
    from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    def one(src):
        out = BUILD_DIR / f"ptxas_{Path(src).stem}.so"
        res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(out), str(src)], capture_output=True, text=True)
        return src, res.stdout + res.stderr
    with ThreadPoolExecutor(len(sources)) as pool:
        for src, text in pool.map(one, sources):
            so = BUILD_DIR / f"ptxas_{Path(src).stem}.so"
            sass = subprocess.run([str(Path(nvcc_path()).parent / "cuobjdump"),
                                   "-sass", str(so)], capture_output=True, text=True)
            so.with_suffix(".sass").write_text(sass.stdout + sass.stderr)
            lines = [ln.strip() for ln in text.splitlines()
                     if "Compiling entry" in ln or "registers" in ln
                     or "spill" in ln or "stack frame" in ln]
            for ln in lines:
                print(f"[probe] ptxas {Path(src).name}: {ln}", flush=True)


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
    if "--fadda-probes" in args:
        parent = args[args.index("--parent") + 1] if "--parent" in args else None
        phase("fadda probes", fadda_probes, gpu, parent)
        return 0
    phase("check flash", check_kernels, flash_attention)
    phase("check flash quant", check_quant_kernel, flash_attention)
    phase("check paged == dense", check_paged_equals_dense, flash_attention)
    phase("check batch independence", check_batch_independence, flash_attention)
    phase("check ssd", check_ssd)
    phase("check moe_positions", check_moe_positions)
    phase("check fadda", check_fadda)
    phase("check moe_positions in a graph", check_moe_positions, graphed)
    phase("check fadda in a graph", check_fadda, graphed)
    phase("check daxpy", check_daxpy)
    phase("check threefry", check_prng)
    served = {arch: phase(f"serve {arch}", serve_model, arch, gpu)
              for arch in WIDTHS}
    cfg, lens, max_len, _ = served["stablelm_3b"]
    rows = phase("time flash", time_kernels, cfg, lens, max_len, gpu)
    ssd_rows = phase("time ssd", time_ssd, lens, gpu)
    floor_ms = phase("launch floor", launch_floor_ms)
    moe_rows = phase("time moe_positions", time_moe_positions, lens, gpu,
                     floor_ms)
    fadda_times = phase("time fadda", time_fadda, cfg.padded_vocab, gpu,
                        floor_ms)
    daxpy_rows = phase("time daxpy", time_daxpy, gpu)
    quick = phase("quickstart", run_quickstart)

    launches = {k: sum(r["counts"][k] for *_, runs in served.values()
                       for r in runs.values()) + quick[k]
                for k in kernel_wrappers()}
    bodies = {k: {body: sum(r["bodies"][k][body] for *_, runs in served.values()
                            for r in runs.values()) for body in v}
              for k, v in read_bodies().items()}
    print(f"[full] launches over every generate and the quickstart: {launches}; "
          f"the flash kernels by body: {bodies}", flush=True)
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
             "src/repro/kernels/daxpy/kernel.py:32")):
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
