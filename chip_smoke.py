"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from the sources in the checkout:
   one ``nvcc`` per source, all started together.
2. Holds each kernel against its plain PyTorch version on the card (flash
   attention in f32 at atol = rtol = 1e-5, over int8/fp8 pools at 1e-4 as
   the widened values differ from the plain path's by rounding; the SSD
   scan in f32 at 1e-4 as its exp and cumsum run in another order; bf16 at
   2e-2, the output being rounded to bf16; the MoE dispatch ranks, the
   ordered ``fadda`` sums and scans and ``daxpy`` exactly, bit for bit),
   checks the threefry bits on the card against the CPU's, and times each
   kernel at the shapes its path gives it, beside its plain version, its
   bound and, where one exists, one PyTorch library call.
3. Serves 8 greedy requests through ``ServeEngine.generate`` at the full
   width of stablelm-3b (dense family), zamba2-1.2b (hybrid), mamba2-130m
   (ssm) and olmoe-1b-7b (moe), random weights from seed 0, with the dense
   and (where the family pages) the paged KV cache, full precision and
   int8/fp8, then one mixed batch (4 greedy, 4 stochastic lanes) on the
   dense cache, counting kernel launches in each run, and checks the
   outputs: finite logits, launch counts, first-step logits against the
   plain path, across cache layouts, and of quantized native decode against
   the gather oracle over the same pool bytes and against a truncating
   oracle; the mixed batch's greedy lanes against the all-greedy run and its
   stochastic lanes' first tokens against the keep set of the plain path.
4. Runs the port's quickstart (daxpy, Fig. 2; fadda, §2.4) on the card.
5. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Any failed phase raises, and the script exits non-zero without a result.
It needs CUDA; without it, or without the repo's ``src/`` beside it, it
fails.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
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
    for fn in kernel_wrappers().values():
        fn.launches = 0


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
            "daxpy": DK.LIBRARY}
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

def check_kernels(flash_attention):
    """Dense at D = 16, 80, 128 and odd widths with causal, window, ragged,
    empty-row and GQA cases; paged with a shuffled table and stale
    out-of-strip entries.  Every block-shape branch of the kernels is hit:
    1-4, 5-8 and >8 rows per block, one and several row chunks, and both
    ways of staging K/V: 16-byte loads (D a multiple of 8 bf16 or 4 f32
    elements, aligned rows) and element loads (D = 37, D = 100 in bf16, and
    K/V that start off a 16-byte boundary)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"dense": 0.0, "paged": 0.0}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        # K/V one element past an aligned start: rows off 16-byte boundaries
        q = torch.randn(2, 4, 5, 80, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(2 * 2 * 33 * 80 + 1, generator=gen, device="cuda")
                .to(dtype)[1:].view(2, 2, 33, 80) for _ in range(2))
        kw = dict(kv_lens=torch.tensor([33, 9], dtype=torch.int32, device="cuda"),
                  causal=True)
        got = flash_attention(q, k, v, impl="kernel", **kw)
        want = flash_attention(q, k, v, impl="naive", **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        for d in (16, 37, 80, 100, 128):
            for (b, hkv, group, sq, skv, causal, window) in (
                    (3, 2, 1, 1, 77, False, None),      # decode, 4 splits
                    (3, 2, 2, 6, 77, True, None),       # 2 splits, GQA
                    (3, 2, 2, 37, 90, True, 9),         # 3 row chunks, window
                    (2, 1, 1, 40, 40, False, None)):    # non-causal prefill
                q = torch.randn(b, hkv * group, sq, d, generator=gen,
                                device="cuda").to(dtype)
                k = torch.randn(b, hkv, skv, d, generator=gen,
                                device="cuda").to(dtype)
                v = torch.randn(b, hkv, skv, d, generator=gen,
                                device="cuda").to(dtype)
                kv_lens = torch.tensor([skv, skv // 2, 0][:b], dtype=torch.int32,
                                       device="cuda")
                q_off = (kv_lens - sq).clamp_min(0) if causal else kv_lens * 0
                kw = dict(kv_lens=kv_lens, causal=causal, window=window,
                          q_offset=q_off)
                got = flash_attention(q, k, v, impl="kernel", **kw)
                want = flash_attention(q, k, v, impl="naive", **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, atol=tol, rtol=tol)
                worst["dense"] = max(worst["dense"],
                                     float((got.float() - want.float()).abs().max()))
            for (b, hkv, group, sq, ps, n_pages) in (
                    (3, 2, 1, 1, 16, 5), (3, 2, 2, 3, 8, 9), (2, 2, 2, 12, 16, 4)):
                n_pool = b * n_pages + 3
                q = torch.randn(b, hkv * group, sq, d, generator=gen,
                                device="cuda").to(dtype)
                kp = torch.randn(n_pool, hkv, ps, d, generator=gen,
                                 device="cuda").to(dtype)
                vp = torch.randn(n_pool, hkv, ps, d, generator=gen,
                                 device="cuda").to(dtype)
                table = torch.randperm(n_pool, generator=gen, device="cuda")[
                    :b * n_pages].reshape(b, n_pages).to(torch.int32)
                skv = n_pages * ps
                kv_lens = torch.tensor([skv, skv // 2 + 1, 0][:b],
                                       dtype=torch.int32, device="cuda")
                table[1, (skv // 2 + 1 + ps - 1) // ps:] = 10 ** 6   # stale ids
                q_off = (kv_lens - sq).clamp_min(0)
                for causal in (False, True):
                    kw = dict(kv_lens=kv_lens, causal=causal, q_offset=q_off,
                              page_table=table)
                    got = flash_attention(q, kp, vp, impl="kernel", **kw)
                    want = flash_attention(q, kp, vp, impl="naive", **kw)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
                    worst["paged"] = max(worst["paged"], float(
                        (got.float() - want.float()).abs().max()))
    print(f"[kernels] checked against the plain versions "
          f"(f32 atol=rtol=1e-5, bf16 2e-2): max |err| dense "
          f"{worst['dense']:.3g}, paged {worst['paged']:.3g}", flush=True)
    return worst


def _quant_pools(gen, n_pool, hkv, ps, d, page_dtype):
    """Random K or V pages truncated to ``page_dtype`` by the port's own
    quantize_block: (narrow pool, f32 scale pool)."""
    from repro_torch.core import paging as PG
    return PG.quantize_block(
        torch.randn(n_pool, hkv, ps, d, generator=gen, device="cuda") * 2.0,
        PG.resolve_page_dtype(page_dtype))


def check_quant_kernel(flash_attention):
    """The paged kernel over int8 and fp8 pools against the plain path
    (extending gather, then the reference), q in f32 and bf16: head dims 48,
    64, 80 and 128 (16-byte loads of 16 narrow elements), page sizes 8 and
    16, GQA group 1 and 4, one and three query rows, ragged kv_lens with
    stale out-of-strip table entries, a sliding window, and an empty lane.
    A head dim that is not a multiple of 16 is refused."""
    from repro_torch.kernels.flash_attention import kernel as K
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for page_dtype in ("int8", "fp8"):
            for d, ps, group, window, sq in ((64, 16, 1, None, 1),
                                             (80, 16, 4, None, 1),
                                             (128, 8, 2, 11, 1),
                                             (48, 8, 1, None, 3)):
                b, hkv, n_pages = 3, 2, 6
                n_pool = b * n_pages + 5
                skv = n_pages * ps
                kp, ks = _quant_pools(gen, n_pool, hkv, ps, d, page_dtype)
                vp, vs = _quant_pools(gen, n_pool, hkv, ps, d, page_dtype)
                q = torch.randn(b, hkv * group, sq, d, generator=gen,
                                device="cuda").to(dtype)
                table = torch.randperm(n_pool, generator=gen, device="cuda")[
                    :b * n_pages].reshape(b, n_pages).to(torch.int32)
                kv_lens = torch.tensor([skv, skv // 2 + 1, 0], dtype=torch.int32,
                                       device="cuda")
                table[1, (skv // 2 + 1 + ps - 1) // ps:] = 10 ** 6   # stale ids
                kw = dict(kv_lens=kv_lens, causal=True, window=window,
                          q_offset=(kv_lens - sq).clamp_min(0), page_table=table,
                          k_scale=ks, v_scale=vs)
                got = flash_attention(q, kp, vp, impl="kernel", **kw)
                want = flash_attention(q, kp, vp, impl="naive", **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, atol=tol, rtol=tol)
                check(not got[2].any(), "an empty lane reads 0")
                worst = max(worst, float((got.float() - want.float()).abs().max()))
    kp, ks = _quant_pools(gen, 4, 1, 8, 40, "int8")
    q = torch.zeros(1, 1, 1, 40, device="cuda")
    ints = [torch.zeros(n, dtype=torch.int32, device="cuda") for n in (1, 1, 1)]
    try:
        K.flash_paged_quant_cuda(q, kp, kp, ks, ks, torch.zeros(
            1, 1, dtype=torch.int32, device="cuda"), *ints, causal=False, scale=1.0)
    except ValueError as e:
        check("multiple of 16" in str(e), f"head dim 40 refused: {e}")
    else:
        check(False, "a quantized pool of head dim 40 must be refused")
    print(f"[kernels] flash_attention_paged_quant checked against the plain "
          f"path (f32 atol=rtol=1e-4, bf16 2e-2; int8 and fp8 pools): max "
          f"|err| {worst:.3g}", flush=True)
    return worst


def check_moe_positions():
    """The dispatch-rank kernel against ``moe_positions_ref``, exactly:
    T*K not a multiple of the 256-assignment tile, one tile and many, more
    than 256 tiles (the scan's carry across chunks), -1 ids and ids >= E,
    E = 4 and 64, K = 2, 6 and 8, and the olmoe prefill shape."""
    from repro_torch.kernels.moe_dispatch import moe_positions

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = ((8, 8, 64), (5, 2, 4), (1000, 6, 64), (7704, 8, 64),
             (20001, 8, 64), (333, 2, 4))
    for t, k, e in cases:
        ids = torch.randint(0, e, (t, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        odd = torch.rand((t, k), generator=gen, device="cuda")
        ids = torch.where(odd < 0.05, -1, ids)
        ids = torch.where(odd > 0.97, e + (ids % 7), ids).contiguous()
        got = moe_positions(ids, e, impl="kernel")
        want = moe_positions(ids, e, impl="naive")
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("pos", "counts")):
            check(g.dtype == w.dtype == torch.int32 and torch.equal(g, w),
                  f"moe_positions {what} equal to the plain version at "
                  f"T={t} K={k} E={e}")
    print(f"[kernels] moe_positions checked against moe_positions_ref "
          f"(exact): {len(cases)} cases, (T, K, E) in {cases}", flush=True)


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


def check_fadda():
    """The ordered kernel against the plain loop (``fadda_scan_plain``) on
    the card, bit for bit, and the op against the numpy scalar loop: n not a
    multiple of the block, blocks 8 to 1024, rows that start off a 16-byte
    boundary, block 128 and 512 giving the same bits, the adversarial
    sequence of §2.4, init = -0.0 with n = 0 (masked lanes add +0.0) and an
    empty row (init kept), and the row scan of (8, 50304) sorted softmax
    probabilities, with every row's n and ragged n."""
    from repro_torch.core.reductions import pairwise_sum
    from repro_torch.kernels.fadda import fadda, fadda_rows
    from repro_torch.kernels.fadda.ref import fadda_ref, fadda_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    n_cases = 0
    for length, n, block in ((600, 600, 128), (600, 421, 128), (1024, 1024, 512),
                             (3, 3, 512), (4096, 4095, 1024), (5000, 4097, 8)):
        x = torch.randn(length + 1, generator=gen, device="cuda")
        for xv in (x[:length], x[1:]):        # 16-byte aligned, and not
            got = fadda(xv, n, block=block)
            want = fadda_scan_plain(xv[None], n, 0.0)[0, -1]
            ref = fadda_ref(xv.cpu().numpy(), n)
            check(_same_bits(got, want) and
                  np.float32(got.item()).tobytes() == ref.tobytes(),
                  f"fadda ({length}, n={n}, block={block}) equal to the loop")
            n_cases += 1
    adv = torch.tensor([1e8, 1.0, -1e8, 1.0] * 64, device="cuda")
    want = fadda_ref(adv.cpu().numpy())
    for block in (128, 512):
        got = np.float32(fadda(adv, block=block).item())
        check(got.tobytes() == want.tobytes(), f"adversarial fadda at block {block}")
    check(np.float32(pairwise_sum(adv).item()) != want,
          "the adversarial sum differs from the tree sum")
    x = torch.randn(2, 16, generator=gen, device="cuda")
    out, part = fadda_rows(x, n=0, init=-0.0, partials=True)
    want = fadda_scan_plain(x, 0, -0.0)
    check(_same_bits(part, want) and _same_bits(out, want[:, -1])
          and not torch.signbit(out).any(),
          "init -0.0, n = 0: every masked lane adds +0.0")
    out, _ = fadda_rows(torch.empty(1, 0, device="cuda"), n=0, init=-0.0,
                        partials=True)
    check(bool(torch.signbit(out).all()), "an empty row keeps init -0.0")
    sp = sorted_probs(gen, 8, 50304)
    want = fadda_scan_plain(sp, 50304, 0.0)
    scans = {}
    for block in (128, 512):
        out, scans[block] = fadda_rows(sp, partials=True, block=block)
        check(_same_bits(scans[block], want) and _same_bits(out, want[:, -1]),
              f"(8, 50304) probability scan at block {block}")
    ragged = torch.tensor([50304, 50303, 1, 0, 4096, 777, 50304, 30000],
                          dtype=torch.int32, device="cuda")
    init = torch.linspace(-1, 1, 8, device="cuda")
    out, part = fadda_rows(sp, ragged, init, partials=True)
    want = fadda_scan_plain(sp, ragged, init)
    check(_same_bits(part, want) and _same_bits(out, want[:, -1]),
          "(8, 50304) scan with ragged n and per-row init")
    print(f"[kernels] fadda checked against the plain loop, bit for bit: "
          f"{n_cases} op cases, the adversarial sequence, -0.0, the (8, 50304) "
          f"probability scan at blocks 128 and 512, ragged n", flush=True)


def check_daxpy():
    """The daxpy kernel against ``daxpy_ref`` on the card, bit for bit, in
    f32 and bf16: n inside the array (the merged tail equal to y), n = len,
    n past len, lengths that are not a multiple of the 16-byte chunk, blocks
    128 to 2048, and x, y one element off a 16-byte boundary."""
    from repro_torch.kernels.daxpy import daxpy
    from repro_torch.kernels.daxpy.ref import daxpy_ref

    gen = torch.Generator(device="cuda").manual_seed(9)
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for length, n, block in ((1000, 777, 128), (1000, 1000, 256), (50, 10, 128),
                                 (2 ** 20 + 3, 2 ** 20 - 5, 2048), (4099, 5000, 512)):
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
          "cases in f32 and bf16", flush=True)


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

def time_kernels(cfg, lens, max_len, gpu):
    from repro_torch.core import paging as PG
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.flash_attention.ops import NO_WINDOW
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, d = len(lens), cfg.n_heads, cfg.resolved_head_dim
    hkv = cfg.n_kv_heads
    s = int(max(lens))
    bf = torch.bfloat16
    item = 2
    win = torch.tensor([NO_WINDOW], dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = {}

    # dense kernel, prefill call: q (B,Hq,S,D) over the (B,Hkv,max_len,D)
    # cache, causal from position 0, ragged kv_lens = prompt lengths
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
    torch.testing.assert_close(out_k, out_p, atol=2e-2, rtol=2e-2)
    pairs = int(mask.sum())
    flops = 4 * h * d * pairs
    nbytes = item * (2 * q.numel() + 2 * hkv * d * int(lens_t.sum()))
    rows["dense_prefill"] = dict(
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
        ms=time_ms(kern, 20), plain_ms=time_ms(plain, 5), library_ms=time_ms(lib, 20),
        flops=flops, bytes=nbytes, max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    del out_k, out_p, mask

    # dense kernel, decode call against the dense cache: q (B,Hq,1,D)
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
    torch.testing.assert_close(out_k, out_p, atol=2e-2, rtol=2e-2)
    live = int(kv1.sum())
    rows["dense_decode"] = dict(
        shape=f"q {tuple(q1.shape)} k/v {tuple(k.shape)} bf16",
        ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20), library_ms=time_ms(lib, 50),
        flops=4 * h * d * live,
        bytes=item * (2 * q1.numel() + 2 * hkv * d * live),
        max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
    del q, out_k, out_p

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
    torch.testing.assert_close(out_k, out_p, atol=2e-2, rtol=2e-2)
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
        kern = lambda: K.flash_paged_quant_cuda(q1, kq, vq, ksc, vsc, tab_c, kv1,
                                                lens_t, win, causal=False,
                                                scale=scale)
        plain = lambda: R.mha_ref(q1, PG.gather_pages(kq, tab_c, scale=ksc),
                                  PG.gather_pages(vq, tab_c, scale=vsc),
                                  kv_lens=kv1, q_offset=lens_t)
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_p, atol=2e-2, rtol=2e-2)
        rows[f"paged_decode_{page_dtype}"] = dict(
            shape=f"q {tuple(q1.shape)} pools {tuple(kq.shape)} {page_dtype} "
                  f"+ scales {tuple(ksc.shape)} f32, ps {PAGE_SIZE}, q bf16",
            ms=time_ms(kern, 50), plain_ms=time_ms(plain, 20), library_ms=None,
            flops=4 * h * d * live,
            bytes=(item * 2 * q1.numel() + 2 * hkv * d * live
                   + 4 * 2 * hkv * live + 4 * tab_c.numel()),
            max_abs_err=float((out_k.float() - out_p.float()).abs().max()))
        del kq, vq, ksc, vsc
    for name, r in rows.items():
        _bound(r)
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[time] {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
              f"{r['max_abs_err']:.3g}  [{gpu}]", flush=True)
    return rows


def time_moe_positions(lens, gpu):
    """The dispatch-rank kernel at olmoe's shapes: the prefill call ranks
    every position of the padded (8, S) batch (T = 8 * S, K = 8, E = 64),
    the decode call one token per lane (T = 8), beside the plain version and
    the byte bound (4 bytes read and 4 written per assignment, 4 per
    count; the integer operations are a few per assignment)."""
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
                          max_abs_err=0.0)
    for name, r in rows.items():
        _bound(r)
        print(f"[time] moe_positions {name}: {r['shape']}: kernel {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, library null (no one PyTorch "
              f"call computes the ranks), bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), exact  [{gpu}]", flush=True)
    return rows


def time_fadda(v, gpu):
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
            bytes=nbytes, chain_ms=chain_ms, max_abs_err=0.0)
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
              f"{r['bytes'] / PEAK_BYTES * 1e3:.4f} ms), exact  [{gpu}]", flush=True)
    return rows


def time_daxpy(gpu):
    """The daxpy kernel at n = 2^26 - 3 in f32 (the whole array active, its
    length not a multiple of the 16-byte chunk), beside the plain version,
    the bound (12 bytes an element at the memory rate; 2 f32 operations an
    element at the f32 peak) and one library call, ``add_(alpha=)`` in
    place on a copy of y."""
    from repro_torch.kernels.daxpy import kernel as DK
    from repro_torch.kernels.daxpy.ref import daxpy_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    n = 2 ** 26 - 3
    x = torch.randn(n, generator=gen, device="cuda")
    y = torch.randn(n, generator=gen, device="cuda")
    y_lib = y.clone()
    a = torch.tensor(2.5)
    kern = lambda: DK.daxpy_cuda(x, y, 2.5, n, block=2048)
    plain = lambda: daxpy_ref(x, y, a, n)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(torch.equal(got, want), "daxpy at 2^26 - 3 equal to the plain version")
    del got, want
    r = dict(shape=f"x, y ({n},) f32", ms=time_ms(kern, 30),
             plain_ms=time_ms(plain, 10),
             library_ms=time_ms(lambda: y_lib.add_(x, alpha=2.5), 30),
             bytes=12 * n, max_abs_err=0.0)
    t_ops = 2 * n / PEAK_F32_FLOPS * 1e3
    t_bytes = r["bytes"] / PEAK_BYTES * 1e3
    r.update(bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"[time] daxpy: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
          f"(add_(alpha=)), bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
          f"{r['bytes'] / 1e6:.1f} MB), exact  [{gpu}]", flush=True)
    return {"f32": r}


def _ssd_inputs(gen, bz, s, h, p, n, dtype):
    """Random SSD inputs at the scales of the JAX package's tests."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    return dict(x=r(bz, s, h, p).to(dtype), dt=r(bz, s, h).abs() * 0.1 + 0.01,
                A=-(r(h).abs() + 0.1), B=(r(bz, s, n) * 0.3).to(dtype),
                C=(r(bz, s, n) * 0.3).to(dtype), D=r(h),
                h0=r(bz, h, p, n) * 0.5)


def check_ssd():
    """The SSD-scan kernel against ``ssd_chunked_ref`` through the op (which
    pads the plain path and predicates dt past ``seq_lens``): ragged rows, a
    non-zero h0, S not a multiple of the chunk, zamba2's (P 64, N 64, 64
    heads) and mamba2's (P 64, N 128, 24 heads) sizes, a chunk that is not a
    multiple of 32 rows and a sequence shorter than one chunk."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for (bz, s, h, p, n, q) in ((2, 300, 64, 64, 64, 128),
                                    (2, 300, 24, 64, 128, 128),
                                    (2, 100, 3, 16, 16, 16),
                                    (2, 77, 3, 64, 128, 40),
                                    (1, 5, 2, 8, 16, 64)):
            a = _ssd_inputs(gen, bz, s, h, p, n, dtype)
            lens = torch.tensor([s, s // 2 + 1][:bz], device="cuda")
            args = (a["x"], a["dt"], a["A"], a["B"], a["C"], a["D"])
            kw = dict(seq_lens=lens, h0=a["h0"], chunk=q)
            got = ssd_scan(*args, impl="kernel", **kw)
            want = ssd_scan(*args, impl="naive", **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=tol, rtol=tol)
                worst = max(worst, float((g.float() - w.float()).abs().max()))
    print(f"[kernels] ssd_scan checked against ssd_chunked_ref (f32 "
          f"atol=rtol=1e-4, bf16 2e-2): max |err| {worst:.3g}", flush=True)
    return worst


def time_ssd(lens, gpu):
    """The SSD-scan kernel at the prefill shapes of the smoke run: x (8, S,
    H, 64) bf16 with S the longest prompt, dt predicated past each prompt's
    length, chunk 128, beside the plain op and the bound."""
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
        (y_k, h_k), (y_p, h_p) = kern(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(y_k, y_p, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(h_k, h_p, atol=1e-4, rtol=1e-4)
        chunks = -(-s // q)
        flops = (2 * q * q * n + 2 * q * q * p + 4 * q * p * n) * b * h * chunks
        nbytes = (2 * a["x"].numel() * 2 + dt.numel() * 4
                  + (a["B"].numel() + a["C"].numel()) * 2
                  + 2 * a["h0"].numel() * 4)
        rows[arch] = dict(
            shape=f"x {tuple(a['x'].shape)} bf16, N {n}, chunk {q}",
            # 2 calls: the plain op is ~260 small kernels, and more calls held
            # behind the spin kernel fill the device's launch queue, which
            # blocks the host
            ms=time_ms(kern, 20), plain_ms=time_ms(plain, 2), library_ms=None,
            flops=flops, bytes=nbytes,
            max_abs_err=float((y_k.float() - y_p.float()).abs().max()))
    for name, r in rows.items():
        _bound(r)
        print(f"[time] ssd_scan {name}: {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library null (no one PyTorch "
              f"call computes the scan), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bytes']:.3g} B, {r['flops']:.3g} FLOP), "
              f"max|err| {r['max_abs_err']:.3g}  [{gpu}]", flush=True)
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


def _want_launches(cfg, page_size, page_dtype, steps, stochastic=False):
    """Each kernel's launches in one ``generate`` of the smoke workload (a
    stochastic batch runs one ordered top-p scan per sampled token)."""
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // cfg.shared_attn_period}[cfg.family]
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


def serve_model(arch, gpu):
    """One model at its published widths through ``ServeEngine.generate``:
    8 prompts, 64 new tokens each, with each cache of ``RUNS[arch]``; every
    kernel's launches counted in each run."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, paged_view, to_paged
    from repro_torch.sample import greedy_tokens
    from repro_torch.serve import ServeEngine

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
    for name, page_size, page_dtype in RUNS[arch]:
        # stop token -1: argmax never emits it, so every lane decodes its budget
        eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1,
                          page_dtype=page_dtype)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(batch, page_size=page_size)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        n_gen = res["n_generated"].cpu().numpy()
        toks = res["tokens"].cpu().numpy()
        check((n_gen == MAX_NEW).all(), f"n_generated {n_gen}")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token ids in the vocab")
        want = _want_launches(cfg, page_size, page_dtype, steps)
        check(counts == want, f"{arch} {name} launches {counts}, expected {want}")
        runs[name] = dict(tokens=toks, total_s=total, counts=counts,
                          cache=res["cache"])
        print(f"[full] {cfg.name} generate {name}: launches "
              f"{ {k: v for k, v in counts.items() if v} } (as expected)",
              flush=True)

    # one mixed batch on the dense cache: lanes 0-3 greedy, 4-7 stochastic
    # (stablelm twice: a seeded batch must repeat its tokens)
    specs = mixed_specs()
    for name in ("mixed", "mixed again")[:2 if cfg.family == "dense" else 1]:
        eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(batch, sampling=specs)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = read_counts()
        n_gen = res["n_generated"].cpu().numpy()
        toks = res["tokens"].cpu().numpy()
        check((n_gen == MAX_NEW).all(), f"n_generated {n_gen}")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token ids in the vocab")
        want = _want_launches(cfg, None, None, steps, stochastic=True)
        check(counts == want, f"{arch} {name} launches {counts}, expected {want}")
        check((toks[:4] == runs["dense"]["tokens"][:4]).all(),
              f"{cfg.name} {name}: greedy lanes equal the all-greedy run")
        runs[name] = dict(tokens=toks, total_s=total, counts=counts)
        if name == "mixed":
            runs[name]["cache"] = res["cache"]
        del res
        print(f"[full] {cfg.name} generate {name} (lanes 0-3 greedy, 4-7 "
              f"stochastic): launches { {k: v for k, v in counts.items() if v} } "
              f"(as expected); greedy lanes equal the all-greedy run (held)",
              flush=True)
    if "mixed again" in runs:
        check((runs["mixed"]["tokens"] == runs["mixed again"]["tokens"]).all(),
              f"{cfg.name}: the seeded mixed batch repeats its tokens")
        print(f"[full] {cfg.name} mixed batch run twice: identical tokens (held)",
              flush=True)
    first_token_keep_set(fam, model, cfg, batch, eng.make_cache(N_REQ, max_len),
                         runs["mixed"]["tokens"][:, 0], gpu)

    # prefill alone, timed apart from the runs above (same inputs)
    def prefill():
        return fam.prefill(model, cfg, batch, eng.make_cache(N_REQ, max_len))
    with torch.inference_mode():
        prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    for name, r in runs.items():
        decode_ms = (r["total_s"] - prefill_s) * 1e3 / steps
        r.update(prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_ms,
                 tokens_per_s=N_REQ * MAX_NEW / r["total_s"])
        print(f"[full] {cfg.name} {name}: generate {r['total_s'] * 1e3:.1f} ms "
              f"for {N_REQ}x{MAX_NEW} tokens, prompts {lens.min()}-{lens.max()}: "
              f"prefill {r['prefill_ms']:.1f} ms (timed alone), decode "
              f"{decode_ms:.2f} ms/step, {r['tokens_per_s']:.1f} tokens/s  "
              f"[{gpu}]", flush=True)
    if pages:
        same = float((runs["dense"]["tokens"] == runs["paged"]["tokens"]).mean())
        if cfg.family == "moe":
            check(same == 1.0, f"{cfg.name} dense and paged tokens identical")
            print(f"[full] {cfg.name} identical tokens dense vs paged: {same:.4f} "
                  "(held)", flush=True)
        else:
            print(f"[full] {cfg.name} identical tokens dense vs paged: {same:.4f} "
                  "(reported, not asserted: bf16 near-ties may flip)", flush=True)
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
        if "cache" in r:
            profile_decode(model, cfg, name, r.pop("cache"), r["tokens"][:, -1], gpu,
                           sampling=specs if name == "mixed" else None)
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

    with torch.inference_mode():
        fast = first_step(model, cfg)
        bf16 = errs(fast, first_step(model, cfg.replace(**PLAIN), fast["tok"]))
        del fast, model, eng, eng_warm
        torch.cuda.empty_cache()
        cfg32 = cfg.replace(compute_dtype="float32")
        model32 = fam.init(cfg32, seed0(), "cuda")
        fast = first_step(model32, cfg32)
        f32 = errs(fast, first_step(model32, cfg32.replace(**PLAIN), fast["tok"]))
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
    return cfg, lens, max_len, runs


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

    phase("build", build_all)
    phase("check flash", check_kernels, flash_attention)
    phase("check flash quant", check_quant_kernel, flash_attention)
    phase("check ssd", check_ssd)
    phase("check moe_positions", check_moe_positions)
    phase("check fadda", check_fadda)
    phase("check daxpy", check_daxpy)
    phase("check threefry", check_prng)
    served = {arch: phase(f"serve {arch}", serve_model, arch, gpu)
              for arch in WIDTHS}
    cfg, lens, max_len, _ = served["stablelm_3b"]
    rows = phase("time flash", time_kernels, cfg, lens, max_len, gpu)
    ssd_rows = phase("time ssd", time_ssd, lens, gpu)
    moe_rows = phase("time moe_positions", time_moe_positions, lens, gpu)
    fadda_times = phase("time fadda", time_fadda, cfg.padded_vocab, gpu)
    daxpy_rows = phase("time daxpy", time_daxpy, gpu)
    quick = phase("quickstart", run_quickstart)

    launches = {k: sum(r["counts"][k] for *_, runs in served.values()
                       for r in runs.values()) + quick[k]
                for k in kernel_wrappers()}
    print(f"[full] launches over every generate and the quickstart: {launches}",
          flush=True)
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
            "shape": row["shape"]})
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
