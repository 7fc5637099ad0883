"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from the sources in the checkout.
2. Holds each kernel against its plain PyTorch version on the card (f32 at
   atol = rtol = 1e-5; bf16 at 2e-2, the output being rounded to bf16), and
   times each at the shapes the serving path gives it, beside its plain
   version, its roofline bound and (dense only) one PyTorch library call.
3. Serves 8 greedy requests through ``ServeEngine.generate`` at the full
   width of stablelm-3b (random weights from seed 0), with the dense and
   the paged KV cache, counting kernel launches in each run, and checks the
   outputs: finite logits, launch counts, first-step logits against the
   plain path and across cache layouts.
4. Prints the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Any failed phase raises, and the script exits non-zero without a result.
It needs CUDA; without it, or without the repo's ``src/`` beside it, it
fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
N_REQ, MAX_NEW, PAGE_SIZE = 8, 64, 16


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


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
    for name, r in rows.items():
        t_ops = r["flops"] / PEAK_BF16_FLOPS * 1e3
        t_bytes = r["bytes"] / PEAK_BYTES * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[time] {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
              f"{r['max_abs_err']:.3g}  [{gpu}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 3: full-width serving through ServeEngine.generate
# ---------------------------------------------------------------------------

def serve_full_width(gpu):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models import dense, to_paged
    from repro_torch.sample import greedy_tokens
    from repro_torch.serve import ServeEngine

    cfg = get_config("stablelm_3b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (
        32, 2560, 32, 32, 80, 6912, 50304), cfg)
    t0 = time.perf_counter()
    model = dense.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[full] stablelm-3b: {cfg.n_layers}L d{cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads}H hd{cfg.resolved_head_dim} "
          f"ff{cfg.d_ff} v{cfg.vocab_size} {cfg.compute_dtype}: "
          f"{n_params / 1e9:.3f}B params, init {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, N_REQ).astype(np.int32)
    s = int(lens.max())
    tokens = rng.randint(1, cfg.vocab_size, (N_REQ, s))
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "lens": torch.from_numpy(lens).cuda()}
    max_len = s + MAX_NEW
    # stop token -1: argmax never emits it, so every lane decodes its budget
    eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=-1)
    eng_warm = ServeEngine(cfg, model, max_new_tokens=2, stop_token=-1)
    eng_warm.generate({"tokens": batch["tokens"][:2, :16]})    # cuBLAS warm-up
    torch.cuda.synchronize()

    runs = {}
    for name, page_size in (("dense", None), ("paged", PAGE_SIZE)):
        K.flash_dense_cuda.launches = 0
        K.flash_paged_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(batch, page_size=page_size)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = {"flash_attention_dense": K.flash_dense_cuda.launches,
                  "flash_attention_paged": K.flash_paged_cuda.launches}
        n_gen = res["n_generated"].cpu().numpy()
        toks = res["tokens"].cpu().numpy()
        check((n_gen == MAX_NEW).all(), f"n_generated {n_gen}")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token ids in the vocab")
        steps = MAX_NEW - 1
        want = {"flash_attention_dense": cfg.n_layers * (1 + (0 if page_size else steps)),
                "flash_attention_paged": cfg.n_layers * (steps if page_size else 0)}
        check(counts == want, f"{name} launches {counts}, expected {want}")
        runs[name] = dict(tokens=toks, total_s=total, counts=counts,
                          cache=res["cache"])
        print(f"[full] generate {name}: launches {counts} (expected {want})",
              flush=True)

    # prefill alone, timed apart from the runs above (same inputs)
    def prefill():
        cache = eng.make_cache(N_REQ, max_len)
        return dense.prefill(model, cfg, batch, cache)
    with torch.inference_mode():
        prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_pre, cache = prefill()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    for name, r in runs.items():
        decode_ms = (r["total_s"] - prefill_s) * 1e3 / (MAX_NEW - 1)
        r.update(prefill_ms=prefill_s * 1e3, decode_ms_per_step=decode_ms,
                 tokens_per_s=N_REQ * MAX_NEW / r["total_s"])
        print(f"[full] {name}: generate {r['total_s'] * 1e3:.1f} ms for "
              f"{N_REQ}x{MAX_NEW} tokens, prompts {lens.min()}-{lens.max()}: "
              f"prefill {r['prefill_ms']:.1f} ms (timed alone), decode "
              f"{decode_ms:.2f} ms/step, {r['tokens_per_s']:.1f} tokens/s  "
              f"[{gpu}]", flush=True)
    same = float((runs["dense"]["tokens"] == runs["paged"]["tokens"]).mean())
    print(f"[full] identical tokens dense vs paged: {same:.4f} (reported, "
          "not asserted: bf16 near-ties may flip)", flush=True)

    # first decode step: kernel path vs plain path, and dense vs paged cache
    with torch.inference_mode():
        first = greedy_tokens(logits_pre)
        step = {"token": first[:, None]}
        pos0 = cache["pos"].clone()
        paged = to_paged(cfg, cache, page_size=PAGE_SIZE)
        l_dense, _ = dense.decode(model, cfg, step, dict(cache, pos=pos0.clone()))
        l_paged, _ = dense.decode(model, cfg, step, dict(paged, pos=pos0.clone()))
        del paged
        naive = cfg.replace(attn_impl="naive")
        cache_n = eng.make_cache(N_REQ, max_len)
        l_pre_n, cache_n = dense.prefill(model, naive, batch, cache_n)
        l_dense_n, _ = dense.decode(model, naive, step, cache_n)
        del cache_n, cache
    for t in (logits_pre, l_dense, l_paged, l_pre_n, l_dense_n):
        check(t.shape == (N_REQ, cfg.padded_vocab) and bool(torch.isfinite(t).all()),
              "first-step logits of the expected shape, all finite")
    errs = {"prefill kernel vs plain": rel_err(logits_pre, l_pre_n),
            "decode kernel vs plain": rel_err(l_dense, l_dense_n),
            "decode paged vs dense": rel_err(l_paged, l_dense)}
    for what, e in errs.items():
        print(f"[full] first-step logits {what}: max|d|/max|ref| = {e:.3g} "
              "(limit 2e-2, bf16)", flush=True)
        check(e <= 2e-2, f"first-step logits {what}: {e} > 2e-2")
    for name, r in runs.items():
        profile_decode(model, cfg, name, r.pop("cache"), r["tokens"][:, -1], gpu)
    return cfg, lens, max_len, runs


def profile_decode(model, cfg, name, cache, last_tok, gpu, steps: int = 4):
    """Where a decode step's time goes: its wall time (host clock, no
    profiler) against the device time of the kernels it launches
    (torch.profiler), and the kernels that take most of that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import dense

    step = {"token": torch.as_tensor(last_tok, device="cuda")[:, None]}

    def run():
        c = cache
        for _ in range(steps):
            _, c = dense.decode(model, cfg, step, c)
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
        print(f"[profile] {name} decode step: wall {wall_ms:.2f} ms; device "
              f"time not measured (the profiler saw no device events)  [{gpu}]",
              flush=True)
        return
    dev_ms = sum(us for _, us in by_name.values()) / 1e3 / steps
    n_kern = sum(n for n, _ in by_name.values()) / steps
    print(f"[profile] {name} decode step: wall {wall_ms:.2f} ms, device "
          f"kernels {dev_ms:.2f} ms ({n_kern:.0f} launches), device idle "
          f"{1 - dev_ms / wall_ms:.1%}, {syncs} host waits in {steps} steps  "
          f"[{gpu}]", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for kname, (n, us) in top:
        print(f"[profile]   {us / 1e3 / steps:8.3f} ms/step {n // steps:5d}x "
              f"{kname[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f"  torch {torch.__version__} cuda {torch.version.cuda}  [{gpu}]",
          flush=True)

    t0 = time.perf_counter()
    lib = K.build()
    print(f"[build] {K.last_build.get('cmd', 'cached: ' + str(lib))}", flush=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}",
          flush=True)

    check_kernels(flash_attention)
    cfg, lens, max_len, runs = serve_full_width(gpu)
    rows = time_kernels(cfg, lens, max_len, gpu)

    launches = {k: sum(r["counts"][k] for r in runs.values())
                for k in ("flash_attention_dense", "flash_attention_paged")}
    entries = []
    for name, row, replaces in (
            ("flash_attention_dense", rows["dense_prefill"],
             "src/repro/kernels/flash_attention/kernel.py:237"),
            ("flash_attention_paged", rows["paged_decode"],
             "src/repro/kernels/flash_attention/kernel.py:165")):
        entries.append({
            "name": name, "route": "cuda", "source": SRC_CU,
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
