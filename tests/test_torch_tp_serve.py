"""Tensor-parallel serving of the port (``ServeEngine(mesh=...)``,
``dist.serve``) over one gloo group of 2 CPU ranks, started once for the
module, at the reference's tiny f32 dense config: ``generate`` on the
dense, paged and int8-paged caches, greedy and mixed greedy/stochastic,
and the first step's prefill and decode logits, bit for bit against the
port's one-device engine on the same weights, greedy tokens equal to the
JAX package's one-device ``generate``; the scheduler's paged +
prefix-sharing + chunked-prefill + compaction trace (the scenario of
``test_sharded_serve_paged_prefix_chunked_compacting``, with and without
overlap) byte for byte with equal stats against the one-device scheduler.
Then the launcher: ``--mesh 1x2 --psum ordered``, ``--mesh 1x1``, every
family at ``--mesh 2x2``, ``--static --mesh 2x1`` and the VLM at ``--mesh
1x2`` print the request lines of the run without a mesh, and heads the
model axis does not cut whole exit naming ROADMAP Queue 1 item 14 before
any rank starts.

The rank function lives here, importable by name, and imports no JAX;
the JAX weights cross to the ranks as numpy arrays.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models.convert import from_jax_params
from repro_torch.sample import SamplingParams, greedy_tokens
from repro_torch.serve import ContinuousBatchingScheduler, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW, STOP = 6, 7
MIXED = [None, SamplingParams(temperature=0.8, top_p=0.9, seed=1, greedy=False),
         None, SamplingParams(temperature=1.0, top_k=8, seed=3, greedy=False)]
SCHED = dict(capacity=4, max_len=24, chunk=3, compact_threshold=0.5,
             page_size=4, pool_pages=14, prefill_chunk=4)


def _batch():
    rng = np.random.RandomState(0)
    return {"tokens": torch.from_numpy(rng.randint(1, 64, (4, 9))),
            "lens": torch.tensor([9, 3, 6, 1], dtype=torch.int32)}


def _trace():
    """``test_sharded_serve``'s paged trace: 8 staggered ragged requests,
    about half behind a shared 8-token prefix (cut to 16), budgets 3-7."""
    rng = np.random.RandomState(12)
    shared, out, t = rng.randint(1, 64, 8), [], 0.0
    for _ in range(8):
        t += rng.exponential(1.5)
        prompt = rng.randint(1, 64, rng.randint(3, 14))
        if rng.rand() < 0.5:
            prompt = np.concatenate([shared, prompt])[:16]
        out.append((t, prompt, int(rng.randint(3, 8))))
    return out


def _under(mesh):
    return (contextlib.nullcontext() if mesh is None
            else SH.use_mesh_rules(mesh, SH.SERVE_RULES))


def _serve(cfg, model, mesh):
    """Every scenario of the module on one engine (a rank's, or the
    one-device one with ``mesh`` None); numpy results."""
    out = {}
    batch = _batch()
    eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=STOP,
                      device="cpu", mesh=mesh)
    eng8 = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=STOP,
                       device="cpu", mesh=mesh, page_dtype="int8")
    for name, e, kw in (("dense", eng, {}), ("paged", eng, dict(page_size=4)),
                        ("int8", eng8, dict(page_size=4)),
                        ("mixed", eng, dict(sampling=MIXED))):
        r = e.generate(batch, **kw)
        out[name] = (r["tokens"].numpy(), r["n_generated"].numpy())
    with torch.inference_mode(), _under(mesh):
        lp, cache = eng.model.prefill(model, cfg, batch, eng.make_cache(4, 16))
        ld, _ = eng.model.decode(model, cfg,
                                 {"token": greedy_tokens(lp)[:, None]}, cache)
    out["logits"] = (lp.numpy(), ld.numpy())
    for overlap in (False, True):
        sched = ContinuousBatchingScheduler(eng, overlap=overlap, **SCHED)
        for rid, (arrival, prompt, budget) in enumerate(_trace()):
            sched.submit(prompt, arrival=arrival, max_new_tokens=budget,
                         sampling=(SamplingParams(temperature=0.8, top_p=0.9,
                                                  seed=rid, greedy=False)
                                   if rid % 3 == 0 else None))
        res = sched.run()
        out[f"sched overlap={overlap}"] = (
            {rid: (r["tokens"], r["n_generated"], r["finish_reason"].value)
             for rid, r in res.items()},
            {k: sched.stats[k] for k in ("steps", "dispatches", "host_syncs",
                                         "prefill_chunks", "prefix_hits",
                                         "compactions", "decode_steps")})
    return out


def _tp_rank(mesh, cfg, params_np):
    """One rank: the JAX weights, this rank's block of them, every
    scenario."""
    return _serve(cfg, from_jax_params(cfg, params_np, device="cpu"), mesh)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """(rank 0's results, rank 1's, the one-device port's, JAX's greedy
    tokens)."""
    import jax
    import jax.numpy as jnp
    from torch_parity import plain_models

    from repro.serve import ServeEngine as JaxEngine

    cfg_j, params_j, cfg_t, _ = plain_models()
    params_np = jax.tree.map(np.asarray, params_j)
    ranks = run_ranks(_tp_rank, (1, 2), ("data", "model"), cfg_t, params_np,
                      device="cpu", timeout=240)
    one = _serve(cfg_t, from_jax_params(cfg_t, params_np, device="cpu"), None)
    jeng = JaxEngine(cfg_j, params_j, max_new_tokens=MAX_NEW, stop_token=STOP)
    jres = jeng.generate({k: jnp.asarray(v.numpy())
                          for k, v in _batch().items()})
    return ranks[0], ranks[1], one, np.asarray(jres["tokens"])


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("run", ["dense", "paged", "int8", "mixed"])
def test_generate_equals_one_device(runs, run):
    tp0, tp1, one, jax_toks = runs
    for tp in (tp0, tp1):
        assert _same_bits(tp[run][0], one[run][0]), (tp[run][0], one[run][0])
        assert _same_bits(tp[run][1], one[run][1])
    if run != "mixed":
        # the greedy lanes of JAX's one-device generate
        np.testing.assert_array_equal(tp0[run][0], jax_toks)
    else:
        np.testing.assert_array_equal(tp0[run][0][[0, 2]], jax_toks[[0, 2]])


def test_first_step_logits_equal_one_device(runs):
    tp0, tp1, one, _ = runs
    for tp in (tp0, tp1):
        for got, want in zip(tp["logits"], one["logits"]):
            assert _same_bits(got, want)


@pytest.mark.parametrize("overlap", [False, True])
def test_paged_prefix_chunked_compacting_trace_equals_one_device(runs,
                                                                overlap):
    tp0, tp1, one, _ = runs
    key = f"sched overlap={overlap}"
    want, st_one = one[key]
    assert st_one["prefill_chunks"] > 0 and st_one["prefix_hits"] > 0
    assert st_one["compactions"] > 0
    for tp in (tp0, tp1):
        got, st = tp[key]
        assert sorted(got) == sorted(want)
        for rid, (toks, n, why) in want.items():
            assert _same_bits(got[rid][0], toks), (rid, got[rid][0], toks)
            assert got[rid][1:] == (n, why), rid
        # the same rounds, dispatches and syncs: one dispatch a round each
        assert st == st_one, (st, st_one)


def test_engine_refuses_heads_the_model_axis_does_not_cut():
    from torch_parity import plain_models
    _, _, cfg_t, model = plain_models()
    mesh = Mesh(("data", "model"), {"data": 1, "model": 4},
                {"data": 0, "model": 0}, {}, "gloo", torch.device("cpu"), 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        ServeEngine(cfg_t, model, device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _req_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("req")]


_NO_MESH = {}


def no_mesh_lines(arch, static):
    """The request lines of the launcher's run of ``arch`` without a mesh
    (in this process; one run per arch)."""
    key = (arch, static)
    if key not in _NO_MESH:
        from repro_torch.launch import serve
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--device", "cpu", "--arch", arch]
                       + (["--static"] if static else []))
        _NO_MESH[key] = _req_lines(buf.getvalue())
    return _NO_MESH[key]


@pytest.mark.parametrize("arch,mesh", [
    ("stablelm_3b", ["--mesh", "1x2", "--psum", "ordered"]),
    ("stablelm_3b", ["--mesh", "1x1"]),
    ("stablelm_3b", ["--mesh", "2x2"]),
    ("stablelm_3b", ["--static", "--mesh", "2x1"]),
    ("olmoe_1b_7b", ["--mesh", "2x2"]),
    ("mamba2_130m", ["--mesh", "2x2"]),
    ("zamba2_1_2b", ["--mesh", "2x2"]),
    ("seamless_m4t_large_v2", ["--mesh", "2x2"]),
    ("llama_3_2_vision_11b", ["--static", "--mesh", "1x2"]),
], ids=["1x2-ordered", "1x1", "dense-2x2", "static-2x1", "moe-2x2",
        "ssm-2x2", "hybrid-2x2", "encdec-2x2", "vlm-1x2"])
def test_launcher_mesh_prints_the_no_mesh_request_lines(arch, mesh):
    """Rank 0 of every mesh prints the request lines of the run without
    one: the scheduler for each family over data 2 x model 2, ``--static``
    over the data axis, the VLM's static batch over the model axis."""
    want = no_mesh_lines(arch, "--static" in mesh)
    assert len(want) in (4, 10)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", "--arch", arch] + mesh,
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert _req_lines(r.stdout) == want


@pytest.mark.parametrize("argv", [
    ["--mesh", "1x4"],
    ["--static", "--mesh", "1x4"],
    ["--arch", "olmoe_1b_7b", "--mesh", "2x4"],
    ["--arch", "zamba2_1_2b", "--mesh", "1x4"],
    ["--arch", "llama_3_2_vision_11b", "--mesh", "1x4"],
])
def test_launcher_refuses_uncovered_meshes_before_any_rank(monkeypatch, argv):
    """Heads or KV heads the model axis does not cut whole (the kv_seq
    fallback) exit naming Queue 1 item 14 before any rank starts."""
    from repro_torch.launch import serve

    def no_ranks(*args, **kwargs):
        raise AssertionError("a rank was started for a refused mesh")
    monkeypatch.setattr(serve, "run_ranks", no_ranks)
    with pytest.raises(SystemExit, match="Queue 1 item 14") as e:
        serve.main(["--device", "cpu"] + argv)
    assert "kv_seq" in str(e.value)
