"""Port parity: ``repro_torch.serve.ServeEngine.generate`` (greedy and
stochastic, dense and paged KV) against the JAX engine with its Pallas
kernels in interpret mode: identical tokens and ``n_generated``.  Inside the port, native paged decode
equals the gather oracle and the dense cache.  Also the port's purity (no
JAX, no ``repro``) and its device rule (the card unless asked otherwise)."""

import pytest

torch = pytest.importorskip("torch")

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
from torch_parity import models, np_

from repro import sample as SJ
from repro.serve import ServeEngine as JaxEngine
from repro_torch import sample as ST
from repro_torch.models import dense as tdense
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    cfg_j, params, cfg_t, model = models()
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(1, cfg_j.vocab_size, (4, 9)),
             "lens": np.array([9, 3, 6, 1], np.int32)}
    # a stop token that lane 1 emits mid-run, so the predicated loop retires
    # a lane early while the others keep decoding
    probe = JaxEngine(cfg_j, params, max_new_tokens=MAX_NEW, stop_token=-999)
    toks = np.asarray(probe.generate({k: jnp.asarray(v)
                                      for k, v in batch.items()})["tokens"])
    stop = int(toks[1, 2])
    return cfg_j, params, cfg_t, model, batch, stop


def _jax_generate(cfg, params, batch, stop, **kw):
    eng = JaxEngine(cfg, params, max_new_tokens=MAX_NEW, stop_token=stop)
    res = eng.generate({k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    return np_(res["tokens"]), np_(res["n_generated"])


def _torch_generate(cfg, model, batch, stop, paged_attn="native", **kw):
    eng = ServeEngine(cfg, model, max_new_tokens=MAX_NEW, stop_token=stop,
                      paged_attn=paged_attn, device="cpu")
    res = eng.generate(batch, **kw)
    return np_(res["tokens"]), np_(res["n_generated"])


@pytest.mark.parametrize("page_size", [None, 8])
def test_generate_matches_jax(setup, page_size):
    cfg_j, params, cfg_t, model, batch, stop = setup
    tok_j, n_j = _jax_generate(cfg_j, params, batch, stop, page_size=page_size)
    tok_t, n_t = _torch_generate(cfg_t, model, batch, stop, page_size=page_size)
    np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_array_equal(n_t, n_j)
    assert n_t.min() < MAX_NEW <= n_t.max()        # one lane stopped early


def test_native_paged_equals_gather_oracle_and_dense(setup):
    _, _, cfg_t, model, batch, stop = setup
    dense = _torch_generate(cfg_t, model, batch, stop)
    native = _torch_generate(cfg_t, model, batch, stop, page_size=4)
    oracle = _torch_generate(cfg_t, model, batch, stop, page_size=4,
                             paged_attn="gather")
    for got in (native, oracle):
        np.testing.assert_array_equal(got[0], dense[0])
        np.testing.assert_array_equal(got[1], dense[1])


def test_stochastic_generate_matches_jax(setup):
    """A broadcast stochastic spec (each lane folds in its index) with the
    predicated stop: the same tokens and ``n_generated`` as the JAX engine."""
    cfg_j, params, cfg_t, model, batch, stop = setup
    spec = dict(temperature=0.9, top_k=20, top_p=0.9, min_p=0.02,
                repetition_penalty=1.2, seed=3, greedy=False)
    tok_j, n_j = _jax_generate(cfg_j, params, batch, stop,
                               sampling=SJ.SamplingParams(**spec))
    tok_t, n_t = _torch_generate(cfg_t, model, batch, stop,
                                 sampling=ST.SamplingParams(**spec))
    np.testing.assert_array_equal(tok_t, tok_j)
    np.testing.assert_array_equal(n_t, n_j)


def test_default_device_is_the_gpu(setup):
    """Without CUDA, the entry points refuse to run rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    _, _, cfg_t, model, _, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg_t, model, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdense.init(cfg_t)


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
                        r"|from\s+repro\b(?!_))", re.M)


def test_port_sources_import_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_launcher_static_on_the_cpu(capsys):
    """``launch.serve --static`` serves one reduced batch, dense and paged,
    with the same tokens."""
    from repro_torch.launch import serve
    outs = []
    for extra in ([], ["--page-size", "4"]):
        serve.main(["--arch", "stablelm_3b", "--static", "--device", "cpu",
                    "--batch", "2", "--max-new", "3"] + extra)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("req") == 2


def test_launcher_samples_on_the_cpu(capsys):
    """``launch.serve --temperature`` samples every request with its own
    seed: reproducible, and not the greedy stream."""
    from repro_torch.launch import serve
    base = ["--arch", "stablelm_3b", "--static", "--device", "cpu",
            "--batch", "2", "--max-new", "4"]
    outs = []
    for extra in (["--temperature", "0.8", "--top-p", "0.9"],
                  ["--temperature", "0.8", "--top-p", "0.9"], []):
        serve.main(base + extra)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("req") == 2
    assert outs[0] != outs[2]


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    """``launch.serve --static`` serves the ssm family (dense cache only)."""
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2_130m", "--static", "--device", "cpu",
                "--batch", "2", "--max-new", "3"])
    assert capsys.readouterr().out.count("req") == 2


def test_launcher_serves_zamba2_dense_and_paged(capsys):
    """``launch.serve --static`` serves the hybrid family with the dense and
    the paged cache, with the same tokens."""
    from repro_torch.launch import serve
    outs = []
    for extra in ([], ["--page-size", "4"]):
        serve.main(["--arch", "zamba2_1_2b", "--static", "--device", "cpu",
                    "--batch", "2", "--max-new", "3"] + extra)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("req") == 2


@pytest.mark.parametrize("argv", [
    ["--arch", "olmoe_1b_7b"],
    ["--arch", "zamba2_1_2b", "--page-size", "4", "--page-dtype", "int8"],
])
def test_launcher_serves_moe_and_quantized_pages(argv, capsys):
    """``launch.serve --static`` serves the moe family (the JAX launcher's
    reduced experts) and int8 pages on the CPU."""
    from repro_torch.launch import serve
    serve.main(["--static", "--device", "cpu", "--batch", "2", "--max-new",
                "3"] + argv)
    assert capsys.readouterr().out.count("req") == 2


def _scheduler_lines(out):
    return {line.split("]")[0] + "]": line for line in out.splitlines()
            if line.startswith("[")}


@pytest.mark.parametrize("extra,tags", [
    ([], ["[scheduler]"]),
    (["--page-size", "4", "--host-swap-pages", "8", "--prefill-chunk", "4"],
     ["[scheduler]", "[paged]", "[swap]"]),
])
def test_launcher_runs_the_scheduler_by_default(extra, tags, capsys):
    """Without ``--static`` the launcher streams its requests through the
    continuous-batching scheduler, fused and unfused with the same tokens,
    and prints the reference launcher's summary lines."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--batch", "3", "--requests", "6",
            "--max-new", "4"] + extra
    outs = []
    for fused in ([], ["--no-fused"]):
        serve.main(base + fused)
        outs.append(capsys.readouterr().out)
    reqs = [[ln for ln in out.splitlines() if ln.startswith("req")]
            for out in outs]
    assert len(reqs[0]) == 6 and reqs[0] == reqs[1]
    assert all("[done]" in ln for ln in reqs[0])
    lines = _scheduler_lines(outs[0])
    for tag in tags:
        assert tag in lines, (tag, outs[0])
    assert "rounds=" in lines["[scheduler]"]
    if "--prefill-chunk" in extra:
        assert "prefill chunks=" in lines["[scheduler]"]


def test_launcher_trace_out_and_metrics(tmp_path, capsys):
    """``--trace-out`` writes a trace that validates, ``--metrics`` prints
    the registry snapshot, and neither changes the served tokens."""
    from repro_torch.launch import serve
    from repro_torch.obs import validate_trace
    base = ["--device", "cpu", "--batch", "2", "--requests", "4",
            "--max-new", "3", "--temperature", "0.8"]
    serve.main(base)
    plain = capsys.readouterr().out
    path = tmp_path / "t.json"
    serve.main(base + ["--trace-out", str(path), "--metrics"])
    out = capsys.readouterr().out
    strip = lambda o: [ln for ln in o.splitlines() if ln.startswith("req")]
    assert strip(out) == strip(plain) and len(strip(plain)) == 4
    assert validate_trace(json.loads(path.read_text())["traceEvents"]) == []
    snap = json.loads(out.split("[obs] ", 2)[2])
    assert snap["rounds"] > 0 and snap["dispatches"] > 0


def test_launcher_page_dtype_needs_page_size(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--static", "--device", "cpu", "--page-dtype", "int8"])
    assert "--page-dtype requires --page-size" in capsys.readouterr().err


@pytest.mark.parametrize("launcher,argv,item", [
    # heads the model axis does not cut whole: the kv_seq fallback
    ("serve", ["--static", "--mesh", "1x4"], "Queue 1 item 14"),
    # training with a head cut in two
    ("train", ["--arch", "stablelm_3b", "--reduce", "--mesh", "1x4"],
     "Queue 1 item 14"),
])
def test_launcher_names_the_roadmap_item_of_unported_modes(launcher, argv,
                                                           item):
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{launcher}").main
    with pytest.raises(SystemExit, match=item):
        main(["--device", "cpu"] + argv)


def _run_jax_launcher(argv):
    """The JAX launcher's printed request lines (it reads ``sys.argv``)."""
    import contextlib
    import io

    from repro.launch import serve as jax_serve
    old, sys.argv = sys.argv, ["serve"] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jax_serve.main()
    finally:
        sys.argv = old
    return [ln for ln in buf.getvalue().splitlines() if ln.startswith("req")]


def _serves_like_jax(argv, capsys, monkeypatch):
    """The port's launcher on the CPU with the JAX launcher's weights carried
    across prints the JAX launcher's request lines."""
    import dataclasses

    import jax

    from repro.models import ModelConfig as JaxConfig
    from repro.models import get_model as jax_get_model
    from repro_torch.launch import serve
    from repro_torch.models.convert import from_jax_params

    want = _run_jax_launcher(argv)
    orig = serve.get_model

    class FromJax:
        def __init__(self, cfg):
            self.mod = orig(cfg)

        def __getattr__(self, name):
            return getattr(self.mod, name)

        def init(self, cfg, gen, device):
            cfg_j = JaxConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})
            params, _ = jax_get_model(cfg_j).init(jax.random.PRNGKey(0), cfg_j)
            return from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device=device)

    monkeypatch.setattr(serve, "get_model", FromJax)
    serve.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("req")]
    assert got == want
    return got


@pytest.mark.parametrize("argv", [
    ["--arch", "llama_3_2_vision_11b", "--static", "--batch", "2",
     "--max-new", "3"],
    ["--arch", "seamless_m4t_large_v2", "--src-len", "12", "--batch", "2",
     "--requests", "3", "--max-new", "3", "--prompt-len", "8"],
])
def test_launcher_serves_the_cross_attention_archs(argv, capsys, monkeypatch):
    """The VLM (one static batch with image embeddings) and encdec (the
    scheduler, each request with its own encoder input) on the CPU, with
    the JAX launcher's weights carried across: the JAX launcher's tokens."""
    assert len(_serves_like_jax(argv, capsys, monkeypatch)) in (2, 3)


@pytest.mark.parametrize("argv", [
    ["--arch", "stablelm_12b", "--static", "--batch", "2", "--max-new", "3"],
    ["--arch", "stablelm_12b", "--batch", "2", "--requests", "3",
     "--max-new", "3", "--prompt-len", "8"],
])
def test_launcher_serves_stablelm_12b(argv, capsys, monkeypatch):
    """stablelm-12b, once listed as pending (its head dim of 160), serves
    like any dense arch: one static batch and the scheduler, on the CPU at
    the launcher's reduced dims, the JAX launcher's tokens."""
    assert len(_serves_like_jax(argv, capsys, monkeypatch)) in (2, 3)
