"""``repro_torch.dist.collectives`` on one gloo group of 4 CPU ranks
(``launch.mesh.run_ranks``, started once for the module): ``ordered`` and
``pairwise`` psum bit for bit against a numpy left-to-right loop and
balanced tree (the odd tail over 3 of the ranks) and against the JAX
package's ``ordered_psum``/``pairwise_psum`` under ``shard_map`` on the same
shards (one JAX subprocess with 4 forced host devices, as
``test_collectives.py`` runs them); ``compressed_psum``'s error bit for
bit and its mean against JAX's; the mode choice point, its refusal of an
unknown mode and its obs counter by mode; ``make_production_mesh``'s
degraded shape against JAX's over 4 devices.  The rank functions live
here, importable by name, and import no JAX.
"""

import os
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.dist import collectives as C
from repro_torch.launch.mesh import (batch_shard_count, make_production_mesh,
                                     run_ranks)
from repro_torch.obs import Obs

RANKS = 4
ROUNDS = 50


def _shards():
    rng = np.random.RandomState(0)
    return rng.randn(RANKS, 1, 16).astype(np.float32)


def _collectives_rank(mesh, x):
    """Every collective of the module on this rank's shard ``x[rank]``."""
    import torch.distributed as dist
    r = mesh.rank
    g = mesh.groups["data"]
    mine = torch.from_numpy(x[r])
    out = {"ordered": C.ordered_psum(mine, g).numpy(),
           "pairwise": C.pairwise_psum(mine, g).numpy(),
           "fast": C.psum(mine, g, "fast").numpy()}
    three = dist.new_group([0, 1, 2])          # every rank makes the group
    if r < 3:
        out["pairwise3"] = C.pairwise_psum(mine, three).numpy()
        out["ordered3"] = C.ordered_psum(mine, three).numpy()
    obs = Obs()
    C.set_obs(obs)
    try:
        for mode in ("ordered", "ordered", "pairwise"):
            C.set_psum_mode(mode)
            out[f"mode {mode}"] = C.psum(mine, g).numpy()
        out["explicit"] = C.psum(mine, g, mode="ordered").numpy()
    finally:
        C.set_psum_mode("fast")
        C.set_obs(None)
    out["counts"] = {k: v for k, v in obs.metrics.snapshot().items()
                     if k.startswith("psum_")}
    try:
        C.set_psum_mode("nope")
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    err = torch.zeros_like(mine)
    out["mean"], out["err"] = (t.numpy() for t in C.compressed_psum(mine, g,
                                                                     err))
    acc, err = np.zeros((1, 16), np.float32), torch.zeros_like(mine)
    for _ in range(ROUNDS):
        m, err = C.compressed_psum(mine, g, err)
        acc += m.numpy()
    out["acc"] = acc
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        prod = make_production_mesh(device="cpu")
    out["production"] = prod.shape
    out["batch ways"] = batch_shard_count(prod)
    out["degraded"] = any("degraded" in str(x.message) for x in w)
    return out


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import compressed_psum, ordered_psum, pairwise_psum
from repro.launch import mesh as M

if hasattr(jax, "shard_map"):
    def smap(f, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
else:
    from jax.experimental.shard_map import shard_map as _shard_map
    def smap(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=False)

x = np.load(sys.argv[1])
out = {}
for n in (4, 3):
    mesh = M.make_mesh((n,), ("data",))
    xs = jnp.asarray(x[:n])
    for name, f in (("ordered", ordered_psum), ("pairwise", pairwise_psum)):
        out[f"{name}{n}"] = np.asarray(jax.jit(smap(
            lambda s, f=f: f(s, "data"), mesh, P("data"), P()))(xs))
mesh = M.make_mesh((4,), ("data",))
step = jax.jit(smap(lambda g, e: compressed_psum(g, "data", e), mesh,
                    (P("data"), P("data")), (P(), P("data"))))
mean, err = step(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
out["mean"], out["err"] = np.asarray(mean), np.asarray(err)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    prod = M.make_production_mesh()
out["production"] = np.asarray(prod.devices.shape)
np.savez(sys.argv[2], **out)
print("jax collectives OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 ranks' results, JAX's results, the shards)."""
    x = _shards()
    ranks = run_ranks(_collectives_rank, (RANKS,), ("data",), x,
                      device="cpu", timeout=240)
    d = tmp_path_factory.mktemp("jax_collectives")
    np.save(d / "x.npy", x)
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/root")}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d / "x.npy"),
                        str(d / "jax.npz")], capture_output=True, text=True,
                       timeout=300, env=env,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stdout + r.stderr
    jx = dict(np.load(d / "jax.npz"))
    for k in ("ordered4", "ordered3", "pairwise4", "pairwise3", "mean"):
        jx[k] = jx[k].reshape(1, 16)                # JAX's (1, 1, 16) block
    return ranks, jx, x


def _loop(x):
    acc = np.zeros_like(x[0])
    for s in x:
        acc = acc + s
    return acc


def _tree(x):
    xs = list(x)
    while len(xs) > 1:
        nxt = [xs[i] + xs[i + 1] for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def test_ordered_psum_is_the_left_to_right_loop_and_jax(runs):
    ranks, jx, x = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(_bits(out["ordered"]), _bits(_loop(x)))
        np.testing.assert_array_equal(_bits(out["ordered"]),
                                      _bits(jx["ordered4"]))
        if r < 3:
            np.testing.assert_array_equal(_bits(out["ordered3"]),
                                          _bits(jx["ordered3"]))


def test_pairwise_psum_is_the_balanced_tree_and_jax(runs):
    """The balanced tree bit for bit.  JAX's ``pairwise_psum``, compiled by
    XLA on the CPU, sums 4 shards left to right (its pairwise reductions
    fuse into one reduce: ROADMAP Queue 3), so over 4 ranks it is held to
    a reassociation's rounding; over 3 the tree and the loop coincide and
    it is held bit for bit."""
    ranks, jx, x = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(_bits(out["pairwise"]), _bits(_tree(x)))
        bound = 4 * 2 ** -24 * np.abs(x).sum(0)   # 3 roundings of partials
        assert (np.abs(out["pairwise"] - jx["pairwise4"]) <= bound).all()
        if r < 3:                                # the odd tail
            np.testing.assert_array_equal(_bits(out["pairwise3"]),
                                          _bits(_tree(x[:3])))
            np.testing.assert_array_equal(_bits(out["pairwise3"]),
                                          _bits(jx["pairwise3"]))


def test_fast_psum_is_the_sum(runs):
    ranks, _, x = runs
    for out in ranks:
        np.testing.assert_allclose(out["fast"], x.sum(0), rtol=1e-6,
                                   atol=1e-6)
    assert all(_bits(o["fast"]).tobytes() == _bits(ranks[0]["fast"]).tobytes()
               for o in ranks)


def test_compressed_psum_matches_jax(runs):
    ranks, jx, x = runs
    amax = np.abs(x).max()
    for r, out in enumerate(ranks):
        # this rank's own residual comp - q * scale: XLA contracts JAX's into
        # one fused multiply-add, so the two differ by the rounding of the
        # product q * scale, half an ulp of this rank's absmax at most
        np.testing.assert_allclose(out["err"], jx["err"][r], rtol=0,
                                   atol=np.spacing(np.abs(x[r]).max()) / 2)
        # the mean sums the ranks in the backend's order
        np.testing.assert_allclose(out["mean"], jx["mean"], rtol=1e-6,
                                   atol=1e-7)
        assert np.abs(out["mean"] - x.mean(0)).max() <= amax / 127.0 + 1e-6
        # error feedback: the mean over rounds converges to the exact mean
        np.testing.assert_allclose(out["acc"] / ROUNDS, x.mean(0),
                                   atol=amax / 127.0 / 10, rtol=0)


def test_psum_mode_choice_point_and_counter(runs):
    ranks, _, x = runs
    for out in ranks:
        np.testing.assert_array_equal(_bits(out["mode ordered"]),
                                      _bits(out["ordered"]))
        np.testing.assert_array_equal(_bits(out["mode pairwise"]),
                                      _bits(out["pairwise"]))
        np.testing.assert_array_equal(_bits(out["explicit"]),
                                      _bits(out["ordered"]))
        assert out["refused"]
        # one count per call, by the mode each call ran
        assert out["counts"] == {"psum_ordered_calls": 3,
                                 "psum_pairwise_calls": 1}, out["counts"]
    assert C.psum_mode() == "fast"
    with pytest.raises(ValueError, match="not in"):
        C.set_psum_mode("nope")


def test_production_mesh_degrades_as_jax(runs):
    ranks, jx, _ = runs
    for out in ranks:
        assert out["degraded"]
        assert tuple(out["production"].values()) == tuple(jx["production"])
        assert out["production"] == {"data": 2, "model": 2}
        assert out["batch ways"] == 2


def test_mesh_entry_points_refuse_without_cuda():
    """No fallback: without CUDA a mesh is started only on the CPU when the
    CPU is asked for, and nothing is spawned before the refusal."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(_collectives_rank, (2,), ("data",), _shards())
