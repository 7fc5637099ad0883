"""Quickstart of the port: the paper's figures.

  Fig. 2   daxpy    — predicate-driven loop control (whilelt), one kernel
                      for every (n, VL)
  Fig. 4/5 strlen   — first-faulting speculative loads and the FFR partition
  Fig. 6   list-XOR — a scalarized sub-loop (pnext/cpy/ctermeq)
  §2.4     fadda    — strictly ordered accumulation: the same bits at every
                      VL, unlike a tree sum

    python -m repro_torch.launch.quickstart               # on the card
    python -m repro_torch.launch.quickstart --device cpu  # plain versions

The counterpart of ``examples/quickstart.py``.  Figs. 2 and §2.4 run on
their kernels; Figs. 4-6 are the partition algebra (``core.ffr``,
``core.partition``) on tensors of the same device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ffr as F
from repro_torch.core import partition as PT
from repro_torch.core import predicate as P
from repro_torch.core.device import resolve_device
from repro_torch.core.reductions import eorv, pairwise_sum
from repro_torch.kernels.daxpy import daxpy
from repro_torch.kernels.daxpy.ref import daxpy_ref
from repro_torch.kernels.fadda import fadda
from repro_torch.kernels.fadda.ref import fadda_ref

VLS = (128, 256, 512)


def fig2_daxpy(device) -> None:
    print("== Fig 2: daxpy, vector-length agnostic ==")
    rng = np.random.RandomState(0)
    n = 1000                                  # NOT a multiple of any VL
    x = torch.from_numpy(rng.randn(n).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randn(n).astype(np.float32)).to(device)
    want = daxpy_ref(x, y, 2.0, n)
    for vl in VLS:                            # "128-bit .. 512-bit machines"
        got = daxpy(x, y, 2.0, n, block=vl)
        if not torch.equal(got, want):
            raise RuntimeError(f"daxpy at VL={vl} differs from the plain version")
        print(f"  VL={vl:4d}: identical result, {-(-n // vl)} strip-mined "
              "iterations")


def fig5_strlen(device) -> None:
    print("== Fig 5: strlen via first-faulting loads ==")
    buf = torch.zeros(1000, dtype=torch.int32, device=device)
    buf[:613] = 65
    for vl in (64, 256):
        got = int(F.strlen(buf, 0, vl=vl))
        print(f"  VL={vl:4d}: strlen = {got}")
        if got != 613:
            raise RuntimeError(f"strlen at VL={vl}: {got} != 613")
    # the FFR itself, paper Fig. 4: lanes after the first fault are cleared
    base = torch.arange(8.0, device=device)
    idx = torch.tensor([0, 1, 100, 3], device=device)
    _, ffr = F.ldff(base, idx, P.ptrue(4, device=device))
    print(f"  FFR for faulting gather: {ffr.tolist()} (lane 2 faulted)")


def fig6_linked_list(device) -> None:
    print("== Fig 6: linked-list XOR via scalarized sub-loop ==")
    rng = np.random.default_rng(1)
    n_nodes, length, vl = 64, 40, 16
    order = rng.permutation(n_nodes)[:length]
    nxt = np.full(n_nodes, -1, np.int32)
    for a, b in zip(order[:-1], order[1:]):
        nxt[a] = b
    vals = rng.integers(0, 1 << 30, n_nodes).astype(np.int32)
    nxt_t = torch.from_numpy(nxt).to(device)
    vals_t = torch.from_numpy(vals).to(device)

    want, p = 0, int(order[0])
    while p != -1:
        want ^= int(vals[p])
        p = nxt[p]

    def lane_step(state, p_lane, lane):
        cur, z = state
        return (nxt_t[cur], P.cpy(p_lane, cur, z)), nxt_t[cur] >= 0

    res, ptr, rounds = 0, torch.tensor(int(order[0]), device=device), 0
    while int(ptr) >= 0:
        zeros = torch.zeros(vl, dtype=torch.int32, device=device)
        (ptr, zvec), part = PT.serial_subloop(P.ptrue(vl, device=device),
                                              lane_step, (ptr, zeros))
        res ^= int(eorv(part, vals_t[zvec.clamp_min(0)]))
        rounds += 1
    print(f"  XOR over {length}-node list in {rounds} vector rounds "
          f"(VL={vl}): {res} == scalar {want}")
    if res != want:
        raise RuntimeError(f"list XOR {res} != the scalar loop's {want}")


def sec24_fadda(device) -> None:
    print("== §2.4: fadda, strictly ordered ==")
    x = np.array([1e8, 1.0, -1e8, 1.0] * 64, np.float32)
    xt = torch.from_numpy(x).to(device)
    want = fadda_ref(x)
    tree = np.float32(pairwise_sum(xt).item())
    for vl in VLS:
        got = np.float32(fadda(xt, block=vl).item())
        if got.tobytes() != want.tobytes():
            raise RuntimeError(f"fadda at VL={vl}: {got} != the scalar loop's {want}")
        print(f"  VL={vl:4d}: {got} (the scalar loop's bits)")
    if tree == want:
        raise RuntimeError("the tree sum should lose the 1.0s")
    print(f"  pairwise tree sum: {tree} (another association, other bits)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to opt out)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fig2_daxpy(device)
    fig5_strlen(device)
    fig6_linked_list(device)
    sec24_fadda(device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
