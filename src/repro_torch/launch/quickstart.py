"""Quickstart of the port: the paper's figures that run on its kernels.

  Fig. 2   daxpy  — predicate-driven loop control (whilelt), one kernel for
                    every (n, VL)
  §2.4     fadda  — strictly ordered accumulation: the same bits at every
                    VL, unlike a tree sum

    python -m repro_torch.launch.quickstart               # on the card
    python -m repro_torch.launch.quickstart --device cpu  # plain versions

The counterpart of ``examples/quickstart.py``.  Its Figs. 5 (strlen through
first-faulting loads) and 6 (the linked-list XOR sub-loop) need
``core/ffr.py`` and ``core/partition.py``, which are not ported yet (ROADMAP
Queue 1 items 2 and 13).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.reductions import pairwise_sum
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
    sec24_fadda(device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
