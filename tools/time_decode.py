#!/usr/bin/env python3
"""Device time of the decode kernel of one checkout, at the five shapes of
tools/ablate_decode.py, three profiled runs of 40 calls each.

  python3 tools/time_decode.py [CHECKOUT] [LABEL]

CHECKOUT (default: this one) is the root of a checkout whose kernels and
shapes are used; it needs tools/ablate_decode.py.  To compare two commits,
unpack the parent into an ignored directory (`git archive`) and time
parent, change, change, parent in one call on the card.  Prints LABEL and
the device us per launch of each run.  Needs a CUDA device and nvcc.
"""
import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(root, "tools"), root, os.path.join(root, "src")]

import torch  # noqa: E402

import ablate_decode as D  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import pim_decode as PD  # noqa: E402

if not PD.__file__.startswith(root):
    raise SystemExit(f"time_decode: imported {PD.__file__}, not the checkout {root}")
if not torch.cuda.is_available():
    raise SystemExit("time_decode: no CUDA device is available")
calls = D.shapes(torch.device("cuda", 0))
runs = {}
for k, f in calls.items():
    runs[k] = []
    for _ in range(3):
        us, n = cs.kernel_us(cs.profiled(f, 40), "pim_decode_kernel")
        runs[k].append(round(us / n, 2))
print(sys.argv[2] if len(sys.argv) > 2 else root, runs, flush=True)
