#!/usr/bin/env python3
"""Device time of the LUT softmax kernel of one checkout at the shapes
chip_smoke.py phase 8 times, warm and with the L2 flushed before each
launch, three profiled runs of 40 calls each.

  python3 tools/time_softmax.py [CHECKOUT] [LABEL]

CHECKOUT (default: this one) is the root of a checkout whose kernel is
used, through its `lut_softmax(scores, mask, cfg)`.  To compare two
commits, unpack the parent into an ignored directory (`git archive`) and
time parent, change, change, parent in one call on the card.  Prints
LABEL and, per shape, the device us per launch of the kernel's own device
kernels (warm, flushed) and of every device kernel of the call (warm: a
copy the wrapper makes counts there).  Needs a CUDA device and nvcc.
"""
import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(root, "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import LUTSoftmaxConfig  # noqa: E402
from repro_torch.kernels import lut_softmax as SM  # noqa: E402

if not SM.__file__.startswith(root):
    raise SystemExit(f"time_softmax: imported {SM.__file__}, not the checkout {root}")
if not torch.cuda.is_available():
    raise SystemExit("time_softmax: no CUDA device is available")
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
lut = LUTSoftmaxConfig()


def scores(*shape):
    return torch.clamp(torch.round(torch.randn(shape, generator=gen, device=dev) * 24),
                       -128, 127).to(torch.int32)


k_pos = torch.arange(160, device=dev)
causal = (k_pos[None, :] <= torch.arange(128, device=dev)[:, None]) & (k_pos < 128)
pre = scores(4, 16, 1, 128, 160)
lens = torch.randint(1, 513, (128, 1), generator=gen, device=dev)
SHAPES = {
    "64x160": (scores(64, 160), (k_pos < 129).expand(64, 160).clone()),
    "128x512": (scores(128, 512), torch.arange(512, device=dev) < lens),
    "8192x160": (pre.view(8192, 160), causal.expand(4, 16, 128, 160).reshape(8192, 160)),
    "8192x160 bcast": (pre, causal.expand(4, 128, 160)[:, None, None].expand(pre.shape)),
    "64x4096": (scores(64, 4096),
                (torch.arange(4096, device=dev) < 4000).expand(64, 4096).clone()),
}
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > the 50 MB L2


def device_us(fn, n=40):
    """(us per call of the lut_softmax kernels, us per call of every device
    kernel but the flush's) over n profiled calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    own = [e for e in ev if "lut_softmax_kernel" in e.key]
    if sum(e.count for e in own) != n:
        raise SystemExit(f"time_softmax: the profiler saw {[e.count for e in own]} of {n}")
    rest = [e for e in ev if "fill" not in e.key.lower()]
    return (round(sum(e.self_device_time_total for e in own) / n, 2),
            round(sum(e.self_device_time_total for e in rest) / n, 2))


runs = {}
for k, (s, m) in SHAPES.items():
    def warm(s=s, m=m):
        return SM.lut_softmax(s, m, lut)

    def cold(s=s, m=m):
        flush.fill_(1)
        return SM.lut_softmax(s, m, lut)
    runs[k] = []
    for _ in range(3):
        w, c = device_us(warm), device_us(cold)
        runs[k].append((w[0], c[0], w[1]))
print(sys.argv[2] if len(sys.argv) > 2 else root,
      "(kernel warm, kernel flushed, every kernel warm) us:", runs, flush=True)
