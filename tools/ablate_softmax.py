#!/usr/bin/env python3
"""Where the LUT softmax kernel's device time goes, by ablation, and how its
launch plan moves it.

  python3 tools/ablate_softmax.py [--out FILE.json]

Builds variants of `src/repro_torch/kernels/csrc/lut_softmax.cu` (plain
string edits of the source, each checked to apply) and times every variant
with torch.profiler at the shapes chip_smoke.py phase 8 times: the classic
request's decode rows (64 x 160), a trace decode step's (128 x 512), the
classic prefill rows (8192 x 160, full mask and the attention's broadcast
mask) and long decode rows (64 x 4096).  Each cut variant leaves out one
more part of the work than the one before it, so consecutive differences
split the time; the cut variants compute wrong codes.  Then the full build
runs under other launch plans: 1-8 warp rows a CTA, and a CTA per row (of
its own width, and of 128, 256 and 1024 threads) for rows of every
length.  The full build is checked against the repo's own
build bit for bit.  Needs a CUDA device and nvcc; the harness is
tools/ablation.py.
"""
from __future__ import annotations

import argparse
import sys

import torch

import ablation as ab
from repro_torch.configs import get_config
from repro_torch.kernels import lut_softmax as SM

# (source text, replacement): each cuts one part of the work out
CUT = {
    "divide": [("floorf(__fdiv_rn(__fmul_rn(__uint2float_rn(e), out_scale), denom))",
                "(__uint2float_rn(e) + denom)")],
    "exps": [("return static_cast<unsigned>(tab[min(max(d, 0), 255)]);",
              "return static_cast<unsigned>(d);")],
    "reductions": [("  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));",
                    "  for (int o = 16; o > 16; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));"),
                   ("  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);",
                    "  for (int o = 16; o > 16; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);")],
    "table load": [("for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x)",
                    "for (int i = threadIdx.x; i < 0; i += blockDim.x)"),
                   ("if (tid < kTableBytes / 16) t4 =", "if (tid < 0) t4 =")],
}
CHAIN = ("divide", "exps", "reductions", "table load")

# the full kernel with clock64() marks: thread 0 of CTA 0 keeps the SM
# cycles since its start at each mark and writes them over the first codes
# of row 0 at its end.  Warp rows: after the table's barrier, after the max
# (the row's loads have landed), after the sum, after the stores.  CTA
# rows: after the loads (used), after the block max, after the exps' sum,
# after the block sum, after the stores.
_MARK = "if (threadIdx.x == 0) tt_[nt_++] = clock64() - t0_;"
_DUMP = ("if (threadIdx.x == 0 && blockIdx.x == 0) { "
         "for (int i = 0; i < nt_; ++i) out[i] = (int)tt_[i]; }")
_START = "const long long t0_ = clock64(); long long tt_[8]; int nt_ = 0;"
TIMED = [
    ("  const bool live = row < static_cast<unsigned>(rows);",
     "  const bool live = row < static_cast<unsigned>(rows);\n  START"),
    ("  __syncthreads();\n  if (!live) return;", "  __syncthreads();\n  MARK;\n  if (!live) return;"),
    ("  m = warp_max(m);\n", "  m = warp_max(m);\n  MARK;\n"),
    ("  const float denom = fmaxf(__uint2float_rn(warp_sum(sum)), 1.0f);",
     "  const float denom = fmaxf(__uint2float_rn(warp_sum(sum)), 1.0f);\n  MARK;"),
    ("      if (j < S) op[j] = code;\n    }\n}", "      if (j < S) op[j] = code;\n    }\n  MARK;\n  DUMP;\n}"),
    ("  const int tid = threadIdx.x, nt = blockDim.x, iters = (S + nt - 1) / nt;",
     "  const int tid = threadIdx.x, nt = blockDim.x, iters = (S + nt - 1) / nt;\n  START"),
    ("  if (tid < kTableBytes / 16) reinterpret_cast<int4*>(tab)[tid] = t4;\n",
     "  MARK;\n  if (tid < kTableBytes / 16) reinterpret_cast<int4*>(tab)[tid] = t4;\n"),
    ("  m = block_max(m, red_max);  // its barrier also publishes the table",
     "  m = block_max(m, red_max);  // its barrier also publishes the table\n  MARK;"),
    ("  const float denom = fmaxf(__ull2float_rn(block_sum(sum, red_sum)), 1.0f);",
     "  MARK;\n  const float denom = fmaxf(__ull2float_rn(block_sum(sum, red_sum)), 1.0f);\n  MARK;"),
    ("    if (j < S) op[j] = code;\n  }\n}", "    if (j < S) op[j] = code;\n  }\n  MARK;\n  DUMP;\n}"),
]


def shapes(dev) -> dict:
    """{shape: (scores, mask)} of the timed calls."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def scores(*shape):
        return torch.clamp(torch.round(torch.randn(shape, generator=gen, device=dev) * 24),
                           -128, 127).to(torch.int32)

    k_pos = torch.arange(160, device=dev)
    causal = (k_pos[None, :] <= torch.arange(128, device=dev)[:, None]) & (k_pos < 128)
    pre = scores(4, 16, 1, 128, 160)
    lens = torch.randint(1, 513, (128, 1), generator=gen, device=dev)
    lens2 = torch.randint(1, 513, (1024, 1), generator=gen, device=dev)
    return {
        "64x160": (scores(64, 160), (k_pos < 129).expand(64, 160).clone()),
        "128x512": (scores(128, 512), torch.arange(512, device=dev) < lens),
        "1024x512": (scores(1024, 512), torch.arange(512, device=dev) < lens2),
        "8192x512": (scores(8192, 512), (torch.arange(512, device=dev) < lens2).repeat(8, 1)),
        "512x160": (scores(512, 160), (k_pos < 129).expand(512, 160).clone()),
        "8192x160": (pre.view(8192, 160), causal.expand(4, 16, 128, 160).reshape(8192, 160)),
        "8192x160 bcast": (pre, causal.expand(4, 128, 160)[:, None, None].expand(pre.shape)),
        "64x4096": (scores(64, 4096), (torch.arange(4096, device=dev) < 4000).expand(
            64, 4096).clone()),
        "16x16384": (scores(16, 16384), torch.ones(16, 16384, dtype=torch.bool, device=dev)),
    }


def plans() -> dict:
    """{label: plan(rows, S, score_bytes, sms)} of the full build's sweep."""
    own = SM._plan

    def rows_per_cta(rpc):
        def plan(rows, S, nbytes, sms=132):
            p = own(rows, S, nbytes, sms)
            if p.regime != "rows":
                return p
            return p._replace(grid=-(-rows // rpc), rows_per_cta=rpc, threads=32 * rpc)
        return plan

    def cta(rows, S, nbytes, sms=132):
        return own(min(rows, sms), S, nbytes, sms)._replace(grid=rows)

    def cta_threads(n):
        def plan(rows, S, nbytes, sms=132):
            p = cta(rows, S, nbytes, sms)._replace(threads=n)
            if p.regime == "held" and S > SM.HELD_POSITIONS * n:   # staged instead
                p = p._replace(regime="staged", smem=SM._HEADER + SM._pad16(S * nbytes)
                               + SM._pad16(S))
            return p
        return plan

    out = {f"{r} warp rows a CTA": rows_per_cta(r) for r in (1, 2, 4, 8)}
    out["a CTA per row"] = cta
    out.update({f"a CTA of {n} threads per row": cta_threads(n) for n in (128, 256, 1024)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the times here (JSON)")
    args = ap.parse_args()
    smi = ab.card("ablate_softmax")
    dev = torch.device("cuda", 0)
    variants, edits = {"full": []}, []
    for part in CHAIN:
        edits = edits + CUT[part]
        variants[f"without {part}"] = edits
    variants["timed"] = TIMED
    libs = ab.build("lut_softmax", variants, SM._SIGNATURES,
                    lambda t: t.replace("START", _START).replace("MARK", _MARK)
                    .replace("DUMP", _DUMP))
    ops = shapes(dev)
    lut = get_config("internlm2-1.8b").lut
    calls = {k: (lambda s=s, m=m: SM.lut_softmax(s, m, lut)) for k, (s, m) in ops.items()}
    ref = {k: f() for k, f in calls.items()}   # the repo's own build
    own_lib, own_plan = SM._lib, SM._plan
    times = {}
    try:
        for name, (lib, _) in libs.items():
            if name == "timed":
                continue
            SM._lib = lambda lib=lib: lib
            if name == "full":
                for k, f in calls.items():
                    if not torch.equal(f(), ref[k]):
                        raise SystemExit(f"ablate_softmax: the full build differs at {k}")
            times[name] = ab.time_calls(calls, "lut_softmax_kernel")
            ab.print_times(name, times[name])
        SM._lib = lambda: libs["timed"][0]
        print("clock64 marks of thread 0 of CTA 0, SM cycles from its start (warp "
              "rows: barrier, max, sum, stores; CTA rows: loads, max, exps, sum, stores)")
        for k, f in calls.items():
            marks = f().flatten()[:5].tolist()
            times.setdefault("marks", {})[k] = marks
            print(f"  {k}: {marks}", flush=True)
        SM._lib = lambda: libs["full"][0]
        for label, plan in plans().items():
            SM._plan = plan
            for k, f in calls.items():
                if not torch.equal(f(), ref[k]):
                    raise SystemExit(f"ablate_softmax: {label} differs at {k}")
            times[label] = ab.time_calls(calls, "lut_softmax_kernel")
            ab.print_times(label, times[label])
    finally:
        SM._lib, SM._plan = own_lib, own_plan
    print("cost of each part, us per launch (the variant before it less the "
          "variant without it):")
    prev = "full"
    for part in CHAIN:
        name = f"without {part}"
        print(f"  {part:32s}" + "".join(
            f"  {k}: {times[prev][k] - times[name][k]:8.2f}" for k in calls), flush=True)
        prev = name
    print(f"  {'loads, stores, launch':32s}" + "".join(
        f"  {k}: {times[prev][k]:8.2f}" for k in calls))
    ab.write(args.out, smi, times)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
