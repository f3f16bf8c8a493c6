#!/usr/bin/env python3
"""Kernel 1's PV tile at head_dim 96: the tile the source builds beside a
wider one.

  python3 tools/ablate_dh96_tile.py [--out chiprun_out/dh96_tile.json]

At head_dim 96 a thread of `src/repro_torch/kernels/csrc/pim_attention.cu`
holds its PV accumulators in three float2 groups 32 dims apart: rows / 16
rows x 6 dims.  The variant takes the generic float4 path there: 1 x 12
dims at 32 rows and 2 x 12 at 64 (16 rows keep 1 x 6), half the rows a
thread and twice the V bytes a multiply-add.  Both builds are held against
the repo's own bit for bit,
their registers and spill stores are printed from ptxas, and each is timed
with torch.profiler at phi-3-vision-4.2b's prefill shapes: Sq 512 causal at
batch 4 over 32/32 heads (32-row CTAs) and over 32/8 (64-row CTAs), and the
served 640-token prefill over a 672-row cache.  Needs a CUDA device and
nvcc; the harness is tools/ablation.py.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

import ablation as ab
from repro_torch.configs import get_config
from repro_torch.core import attention as A
from repro_torch.kernels import ops
from repro_torch.kernels import pim_attention as PA

TG_LINE = "constexpr int TG = DH % 3 == 0 ? 2 : (ACC / NG >= 4 ? 4 : ACC / NG);"
VARIANTS = {"as built": [],
            "12-dim float4 tile": [(TG_LINE, "constexpr int TG = ACC / NG >= 4 ? 4 : "
                                             "ACC / NG;")]}


def shapes(dev) -> dict:
    """{shape: a call of pim_attention on random operands}."""
    base = get_config("phi-3-vision-4.2b")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def dense(cfg, B, Sq, Sk, kv_len):
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        cache = A.init_kv_cache(B, Sk, Hkv, Dh, device=dev)
        A.cache_write(cache, rand(B, kv_len, Hkv, Dh), rand(B, kv_len, Hkv, Dh), 0, cfg.pim)
        return ops.kernel_attention_layout(rand(B, Sq, H, Dh), cache, 8)

    gqa = dataclasses.replace(base, num_kv_heads=8)
    a, b, c = dense(base, 4, 512, 512, 512), dense(gqa, 4, 512, 512, 512), \
        dense(base, 4, 640, 672, 640)
    return {"32/32 Sq512": lambda: PA.pim_attention(*a, 0, 512),
            "32/8 Sq512": lambda: PA.pim_attention(*b, 0, 512),
            "32/32 prefill Sq640": lambda: PA.pim_attention(*c, 0, 640)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the times here (JSON)")
    args = ap.parse_args()
    smi = ab.card("ablate_dh96_tile")
    dev = torch.device("cuda", 0)
    assert TG_LINE in open(f"{ab.CSRC}/pim_attention.cu").read()
    libs = ab.build("pim_attention", VARIANTS, PA._SIGNATURES,
                    entries="pim_attention_kernelILi96E")
    calls = shapes(dev)
    ref = {k: f() for k, f in calls.items()}   # the repo's own build
    own, times = PA._lib, {}
    try:
        for name, (lib, _) in libs.items():
            PA._lib = lambda lib=lib: lib
            for k, f in calls.items():
                if not torch.equal(f(), ref[k]):
                    raise SystemExit(f"ablate_dh96_tile: {name} differs at {k}")
            times[name] = ab.time_calls(calls, "pim_attention_kernel")
            ab.print_times(name, times[name])
        for name, (lib, _) in reversed(list(libs.items())):   # and in reverse order
            PA._lib = lambda lib=lib: lib
            again = ab.time_calls(calls, "pim_attention_kernel")
            ab.print_times(name + ", again", again)
            times[name + ", again"] = again
    finally:
        PA._lib = own
    ab.write(args.out, smi, times)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
