#!/usr/bin/env python3
"""Where the prefill attention kernel's device time goes, by ablation.

  python3 tools/ablate_attention.py [--out chiprun_out/ablation.json]

No kernel profiler runs where the card is, so this script builds variants
of `src/repro_torch/kernels/csrc/pim_attention.cu` with a part of the work
cut out (plain string edits of the source, each checked to apply), and
times every variant with torch.profiler at four shapes of internlm2-1.8b
(16/8 heads, head_dim 128, int8 KV): dense Sq 512 causal at batch 4 (the
shape chip_smoke.py phase 2 times), the classic request's prefill (Sq 128
over a 160-row cache), paged Sq 512 over 16-token pages (phase 3), and an
admission wave of the phase 7 trace (8 prompts of 16-256 tokens bucketed
to Sq 256, paged).  A part's cost is the full kernel's time less the time
of the variant without it; one more variant is the full kernel with a
4-slot ring (one dense CTA an SM, not two).  The cut variants compute wrong
outputs; the full build is checked against the repo's own build bit for
bit.  Needs a CUDA device and nvcc; the harness is tools/ablation.py.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import ablation as ab
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.core import attention as A
from repro_torch.kernels import ops
from repro_torch.kernels import pim_attention as PA

# (source text, replacement): each cuts one part of the work out
CUT = {
    "PV loop": [("for (int j = j0; j < j0 + n; ++j) {\n          float e[TR]",
                 "for (int j = j0; j < j0; ++j) {\n          float e[TR]")],
    "exps": [("for (int j0 = jb; j0 < jb + JN; j0 += seg) {",
              "for (int j0 = jb; j0 < jb; j0 += seg) {")],
    "score division": [(
        "const int c = pim::score_code_int(\n"
        "              __fadd_rn(__int_as_float(s[t][x]), -12582912.0f), hi ? qs_hi : qs_lo,\n"
        "              tsc[col], a.sm_scale, a.score_scale, qmax);",
        "const int c = (s[t][x] >> 10) & 127;")],
    "V * v_scale": [(
        "for (int i = tid; i < kKvRows * DH / 4; i += pim::kThreads) {",
        "for (int i = tid; i < 0; i += pim::kThreads) {")],
    "codes, masks and maxima": [(
        "for (int x = 0; x < 4; ++x) {\n          const int col",
        "for (int x = 0; x < 0; ++x) {\n          const int col")],
    "K/V loads": [
        ("for (int i = tid; i < kKvRows * V; i += pim::kThreads) {",
         "for (int i = tid; i < 0; i += pim::kThreads) {"),
        ("if (tid < kKvRows) {\n      const long row = row_of(cu, tid);",
         "if (tid < 0) {\n      const long row = row_of(cu, tid);")],
    "every stage": [("for (int n = 0; cc.ok; ++n) {", "for (int n = 0; false; ++n) {")],
}
# each variant cuts its parts and those of the variants before it in the
# chain, so that consecutive differences split the time
CHAIN = ("PV loop", "exps", "score division", "V * v_scale",
         "codes, masks and maxima", "K/V loads")


# not a cut: the full kernel with a 4-slot ring (one dense CTA an SM)
FOUR_SLOTS = [("constexpr int kStages = 3;", "constexpr int kStages = 4;")]


def shapes(dev) -> dict:
    """{shape: a call of pim_attention on random operands}."""
    cfg = get_config("internlm2-1.8b")
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def dense(B, Sq, Sk, kv_len):
        cache = A.init_kv_cache(B, Sk, Hkv, Dh, device=dev)
        A.cache_write(cache, rand(B, kv_len, Hkv, Dh), rand(B, kv_len, Hkv, Dh), 0, cfg.pim)
        return ops.kernel_attention_layout(rand(B, Sq, H, Dh), cache, 8)

    def paged(lens, Sq, S):
        B = len(lens)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        pt, P = cs.random_table(lens, S // cs.PAGE, 0, dev)
        pool = A.init_paged_kv_cache(P, cs.PAGE, Hkv, Dh, device=dev)
        A.paged_cache_write(pool, rand(B, S, Hkv, Dh), rand(B, S, Hkv, Dh), zeros,
                            cfg.pim, pt, seq_lens=lens_d)
        q_q, qs = ops._q_kernel_layout(rand(B, Sq, H, Dh), 8)
        return (q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale), pt, lens_d, zeros

    out = {}
    o = dense(4, 512, 512, 512)
    out["dense Sq512"] = lambda: PA.pim_attention(*o, 0, 512)
    s = dense(4, 128, 160, 128)
    out["classic prefill Sq128 Sk160"] = lambda: PA.pim_attention(*s, 0, 128)
    p, pt, lens, z = paged([512] * 4, 512, 512)
    out["paged Sq512"] = lambda: PA.pim_attention(*p, z, lens, page_table=pt)
    wave = np.random.RandomState(0).randint(16, 257, 8).tolist()
    w, wpt, wl, wz = paged(wave, 256, 256)
    out["trace wave Sq256 paged"] = lambda: PA.pim_attention(*w, wz, wl, page_table=wpt,
                                                             q_len=wl)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the times here (JSON)")
    args = ap.parse_args()
    smi = ab.card("ablate_attention")
    dev = torch.device("cuda", 0)
    libs = ab.build("pim_attention", ab.chain_variants(
        CUT, CHAIN, {"full, four ring slots": FOUR_SLOTS}), PA._SIGNATURES)
    calls = shapes(dev)
    ref = {k: f() for k, f in calls.items()}   # the repo's own build
    own, stages = PA._lib, PA.STAGES
    times = {}
    try:
        for name, (lib, _) in libs.items():
            PA._lib = lambda lib=lib: lib
            PA.STAGES = 4 if name == "full, four ring slots" else stages
            if name == "full":
                for k, f in calls.items():
                    if not torch.equal(f(), ref[k]):
                        raise SystemExit(f"ablate_attention: full build differs at {k}")
            times[name] = ab.time_calls(calls, "pim_attention_kernel")
            ab.print_times(name, times[name])
    finally:
        PA._lib, PA.STAGES = own, stages
    ab.print_chain(times, CHAIN, calls, "set-up and output (no stage)")
    ab.write(args.out, smi, times)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
