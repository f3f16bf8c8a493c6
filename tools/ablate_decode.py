#!/usr/bin/env python3
"""Where the split-K decode kernel's device time goes, by ablation.

  python3 tools/ablate_decode.py [--out chiprun_out/ablate_decode.json]

No kernel profiler runs where the card is, so this script builds variants
of `src/repro_torch/kernels/csrc/pim_decode.cu` (plain string edits of the
source, each checked to apply) and times every variant with torch.profiler
at five shapes of internlm2-1.8b (16/8 heads, head_dim 128, int8 KV): dense
kv_len 4096 at block_k 256, batch 4 (chip_smoke.py phase 2), the same over
16-token pages (phase 3), dense kv_len 16384 (past the 50 MB L2), the
classic request's decode (a 160-row cache holding 144 tokens) and a decode
step of the phase 7 trace (8 slots of 16-320 tokens over 32-page tables).
Each cut variant leaves out one more part of the work than the one before
it, so consecutive differences split the time; the cut variants compute
wrong outputs.  Other variants change the ring depth, or mark the SM
clock at each phase of one CTA, and the full build runs at several chunk
counts (CTAs a tile).
The full build is checked against the repo's own build bit for bit.
Needs a CUDA device and nvcc; the harness is tools/ablation.py.
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
from repro_torch.kernels import pim_decode as PD

# (source text, replacement): each cuts one part of the work out
CUT = {
    "combine": [("const int n_chunks = (n_p + C - 1) / C;", "const int n_chunks = 0;"),
                ("for (int i = tid; i < n_p * RT; i += T) {",
                 "for (int i = tid; i < 0; i += T) {")],
    "partition records": [("for (int i = tid; i < nbu * RT * DV; i += T) {",
                           "for (int i = tid; i < 0; i += T) {"),
                          ("if ((cc.mask >> wblk) & 1u) {\n          unsigned char* rec",
                           "if (false) {\n          unsigned char* rec")],
    "PV": [("for (int j = 0; j < kKeys; ++j) {\n        float vd[DPL], e[RT];",
            "for (int j = 0; j < 0; ++j) {\n        float vd[DPL], e[RT];")],
    "exps": [("for (int i = lane; i < kKeys * RT; i += 32) {",
              "for (int i = lane; i < 0; i += 32) {")],
    "scores": [("for (int kk = 0; kk < KS; ++kk) {\n        uint32_t x4[4];",
                "for (int kk = 0; kk < 0; ++kk) {\n        uint32_t x4[4];"),
               ("for (int i = 0; i < VPL; ++i) {\n        int k, sv;",
                "for (int i = 0; i < 0; ++i) {\n        int k, sv;")],
    "K/V loads": [("for (int i = tid; i < kKvRows * V; i += T) {",
                   "for (int i = tid; i < 0; i += T) {"),
                  ("if (tid < kKvRows) {\n      const long row = row_of(cu, tid);",
                   "if (tid < 0) {\n      const long row = row_of(cu, tid);")],
    "every stage": [("for (int n = 0; cc.ok; ++n) {", "for (int n = 0; false; ++n) {")],
}
CHAIN = ("combine", "partition records", "PV", "exps", "scores", "K/V loads")
# not a cut: the full kernel with more ring slots
OTHER = {
    "5 ring slots": [("constexpr int kStages = 3;", "constexpr int kStages = 5;")],
}
CHUNK_SWEEP = (1, 4)   # CTAS_PER_SM of the full build besides its own

# the full kernel with clock64() marks: thread 0 of CTA (0, 0) keeps the SM
# cycles since its start at each mark (after the set-up; in each stage after
# its barrier, after the next stage's copies are issued, after the scores
# and after the codes (K) or after the exps and after PV (V), and at its
# end; after the ticket, after the combine's maxima, at the exit) in
# counters[512 ..] past any tile's counter (counters[511]: the number of
# marks), zeroed again once read
_DUMP = ("if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) { MARK; "
         "for (int i = 0; i < nt_; ++i) a.counters[512 + i] = (int)tt_[i]; "
         "a.counters[511] = nt_; }")
_MARK = "if (tid == 0 && nt_ < 60) tt_[nt_++] = clock64() - t0_;"
TIMED = [
    ("const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
     "const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const long long t0_ = clock64(); __shared__ long long tt_[64]; int nt_ = 0;"),
    ("  uint32_t qa[KS][4];", "  MARK;\n  uint32_t qa[KS][4];"),
    ("    __syncthreads();  // stage n landed; stage n - 1 is no longer read",
     "    __syncthreads();  // stage n landed; stage n - 1 is no longer read\n    MARK;"),
    ("    advance(cc);\n", "    MARK;\n    advance(cc);\n"),
    ("    pim::cp_async_commit();\n    const int8_t* st =",
     "    pim::cp_async_commit();\n    MARK;\n    const int8_t* st ="),
    ("      const bool blk_ok = (cc.mask >> wblk) & 1u;\n      int mx = kNegInt;",
     "      MARK;\n      const bool blk_ok = (cc.mask >> wblk) & 1u;\n      int mx = kNegInt;"),
    ("#pragma unroll\n      for (int o = 1; o < 32 / RT; o <<= 1)",
     "      MARK;\n#pragma unroll\n      for (int o = 1; o < 32 / RT; o <<= 1)"),
    ("      __syncwarp();\n      if (cc.c == cc.c_lo) {",
     "      __syncwarp();\n      MARK;\n      if (cc.c == cc.c_lo) {"),
    ("      if (cc.c == cc.c_hi && wpb == 1) {", "      MARK;\n      if (cc.c == cc.c_hi && wpb == 1) {"),
    ("= p == lo;\n    return;", "= p == lo;\n    DUMP;\n    return;"),
    ("    if (!s_last) return;", "    if (!s_last) { DUMP; return; }\n    MARK;"),
    ("  const int n_chunks = (n_p + C - 1) / C;", "  MARK;\n  const int n_chunks = (n_p + C - 1) / C;"),
    ("  if (n_active > 1 && tid == 0) a.counters[tile] = 0;",
     "  if (n_active > 1 && tid == 0) a.counters[tile] = 0;\n  DUMP;"),
]


def shapes(dev) -> dict:
    """{shape: a call of pim_decode on random operands}."""
    cfg = get_config("internlm2-1.8b")
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def dense(B, Sk, kv_len):
        cache = A.init_kv_cache(B, Sk, Hkv, Dh, device=dev)
        A.cache_write(cache, rand(B, kv_len, Hkv, Dh), rand(B, kv_len, Hkv, Dh), 0, cfg.pim)
        return ops.kernel_attention_layout(rand(B, 1, H, Dh), cache, 8)

    def paged(lens, S):
        B = len(lens)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        pt, P = cs.random_table(lens, S // cs.PAGE, 0, dev)
        pool = A.init_paged_kv_cache(P, cs.PAGE, Hkv, Dh, device=dev)
        A.paged_cache_write(pool, rand(B, S, Hkv, Dh), rand(B, S, Hkv, Dh), zeros,
                            cfg.pim, pt, seq_lens=lens_d)
        q_q, qs = ops._q_kernel_layout(rand(B, 1, H, Dh), 8)
        return (q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale), pt, lens_d

    out = {}
    d4 = dense(4, 4096, 4096)
    out["dense kv4096"] = lambda: PD.pim_decode(*d4, 4095, 4096)
    p4, pt4, l4 = paged([4096] * 4, 4096)
    out["paged kv4096"] = lambda: PD.pim_decode(*p4, l4 - 1, l4, page_table=pt4)
    d16 = dense(4, 16384, 16384)
    out["dense kv16384"] = lambda: PD.pim_decode(*d16, 16383, 16384)
    dc = dense(4, 160, 144)
    out["classic kv144"] = lambda: PD.pim_decode(*dc, 143, 144)
    lens = np.random.RandomState(0).randint(16, 321, 8).tolist()
    pt_, ptt, lt = paged(lens, 512)
    out["trace step"] = lambda: PD.pim_decode(*pt_, lt - 1, lt, page_table=ptt)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the times here (JSON)")
    args = ap.parse_args()
    smi = ab.card("ablate_decode")
    dev = torch.device("cuda", 0)
    libs = ab.build("pim_decode", dict(ab.chain_variants(CUT, CHAIN, OTHER), timed=TIMED),
                    PD._SIGNATURES,
                    lambda t: t.replace("DUMP", _DUMP).replace("MARK", _MARK))
    calls = shapes(dev)
    ref = {k: f() for k, f in calls.items()}   # the repo's own build
    own, stages, per_sm = PD._lib, PD.STAGES, PD.CTAS_PER_SM

    def use(name, chunks_per_sm=per_sm):
        lib, text = libs[name]
        PD._lib = lambda: lib
        PD.STAGES = int(text.split("constexpr int kStages = ")[1].split(";")[0])
        PD.CTAS_PER_SM = chunks_per_sm
        PD.launch_plan.cache_clear()
        PD._checked_plan.cache_clear()

    runs = [(name, per_sm) for name in libs if name != "timed"] + [
        ("full", c) for c in CHUNK_SWEEP]
    times = {}
    try:
        for name, chunks_per_sm in runs:
            use(name, chunks_per_sm)
            label = name if chunks_per_sm == per_sm else f"full, CTAS_PER_SM {chunks_per_sm}"
            if name == "full":
                for k, f in calls.items():
                    if not torch.equal(f(), ref[k]):
                        raise SystemExit(f"ablate_decode: {label} differs at {k}")
            times[label] = ab.time_calls(calls, "pim_decode_kernel")
            ab.print_times(label, times[label])
        use("timed")
        print("clock64 marks of CTA (0, 0), SM cycles from its start: set-up; "
              "each stage's barrier and end; ticket; maxima; exit")
        for k, f in calls.items():
            f()
            torch.cuda.synchronize()
            c = PD._counters[dev]
            marks = c[512:512 + int(c[511])].tolist()
            c[511:].zero_()   # the marks' slots are tile counters of larger grids
            times.setdefault("marks", {})[k] = marks
            print(f"  {k}: {marks}", flush=True)
    finally:
        PD._lib, PD.STAGES, PD.CTAS_PER_SM = own, stages, per_sm
        PD.launch_plan.cache_clear()
        PD._checked_plan.cache_clear()
    ab.print_chain(times, CHAIN, calls, "set-up and exit (no stage)")
    ab.write(args.out, smi, times)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
