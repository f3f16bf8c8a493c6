#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

  python3 chip_smoke.py [--out results.json] [--phases 1,2,3]

With no arguments it runs and checks every phase; `--phases` runs a subset
(phase 1 always, and the phases a chosen one needs), for short calls that
iterate on one kernel: `--phases 1,2,3` builds and checks both attention
kernels, dense and paged, `--phases 1,8` the PIM matmul and LUT softmax.

1. Prints the card and builds the CUDA kernels from `src/repro_torch/kernels/csrc`,
   with ptxas's registers and spills, and counts the tensor-core (IMMA)
   instructions, and all instructions, in the SASS of each pim_matmul,
   pim_attention and pim_decode kernel.
2. Holds each kernel against its plain PyTorch version at the widths of
   internlm2-1.8b (16 query heads over 8 KV heads, head_dim 128): causal,
   windowed and 4-bit prefill at Sq 512, and at Sq 512 a group of 4 q
   heads (16 over 4 KV heads) and head_dim 64; split-K decode at kv_len 4096 with
   block_k 256, verify rows (Sq 4), a q_len-0 row and 4-bit KV; iteration
   maps against the analytic count; and decode at the served request's
   own shape (a 160-token cache holding 129..159 tokens, one partial
   partition), with verify rows and 4-bit KV there too.  Times kernel,
   plain version and, as a yardstick only, bf16
   `scaled_dot_product_attention` at the same shapes: device time from
   torch.profiler, and the wall time of back-to-back calls beside it.  A
   decode call runs one device kernel and nothing else.
3. Holds the paged mode of both kernels against their plain versions at
   the same widths, over random permuted page tables of 16-token pages
   (slot lengths 0, 15, 16, 17, 1000, 2048): decode, verify rows (Sq 4),
   4-bit KV and a ragged prefill chunk (Sq 128, per-row offsets), with
   iteration maps equal, and paged == dense bit for bit at block_k == page
   size.  Times the paged mode at the shapes timed in phase 2 (one
   pim_decode_kernel per decode call).
4. Checks the kernel path of a small model against the plain path on the CPU.
5. Runs the continuous-batching Scheduler on the card at that small width
   (float32, kernel path): dense slots, the paged pool and classic greedy
   generation give the same streams, a starved pool stalls and evicts
   without changing them, every page returns to the free list and
   `audit()` passes after every step.
6. Serves internlm2-1.8b at full width and depth (random weights from a
   seed) through `repro_torch.runtime.serve_lib.generate`, batch 4, prompt
   128, 32 new tokens, greedy, counting kernel launches (24 prefill and
   31 x 24 decode launches, no plain-version call).  Then serves the
   request cut to 8 new tokens, once as it is and once under
   torch.profiler, and prints where its device time goes: the busy share
   over the unprofiled wall time, each attention kernel's device time per
   launch (the profiler must see one kernel per wrapper call), kernel 2's
   bound at the cut's shapes beside it, and the top device operators.
7. Serves a 16-request trace (prompts 16-256 tokens, budgets 16-64) through
   the Scheduler at full width, on dense slots and on the paged pool,
   counting kernel launches in each (24 prefill launches a prefill forward,
   no plain-version call); holds served launches of both kernels
   on each storage (every admission wave's ragged prefill and three decode
   steps, on the scheduler's own cache or pool, lengths, q_len and page
   table) against their plain versions; checks budgets, vocabulary, freed
   pages, a repeatable paged stream and, for prompts of one page, dense and
   paged prefill logits equal bit for bit; prints where and by how much
   the two storages' streams and logits part; then profiles the first 3
   steps of the paged run as phase 6 does, with kernel 2's bound at the
   shapes of those steps' decode calls.
8. (Run right after phase 3, beside the other kernel checks.)  Holds the
   PIM matmul (kernel 3) in both ADC modes and the LUT softmax (kernel 4)
   against their plain versions bit for bit: the linears' shapes (K 2048
   -> N 1024/2048/8192, K 8192 -> N 2048) at M 4, 512 and 2048, a K that
   is not a multiple of 16, a row-major layer view of stacked weights and
   the deployed (K, N) view of an (N, K) store, x rows that are not
   16-byte aligned; softmax rows at every boundary of kernel 4's regimes
   (S 1 to 1025 around the warp rows' limit, 4096, the longest row staged
   in shared memory and one past it), int32 and int8 codes, 1 and 9 rows,
   score views one element into their storage, all-masked rows, the
   served prefill (8192 x 160, also as the attention's broadcast mask) and
   decode (64 x 4096) rows, flat rows whose sum of exps passes 2^24.
   Times kernel 3 at the served shapes (M 4, 512 and 2048, with TOP/s and
   the share of its bound) beside its plain version, its bound and, for the
   ideal mode, `torch._int_mm`; kernel 4 at the served shapes (64 x 160,
   128 x 512, 8192 x 160, 64 x 4096), warm and with L2 flushed, beside its
   plain version and its bound (no one PyTorch call computes the ADC or
   the LUT softmax).
9. Serves internlm2-1.8b at the paper's fidelity, with the phase 6
   weights: `adc_mode="quantized"` (every PIM linear through kernel 3) and
   behavioral attention (kernel 4 once per layer).  The classic request
   and the phase 7 trace on the paged pool, each with its launch counts
   held to 168 and 24 per forward, no plain-version call, the peak device
   memory, a replay of served launches of both kernels (a prefill and a
   decode step) against their plain versions, kernel 4's on its served
   broadcast mask with no other device kernel around it, and a profile as
   in phases 6 and 7, with kernel 4's bound at its served operands and
   the device kernels per forward.

Exits non-zero, printing no result, when there is no GPU or any check
fails.  The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import attention as A  # noqa: E402
from repro_torch.core.attention import expected_kv_block_iters  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.core import pim as core_pim  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import lut_softmax as sm_k  # noqa: E402
from repro_torch.kernels import pim_attention as attn_k  # noqa: E402
from repro_torch.kernels import pim_decode as dec_k  # noqa: E402
from repro_torch.kernels import pim_matmul as mm_k  # noqa: E402
from repro_torch.kernels.pim_attention import (  # noqa: E402
    pim_attention, pim_attention_plain)
from repro_torch.kernels.pim_decode import pim_decode, pim_decode_plain  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve_lib  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor-core
# ops/s, float32 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_OPS = 67e12
# |kernel - plain| <= REL_TOL * max|plain|: the two reorder float32 sums of
# LUT exps times dequantized V (score codes and block sums are exact)
REL_TOL = 1e-5


PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9)
# what a phase needs run first: kernel entries (2, 8) or the small model (4)
NEEDS = {3: {2}, 5: {4}, 6: {2}, 7: {2}, 9: {8}}


class CheckFailed(SystemExit):
    pass


T0 = time.perf_counter()


def stamp(what: str) -> None:
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(f"chip_smoke: check failed: {what}")


def sass_imma(name: str) -> dict:
    """{kernel: (IMMA, MUFU.RCP, all) instruction counts} in the SASS of the
    built library `name`, from the toolkit's cuobjdump ({} without it)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"  no cuobjdump beside nvcc: SASS of {name} not counted")
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += "IMMA" in line
            counts[fn][1] += "MUFU.RCP" in line
            counts[fn][2] += line.strip().startswith("/*") and ";" in line
    for fn, (imma, rcp, n) in counts.items():
        print(f"  SASS {name}: {imma} IMMA, {rcp} MUFU.RCP, {n} instructions in {fn[:96]}")
    check(bool(counts) and all(c[0] > 0 for c in counts.values()),
          f"every {name} kernel runs on the tensor cores (IMMA in its SASS)")
    return counts


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(events) -> dict:
    """{device kernel or copy: (self device us, count)} of a profile's
    `key_averages()`."""
    return {e.key: (e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def kernel_us(times: dict, kernel: str):
    """(device us, launches) of the device kernel named `kernel` (any
    template instance)."""
    hits = [v for k, v in times.items() if f"{kernel}(" in k or f"{kernel}<" in k]
    return sum(us for us, _ in hits), sum(n for _, n in hits)


def profiled(fn, iters: int) -> dict:
    """`device_us` of `iters` calls of `fn`, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_us(prof.key_averages())


def others(times: dict, kernel: str) -> dict:
    """{device kernel: launches} of a profile's kernels other than `kernel`
    (memory copies and sets left out)."""
    return {k[:48]: c for k, (_, c) in times.items()
            if f"{kernel}(" not in k and f"{kernel}<" not in k
            and not k.startswith(("Memcpy", "Memset"))}


def per_call_ms(times: dict, iters: int) -> float:
    """Summed device time of a profile, per call."""
    return sum(us for us, _ in times.values()) / iters / 1e3


ATTENTION_KERNELS = (("pim_attention_kernel", "pim_attention"),
                     ("pim_decode_kernel", "pim_decode"))


class EventsDropped(Exception):
    """The profiler saw fewer of a kernel's launches than were made."""


def profile_report(prof, wall_s: float, prof_s: float, label: str,
                   launches: dict, kernel_names=ATTENTION_KERNELS,
                   last: bool = True) -> dict:
    """Print where a profiled run's device time went: busy share of the
    unprofiled wall `wall_s` of the same run, each (device kernel, wrapper)
    of `kernel_names`' device time per launch and the top device operators.
    `launches` are the wrapper counts of the profiled run: the profiler must
    see one device kernel per wrapper call.  Where it saw fewer (it can drop
    a few events of a long run), raises EventsDropped unless `last`."""
    stamp(f"profile of the {label} taken")
    events = prof.key_averages()
    times = device_us(events)
    stamp("key_averages done")
    for kernel, wrapper in kernel_names:
        n, made = kernel_us(times, kernel)[1], launches.get(wrapper, 0)
        if n < made and not last:
            raise EventsDropped(f"the profiler saw {n} of {made} {kernel} launches")
    busy_ms = sum(us for us, _ in times.values()) / 1e3
    n_dev = sum(n for _, n in times.values())
    host_launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"  profiled {label}: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / (wall_s * 1e3):.1%} of the unprofiled wall "
          f"{wall_s * 1e3:.1f} ms ({busy_ms / (prof_s * 1e3):.1%} of the "
          f"profiled wall {prof_s * 1e3:.1f} ms); {n_dev} device kernels and "
          f"copies, {host_launches} cudaLaunchKernel calls")
    kernels = {}
    for kernel, wrapper in kernel_names:
        us, n = kernel_us(times, kernel)
        made = launches.get(wrapper, 0)
        check(n > 0 and n == made, f"profiled {label}: one {kernel} per "
              f"{wrapper} call ({n} seen, {made} made)")
        kernels[kernel] = dict(device_us=us, count=n, us_per_launch=us / n,
                               launched=made)
        print(f"  {kernel}: {n} launches seen of {made} made, {us / 1e3:.3f} ms, "
              f"{us / n:.2f} us each")
        for key, (u, c) in times.items():
            if f"{kernel}(" in key or f"{kernel}<" in key:
                print(f"    {key[:64]}: {c} launches, {u / c:.2f} us each")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12,
                       max_name_column_width=48))
    return dict(profiled_wall_ms=prof_s * 1e3, device_busy_ms=busy_ms,
                busy_share=busy_ms / (wall_s * 1e3), device_events=n_dev,
                host_launches=host_launches, kernels=kernels)


def profiled_report(prepare, run, label: str, wall_s: float,
                    kernel_names=ATTENTION_KERNELS, tries: int = 3) -> dict:
    """`profile_report` of `run(prepare())` under torch.profiler (only the
    run is timed and profiled), profiled again, up to `tries` times, while
    the profiler drops some of its kernels' events."""
    for attempt in range(1, tries + 1):
        state = prepare()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(state)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        try:
            return profile_report(prof, wall_s, prof_s, label, dict(_build.LAUNCHES),
                                  kernel_names, last=attempt == tries)
        except EventsDropped as e:
            print(f"  {e}: profiling again", flush=True)


def unprofiled_wall(prepare, run, recorder) -> tuple:
    """(what `recorder()` yields, wall s) of `run(prepare())` inside the
    context `recorder()`, unprofiled: the same work as `profiled_report`'s."""
    state = prepare()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with recorder() as seen:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return seen, wall


def attention_bound(nbytes: int, pairs: int, Dh: int):
    """(ms, limit) of an attention call on the H100: `nbytes` over HBM,
    against 2 Dh int8 operations (scores) and 2 Dh float32 ones (PV) per
    unmasked (query, key) pair."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (2 * Dh * pairs / INT8_OPS + 2 * Dh * pairs / F32_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decode_bound(kv_lens, q_lens, Sq: int, cfg):
    """(ms, limit) of one pim_decode call at a served shape: the int8 K/V
    rows and f32 scales that each slot with a query attends to, read once,
    q, its scales and the f32 output, against the pairs it scores."""
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    live = [(kv, ql) for kv, ql in zip(kv_lens, q_lens) if ql > 0]
    nbytes = (sum(kv for kv, _ in live) * Hkv * (2 * Dh + 8)
              + len(kv_lens) * H * Sq * (Dh + 4 + 4 * Dh))
    return attention_bound(nbytes, sum(H * ql * kv for kv, ql in live), Dh)


@contextlib.contextmanager
def decode_shapes(cfg):
    """Within the block, the decode wrapper keeps each launch's scalar table
    on the device (no host sync); after it, the list holds ([kv_len],
    [q_len], Sq) of every launch, one slot per sequence of the batch."""
    dec_k.SHAPES, seen = [], []
    try:
        yield seen
    finally:
        kept, dec_k.SHAPES = dec_k.SHAPES, None
    for scalars, (BH, Sq, _) in kept:
        _, kv, ql = scalars.tolist()
        B = BH // cfg.num_heads
        if len(kv) == 1:   # int lengths: one column for the batch
            kv, ql = kv * B, ql * B
        seen.append((kv[:B], ql[:B], Sq))


def served_decode(entries, label: str, report: dict, shapes, cfg) -> None:
    """Kernel 2's device us per launch of a profiled serving run beside its
    mean bound over the same launches' shapes (those of the unprofiled run
    of the same work)."""
    bounds = [decode_bound(kv, ql, Sq, cfg)[0] * 1e3 for kv, ql, Sq in shapes]
    us = report["kernels"]["pim_decode_kernel"]["us_per_launch"]
    b_us = sum(bounds) / len(bounds)
    entries["pim_decode"].setdefault("served_us", {})[label] = us
    entries["pim_decode"].setdefault("served_bound_us", {})[label] = b_us
    print(f"  kernel 2 on the {label}: {us:.2f} us per launch, bound {b_us:.3f} us "
          f"(mean over its {len(bounds)} calls' shapes), {b_us / us:.1%} of it")


PAGE = 16     # tokens per KV page in phases 3, 5 and 7
PROFILED_STEPS = 3   # scheduler steps of the paged trace under the profiler
PROFILED_TOKENS = 8  # new tokens of the classic request under the profiler


def random_table(lens, n_tables: int, seed: int, dev, holes: bool = False):
    """A (B, n_tables) int32 page table on `dev`: a random permutation of
    pages 1..P-1 (page 0 is the trash page), -1 past each row's pages and,
    with `holes`, at a random page inside each row of more than two pages.
    Returns (table, P)."""
    rng = np.random.RandomState(seed)
    P = len(lens) * n_tables + 1
    perm = rng.permutation(np.arange(1, P))
    pt = np.full((len(lens), n_tables), -1, np.int32)
    i = 0
    for b, n in enumerate(lens):
        k = -(-int(n) // PAGE)
        pt[b, :k] = perm[i:i + k]
        i += k
        if holes and k > 2:
            pt[b, rng.randint(1, k - 1)] = -1
    return torch.from_numpy(pt).to(dev), P


def run_audited(sched, trace):
    """Submit `trace` [(prompt, budget)], step the scheduler to the end with
    `audit()` after every step; returns the streams in trace order."""
    rids = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        sched.audit()
    return [res.get(r, []) for r in rids]


# ---- 3. the paged mode of both kernels --------------------------------------
def paged_kernels(dev, cfg, gen, compare, bound, entries) -> None:
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def operands(lens, Sq, S, kv_bits=8, seed=0, holes=False):
        """The same K/V in a paged pool (random table of PAGE-token pages,
        with `holes` unallocated pages inside the slots' ranges) and in a
        dense ragged cache of S tokens; returns (paged operands, table,
        dense operands, (B,) lengths)."""
        B = len(lens)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        dense = A.init_kv_cache(B, S, Hkv, Dh, kv_bits=kv_bits, device=dev, ragged=True)
        A.cache_write_ragged(dense, k, v, zeros, pim_cfg, seq_lens=lens_d)
        pt, P = random_table(lens, S // PAGE, seed, dev, holes)
        pool = A.init_paged_kv_cache(P, PAGE, Hkv, Dh, kv_bits=kv_bits, device=dev)
        A.paged_cache_write(pool, k, v, zeros, pim_cfg, pt, seq_lens=lens_d)
        q_q, qs = ops._q_kernel_layout(q, pim_cfg.input_bits)
        return ((q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale), pt,
                ops.kernel_attention_layout(q, dense, pim_cfg.input_bits), lens_d)

    print("paged kernels vs plain versions and vs dense at block_k == "
          f"page size {PAGE}:", flush=True)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    for seed, lens in enumerate(([0, 15, 1000, 2048], [16, 17, 2048, 1000])):
        for what, Sq, kv_bits, kern, plain in (
                ("decode", 1, 8, pim_decode, pim_decode_plain),
                ("decode verify rows", 4, 8, pim_decode, pim_decode_plain),
                ("decode", 1, 4, pim_decode, pim_decode_plain),
                ("prefill ragged chunk", 128, 8, pim_attention, pim_attention_plain)):
            paged, pt, dense, lens_d = operands(lens, Sq, 2048, kv_bits, seed)
            offs = torch.clamp(lens_d - Sq, min=0)
            ql = torch.clamp(lens_d, max=Sq)
            name = f"{what} paged Sq{Sq} kv{kv_bits} lens {lens}"
            o_k = kern(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw)
            compare(name, o_k, plain(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw))
            o_d = kern(*dense, offs, lens_d, q_len=ql, block_k=PAGE, **kw)
            check(torch.equal(o_k[0], o_d[0]) and torch.equal(o_k[1], o_d[1]),
                  f"{name}: paged == dense at block_k {PAGE}, bit for bit")
    # an unallocated page inside each slot's range (no record is written
    # for it): decode skips it as the plain version does, Sq 1 and verify
    # rows, several CTAs a head over the 128 pages of a 2048-token slot
    for Sq in (1, 4):
        lens = [40, 300, 2048, 1000]
        paged, pt, _, lens_d = operands(lens, Sq, 2048, seed=5 + Sq, holes=True)
        check(all(bool((pt[b, :-(-n // PAGE)] < 0).any()) for b, n in enumerate(lens)),
              "each slot's table has a hole inside its pages")
        offs, ql = lens_d - Sq, torch.clamp(lens_d, max=Sq)
        compare(f"decode paged Sq{Sq} holes inside the ranges, lens {lens}",
                pim_decode(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw),
                pim_decode_plain(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw))

    def paged_bytes(paged, pt):
        """Operand bytes the launch needs: q, its scales, the allocated
        pages of the four pool planes, the table and the f32 output."""
        q_q, qs = paged[:2]
        n_pages = int((pt >= 0).sum())
        pages = sum(t[0].numel() * t.element_size() for t in paged[2:]) * n_pages
        return (q_q.numel() + 4 * qs.numel() + pages + 4 * pt.numel()
                + 4 * q_q.numel())

    # the paged mode at the shapes phase 2 timed, for the same work
    B = 4
    paged, pt, _, lens_d = operands([512] * B, 512, 512, seed=2)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    compare("prefill paged timed shape Sq512",
            pim_attention(*paged, zeros, lens_d, page_table=pt, **kw),
            pim_attention_plain(*paged, zeros, lens_d, page_table=pt, **kw))
    fn = lambda: pim_attention(*paged, zeros, lens_d, pim_cfg, lut_cfg,  # noqa: E731
                               page_table=pt)
    us, n = kernel_us(profiled(fn, 20), "pim_attention_kernel")
    check(n == 20, f"profiler saw the 20 paged prefill launches ({n})")
    b_ms, _ = bound(paged_bytes(paged, pt), B * H * 512 * 513 // 2)
    entries["pim_attention"].update(paged_ms=us / 20 / 1e3, paged_bound_ms=b_ms)
    print(f"  paged prefill Sq512, device ms per call: kernel {us / 20 / 1e3:.4f} "
          f"(dense {entries['pim_attention']['ms']:.4f}), bound {b_ms:.4f}")

    kv = 4096
    paged, pt, _, lens_d = operands([kv] * B, 1, kv, seed=3)
    offs = lens_d - 1
    compare("decode paged timed shape kv_len 4096",
            pim_decode(*paged, offs, lens_d, page_table=pt, **kw),
            pim_decode_plain(*paged, offs, lens_d, page_table=pt, **kw))
    fn = lambda: pim_decode(*paged, offs, lens_d, pim_cfg, lut_cfg,  # noqa: E731
                            page_table=pt)
    times = profiled(fn, 50)
    us, n = kernel_us(times, "pim_decode_kernel")
    check(n == 50, f"profiler saw one pim_decode_kernel per paged decode call ({n} of 50)")
    print(f"  other device kernels of the 50 paged calls: {others(times, 'pim_decode_kernel')} "
          "(the wrapper stacks tensor scalars into one table)")
    b_ms, _ = bound(paged_bytes(paged, pt), B * H * kv)
    entries["pim_decode"].update(paged_ms=us / 50 / 1e3, paged_bound_ms=b_ms)
    print(f"  paged decode kv{kv}, device ms per call: kernel {us / 50 / 1e3:.4f} "
          f"(dense {entries['pim_decode']['ms']:.4f}), bound {b_ms:.4f}")


# ---- 5. the Scheduler at small width on the card ----------------------------
def smoke_scheduler(dev, small, params) -> None:
    """Streams of the dense and the paged Scheduler against classic greedy
    generation, each request on its own.  The split-K partitions are one
    page wide, so that decode over dense slots and over pages does the same
    arithmetic bit for bit.  (With 8-token pages against 16-token
    partitions the LUT-domain rescales round differently, and this model's
    greedy stream flips at the fifth token of the first prompt.)  Prefill
    tiles still differ for prompts longer than a page (one 256-row block
    against 16-row pages)."""
    cfg = dataclasses.replace(small, decode_block_k=PAGE)
    model = build_model(cfg, dev)
    V = cfg.vocab_size
    print("scheduler at smoke width (float32, kernel path):", flush=True)

    def isolated(trace, max_len):
        return [serve_lib.greedy_generate(
            model, params, {"tokens": torch.tensor([p])}, b, max_len)[0].tolist()
                for p, b in trace]

    full = data.lm_batch(1, 4, 24, V)
    trace = [(full[i, :n].tolist(), b)
             for i, (n, b) in enumerate(zip([5, 17, 24, 9], [4, 7, 10, 13]))]
    ref = isolated(trace, 64)
    dense = run_audited(serve_lib.Scheduler(model, params, max_batch_slots=2,
                                            max_len=64), trace)
    check(dense == ref, "dense slots (2 slots, 4 mixed requests) == isolated greedy")
    sched = serve_lib.Scheduler(model, params, max_batch_slots=2, max_len=64,
                                page_size=PAGE, num_pages=9)
    paged = run_audited(sched, trace)
    check(paged == ref, "paged pool (9 pages) == isolated greedy; audit() after every step")
    check(len(sched.free_pages) == sched.num_pages - 1, "every page returned to the free list")

    full = data.lm_batch(4, 2, 30, V)
    trace = [(full[0].tolist(), 24), (full[1].tolist(), 8)]
    sched = serve_lib.Scheduler(model, params, max_batch_slots=2, max_len=64,
                                page_size=PAGE, num_pages=6, decode_chunk=8)
    starved = run_audited(sched, trace)
    check(sched.n_evictions >= 1, f"a starved pool (6 pages) evicted ({sched.n_evictions})")
    check(starved == isolated(trace, 64), "starved-pool streams == isolated greedy")
    check(len(sched.free_pages) == sched.num_pages - 1, "every page returned to the free list")

    toks = {"tokens": torch.from_numpy(data.lm_batch(0, 3, 8, V)).long()}
    classic = serve_lib.greedy_generate(model, params, toks, 6, 32)
    for ps in (0, PAGE):
        out = serve_lib.generate(model, params, toks, 6, 32,
                                 continuous_batching=True, page_size=ps)
        check(torch.equal(out, classic),
              f"generate(continuous_batching=True, page_size={ps}) == classic generate")


# ---- 7. the Scheduler at full width -----------------------------------------
def prefill_logits(model, params, prompts):
    """Logits of one admission wave of `prompts` (each at most 256 tokens)
    through dense slots (256-row KV tiles) and through the paged pool
    (16-row pages): returns (dense, paged), float32."""
    dev = model.device
    n = len(prompts)
    toks = np.zeros((n, 256), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks = torch.from_numpy(toks).long().to(dev)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(lens)
    pt = torch.arange(1, n * 16 + 1, dtype=torch.int32, device=dev).view(n, 16)
    with torch.inference_mode():
        ld, _ = model.forward_serve(params, {"tokens": toks},
                                    model.init_cache(n, 256, ragged=True),
                                    zeros, seq_lens=lens)
        lp, _ = model.forward_serve(params, {"tokens": toks},
                                    model.init_cache(n, 256, page_size=PAGE,
                                                     num_pages=n * 16 + 1),
                                    zeros, seq_lens=lens, pages=pt)
    return ld.float(), lp.float()


@contextlib.contextmanager
def recorded(pick, targets=None):
    """Within the block, keeps copies of the operands of the serving path's
    kernel launches that `pick(name, index)` labels (name a key of
    `targets`, {name: (module, attribute)} of the wrappers the path calls,
    by default the attention wrappers of `ops`; index of the launch among
    that wrapper's in the block): yields {label: (name, args, kwargs)}.  The
    copies are taken at launch, since the scheduler writes its cache in
    place afterwards."""
    def copied(x):
        """A copy of a tensor operand in its layout: a broadcast (stride 0)
        dim stays a broadcast of the copied storage."""
        if not isinstance(x, torch.Tensor):
            return x
        if 0 not in x.stride():
            return x.clone()
        one = tuple(slice(0, 1) if st == 0 else slice(None) for st in x.stride())
        return x[one].clone().expand(x.shape)

    kept, counts, wrapped = {}, {}, {}

    def wrap(name, fn):
        def launch(*args, **kw):
            i = counts[name] = counts.get(name, -1) + 1
            label = pick(name, i)
            if label:
                kept[label] = (name, tuple(copied(a) for a in args),
                               {k: copied(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return launch

    if targets is None:
        targets = {name: (ops, name) for name in ("pim_attention", "pim_decode")}
    for name, (mod, attr) in targets.items():
        wrapped[name] = getattr(mod, attr)
        setattr(mod, attr, wrap(name, wrapped[name]))
    try:
        yield kept
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, wrapped[name])


def replay_served(storage: str, kept: dict, compare) -> None:
    """Hold each recorded launch of the `storage` scheduler run against the
    kernel's plain version on the same operands (REL_TOL, iteration maps
    equal)."""
    plain = {"pim_attention": (pim_attention, pim_attention_plain),
             "pim_decode": (pim_decode, pim_decode_plain)}
    for name in plain:
        check(any(n == name for n, _, _ in kept.values()),
              f"{storage}: recorded served launches of {name}")
    for label, (name, args, kw) in kept.items():
        kern, ref = plain[name]
        ql = kw.get("q_len")
        what = (f"{'prefill' if name == 'pim_attention' else 'decode'} served "
                f"by the {storage} scheduler, {label}: Sq {args[0].shape[1]}, "
                f"kv_len {torch.as_tensor(args[7]).tolist()}, q_len "
                f"{None if ql is None else ql.tolist()}")
        compare(what, kern(*args, **kw, return_iters=True),
                ref(*args, **kw, return_iters=True))


SCHED_KW = dict(max_batch_slots=8, max_len=512, decode_chunk=8)


def sched_trace(V: int):
    """The 16-request trace of phases 7 and 9: prompts of 16-256 tokens and
    budgets of 16-64 drawn from seed 0 (one prompt a whole number of pages).
    Returns (trace [(prompt, budget)], prompt lengths, budgets)."""
    rng = np.random.RandomState(0)
    n_req = 16
    lens = rng.randint(16, 257, n_req)
    if not (lens % PAGE == 0).any():
        lens[0] = PAGE * max(1, lens[0] // PAGE)
    budgets = rng.randint(16, 65, n_req)
    toks = data.lm_batch(0, n_req, 256, V)
    trace = [(toks[i, :n].tolist(), int(b)) for i, (n, b) in enumerate(zip(lens, budgets))]
    return trace, lens, budgets


def full_scheduler(model, params, cfg, entries, compare) -> dict:
    V = cfg.vocab_size
    trace, lens, budgets = sched_trace(V)
    n_req = len(trace)
    n_tok = int(budgets.sum())
    kw = SCHED_KW
    print(f"scheduler at full width: {n_req} requests, prompts {lens.tolist()}, "
          f"budgets {budgets.tolist()} ({n_tok} tokens), {kw}", flush=True)

    L = cfg.num_layers

    def pick(name, i):
        """Every admission wave's prefill (at a layer that moves with the
        wave) and three decode forwards: early, mid-trace and late, when
        slots have retired."""
        if name == "pim_attention":
            return f"wave {i // L + 1} layer {i % L}" if i % L == (i // L * 7) % L else None
        for f in (2, 40, 80):
            if i == f * L + f % L:
                return f"decode forward {f + 1} layer {f % L}"
        return None

    def serve(record=False, **extra):
        sched = serve_lib.Scheduler(model, params, **kw, **extra)
        rids = [sched.submit(p, b) for p, b in trace]
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with recorded(pick) if record else contextlib.nullcontext({}) as kept, \
                plain_calls() as n_plain:
            t0 = time.perf_counter()
            res = sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check(not n_plain, f"{'paged' if extra else 'dense'}: no plain-version call "
              f"on the path ({n_plain})")
        check(launches.get("pim_attention", 0) % L == 0,
              f"{'paged' if extra else 'dense'}: {L} prefill launches per prefill forward")
        if record:
            replay_served("paged" if extra else "dense", kept, compare)
        streams = [res.get(r, []) for r in rids]
        check(all(len(s) == b for s, (_, b) in zip(streams, trace))
              and all(0 <= t < V for s in streams for t in s),
              f"{'paged' if extra else 'dense'}: every request got its budget "
              "of in-vocabulary tokens")
        for name in ("pim_attention", "pim_decode"):
            check(launches.get(name, 0) > 0,
                  f"{'paged' if extra else 'dense'} scheduler launched {name}")
        sched.audit()
        st = sched.stats
        info = dict(wall_s=wall, tokens_per_s=n_tok / wall,
                    ms_per_step=wall / st["steps"] * 1e3, steps=st["steps"],
                    model_steps=st["model_steps"], evictions=st["evictions"],
                    launches=launches)
        if extra:
            check(len(sched.free_pages) == sched.num_pages - 1,
                  "paged: every page returned to the free list")
            info.update(peak_pages_in_use=sched.peak_pages_in_use,
                        num_pages=sched.num_pages)
        print(f"  {'paged' if extra else 'dense'}: {wall:.2f} s, "
              f"{n_tok / wall:.1f} tokens/s, {info['ms_per_step']:.1f} ms per "
              f"scheduler step ({st['steps']} steps, {st['model_steps']} "
              f"forwards), launches {launches}"
              + (f", peak pages {sched.peak_pages_in_use} of "
                 f"{sched.num_pages - 1}" if extra else ""), flush=True)
        return streams, info

    # the dense run and the second paged run keep copies of some launches'
    # operands and replay them against the plain versions after the run;
    # the first paged run is the clean one for timing
    dense, dense_info = serve(record=True)
    paged, paged_info = serve(page_size=PAGE)
    again, _ = serve(record=True, page_size=PAGE)
    check(again == paged, "a second paged run gives identical streams")
    agree = sum(a == b for a, b in zip(dense, paged))
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
                  for a, b in zip(dense, paged)]
    print(f"  dense and paged streams agree on {agree} of {n_req} requests "
          "(256-row tiles and 16-row pages round the LUT rescales "
          f"differently); first differing token per request: {first_diff}")
    # prompts of one page run the same tiles on both storages
    ld, lp = prefill_logits(model, params, [p[:PAGE] for p, _ in trace[:8]])
    check(torch.equal(ld, lp), f"prompts of {PAGE} tokens: dense and paged "
          "prefill logits equal bit for bit")
    ld, lp = prefill_logits(model, params, [p for p, _ in trace[:8]])
    span = ld.amax(-1) - ld.amin(-1)
    top2 = torch.topk(ld, 2, dim=-1).values
    diff = ((lp - ld).abs().amax(-1) / span).tolist()
    gap = ((top2[:, 0] - top2[:, 1]) / span).tolist()
    print("  first 8 prompts, dense vs paged prefill logits: largest "
          f"difference per row {[round(x, 5) for x in diff]}, top-2 gap per "
          f"row {[round(x, 5) for x in gap]} (shares of the row's logit "
          f"range); argmax agrees on {int((ld.argmax(-1) == lp.argmax(-1)).sum())}"
          " of 8", flush=True)
    for name in ("pim_attention", "pim_decode"):
        entries[name]["dense_sched_launches"] = dense_info["launches"].get(name, 0)
        entries[name]["paged_launches"] = paged_info["launches"].get(name, 0)

    # the profiler's summary costs about 0.6 ms of host time per launch, so
    # it covers the first PROFILED_STEPS steps (both runs of them are the
    # same work: the trace and the scheduler are deterministic)
    def submitted():
        sched = serve_lib.Scheduler(model, params, page_size=PAGE, **kw)
        for p, b in trace:
            sched.submit(p, b)
        return sched

    def steps(sched):
        for _ in range(PROFILED_STEPS):
            sched.step()

    shapes, wall = unprofiled_wall(submitted, steps, lambda: decode_shapes(cfg))
    paged_info["profile"] = profiled_report(
        submitted, steps, f"first {PROFILED_STEPS} steps of the paged trace", wall)
    served_decode(entries, "trace", paged_info["profile"], shapes, cfg)
    return dict(dense=dense_info, paged=paged_info, agree=agree,
                prompts=lens.tolist(), budgets=budgets.tolist())


# ---- 8. kernels 3 and 4 against their plain versions ------------------------
# (K, N) of the PIM linears of internlm2-1.8b: wk/wv, wq/wo, w_gate/w_in, w_out
LINEARS = ((2048, 1024), (2048, 2048), (2048, 8192), (8192, 2048))
LINEARS_PER_LAYER = 7
HEAD_MM = (4, 2048, 8192)   # (M, K, N) of kernel 3's line in the JSON: decode w_gate / w_in


def int8_codes(shape, gen, dev, scale: float = 40.0) -> torch.Tensor:
    """Random int8 codes, roughly as a per-token quantize spreads them."""
    x = torch.randn(shape, generator=gen, device=dev) * scale
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def matmul_bound(M: int, K: int, N: int, quantized: bool):
    """Least time of an (M, K) x (K, N) PIM matmul on the H100: x, w and the
    f32 output moved once over HBM, against 2 int8 operations per
    multiply-add at the int8 tensor-core rate plus, under the ADC, 5 float32
    operations per 16-row group and output (divide, round, two clamps, add)
    at the float32 rate."""
    t_bytes = (M * K + K * N + 4 * M * N) / HBM_BPS * 1e3
    t_ops = (2 * M * N * K / INT8_OPS
             + (5 * M * N * -(-K // 16) / F32_OPS if quantized else 0.0)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def softmax_bound(scores: torch.Tensor, mask: torch.Tensor):
    """Least time of the LUT softmax on the H100: each input byte read once
    (the scores at their own dtype, the mask at its un-broadcast size) and
    the int32 codes written once; a few operations per element are far
    below.  A full mask over int32 scores: 9 bytes per position."""
    mask_bytes = math.prod(n for n, st in zip(mask.shape, mask.stride()) if st != 0)
    nbytes = scores.numel() * (scores.element_size() + 4) + mask_bytes
    return nbytes / HBM_BPS * 1e3, "bytes"


def kernel_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device ms per launch of the device kernel `kernel` over `iters` calls
    of `fn` (torch.profiler; other kernels of the calls left out)."""
    for _ in range(5):   # the profiler may drop a short kernel's events
        us, n = kernel_us(profiled(fn, iters), kernel)
        if n == iters:
            return us / n / 1e3
        print(f"  profiler saw {n} of the {iters} {kernel} launches: profiling again")
    check(False, f"profiler saw the {iters} {kernel} launches ({n})")


L2_FLUSH_BYTES = 64 << 20   # a write of more than the H100's 50 MB L2


def flushed(fn, dev):
    """`fn` after a write of L2_FLUSH_BYTES: it finds its operands in HBM."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def call():
        buf.fill_(1)
        return fn()
    return call


def staged_max_s(score_bytes: int) -> int:
    """The longest row that kernel 4 stages in shared memory."""
    lo, hi = sm_k.ROWS_MAX_S, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        staged = sm_k._plan(1, mid, score_bytes).regime == "staged"
        lo, hi = (mid, hi) if staged else (lo, mid)
    return lo


def softmax_kernel(dev, lut, gen, same, entries) -> None:
    """Kernel 4 against its plain version bit for bit at every regime's
    boundaries and the served shapes, then timed warm and with L2 flushed."""
    print("kernel 4 (lut_softmax) vs its plain version, bit for bit:", flush=True)

    def scores(shape, dtype=torch.int32):
        return torch.clamp(torch.round(torch.randn(shape, generator=gen, device=dev)
                                       * 24), -128, 127).to(dtype)

    def held(s, mk):
        return bool(torch.equal(sm_k.lut_softmax(s, mk, lut),
                                sm_k.lut_softmax_plain(s, mk, lut)))

    # warp rows (S <= 1024, more than 8 rows an SM: 1,100 rows, not a
    # multiple of a CTA's 8), CTA rows held in registers (S <= 4096),
    # staged in shared memory up to its limit and streamed past it; 1 and 9
    # rows, aligned and one element into the storage, an all-masked row
    # among several
    for dtype in (torch.int32, torch.int8):
        top = staged_max_s(dtype.itemsize)
        for rows in (1, 9, 1100):
            lengths = ((1, 31, 32, 33, 127, 128, 129, 160, 512, 1023, 1024, 1025, 2048,
                        4096, 4097, top, top + 1) if rows < 1100 else (160, 1023, 1024))
            for S in lengths:
                ok = []
                flat = scores((rows * S + 1,), dtype)
                for off in (0, 1):
                    mk = torch.rand((rows, S), generator=gen, device=dev) < 0.9
                    if rows > 1:
                        mk[-1] = False
                    ok.append(held(flat[off:off + rows * S].view(rows, S), mk))
                regime = sm_k._plan(rows, S, dtype.itemsize).regime
                check(all(ok), f"{str(dtype)[6:]} {rows} x {S} ({regime}), aligned and "
                      "one element in: kernel == plain bit for bit")

    # behavioral prefill rows of the classic request: 4 x 16 heads x 128
    # queries over its 160-row cache, causal, as a full mask and as the
    # attention hands it over (broadcast over the heads); decode rows: 4 x 16
    # heads over 4096 positions, 4000 valid
    k_pos = torch.arange(160, device=dev)
    causal = (k_pos[None, :] <= torch.arange(128, device=dev)[:, None]) & (k_pos < 128)
    pre_mask = causal.expand(4, 16, 128, 160).reshape(8192, 160)
    pre = scores((8192, 160))
    same("prefill rows 8192 x 160, causal", "lut_softmax",
         sm_k.lut_softmax(pre, pre_mask, lut), sm_k.lut_softmax_plain(pre, pre_mask, lut))
    att = pre.view(4, 16, 1, 128, 160)
    att_mask = causal.expand(4, 128, 160)[:, None, None].expand(att.shape)
    for what, s in (("int32", att), ("int8", att.to(torch.int8))):
        same(f"the attention's (4, 16, 1, 128, 160) {what} scores, its broadcast mask",
             "lut_softmax", sm_k.lut_softmax(s, att_mask, lut),
             sm_k.lut_softmax_plain(s, att_mask, lut))
    dec_mask = (torch.arange(4096, device=dev) < 4000).expand(64, 4096).clone()
    dec_mask[5] = False                                 # an all-masked row
    dec = scores((64, 4096))
    out = sm_k.lut_softmax(dec, dec_mask, lut)
    same("decode rows 64 x 4096 with an all-masked row", "lut_softmax", out,
         sm_k.lut_softmax_plain(dec, dec_mask, lut))
    check(int(out[5].abs().max()) == 0, "the all-masked row's codes are all 0")
    s8 = dec.to(torch.int8)
    same("int8 score codes", "lut_softmax", sm_k.lut_softmax(s8, dec_mask, lut),
         sm_k.lut_softmax_plain(s8, dec_mask, lut))
    for R, S in ((3, 1024), (2, 4096)):     # a warp row and a staged row
        flat = torch.zeros((R, S), dtype=torch.int32, device=dev)
        flat_mask = torch.ones_like(flat, dtype=torch.bool)
        out = sm_k.lut_softmax(flat, flat_mask, lut)
        same(f"flat rows of {S} table maxima (sum of exps 2^15 * {S} > 2^24)",
             "lut_softmax", out, sm_k.lut_softmax_plain(flat, flat_mask, lut))
        check(bool((out == 65536 // S).all()),
              f"flat rows: every code is 2^16 / {S} = {65536 // S}")

    # ---- timing: served shapes, warm and with L2 flushed ----------------
    print("kernel 4 times, device ms per launch (torch.profiler):", flush=True)
    lens = torch.randint(1, 513, (128, 1), generator=gen, device=dev)
    timed = (("classic decode rows 64 x 160", scores((64, 160)),
              (k_pos < 129).expand(64, 160).clone()),
             ("trace decode rows 128 x 512", scores((128, 512)),
              torch.arange(512, device=dev) < lens),
             ("prefill rows 8192 x 160", pre, pre_mask),
             ("prefill 8192 x 160 as served (broadcast mask)", att, att_mask),
             ("decode rows 64 x 4096", dec, dec_mask))
    srows = []
    for what, sc, mk in timed:
        def call():
            return sm_k.lut_softmax(sc, mk, lut)
        ms = kernel_ms(call, "lut_softmax_kernel")
        cold = kernel_ms(flushed(call, dev), "lut_softmax_kernel")
        plain_ms = per_call_ms(profiled(lambda: sm_k.lut_softmax_plain(sc, mk, lut), 3), 3)
        b_ms, b_by = softmax_bound(sc, mk)
        R, S = sc.numel() // sc.shape[-1], sc.shape[-1]
        regime = sm_k._plan(R, S, sc.element_size()).regime
        srows.append(dict(what=what, rows=R, S=S, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, regime=regime))
        print(f"  lut_softmax {what} ({regime}): warm {ms:.5f} "
              f"({b_ms / ms:.1%} of the bound), L2 flushed {cold:.5f} ({b_ms / cold:.1%}), "
              f"bound {b_ms:.5f} ({b_by}), plain {plain_ms:.4f}", flush=True)
    head = srows[2]
    entries["lut_softmax"] = dict(
        name="lut_softmax", route="cuda",
        source="src/repro_torch/kernels/csrc/lut_softmax.cu",
        replaces="src/repro/kernels/lut_softmax.py:73",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, cold_ms=head["cold_ms"], timed=srows,
        shape="8192 x 160 prefill rows of the classic request, full mask; library: "
              "no one PyTorch call computes the LUT softmax")


def adc_kernels(dev, cfg, gen, entries) -> None:
    """Kernel 3 in both ADC modes and kernel 4, each against its plain
    version bit for bit at the served shapes, then timed (device time from
    torch.profiler)."""
    pim_q = dataclasses.replace(cfg.pim, adc_mode="quantized")
    pim_i = dataclasses.replace(cfg.pim, adc_mode="ideal")
    err = {"pim_matmul": 0.0, "lut_softmax": 0.0}

    def same(what, name, kern, plain):
        torch.cuda.synchronize()
        e = (kern.double() - plain.double()).abs().max().item() if kern.numel() else 0.0
        check(kern.shape == plain.shape and torch.equal(kern, plain),
              f"{what}: kernel == plain bit for bit (max|diff| {e:.3g})")
        err[name] = max(err[name], e)

    def deployed(K, N, layers=3, r=1):
        """Layer r of a stack in the deployed layout: a (K, N) view of an
        (N, K) store, at an offset into the stack."""
        return int8_codes((layers, N, K), gen, dev).transpose(1, 2)[r]

    print("kernel 3 (pim_matmul) vs its plain version, bit for bit:", flush=True)
    for K, N in LINEARS:
        w = deployed(K, N)
        for M in (4, 512, 2048):
            x = int8_codes((M, K), gen, dev)
            for pc in (pim_q, pim_i):
                same(f"M{M} K{K} N{N} {pc.adc_mode}", "pim_matmul",
                     mm_k.pim_matmul_int(x, w, pc), mm_k.pim_matmul_int_plain(x, w, pc))
    stack = int8_codes((3, 2000, 1024), gen, dev)
    w = stack[1]
    check(w.storage_offset() == 2000 * 1024 and w.stride() == (1024, 1),
          "a row-major layer view of a stacked (3, 2000, 1024) block")
    for M in (4, 512):
        x = int8_codes((M, 2000), gen, dev)
        for pc in (pim_q, pim_i):
            same(f"M{M} K2000 (not a multiple of 16) N1024 row-major layer view "
                 f"{pc.adc_mode}", "pim_matmul", mm_k.pim_matmul_int(x, w, pc),
                 mm_k.pim_matmul_int_plain(x, w, pc))
            same(f"M{M} K2000 deployed view {pc.adc_mode}", "pim_matmul",
                 mm_k.pim_matmul_int(x, w.t().contiguous().t(), pc),
                 mm_k.pim_matmul_int_plain(x, w, pc))
    x, w = int8_codes((3, 200), gen, dev), deployed(200, 24)
    same("M3 K200 N24 quantized", "pim_matmul", mm_k.pim_matmul_int(x, w, pim_q),
         mm_k.pim_matmul_int_plain(x, w, pim_q))
    w = deployed(2048, 1024)
    for M in (4, 12, 512):
        # a contiguous x one byte into its storage: rows not 16-byte aligned
        x = int8_codes((M * 2048 + 1,), gen, dev)[1:].view(M, 2048)
        check(x.data_ptr() % 16 != 0, f"M{M} x view is misaligned")
        for pc in (pim_q, pim_i):
            same(f"M{M} K2048 N1024 misaligned x {pc.adc_mode}", "pim_matmul",
                 mm_k.pim_matmul_int(x, w, pc), mm_k.pim_matmul_int_plain(x, w, pc))

    # ---- timing at the served shapes -----------------------------------
    print("kernel 3 times, device ms per call (torch.profiler):", flush=True)
    rows = []
    for M in (4, 512, 2048):
        for K, N in LINEARS:
            x, w = int8_codes((M, K), gen, dev), deployed(K, N)
            xp = F.pad(x, (0, 0, 0, max(0, 32 - M)))       # cuBLAS takes > 16 rows
            t = {}
            for mode, pc in (("quantized", pim_q), ("ideal", pim_i)):
                for _ in range(5):   # the profiler may drop a short kernel's events
                    times = profiled(lambda: mm_k.pim_matmul_int(x, w, pc), 20)
                    _, n = kernel_us(times, "pim_matmul_kernel")
                    if n == 20:
                        break
                    print(f"  profiler saw {n} of the 20 {mode} launches: profiling again")
                check(n == 20, f"profiler saw the 20 {mode} pim_matmul launches ({n})")
                t[mode] = per_call_ms(times, 20)
            t["plain"] = per_call_ms(profiled(lambda: mm_k.pim_matmul_int_plain(x, w, pim_q), 2), 2)
            for _ in range(5):   # the profiler may drop a session's events
                t["int_mm"] = per_call_ms(profiled(lambda: torch._int_mm(xp, w), 20), 20)
                if t["int_mm"] > 0:
                    break
            check(t["int_mm"] > 0, "profiler saw the torch._int_mm launches")
            b_ms, b_by = matmul_bound(M, K, N, True)
            bi_ms, _ = matmul_bound(M, K, N, False)
            tops = {m: 2 * M * N * K / (t[m] * 1e-3) / 1e12 for m in ("quantized", "ideal")}
            rows.append(dict(M=M, K=K, N=N, ms=t["quantized"], ideal_ms=t["ideal"],
                             plain_ms=t["plain"], int_mm_ms=t["int_mm"], bound_ms=b_ms,
                             bound_by=b_by, ideal_bound_ms=bi_ms, tops=tops["quantized"],
                             ideal_tops=tops["ideal"]))
            print(f"  pim_matmul M{M} K{K} N{N}: quantized {t['quantized']:.4f} "
                  f"({tops['quantized']:.1f} TOP/s, {b_ms / t['quantized']:.1%} of the bound "
                  f"{b_ms:.4f}, {b_by}), ideal {t['ideal']:.4f} ({tops['ideal']:.1f} TOP/s, "
                  f"{bi_ms / t['ideal']:.1%} of {bi_ms:.4f}; {t['ideal'] / t['int_mm']:.2f}x "
                  f"torch._int_mm {t['int_mm']:.4f}), plain (quantized) {t['plain']:.4f}",
                  flush=True)
    head = next(r for r in rows if (r["M"], r["K"], r["N"]) == HEAD_MM)
    entries["pim_matmul"] = dict(
        name="pim_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_matmul.cu",
        replaces="src/repro/kernels/pim_matmul.py:69",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, ideal_ms=head["ideal_ms"],
        int_mm_ms=head["int_mm_ms"], timed=rows,
        shape="M4 K2048 N8192 quantized ADC (decode w_gate / w_in); library: "
              "no one PyTorch call computes the ADC; int_mm_ms is torch._int_mm "
              "of the ideal mode")
    softmax_kernel(dev, cfg.lut, gen, same, entries)
    for name in err:
        entries[name]["max_abs_err"] = err[name]


# ---- 9. paper-fidelity serving: 6-bit ADC linears, behavioral attention ----
ADC_KERNELS = (("pim_matmul_kernel", "pim_matmul"), ("lut_softmax_kernel", "lut_softmax"))
ADC_TARGETS = {"pim_matmul": (core_pim, "_adc_matmul"),
               "lut_softmax": (A, "_lut_softmax_kernel")}


@contextlib.contextmanager
def plain_calls():
    """Counts calls of the plain versions of the four kernels in the block
    (the served path on the card must make none): yields the counter."""
    counts = {}
    saved = {"pim_attention": (attn_k, "pim_attention_plain"),
             "pim_decode": (dec_k, "pim_decode_plain"),
             "pim_matmul": (mm_k, "pim_matmul_int_plain"),
             "lut_softmax": (sm_k, "lut_softmax_plain")}
    fns = {name: getattr(mod, attr) for name, (mod, attr) in saved.items()}

    def counting(name):
        def call(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fns[name](*a, **k)
        return call

    for name, (mod, attr) in saved.items():
        setattr(mod, attr, counting(name))
    try:
        yield counts
    finally:
        for name, (mod, attr) in saved.items():
            setattr(mod, attr, fns[name])


def replay_adc(label: str, kept: dict, rows: dict) -> None:
    """Hold recorded served launches of kernels 3 and 4 against their plain
    versions on the same operands, bit for bit.  `rows` {what: tokens} names
    every launch that must have been recorded (a prefill and a decode
    forward of each kernel) and the tokens its operands hold: kernel 3's M,
    kernel 4's batch x query rows."""
    plain = {"pim_matmul": (mm_k.pim_matmul_int, mm_k.pim_matmul_int_plain),
             "lut_softmax": (sm_k.lut_softmax, sm_k.lut_softmax_plain)}
    check(sorted(kept) == sorted(rows),
          f"{label}: recorded served launches {sorted(kept)}, expected {sorted(rows)}")
    for what, (name, args, kw) in kept.items():
        s = args[0].shape
        tokens = s[0] if name == "pim_matmul" else s[0] * s[-2]
        check(tokens == rows[what], f"{label}, {what}: {name} operands hold "
              f"{tokens} tokens, expected {rows[what]}")
        kern, ref = plain[name]
        o_k, o_p = kern(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(o_k, o_p), f"{label}, {what}: {name} operands "
              f"{tuple(args[0].shape)} x {tuple(args[1].shape)}, kernel == plain "
              "bit for bit")
        if name == "lut_softmax":
            mask = args[1]
            check(0 in mask.stride(), f"{label}, {what}: the served mask is a "
                  f"broadcast (strides {mask.stride()})")
            extra = others(profiled(lambda: kern(*args, **kw), 3), "lut_softmax_kernel")
            check(not extra, f"{label}, {what}: the served call runs kernel 4 and no "
                  f"other device kernel (no mask copy, no int32 conversion) {extra}")


@contextlib.contextmanager
def softmax_bounds():
    """Within the block, each kernel 4 call of the behavioral attention
    records its bound in us (`softmax_bound` of its operands): yields the
    list."""
    seen, fn = [], A._lut_softmax_kernel

    def call(scores, mask, cfg):
        seen.append(softmax_bound(scores, mask)[0] * 1e3)
        return fn(scores, mask, cfg)

    A._lut_softmax_kernel = call
    try:
        yield seen
    finally:
        A._lut_softmax_kernel = fn


def served_softmax(entries, label: str, report: dict, bounds, L: int) -> None:
    """Kernel 4's device us per launch of a profiled serving run beside its
    mean bound over the launches of the unprofiled run of the same work, and
    the run's device kernels and copies per forward (one kernel 4 launch
    per layer and forward)."""
    k = report["kernels"]["lut_softmax_kernel"]
    us, b_us = k["us_per_launch"], sum(bounds) / len(bounds)
    forwards = k["launched"] // L
    report["device_events_per_forward"] = report["device_events"] / forwards
    entries["lut_softmax"].setdefault("served_us", {})[label] = us
    entries["lut_softmax"].setdefault("served_bound_us", {})[label] = b_us
    print(f"  kernel 4 on the {label}: {us:.2f} us per launch, bound {b_us:.3f} us "
          f"(mean over its {len(bounds)} calls' operands), {b_us / us:.1%} of it; "
          f"{report['device_events_per_forward']:.1f} device kernels and copies "
          f"per forward ({forwards} forwards)", flush=True)


def expect_launches(label: str, launches: dict, forwards: int, L: int) -> None:
    """Kernel 3 once per PIM linear and kernel 4 once per layer (every query
    block here is one chunk) in every forward; no attention kernel."""
    want = {"pim_matmul": LINEARS_PER_LAYER * L * forwards, "lut_softmax": L * forwards}
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{label}: {name} launched {launches.get(name, 0)} times, expected {n}")
    check(not launches.get("pim_attention") and not launches.get("pim_decode"),
          f"{label}: no attention kernel on the behavioral path")


def paper_fidelity(cfg, params, entries) -> dict:
    """internlm2-1.8b at full width and depth under the paper's numerics:
    every PIM linear through the 6-bit ADC (kernel 3) and the behavioral
    Score -> LUT softmax (kernel 4) -> AV attention, with the phase 6
    weights.  The classic request and the phase 7 trace on the paged
    pool."""
    pcfg = dataclasses.replace(cfg, attn_impl="behavioral",
                               pim=dataclasses.replace(cfg.pim, adc_mode="quantized"))
    model = build_model(pcfg)
    dev, L, V = model.device, pcfg.num_layers, pcfg.vocab_size
    print(f"paper fidelity: {pcfg.pim}, attn_impl {pcfg.attn_impl}", flush=True)
    out = {}

    Bs, P, T = 4, 128, 32
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, V)).long()}
    logits, _ = model.forward_serve(params, {"tokens": batch["tokens"].to(dev)},
                                    model.init_cache(Bs, P + T), 0)
    check(tuple(logits.shape) == (Bs, V) and bool(torch.isfinite(logits).all()),
          "paper fidelity: prefill logits finite, (4, 92544)")
    serve_lib.generate(model, params, batch, 2, P + T)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)          # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pick(name, i):
        """Layer 0 of the prefill (w_gate for kernel 3), layer 3 of the
        sixth forward, a decode step (w_out)."""
        mm = name == "pim_matmul"
        per = LINEARS_PER_LAYER if mm else 1
        if i == (4 if mm else 0):
            return "prefill layer 0" + (" w_gate" if mm else "")
        if i == 5 * per * L + 3 * per + (6 if mm else 0):
            return "decode forward 6 layer 3" + (" w_out" if mm else "")
        return None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(pick, ADC_TARGETS) as kept:
        t0 = time.perf_counter()
        toks = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not n_plain, f"classic request: no plain-version call on the path ({n_plain})")
    check(tuple(toks.shape) == (Bs, T) and int(toks.min()) >= 0 and int(toks.max()) < V,
          "paper fidelity: served (4, 32) token ids in the vocabulary")
    expect_launches("classic request", launches, T, L)
    replay_adc("classic request", kept, {
        "prefill layer 0 w_gate": Bs * P, "prefill layer 0": Bs * P,
        "decode forward 6 layer 3 w_out": Bs, "decode forward 6 layer 3": Bs})
    decode_ms = (total_s - prefill_s) / (T - 1) * 1e3
    print(f"  classic request: prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} "
          f"ms/token, {Bs * T / total_s:.1f} tokens/s, peak {peak:.2f} GiB; launches "
          f"{launches}; first sequence {toks[0, :12].tolist()}", flush=True)
    for name in ("pim_matmul", "lut_softmax"):
        entries[name]["launches"] = launches.get(name, 0)
    def cut(_):
        serve_lib.generate(model, params, batch, PROFILED_TOKENS, P + T)

    bounds, wall = unprofiled_wall(lambda: None, cut, softmax_bounds)
    out["classic"] = dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
        tokens_per_s=Bs * T / total_s, total_s=total_s, launches=launches,
        peak_gib=peak, **profiled_report(
            lambda: None, cut, f"paper-fidelity request cut to {PROFILED_TOKENS} new "
            "tokens", wall, ADC_KERNELS))
    served_softmax(entries, "classic request", out["classic"], bounds, L)

    trace, lens, budgets = sched_trace(V)
    n_tok = int(budgets.sum())

    def pick_sched(name, i):
        """Layer 0 of the first admission wave (8 prompts bucketed to 256
        rows) and of the fourth forward, a decode step."""
        mm = name == "pim_matmul"
        if i == (4 if mm else 0):
            return "wave 1 prefill layer 0" + (" w_gate" if mm else "")
        if i == 3 * (LINEARS_PER_LAYER if mm else 1) * L + (6 if mm else 0):
            return "decode forward 4 layer 0" + (" w_out" if mm else "")
        return None

    sched = serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
    rids = [sched.submit(p, b) for p, b in trace]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(pick_sched, ADC_TARGETS) as kept:
        t0 = time.perf_counter()
        res = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = sched.stats
    check(not n_plain, f"paged trace: no plain-version call on the path ({n_plain})")
    streams = [res.get(r, []) for r in rids]
    check(all(len(s) == b for s, (_, b) in zip(streams, trace))
          and all(0 <= t < V for s in streams for t in s),
          "paper fidelity, paged trace: every request got its budget of "
          "in-vocabulary tokens")
    expect_launches("paged trace", launches, st["model_steps"], L)
    slots = SCHED_KW["max_batch_slots"]
    wave = slots * sched._bucket(int(lens[:slots].max()))
    replay_adc("paged trace", kept, {
        "wave 1 prefill layer 0 w_gate": wave, "wave 1 prefill layer 0": wave,
        "decode forward 4 layer 0 w_out": slots, "decode forward 4 layer 0": slots})
    sched.audit()
    check(len(sched.free_pages) == sched.num_pages - 1,
          "paper fidelity, paged trace: every page returned to the free list")
    print(f"  paged trace: {wall:.2f} s, {n_tok / wall:.1f} tokens/s, "
          f"{wall / st['steps'] * 1e3:.1f} ms per scheduler step ({st['steps']} steps, "
          f"{st['model_steps']} forwards), peak {peak:.2f} GiB, peak pages "
          f"{sched.peak_pages_in_use}, launches {launches}", flush=True)
    entries["pim_matmul"]["paged_launches"] = launches.get("pim_matmul", 0)
    entries["lut_softmax"]["paged_launches"] = launches.get("lut_softmax", 0)
    peak_pages = sched.peak_pages_in_use
    def submitted():
        sched = serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
        for p, b in trace:
            sched.submit(p, b)
        return sched

    def steps(sched):
        for _ in range(PROFILED_STEPS):
            sched.step()

    bounds, cut_wall = unprofiled_wall(submitted, steps, softmax_bounds)
    out["paged"] = dict(
        wall_s=wall, tokens_per_s=n_tok / wall, ms_per_step=wall / st["steps"] * 1e3,
        steps=st["steps"], model_steps=st["model_steps"], launches=launches,
        peak_gib=peak, peak_pages_in_use=peak_pages,
        profile=profiled_report(
            submitted, steps, f"first {PROFILED_STEPS} steps of the paper-fidelity "
            "paged trace", cut_wall, ADC_KERNELS))
    served_softmax(entries, "paged trace", out["paged"]["profile"], bounds, L)
    return out


def dense_kernels(dev, cfg, gen, operands, compare, bound, entries) -> None:
    """Phase 2: both attention kernels against their plain versions at the
    widths of `cfg`, dense, with their times."""
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh, B = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    print("kernels vs plain versions:", flush=True)
    # prefill: causal Sq 512 (timed), windowed, 4-bit, and the serve shape
    Sq = 512
    q, cache, opnd = operands(Sq, Sq, Sq)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    compare("prefill causal Sq512",
                  pim_attention(*opnd, 0, Sq, **kw),
                  pim_attention_plain(*opnd, 0, Sq, **kw))
    _, iters = pim_attention(*opnd, 0, Sq, **kw)
    exp = expected_kv_block_iters(Sq, Sq, 0, 32, 256)
    check(bool((iters.sum(dim=1) == exp).all()),
          f"prefill iterations per head == expected_kv_block_iters ({exp})")
    kern = lambda: pim_attention(*opnd, 0, Sq, pim_cfg, lut_cfg)  # noqa: E731
    plain = lambda: pim_attention_plain(*opnd, 0, Sq, pim_cfg, lut_cfg)  # noqa: E731
    qb = q.transpose(1, 2)
    kf = torch.randn(B, Hkv, Sq, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qb, kf, kf, is_causal=True, enable_gqa=True)
    us, n = kernel_us(profiled(kern, 20), "pim_attention_kernel")
    check(n == 20, f"profiler saw the 20 prefill launches ({n})")
    ms = us / 20 / 1e3
    plain_ms, lib_ms = per_call_ms(profiled(plain, 3), 3), per_call_ms(profiled(lib, 20), 20)
    walls = dict(wrapper_ms=cuda_ms(kern, 20), plain_wall_ms=cuda_ms(plain, 3),
                 library_wall_ms=cuda_ms(lib, 20))
    nbytes = sum(t.numel() * t.element_size() for t in opnd) + B * H * Sq * Dh * 4
    pairs = B * H * Sq * (Sq + 1) // 2
    b_ms, b_by = bound(nbytes, pairs)
    entries["pim_attention"] = dict(
        name="pim_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_attention.cu",
        replaces="src/repro/kernels/pim_attention.py:224",
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, **walls,
        shape=f"B{B} H{H}/{Hkv} Dh{Dh} Sq{Sq} Sk{Sq} causal int8")
    print(f"  prefill Sq{Sq}, device ms per call: kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}, sdpa bf16 {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); "
          f"wall of back-to-back calls: wrapper {walls['wrapper_ms']:.4f}, plain "
          f"{walls['plain_wall_ms']:.4f}, sdpa {walls['library_wall_ms']:.4f}")
    compare("prefill window 128",
            pim_attention(*opnd, 0, Sq, window=128, **kw),
            pim_attention_plain(*opnd, 0, Sq, window=128, **kw))
    _, _, opnd4 = operands(Sq, Sq, Sq, kv_bits=4)
    compare("prefill kv4", pim_attention(*opnd4, 0, Sq, **kw),
            pim_attention_plain(*opnd4, 0, Sq, **kw))
    _, _, opnd_s = operands(128, 160, 128)
    compare("prefill serve shape Sq128 Sk160",
            pim_attention(*opnd_s, 0, 128, **kw),
            pim_attention_plain(*opnd_s, 0, 128, **kw))
    # a group of 4 q heads (two CTAs of 64 rows at head_dim 128) and head_dim 64
    for what, heads in (("q_per_kv 4 (16 over 4 heads)", (16, 4, Dh)),
                        ("head_dim 64", (H, Hkv, 64))):
        _, _, opnd_h = operands(Sq, Sq, Sq, heads=heads)
        compare(f"prefill {what} Sq{Sq}",
                pim_attention(*opnd_h, 0, Sq, **kw),
                pim_attention_plain(*opnd_h, 0, Sq, **kw))

    # decode: kv_len 4096, block_k 256
    kv = 4096
    q, cache, opnd = operands(1, kv, kv)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, block_k=256, return_iters=True)
    compare("decode kv_len 4096", pim_decode(*opnd, kv - 1, kv, **kw),
                  pim_decode_plain(*opnd, kv - 1, kv, **kw))
    _, iters = pim_decode(*opnd, kv - 1, kv, **kw)
    exp = expected_kv_block_iters(1, kv, kv - 1, 1, 256, kv_valid_len=kv)
    check(bool((iters.sum(dim=1) == exp).all()),
          f"decode partitions per KV head == expected_kv_block_iters ({exp})")
    kern = lambda: pim_decode(*opnd, kv - 1, kv, pim_cfg, lut_cfg)  # noqa: E731
    plain = lambda: pim_decode_plain(*opnd, kv - 1, kv, pim_cfg, lut_cfg)  # noqa: E731
    qb = q.transpose(1, 2)
    kf = torch.randn(B, Hkv, kv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(qb, kf, kf, enable_gqa=True)  # noqa: E731
    times = profiled(kern, 50)
    us, n = kernel_us(times, "pim_decode_kernel")
    check(n == 50, f"profiler saw one pim_decode_kernel per decode call ({n} of 50)")
    rest = others(times, "pim_decode_kernel")
    check(not rest, f"a decode call runs one device kernel, no copy kernel ({rest})")
    ms = us / 50 / 1e3
    plain_ms, lib_ms = per_call_ms(profiled(plain, 3), 3), per_call_ms(profiled(lib, 50), 50)
    walls = dict(wrapper_ms=cuda_ms(kern, 50), plain_wall_ms=cuda_ms(plain, 3),
                 library_wall_ms=cuda_ms(lib, 50))
    nbytes = sum(t.numel() * t.element_size() for t in opnd) + B * H * Dh * 4
    b_ms, b_by = bound(nbytes, B * H * kv)
    entries["pim_decode"] = dict(
        name="pim_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_decode.cu",
        replaces="src/repro/kernels/pim_decode.py:160",
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, **walls,
        shape=f"B{B} H{H}/{Hkv} Dh{Dh} Sq1 kv_len{kv} block_k256 int8")
    print(f"  decode kv{kv}, device ms per call: kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}, sdpa bf16 {lib_ms:.4f}, "
          f"bound {b_ms:.4f} ({b_by}); wall of back-to-back calls: wrapper "
          f"{walls['wrapper_ms']:.4f}, plain {walls['plain_wall_ms']:.4f}, "
          f"sdpa {walls['library_wall_ms']:.4f}")
    # verify rows: Sq 4, bit-identical to single-step launches
    qv, cache_v, opnd_v = operands(4, kv, kv)
    o_v, it_v = pim_decode(*opnd_v, kv - 4, kv, **kw)
    compare("decode verify rows Sq4", (o_v, it_v),
            pim_decode_plain(*opnd_v, kv - 4, kv, **kw))
    same = True
    for l in range(4):
        o_1 = ops.pim_flash_attention(qv[:, l:l + 1], cache_v, kv - 4 + l,
                                      pim_cfg, lut_cfg, out_dtype=torch.float32)
        same &= torch.equal(o_v.reshape(B, H, 4, Dh)[:, :, l], o_1[:, 0])
    check(bool(same), "verify rows bit-identical to single-step decodes")
    ql = torch.tensor([1, 0, 1, 1], device=dev)
    compare("decode ragged q_len with a 0 row",
            pim_decode(*opnd, kv - 1, kv, q_len=ql, **kw),
            pim_decode_plain(*opnd, kv - 1, kv, q_len=ql, **kw))
    _, _, opnd4 = operands(1, kv, kv, kv_bits=4)
    compare("decode kv4", pim_decode(*opnd4, kv - 1, kv, **kw),
            pim_decode_plain(*opnd4, kv - 1, kv, **kw))
    # the served request's own shape: a cache of prompt + new tokens = 160
    # rows, holding 129..159 of them, so one partial partition whose rows
    # past Sk are zero-filled and whose rows past kv_len are masked
    Sk = 160
    for kvs in (129, 144, 159):
        _, _, opnd_s = operands(1, Sk, kvs)
        compare(f"decode serve shape Sk{Sk} kv_len {kvs}",
                pim_decode(*opnd_s, kvs - 1, kvs, **kw),
                pim_decode_plain(*opnd_s, kvs - 1, kvs, **kw))
    _, _, opnd_s = operands(4, Sk, 150)
    compare(f"decode serve shape Sk{Sk} verify rows Sq4",
            pim_decode(*opnd_s, 146, 150, **kw),
            pim_decode_plain(*opnd_s, 146, 150, **kw))
    _, _, opnd_s = operands(1, Sk, 137, kv_bits=4)
    compare(f"decode serve shape Sk{Sk} kv4",
            pim_decode(*opnd_s, 136, 137, **kw),
            pim_decode_plain(*opnd_s, 136, 137, **kw))
    # block sizes other than 16, 32, 64 and multiples of 128: each partition
    # a unit of its own, its rows past block_k zero-filled and masked
    _, _, opnd_o = operands(4, 1000, 1000)
    for bk in (8, 48, 96, 192):
        for what, o, L in (("Sq1", opnd, kv), ("verify rows Sq4", opnd_o, 1000)):
            n, kwb = o[0].shape[1], dict(kw, block_k=bk)
            compare(f"decode block_k {bk} {what} kv_len {L}",
                    pim_decode(*o, L - n, L, **kwb), pim_decode_plain(*o, L - n, L, **kwb))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the results here")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phases to run (default: all); phase 1 "
                         "always runs, and a phase brings the ones it needs")
    args = ap.parse_args(argv)
    phases = {1} | {int(p) for p in args.phases.split(",") if p.strip()}
    if not phases <= set(PHASES):
        ap.error(f"--phases takes phases of {PHASES}")
    for p in sorted(phases, reverse=True):
        phases |= NEEDS.get(p, set())

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {}

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    results["card"] = smi
    _build.build_all()
    info = _build.build_info
    print(f"build: {info['seconds']:.1f}s for {info['built'] or 'nothing (cached)'}")
    for name in _build.SOURCES:
        for line in str(info.get(f"nvcc_{name}", "")).splitlines():
            if "Function properties for" in line:   # the kernel (template) named
                print(f"  ptxas {name}: {line.split('for')[-1].strip()[-48:]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    results["build_s"] = info["seconds"]
    results["pim_matmul_imma"] = sass_imma("pim_matmul")
    results["pim_attention_imma"] = sass_imma("pim_attention")
    results["pim_decode_imma"] = sass_imma("pim_decode")

    # ---- 2. kernels against their plain versions --------------------------
    cfg = get_config("internlm2-1.8b")
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh, B = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(Sq, Sk, kv_len, kv_bits=8, heads=(H, Hkv, Dh)):
        """Random q and a dense cache of kv_len tokens at (q heads, KV
        heads, head_dim) `heads`: (q, cache, kernel operands)."""
        Hq, Hk, D = heads
        q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, kv_len, Hk, D, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, kv_len, Hk, D, generator=gen, device=dev, dtype=torch.bfloat16)
        cache = A.init_kv_cache(B, Sk, Hk, D, kv_bits=kv_bits, device=dev)
        A.cache_write(cache, k, v, 0, pim_cfg)
        return q, cache, ops.kernel_attention_layout(q, cache, pim_cfg.input_bits)

    max_err = {"pim_attention": 0.0, "pim_decode": 0.0}

    def compare(name, kern, plain):
        """Hold a kernel's (out, iters) to its plain version's; the error
        counts toward pim_attention in "prefill ..." cases, else pim_decode."""
        (o_k, it_k), (o_p, it_p) = kern, plain
        torch.cuda.synchronize()
        err = (o_k - o_p).abs().max().item()
        scale = o_p.abs().max().item()
        check(bool(torch.isfinite(o_k).all()) and err <= REL_TOL * scale,
              f"{name}: max|kernel-plain| {err:.3g} <= {REL_TOL} * {scale:.3g}")
        check(torch.equal(it_k, it_p), f"{name}: iteration maps equal")
        kernel = "pim_attention" if name.startswith("prefill") else "pim_decode"
        max_err[kernel] = max(max_err[kernel], err)

    def bound(nbytes, pairs):
        return attention_bound(nbytes, pairs, Dh)

    entries = {}
    if 2 in phases:
        stamp("phase 2")
        dense_kernels(dev, cfg, gen, operands, compare, bound, entries)
    if 3 in phases:
        stamp("phase 3")
        paged_kernels(dev, cfg, gen, compare, bound, entries)
    if 8 in phases:
        stamp("phase 8")
        adc_kernels(dev, cfg, gen, entries)
    if 4 in phases:
        small_model(dev, 5 in phases)
    if phases & {6, 7, 9}:
        serve_phases(dev, cfg, phases, entries, compare, results)
    stamp(f"phases {sorted(phases)} done: every check passed")
    for name in max_err:
        if name in entries:
            entries[name]["max_abs_err"] = max_err[name]
    results["kernels"] = list(entries.values())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("wrapper_ms", "cold_ms", "served_us", "served_bound_us", "paged_ms", "paged_bound_ms",
             "paged_launches", "dense_sched_launches", "ideal_ms", "int_mm_ms")
    print(json.dumps({"kernels": [{**{k: e.get(k) for k in keys},
                                   **{k: e[k] for k in extra if k in e}}
                                  for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def small_model(dev, scheduler: bool) -> None:
    """Phase 4, the kernel path of a small model on the GPU against the
    plain path on the CPU, and phase 5 on it when `scheduler`."""
    stamp("phase 4")
    small = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                                attn_impl="kernel", compute_dtype="float32")
    m_cpu, m_gpu = build_model(small, "cpu"), build_model(small, dev)
    p_cpu = m_cpu.init(seed=0)

    def to_gpu(t):
        if isinstance(t, dict):
            return {k: to_gpu(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(to_gpu(v) for v in t)
        return t.to(dev)

    p_gpu = to_gpu(p_cpu)
    toks = torch.from_numpy(data.lm_batch(0, 2, 16, small.vocab_size)).long()
    l_cpu, _ = m_cpu.forward_serve(p_cpu, {"tokens": toks}, m_cpu.init_cache(2, 24), 0)
    l_gpu, _ = m_gpu.forward_serve(p_gpu, {"tokens": toks.to(dev)}, m_gpu.init_cache(2, 24), 0)
    rel = ((l_gpu.cpu() - l_cpu).abs().max() / l_cpu.abs().max()).item()
    check(rel <= 1e-4, f"smoke model f32 logits, GPU kernels vs CPU plain: rel {rel:.3g} <= 1e-4")
    s_cpu = serve_lib.generate(m_cpu, p_cpu, {"tokens": toks}, 8, 24)
    s_gpu = serve_lib.generate(m_gpu, p_gpu, {"tokens": toks}, 8, 24)
    check(torch.equal(s_cpu, s_gpu.cpu()), "smoke model 8-token greedy streams equal")

    if scheduler:
        stamp("phase 5")
        smoke_scheduler(dev, small, p_gpu)


def serve_phases(dev, cfg, phases, entries, compare, results) -> None:
    """Phases 6, 7 and 9 at full width and depth, on the phase 6 weights."""
    stamp("phase 6: model and weights")
    Dh = cfg.resolved_head_dim
    cfg = dataclasses.replace(cfg, attn_impl="kernel")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {Dh}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params "
          f"(init+deploy {time.perf_counter() - t0:.1f}s)", flush=True)
    if 6 in phases:
        serve_classic(model, params, cfg, entries, results)
    if 7 in phases:
        stamp("phase 7")
        results["scheduler"] = full_scheduler(model, params, cfg, entries, compare)
    if 9 in phases:
        stamp("phase 9")
        results["paper_fidelity"] = paper_fidelity(cfg, params, entries)


def serve_classic(model, params, cfg, entries, results) -> None:
    """Phase 6: the classic request on the kernel path, then profiled."""
    stamp("phase 6: the classic request")
    dev = model.device
    Bs, P, T = 4, 128, 32
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, cfg.vocab_size)).long()}
    logits, _ = model.forward_serve(params, {"tokens": batch["tokens"].to(dev)},
                                    model.init_cache(Bs, P + T), 0)
    check(tuple(logits.shape) == (Bs, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "full model prefill logits finite, (4, 92544)")
    serve_lib.generate(model, params, batch, 2, P + T)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)          # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    _build.LAUNCHES.clear()
    with plain_calls() as n_plain:
        t0 = time.perf_counter()
        out = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L = cfg.num_layers
    check(not n_plain, f"classic request: no plain-version call on the path ({n_plain})")
    check(launches.get("pim_attention") == L and launches.get("pim_decode") == (T - 1) * L,
          f"classic request: {L} prefill launches (one prefill forward) and "
          f"{(T - 1) * L} decode launches")
    check(tuple(out.shape) == (Bs, T) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, "served (4, 32) token ids in the vocabulary")
    decode_ms = (total_s - prefill_s) / (T - 1) * 1e3
    print(f"  prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / total_s:.1f} tokens/s over the request "
          f"(batch {Bs}, prompt {P}, {T} new tokens)")
    print(f"  first sequence: {out[0, :12].tolist()}")
    print(f"  launches: {launches}")
    for name in ("pim_attention", "pim_decode"):
        check(launches.get(name, 0) > 0, f"main path launched {name}")
        entries[name]["launches"] = launches.get(name, 0)

    # the request cut to PROFILED_TOKENS new tokens, unprofiled and then
    # under the profiler: where the device time goes
    def cut(_):
        serve_lib.generate(model, params, batch, PROFILED_TOKENS, P + T)

    shapes, wall = unprofiled_wall(lambda: None, cut, lambda: decode_shapes(cfg))
    results["serve"] = dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
        tokens_per_s=Bs * T / total_s, total_s=total_s, launches=launches,
        **profiled_report(lambda: None, cut,
                          f"request cut to {PROFILED_TOKENS} new tokens", wall))
    served_decode(entries, "classic request", results["serve"], shapes, cfg)


if __name__ == "__main__":
    sys.exit(main())
