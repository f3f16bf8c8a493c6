#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

  python3 chip_smoke.py [--out results.json]

1. Prints the card and builds the CUDA kernels from `src/repro_torch/kernels/csrc`.
2. Holds each kernel against its plain PyTorch version at the widths of
   internlm2-1.8b (16 query heads over 8 KV heads, head_dim 128): causal,
   windowed and 4-bit prefill at Sq 512; split-K decode at kv_len 4096 with
   block_k 256, verify rows (Sq 4), a q_len-0 row and 4-bit KV; iteration
   maps against the analytic count; and decode at the served request's
   own shape (a 160-token cache holding 129..159 tokens, one partial
   partition), with verify rows and 4-bit KV there too.  Times kernel,
   plain version and, as a yardstick only, bf16
   `scaled_dot_product_attention` at the same shapes: device time from
   torch.profiler, and the wall time of back-to-back calls beside it.
3. Holds the paged mode of both kernels against their plain versions at
   the same widths, over random permuted page tables of 16-token pages
   (slot lengths 0, 15, 16, 17, 1000, 2048): decode, verify rows (Sq 4),
   4-bit KV and a ragged prefill chunk (Sq 128, per-row offsets), with
   iteration maps equal, and paged == dense bit for bit at block_k == page
   size.  Times the paged mode at the shapes timed in phase 2.
4. Checks the kernel path of a small model against the plain path on the CPU.
5. Runs the continuous-batching Scheduler on the card at that small width
   (float32, kernel path): dense slots, the paged pool and classic greedy
   generation give the same streams, a starved pool stalls and evicts
   without changing them, every page returns to the free list and
   `audit()` passes after every step.
6. Serves internlm2-1.8b at full width and depth (random weights from a
   seed) through `repro_torch.runtime.serve_lib.generate`, batch 4, prompt
   128, 32 new tokens, greedy, counting kernel launches.  Then serves the
   request cut to 8 new tokens, once as it is and once under
   torch.profiler, and prints where its device time goes: the busy share
   over the unprofiled wall time, each attention kernel's device time per
   launch and the top device operators.
7. Serves a 16-request trace (prompts 16-256 tokens, budgets 16-64) through
   the Scheduler at full width, on dense slots and on the paged pool,
   counting kernel launches in each; holds served launches of both kernels
   on each storage (every admission wave's ragged prefill and three decode
   steps, on the scheduler's own cache or pool, lengths, q_len and page
   table) against their plain versions; checks budgets, vocabulary, freed
   pages, a repeatable paged stream and, for prompts of one page, dense and
   paged prefill logits equal bit for bit; prints where and by how much
   the two storages' streams and logits part; then profiles the first 3
   steps of the paged run as phase 6 does.

Exits non-zero, printing no result, when there is no GPU or any check
fails.  The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
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
from repro_torch.kernels import _build, ops  # noqa: E402
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


class CheckFailed(SystemExit):
    pass


T0 = time.perf_counter()


def stamp(what: str) -> None:
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(f"chip_smoke: check failed: {what}")


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
    """(device us, launches) of the device kernel named `kernel`."""
    hits = [v for k, v in times.items() if f"{kernel}(" in k]
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


def per_call_ms(times: dict, iters: int) -> float:
    """Summed device time of a profile, per call."""
    return sum(us for us, _ in times.values()) / iters / 1e3


def profile_report(prof, wall_s: float, prof_s: float, label: str,
                   launches: dict) -> dict:
    """Print where a profiled run's device time went: busy share of the
    unprofiled wall `wall_s` of the same run, each attention kernel's
    device time per launch and the top device operators.  `launches` are
    the wrapper counts of the profiled run: the profiler should see as many
    launches of each kernel (a pim_decode call runs two kernels)."""
    stamp(f"profile of the {label} taken")
    events = prof.key_averages()
    times = device_us(events)
    stamp("key_averages done")
    busy_ms = sum(us for us, _ in times.values()) / 1e3
    n_dev = sum(n for _, n in times.values())
    host_launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"  profiled {label}: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / (wall_s * 1e3):.1%} of the unprofiled wall "
          f"{wall_s * 1e3:.1f} ms ({busy_ms / (prof_s * 1e3):.1%} of the "
          f"profiled wall {prof_s * 1e3:.1f} ms); {n_dev} device kernels and "
          f"copies, {host_launches} cudaLaunchKernel calls")
    kernels = {}
    for kernel, wrapper in (("pim_attention_kernel", "pim_attention"),
                            ("pim_decode_kernel", "pim_decode"),
                            ("pim_decode_combine_kernel", "pim_decode")):
        us, n = kernel_us(times, kernel)
        check(n > 0, f"profiled {label} ran {kernel}")
        kernels[kernel] = dict(device_us=us, count=n, us_per_launch=us / n,
                               launched=launches.get(wrapper, 0))
        print(f"  {kernel}: {n} launches seen of {launches.get(wrapper, 0)} "
              f"made, {us / 1e3:.3f} ms, {us / n:.2f} us each")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12,
                       max_name_column_width=48))
    return dict(profiled_wall_ms=prof_s * 1e3, device_busy_ms=busy_ms,
                busy_share=busy_ms / (wall_s * 1e3), device_events=n_dev,
                host_launches=host_launches, kernels=kernels)


PAGE = 16     # tokens per KV page in phases 3, 5 and 7
PROFILED_STEPS = 3   # scheduler steps of the paged trace under the profiler
PROFILED_TOKENS = 8  # new tokens of the classic request under the profiler


def random_table(lens, n_tables: int, seed: int, dev):
    """A (B, n_tables) int32 page table on `dev`: a random permutation of
    pages 1..P-1 (page 0 is the trash page), -1 past each row's pages.
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

    def operands(lens, Sq, S, kv_bits=8, seed=0):
        """The same K/V in a paged pool (random table of PAGE-token pages)
        and in a dense ragged cache of S tokens; returns (paged operands,
        table, dense operands, (B,) lengths)."""
        B = len(lens)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        dense = A.init_kv_cache(B, S, Hkv, Dh, kv_bits=kv_bits, device=dev, ragged=True)
        A.cache_write_ragged(dense, k, v, zeros, pim_cfg, seq_lens=lens_d)
        pt, P = random_table(lens, S // PAGE, seed, dev)
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
    us1, n1 = kernel_us(times, "pim_decode_kernel")
    us2, n2 = kernel_us(times, "pim_decode_combine_kernel")
    check(n1 == n2 == 50, f"profiler saw the 50 paged decode launches of each kernel ({n1}, {n2})")
    b_ms, _ = bound(paged_bytes(paged, pt), B * H * kv)
    entries["pim_decode"].update(paged_ms=(us1 + us2) / 50 / 1e3, paged_bound_ms=b_ms)
    print(f"  paged decode kv{kv}, device ms per call: kernels "
          f"{(us1 + us2) / 50 / 1e3:.4f} (combine {us2 / 50 / 1e3:.4f}; dense "
          f"{entries['pim_decode']['ms']:.4f}), bound {b_ms:.4f}")


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
def recorded(pick):
    """Within the block, keeps copies of the operands of the serving path's
    kernel launches that `pick(name, index)` labels ("pim_attention" or
    "pim_decode", index of the launch among that wrapper's in the block):
    yields {label: (name, args, kwargs)}.  The copies are taken at launch,
    since the scheduler writes its cache in place afterwards."""
    def copied(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

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

    for name in ("pim_attention", "pim_decode"):
        wrapped[name] = getattr(ops, name)
        setattr(ops, name, wrap(name, wrapped[name]))
    try:
        yield kept
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)


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


def full_scheduler(model, params, cfg, entries, compare) -> dict:
    V = cfg.vocab_size
    rng = np.random.RandomState(0)
    n_req = 16
    lens = rng.randint(16, 257, n_req)
    if not (lens % PAGE == 0).any():
        lens[0] = PAGE * max(1, lens[0] // PAGE)
    budgets = rng.randint(16, 65, n_req)
    toks = data.lm_batch(0, n_req, 256, V)
    trace = [(toks[i, :n].tolist(), int(b)) for i, (n, b) in enumerate(zip(lens, budgets))]
    n_tok = int(budgets.sum())
    kw = dict(max_batch_slots=8, max_len=512, decode_chunk=8)
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
        with recorded(pick) if record else contextlib.nullcontext({}) as kept:
            t0 = time.perf_counter()
            res = sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
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
    walls = []
    for profiled_run in (False, True):
        sched = serve_lib.Scheduler(model, params, page_size=PAGE, **kw)
        for p, b in trace:
            sched.submit(p, b)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     ) if profiled_run else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                sched.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    paged_info["profile"] = profile_report(
        prof, walls[0], walls[1], f"first {PROFILED_STEPS} steps of the paged "
        f"trace ({sched.model_steps} forwards)", dict(_build.LAUNCHES))
    return dict(dense=dense_info, paged=paged_info, agree=agree,
                prompts=lens.tolist(), budgets=budgets.tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the results here")
    args = ap.parse_args(argv)

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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    results["build_s"] = info["seconds"]

    # ---- 2. kernels against their plain versions --------------------------
    stamp("phase 2")
    cfg = get_config("internlm2-1.8b")
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh, B = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(Sq, Sk, kv_len, kv_bits=8):
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, kv_len, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, kv_len, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        cache = A.init_kv_cache(B, Sk, Hkv, Dh, kv_bits=kv_bits, device=dev)
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
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = (2 * Dh * pairs / INT8_OPS + 2 * Dh * pairs / F32_OPS) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    print("kernels vs plain versions:", flush=True)
    entries = {}
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
    us1, n1 = kernel_us(times, "pim_decode_kernel")
    us2, n2 = kernel_us(times, "pim_decode_combine_kernel")
    check(n1 == n2 == 50, f"profiler saw the 50 decode launches of each kernel ({n1}, {n2})")
    # one pim_decode call (one count) runs the split-K kernel and the combine
    ms, combine_ms = (us1 + us2) / 50 / 1e3, us2 / 50 / 1e3
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
        bound_by=b_by, library_ms=lib_ms, combine_ms=combine_ms, **walls,
        shape=f"B{B} H{H}/{Hkv} Dh{Dh} Sq1 kv_len{kv} block_k256 int8")
    print(f"  decode kv{kv}, device ms per call: kernels {ms:.4f} (combine "
          f"{combine_ms:.4f}), plain {plain_ms:.4f}, sdpa bf16 {lib_ms:.4f}, "
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

    stamp("phase 3")
    paged_kernels(dev, cfg, gen, compare, bound, entries)

    # ---- 4. a small model: kernel path on the GPU vs plain path on the CPU
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

    stamp("phase 5")
    smoke_scheduler(dev, small, p_gpu)

    # ---- 6. serve internlm2-1.8b at full width and depth -----------------
    stamp("phase 6")
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
    t0 = time.perf_counter()
    out = serve_lib.generate(model, params, batch, T, P + T)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(tuple(out.shape) == (Bs, T) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, "served (4, 32) token ids in the vocabulary")
    decode_ms = (total_s - prefill_s) / (T - 1) * 1e3
    print(f"  prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / total_s:.1f} tokens/s over the request "
          f"(batch {Bs}, prompt {P}, {T} new tokens)")
    print(f"  first sequence: {out[0, :12].tolist()}")
    print(f"  launches: {launches}")
    for name in entries:
        check(launches.get(name, 0) > 0, f"main path launched {name}")
        entries[name]["launches"] = launches.get(name, 0)

    # the request cut to PROFILED_TOKENS new tokens, unprofiled and then
    # under the profiler: where the device time goes
    walls = []
    for profiled_run in (False, True):
        _build.LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     ) if profiled_run else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            serve_lib.generate(model, params, batch, PROFILED_TOKENS, P + T)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    results["serve"] = dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
        tokens_per_s=Bs * T / total_s, total_s=total_s, launches=launches,
        **profile_report(prof, walls[0], walls[1], f"request cut to "
                         f"{PROFILED_TOKENS} new tokens", dict(_build.LAUNCHES)))

    stamp("phase 7")
    results["scheduler"] = full_scheduler(model, params, cfg, entries, compare)
    stamp("phase 7 done")
    for name, entry in entries.items():
        entry["max_abs_err"] = max_err[name]
    results["kernels"] = list(entries.values())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("wrapper_ms", "combine_ms", "paged_ms", "paged_bound_ms",
             "paged_launches", "dense_sched_launches")
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys},
                                   **{k: e[k] for k in extra if k in e}}
                                  for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
