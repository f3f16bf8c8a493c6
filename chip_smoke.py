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
3. Checks the kernel path of a small model against the plain path on the CPU.
4. Serves internlm2-1.8b at full width and depth (random weights from a
   seed) through `repro_torch.runtime.serve_lib.generate`, batch 4, prompt
   128, 32 new tokens, greedy, counting kernel launches.  Then serves the
   same request again under torch.profiler and prints where its device time
   goes: the busy share over the unprofiled wall time, each attention
   kernel's device time per launch and the top device operators.

Exits non-zero, printing no result, when there is no GPU or any check
fails.  The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

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

    for name, entry in entries.items():
        entry["max_abs_err"] = max_err[name]

    # ---- 3. a small model: kernel path on the GPU vs plain path on the CPU
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

    # ---- 4. serve internlm2-1.8b at full width and depth -----------------
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

    # the same request again, under the profiler: where the device time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = prof.key_averages()
    times = device_us(events)
    busy_ms = sum(us for us, _ in times.values()) / 1e3
    n_dev = sum(n for _, n in times.values())
    host_launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"  profiled request: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / (total_s * 1e3):.1%} of the unprofiled wall "
          f"{total_s * 1e3:.1f} ms ({busy_ms / (prof_s * 1e3):.1%} of the "
          f"profiled wall {prof_s * 1e3:.1f} ms); {n_dev} device kernels and "
          f"copies, {host_launches} cudaLaunchKernel calls")
    serve_kernels = {}
    for kernel in ("pim_attention_kernel", "pim_decode_kernel",
                   "pim_decode_combine_kernel"):
        us, n = kernel_us(times, kernel)
        check(n > 0, f"profiled request ran {kernel}")
        serve_kernels[kernel] = dict(device_us=us, count=n, us_per_launch=us / n)
        print(f"  {kernel}: {n} launches, {us / 1e3:.3f} ms, {us / n:.2f} us each")
    print(events.table(sort_by="self_cuda_time_total", row_limit=12,
                       max_name_column_width=48))
    results.update(serve=dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                              tokens_per_s=Bs * T / total_s, total_s=total_s,
                              launches=launches, profiled_wall_ms=prof_s * 1e3,
                              device_busy_ms=busy_ms,
                              busy_share=busy_ms / (total_s * 1e3),
                              device_events=n_dev, host_launches=host_launches,
                              kernels=serve_kernels),
                   kernels=list(entries.values()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("wrapper_ms", "combine_ms")
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
