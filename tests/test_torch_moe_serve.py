"""deepseek-moe-16b served by the port against the JAX package, on the CPU.

The SMOKE config: 3 layers, the first a dense prefix layer and two MoE
layers (4 routed experts, 1 shared, top-2), d_model 64, head_dim 32.
Parameters from the reference's seeded `init` through `from_jax_params`,
float32 compute at the ideal ADC, the port on one torch thread.  Bounds:
  * `forward_serve` logits of a prefill and a decode step within rel 1e-4
    of JAX's (measured ~1e-6), on the dense cache and the paged pool, on
    the behavioral and the kernel paths;
  * one MoE block in bfloat16 bit for bit against the reference's eager
    block (behavioral path);
  * greedy `generate` and the Scheduler (paged pool, kernel path; and a
    starved pool spilling to host memory) token for token as JAX's, with
    the spill statistics and free list equal; speculative verify rows,
    prefix sharing and ragged dense slots too; a crash / snapshot restore
    of the MoE Scheduler serves the uncrashed streams;
  * capacity routing (ROADMAP §3): a token's output depends on the rows
    that share its step, so chunked prefill in mixed steps parts from the
    unchunked stream, in JAX's Scheduler and in the port's alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import attention as JA
from repro.models import blocks as JB
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.core import attention as TA
from repro_torch.data import pipeline as TD
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import fault as TF
from repro_torch.runtime import serve_lib as TS

ARCH = "deepseek-moe-16b"
PAGE = 8
STATS = ("steps", "model_steps", "evictions", "spills", "restores",
         "spilled_pages", "spill_bytes", "recompute_fallbacks")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


@pytest.fixture(scope="module")
def models():
    """{impl: (jax model, jax params, port model, port params)}, float32."""
    jp, out = None, {}
    for impl in ("behavioral", "kernel"):
        jcfg, tcfg = _cfgs(attn_impl=impl, compute_dtype="float32",
                           decode_block_k=PAGE)
        jm = jax_build(jcfg)
        if jp is None:
            jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        out[impl] = (jm, jp, build_model(tcfg, "cpu"),
                     from_jax_params(jp, tcfg, "cpu"))
    return out


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _steps(jm, jp, tm, tp, toks, paged):
    """[(jax logits, port logits)] of a prefill and a decode step."""
    B, S = toks.shape
    t_toks = torch.from_numpy(toks).long()
    if not paged:
        jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks)},
                                     jm.init_cache(B, S + 4), 0)
        jl2, _, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks[:, :1])}, jc, S)
        tl, tc = tm.forward_serve(tp, {"tokens": t_toks}, tm.init_cache(B, S + 4), 0)
        tl2, _ = tm.forward_serve(tp, {"tokens": t_toks[:, :1]}, tc, S)
        return [(jl, tl), (jl2, tl2)]
    mp = -(-(S + 4) // PAGE)
    table = (1 + np.random.RandomState(1).permutation(B * mp)).reshape(B, mp)
    table = table.astype(np.int32)
    n = B * mp + 1
    jc = jm.init_cache(B, S + 4, ragged=True, page_size=PAGE, num_pages=n)
    tc = tm.init_cache(B, S + 4, page_size=PAGE, num_pages=n)
    out = []
    for toks_i, off in ((toks, 0), (toks[:, :1], S)):
        s = toks_i.shape[1]
        offs = np.full(B, off, np.int32)
        lens = np.full(B, s, np.int32)
        jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks_i)}, jc,
                                     jnp.asarray(offs), seq_lens=jnp.asarray(lens),
                                     pages=jnp.asarray(table))
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks_i).long()},
                                  tc, torch.from_numpy(offs),
                                  seq_lens=torch.from_numpy(lens),
                                  pages=torch.from_numpy(table))
        out.append((jl, tl))
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("impl", ["behavioral", "kernel"])
def test_forward_serve_logits_match_jax(models, impl, paged):
    jm, jp, tm, tp = models[impl]
    toks = np.random.RandomState(2).randint(0, 256, (2, 8)).astype(np.int32)
    for j, t in _steps(jm, jp, tm, tp, toks, paged):
        assert t.shape == j.shape
        assert _rel(t, j) <= 1e-4


def test_bf16_moe_block_bit_identical_to_jax_eager(models):
    """A MoE block (attention, then the routed and shared experts) of the
    stack in bfloat16, behavioral path."""
    _, jp, _, _ = models["behavioral"]
    jcfg, tcfg = _cfgs(attn_impl="behavioral")
    blk = jax.tree.map(lambda a: a[1], jp["blocks"][0])
    tblk = TT._index(from_jax_params(jp, tcfg, "cpu")["blocks"][0], 1)
    assert "moe" in tblk and "mlp" not in tblk
    x = np.random.RandomState(3).randn(2, 8, 64).astype(np.float32)
    jo, _ = JB.attn_block_fwd_serve(blk, jnp.asarray(x, jnp.bfloat16),
                                    JA.init_kv_cache(2, 12, 2, 32), 0, jcfg)
    to = TB.attn_block_fwd_serve(tblk, torch.from_numpy(x).bfloat16(),
                                 TA.init_kv_cache(2, 12, 2, 32), 0, tcfg)
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo.astype(jnp.float32)))


def test_greedy_generate_stream_identical_to_jax(models):
    jm, jp, tm, tp = models["kernel"]
    toks = TD.lm_batch(4, 2, 8, 256)
    js = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 8, 16)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 8, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _trace(seed, lens, budget):
    full = TD.lm_batch(seed, len(lens), max(lens), 256)
    return [(full[i, :n].tolist(), budget) for i, n in enumerate(lens)]


def _run(sched, trace, audit=False):
    rids = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        if audit:
            sched.audit()
    return [res.get(r, []) for r in rids]


SCHED = dict(max_batch_slots=3, max_len=48, decode_chunk=4, page_size=PAGE)
TRACE = _trace(1, [5, 17, 12, 9], 10)


def test_scheduler_kernel_path_paged_matches_jax(models):
    """The trace through 3 slots of a paged pool on the kernel path, with
    slot reuse; `audit()` after every step; every page back."""
    jm, jp, tm, tp = models["kernel"]
    js = _run(JS.Scheduler(jm, jp, **SCHED), TRACE)
    sched = TS.Scheduler(tm, tp, audit_every_step=True, **SCHED)
    assert _run(sched, TRACE, audit=True) == js
    assert [len(s) for s in js] == [10] * 4
    assert sorted(sched.free_pages) == list(range(1, sched.num_pages))


def test_starved_pool_spills_like_jax(models):
    """A pool of 8 + 1 pages spills slots to a host victim pool and
    restores them: streams, spill statistics and the free list equal
    JAX's, the pages' bytes carrying the dense prefix's layer too."""
    jm, jp, tm, tp = models["behavioral"]
    kw = dict(SCHED, num_pages=9, victim_pool_pages=16)
    trace = _trace(3, [14, 16, 12], 12)
    js = JS.Scheduler(jm, jp, **kw)
    j_streams = _run(js, trace)
    ts = TS.Scheduler(tm, tp, audit_every_step=True, **kw)
    assert _run(ts, trace, audit=True) == j_streams
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    assert ts.stats["spills"] >= 1
    assert [int(p) for p in ts.free_pages] == [int(p) for p in js.free_pages]


def test_crash_restore_serves_the_uncrashed_streams(models, tmp_path):
    """Snapshots every 2 steps, a crash at step 3 and a fresh scheduler
    restoring the newest snapshot: a cache tree with a dense prefix."""
    _, _, tm, tp = models["behavioral"]
    kw = dict(SCHED, num_pages=40)
    ref = TS.Scheduler(tm, tp, **kw)
    want = _run(ref, TRACE)
    d = str(tmp_path / "snap")
    plan = dict(crash_at_step=3)
    crash = TS.Scheduler(tm, tp, snapshot_dir=d, snapshot_every=2,
                         fault_plan=TF.FaultPlan(**plan), **kw)
    with pytest.raises(TF.CrashInjected):
        _run(crash, TRACE)
    again = TS.Scheduler(tm, tp, snapshot_dir=d, snapshot_every=2,
                         fault_plan=TF.FaultPlan(**plan), audit_every_step=True, **kw)
    assert "dense_prefix" in again.cache
    assert again.restore() >= 1
    again.run()
    assert again.results() == ref.results()
    assert [ref.results()[r] for r in sorted(ref.results())] == want


def test_capacity_routing_parts_chunked_streams_like_jax(models):
    """Capacity is computed over every row of a step, so a prompt
    prefilled in chunks beside decoding slots routes otherwise than one
    prefilled whole: the mixed-step streams part from the plain ones, the
    same way in JAX's Scheduler and in the port's."""
    jm, jp, tm, tp = models["behavioral"]
    trace = _trace(6, [20, 6, 23, 4], 10)
    mixed = dict(mixed_steps=True, prefill_chunk_budget=8)
    runs = {}
    for name, kw in (("plain", {}), ("mixed", mixed)):
        kw = dict(SCHED, num_pages=40, **kw)
        runs[name] = (_run(JS.Scheduler(jm, jp, **kw), trace),
                      _run(TS.Scheduler(tm, tp, **kw), trace))
    for name, (j, t) in runs.items():
        assert t == j, name
    assert runs["plain"][1] != runs["mixed"][1]


MOTIF = [5, 6, 7, 8] * 5
MODES = {
    "speculative": (dict(speculate=True, draft_len=3),
                    [(MOTIF + [1, 2], 12), (MOTIF[:9], 12), (MOTIF + [3], 12)]),
    "prefix_sharing": (dict(prefix_sharing=True),
                       [(TRACE[1][0][:16] + [9, 9], 8), (TRACE[1][0][:16] + [7], 8),
                        (TRACE[2][0], 8)]),
    "dense_slots": (dict(page_size=0), TRACE),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_modes_match_jax(models, mode):
    """Speculative verify rows, shared prefixes with copy-on-write and
    ragged dense slots serve a MoE stack as JAX's Scheduler does."""
    jm, jp, tm, tp = models["behavioral"]
    opts, trace = MODES[mode]
    kw = dict(SCHED, num_pages=40, **opts)
    js = JS.Scheduler(jm, jp, **kw)
    j_streams = _run(js, trace)
    ts = TS.Scheduler(tm, tp, audit_every_step=True, **kw)
    assert _run(ts, trace, audit=True) == j_streams
    if mode == "speculative":
        assert ts.stats["spec_accepted"] == js.stats["spec_accepted"] > 0
    if mode == "prefix_sharing":
        assert ts.prefix_hits == js.prefix_hits > 0
