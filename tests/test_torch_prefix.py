"""Prefix sharing with copy-on-write in the port's Scheduler, against the
JAX package's, on the CPU.

SMOKE internlm2-1.8b in float32 at the ideal ADC on the behavioral path,
parameters from the JAX package's seeded `init` through `from_jax_params`.
Each scenario of the reference's prefix-sharing tests runs once through
the JAX Scheduler (in a module-scoped fixture, on one cache length and
page size so that JAX compiles few shapes) and once through the port's,
audited after every step; streams, every sharing counter, the directory
(keys, pages, tokens covered, LRU order), the refcounts and the free list
must be equal.  Also: the eviction tie-break by request id, and page
copies equal to JAX's byte for byte at both KV precisions, with and
without the layer axis.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import attention as JA
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.core import attention as TA
from repro_torch.data import pipeline as TD
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
MAX_LEN = 64
PS = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params)."""
    kw = dict(attn_impl="behavioral", compute_dtype="float32")
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg, "cpu")
    return jm, jp, tm, from_jax_params(jp, tcfg, "cpu")


def _scenarios():
    """name -> (scheduler options, [trace, ...]): each trace is submitted
    once the previous one has been served to the end."""
    base = TD.lm_batch(0, 7, 48, 256)
    prefix = base[6, :32].tolist()                  # 2 shared pages
    shared = [(prefix + base[i, :5 + i].tolist(), 6 + i) for i in range(5)]
    aligned = TD.lm_batch(2, 1, 32, 256)[0].tolist()
    odd = TD.lm_batch(5, 1, 27, 256)[0].tolist()
    ev = TD.lm_batch(4, 2, 40, 256)
    distinct = TD.lm_batch(6, 4, 32, 256)
    big = dict(max_batch_slots=3, num_pages=40, decode_chunk=4)
    return {
        # sharing off and on over one trace of a common 32-token prefix
        "off": (dict(big, prefix_sharing=False), [shared]),
        "on": (dict(big, prefix_sharing=True), [shared]),
        # two identical page-aligned prompts: the second's 1-token tail
        # writes into a shared page, which copy-on-write privatizes
        "cow": (dict(big, prefix_sharing=True), [[(aligned, 8), (aligned, 12)]]),
        # retire -> keep: the second request hits the first's whole-prompt
        # entry after it retired, its partial last page copied
        "keep": (dict(big, prefix_sharing=True), [[(odd, 6)], [(odd, 9)]]),
        # a starved pool evicts the youngest slot; the shared pages survive
        "evict": (dict(max_batch_slots=2, num_pages=5, decode_chunk=8,
                       prefix_sharing=True),
                  [[(ev[0, :32].tolist() + ev[1, :4].tolist(), 24),
                    (ev[0, :32].tolist() + ev[1, 4:8].tolist(), 24)]]),
        # a directory capped at 4 pages evicts LRU entries
        "lru": (dict(big, prefix_sharing=True, prefix_cache_pages=4),
                [[(distinct[i].tolist(), 4) for i in range(4)]]),
    }


def _drive(sched, traces, audit=False):
    streams = []
    for trace in traces:
        rids = [sched.submit(p, b) for p, b in trace]
        res = {}
        while sched.queue or any(r is not None for r in sched.slot_req):
            for rid, toks in sched.step().items():
                res.setdefault(rid, []).extend(toks)
            if audit:
                sched.audit()
        streams += [res.get(r, []) for r in rids]
    return streams


def _state(sched):
    """Everything the two schedulers must agree on after a run."""
    return dict(
        hits=sched.prefix_hits, hit_tokens=sched.prefix_hit_tokens,
        computed=sched.prefill_tokens_computed, cow=sched.n_cow_copies,
        dir_evictions=sched.prefix_evictions, evictions=sched.n_evictions,
        directory_pages=sched.directory_pages(),
        peak=sched.peak_pages_in_use,
        directory=[(k, tuple(int(p) for p in v[0]), int(v[1]))
                   for k, v in sched.prefix_dir.items()],
        page_ref=[int(r) for r in sched.page_ref],
        free=[int(p) for p in sched.free_pages])


def _cleared(sched):
    sched.clear_prefix_cache()
    return len(sched.free_pages), int(sched.page_ref.sum())


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every scenario through the JAX Scheduler: name -> (streams, state,
    stats, state after clear_prefix_cache)."""
    jm, jp, _, _ = models
    out = {}
    for name, (kw, traces) in _scenarios().items():
        sched = JS.Scheduler(jm, jp, max_len=MAX_LEN, page_size=PS, **kw)
        streams = _drive(sched, traces)
        out[name] = (streams, _state(sched), sched.stats, _cleared(sched))
    return out


def _port(models, name):
    _, _, tm, tp = models
    kw, traces = _scenarios()[name]
    sched = TS.Scheduler(tm, tp, max_len=MAX_LEN, page_size=PS, **kw)
    return _drive(sched, traces, audit=True), sched


def _matches_jax(models, jax_runs, name):
    """The scenario's port run equals JAX's in streams, state and stats;
    returns (streams, state) of the port."""
    streams, sched = _port(models, name)
    j_streams, j_state, j_stats, j_cleared = jax_runs[name]
    state = _state(sched)
    assert streams == j_streams
    assert state == j_state
    assert sched.stats == {k: j_stats[k] for k in sched.stats}
    assert _cleared(sched) == j_cleared == (sched.num_pages - 1, 0)
    sched.audit()
    return streams, state


def test_sharing_streams_and_counters_match_jax(models, jax_runs):
    off, s_off = _matches_jax(models, jax_runs, "off")
    on, s_on = _matches_jax(models, jax_runs, "on")
    assert on == off
    assert s_on["hits"] == 4 and s_on["hit_tokens"] == 4 * 32
    assert s_on["computed"] == s_off["computed"] - s_on["hit_tokens"]
    assert s_on["peak"] < s_off["peak"]


def test_directory_and_refcounts_match_jax(models, jax_runs):
    """The shared prefix lives in one set of pages, under the same key,
    pages and LRU position as in the reference's directory."""
    _, state = _matches_jax(models, jax_runs, "on")
    prefix = TD.lm_batch(0, 7, 48, 256)[6, :32]
    entry = {k: (p, c) for k, p, c in state["directory"]}[
        TS.Scheduler._prefix_key(prefix)]
    assert entry[1] == 32 and len(entry[0]) == 2
    assert state["directory_pages"] == len(set(
        p for _, pages, _ in state["directory"] for p in pages))


def test_cow_divergence_on_identical_aligned_prompts(models, jax_runs):
    streams, state = _matches_jax(models, jax_runs, "cow")
    assert state["cow"] >= 1 and state["hits"] == 1
    assert streams[0] == streams[1][:8]


def test_retire_keep_exact_prompt_hit(models, jax_runs):
    streams, state = _matches_jax(models, jax_runs, "keep")
    assert state["hits"] == 1 and state["hit_tokens"] == 26
    assert state["cow"] >= 1
    assert streams[0] == streams[1][:6]


def test_eviction_under_sharing_keeps_shared_pages(models, jax_runs):
    _, state = _matches_jax(models, jax_runs, "evict")
    assert state["evictions"] >= 1 and state["hits"] >= 1


def test_directory_lru_eviction_under_cap(models, jax_runs):
    _, state = _matches_jax(models, jax_runs, "lru")
    assert state["directory_pages"] <= 4 and state["dir_evictions"] >= 1


def test_eviction_victim_tie_breaks_by_rid(models):
    """Equal admission stamps break on the highest request id, wherever
    it sits; a younger stamp still wins."""
    _, _, tm, tp = models
    sched = TS.Scheduler(tm, tp, max_batch_slots=3, max_len=32, page_size=16,
                         num_pages=7)
    sched.active[:] = [True, True, True]
    sched._admit_seq[:] = [7, 7, 7]
    sched.slot_req = [TS.Request(5, [1], 4), TS.Request(9, [1], 4),
                      TS.Request(2, [1], 4)]
    assert sched._eviction_victim() == 1
    sched.slot_req[1].rid, sched.slot_req[2].rid = 2, 9
    assert sched._eviction_victim() == 2
    sched._admit_seq[:] = [8, 7, 7]
    assert sched._eviction_victim() == 0


def _random_planes(shape_kv, shape_s, kv_bits, seed):
    rng = np.random.RandomState(seed)
    k = rng.randint(-128, 128, shape_kv).astype(np.int8)
    v = rng.randint(-128, 128, shape_kv).astype(np.int8)
    ks = rng.rand(*shape_s).astype(np.float32)
    vs = rng.rand(*shape_s).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("layers", [None, 3])
def test_copy_pages_bytes_match_jax(kv_bits, layers):
    """Page dst[i] := page src[i] in every plane, in place, equal to JAX's
    `copy_pages` byte for byte (a page both copied from and into reads its
    old bytes)."""
    P, ps, Hkv, Dh = 7, 4, 2, 8
    lead = () if layers is None else (layers,)
    dhp = Dh * kv_bits // 8
    planes = _random_planes(lead + (P, ps, Hkv, dhp), lead + (P, ps, Hkv),
                            kv_bits, 1)
    src, dst = [2, 5, 3], [4, 2, 6]
    axis = 0 if layers is None else 1
    jpool = JA.copy_pages(JA.PagedKVCache(*map(jnp.asarray, planes)),
                          jnp.asarray(src), jnp.asarray(dst), page_axis=axis)
    tpool = TA.PagedKVCache(*map(torch.tensor, planes))
    TA.copy_pages(tpool, torch.tensor(src), torch.tensor(dst), page_axis=axis)
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tpool, f).numpy(),
                                      np.asarray(getattr(jpool, f)))
    assert not np.array_equal(np.asarray(jpool.k_q), planes[0])


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_cache_copy_pages_bytes_match_jax(kv_bits):
    """The all-layer copy of the SMOKE model's pools (the layer-stacked
    "blocks" pools) equals JAX's `cache_copy_pages` byte for byte."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), kv_bits=kv_bits)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), kv_bits=kv_bits)
    jc = jax_build(jcfg).init_cache(2, 32, ragged=True, page_size=8,
                                    num_pages=9)
    tc = build_model(tcfg, "cpu").init_cache(2, 32, page_size=8, num_pages=9)
    fill = []
    for i, (jp, tp) in enumerate(zip(jc["blocks"], tc["blocks"])):
        planes = _random_planes(tp.k_q.shape, tp.k_scale.shape, kv_bits, 10 + i)
        for f, x in zip(("k_q", "v_q", "k_scale", "v_scale"), planes):
            getattr(tp, f).copy_(torch.from_numpy(x))
        fill.append(JA.PagedKVCache(*map(jnp.asarray, planes)))
    jc = dict(jc, blocks=tuple(fill))
    src, dst = [1, 3, 8], [7, 1, 2]
    jc = JT.cache_copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    TT.cache_copy_pages(tc, torch.tensor(src), torch.tensor(dst))
    for jp, tp in zip(jc["blocks"] + jc["tail"], tc["blocks"] + tc["tail"]):
        for f in ("k_q", "v_q", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))
