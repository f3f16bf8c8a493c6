"""Chunked prefill and mixed prefill+decode steps in the port's Scheduler,
against the JAX package's, on the CPU.

SMOKE internlm2-1.8b in float32 at the ideal ADC, parameters from the JAX
package's seeded `init` through `from_jax_params`.  The scheduler
scenarios of the reference's chunked-prefill tests run on the behavioral
path, once through the JAX Scheduler (a module-scoped fixture, one cache
length and one chunk budget so that JAX compiles few shapes) and once
through the port's, audited after every step: dense fused, paged fused and
paged paired mixed steps, mixed steps with prefix sharing and a deferred
admission, a starved pool, and a long prompt prefilled while another slot
decodes.  Streams, counters and stats must be equal, and equal to
`mixed_steps=False`.  Also: `plan_prefill_chunk` against JAX's over a
hypothesis grid, one mixed forward (`decode_rows`) against separate
dispatches on the port's kernel path bit for bit and against JAX's kernel
path in interpret mode, and the port's kernel path holding sharing on ==
off == mixed fused == mixed paired bit for bit.  On the card (`gpu`): a
row's RMSNorm takes the same bits whatever the number of rows beside it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_config
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TD
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
MAX_LEN = 64
BUDGET = 8
PS = 16


def _cfgs(impl):
    kw = dict(attn_impl=impl, compute_dtype="float32")
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


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
    """(jax model, jax params, port model, port params), behavioral."""
    jcfg, tcfg = _cfgs("behavioral")
    jm = jax_build(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg, "cpu")
    return jm, jp, tm, from_jax_params(jp, tcfg, "cpu")


@pytest.fixture(scope="module")
def kernel_models(models):
    """(jax model, port model, port params) on the kernel path."""
    _, jp, _, _ = models
    jcfg, tcfg = _cfgs("kernel")
    return jax_build(jcfg), build_model(tcfg, "cpu"), from_jax_params(jp, tcfg, "cpu")


# ---------------------------------------------------------------------------
# the chunk planner
# ---------------------------------------------------------------------------
def _plan(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@settings(max_examples=300, deadline=None)
@given(p_len=st.integers(0, 600), start=st.integers(-2, 610),
       budget=st.integers(-2, 128), page_size=st.integers(0, 64))
def test_plan_prefill_chunk_matches_jax(p_len, start, budget, page_size):
    args = (start, p_len, budget, page_size)
    assert _plan(TS.plan_prefill_chunk, *args) == _plan(JS.plan_prefill_chunk, *args)


def test_plan_prefill_chunk_covers_a_prompt_once():
    """From a prefix hit at 5, budget 16, pages of 8: interior boundaries on
    pages, every token once."""
    pos, chunks = 5, []
    while pos < 61:
        end = TS.plan_prefill_chunk(pos, 61, 16, 8)
        chunks.append((pos, end))
        pos = end
    assert chunks == [(5, 16), (16, 32), (32, 48), (48, 61)]
    with pytest.raises(ValueError):
        TS.plan_prefill_chunk(5, 5, 4)
    with pytest.raises(ValueError):
        TS.plan_prefill_chunk(0, 5, 0)


# ---------------------------------------------------------------------------
# scheduler scenarios against JAX
# ---------------------------------------------------------------------------
def _scenarios():
    """name -> (scheduler options, trace)."""
    full = TD.lm_batch(1, 4, 24, 256)
    trace = [(full[i, :n].tolist(), b)
             for i, (n, b) in enumerate(zip([5, 17, 24, 9], [4, 7, 10, 13]))]
    base = TD.lm_batch(0, 7, 48, 256)
    prefix = base[6, :32].tolist()
    shared = [(prefix + base[i, :5 + i].tolist(), 6 + i) for i in range(5)]
    twins = [(prefix + base[0, :3].tolist(), 4)] * 2
    starved = TD.lm_batch(4, 3, 24, 256)
    mixed = dict(mixed_steps=True, prefill_chunk_budget=BUDGET)
    two = dict(max_batch_slots=2)
    share = dict(max_batch_slots=3, page_size=PS, num_pages=40,
                 prefix_sharing=True)
    pool = dict(max_batch_slots=3, page_size=8, num_pages=10)
    return {
        "dense": (two, trace),
        "dense_fused": (dict(two, **mixed), trace),
        "paged": (dict(two, page_size=PS), trace),
        "paged_fused": (dict(two, page_size=PS, **mixed), trace),
        "paged_paired": (dict(two, page_size=PS, mixed_dispatch="paired",
                              **mixed), trace),
        "share": (share, shared),
        "share_fused": (dict(share, **mixed), shared),
        # the second twin defers until the first's chunked prefill
        # registers the prefix, then maps it
        "defer": (dict(share, **mixed), twins),
        "starved": (pool, [(starved[i, :16 + 4 * i].tolist(), 14)
                           for i in range(3)]),
        "starved_fused": (dict(pool, **mixed),
                          [(starved[i, :16 + 4 * i].tolist(), 14)
                           for i in range(3)]),
    }


def _drive(sched, trace, audit=False):
    rids = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        if audit:
            sched.audit()
    return [res.get(r, []) for r in rids]


def _state(sched):
    state = dict(computed=sched.prefill_tokens_computed,
                 hits=sched.prefix_hits, hit_tokens=sched.prefix_hit_tokens,
                 cow=sched.n_cow_copies, evictions=sched.n_evictions)
    if sched.paged:
        state.update(peak=sched.peak_pages_in_use,
                     page_ref=[int(r) for r in sched.page_ref],
                     free=[int(p) for p in sched.free_pages])
    return state


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every scenario through the JAX Scheduler: name -> (streams, state,
    stats)."""
    jm, jp, _, _ = models
    out = {}
    for name, (kw, trace) in _scenarios().items():
        sched = JS.Scheduler(jm, jp, max_len=MAX_LEN, decode_chunk=4, **kw)
        out[name] = (_drive(sched, trace), _state(sched), sched.stats)
    return out


def _matches_jax(models, jax_runs, name):
    _, _, tm, tp = models
    kw, trace = _scenarios()[name]
    sched = TS.Scheduler(tm, tp, max_len=MAX_LEN, decode_chunk=4, **kw)
    streams = _drive(sched, trace, audit=True)
    j_streams, j_state, j_stats = jax_runs[name]
    assert streams == j_streams
    assert _state(sched) == j_state
    assert sched.stats == {k: j_stats[k] for k in sched.stats}
    return streams, _state(sched)


@pytest.mark.parametrize("storage,dispatch", [
    ("dense", "fused"), ("paged", "fused"), ("paged", "paired")])
def test_mixed_steps_match_jax_and_unmixed(models, jax_runs, storage, dispatch):
    base, s0 = _matches_jax(models, jax_runs, storage)
    mixed, s1 = _matches_jax(models, jax_runs, f"{storage}_{dispatch}")
    assert mixed == base
    assert s1["computed"] == s0["computed"] == sum(
        len(p) for p, _ in _scenarios()[storage][1])


def test_mixed_prefix_sharing_and_deferral_match_jax(models, jax_runs):
    on, s_on = _matches_jax(models, jax_runs, "share")
    mixed, s_mix = _matches_jax(models, jax_runs, "share_fused")
    assert mixed == on
    assert s_mix["hits"] == s_on["hits"] == 4
    assert s_mix["hit_tokens"] == s_on["hit_tokens"]
    assert s_mix["computed"] == s_on["computed"]
    twins, s2 = _matches_jax(models, jax_runs, "defer")
    assert twins[0] == twins[1]
    assert s2["hits"] == 1 and s2["hit_tokens"] == 32


def test_mixed_starved_pool_matches_jax(models, jax_runs):
    base, _ = _matches_jax(models, jax_runs, "starved")
    mixed, s1 = _matches_jax(models, jax_runs, "starved_fused")
    assert mixed == base
    assert s1["evictions"] > 0


def _interleave(sched, full):
    """Slot 0 decodes a 40-token budget; a 48-token prompt arrives.
    Returns (per-step emissions, steps before the prompt's first token,
    slot 0's tokens meanwhile, the prompt's stream)."""
    ra = sched.submit(full[0, :8].tolist(), 40)
    log, got_a = [], []
    while len(got_a) < 3:
        em = sched.step()
        log.append(em)
        got_a += em.get(ra, [])
    rc = sched.submit(full[1].tolist(), 4)
    before, a_during, got_c = 0, 0, []
    while not got_c:
        em = sched.step()
        log.append(em)
        got_c += em.get(rc, [])
        if not got_c:
            before += 1
            a_during += len(em.get(ra, []))
    while sched.queue or any(r is not None for r in sched.slot_req):
        em = sched.step()
        log.append(em)
        got_c += em.get(rc, [])
    return log, before, a_during, got_c


def test_long_prompt_interleaves_with_decode_like_jax(models):
    """While a 48-token prompt is prefilled in chunks of 8, the decoding
    slot emits on every step but the last chunk's, step for step as in the
    reference, and the prompt's stream equals classic greedy."""
    jm, jp, tm, tp = models
    full = TD.lm_batch(6, 2, 48, 256)
    kw = dict(max_batch_slots=2, max_len=MAX_LEN, decode_chunk=4,
              mixed_steps=True, prefill_chunk_budget=BUDGET)
    j = _interleave(JS.Scheduler(jm, jp, **kw), full)
    t = _interleave(TS.Scheduler(tm, tp, **kw), full)
    assert t == j
    _, before, a_during, got_c = t
    assert before >= 5 and a_during >= before - 1
    ref = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(full[1:2]).long()},
                             4, MAX_LEN)[0].tolist()
    assert got_c == ref


# ---------------------------------------------------------------------------
# one mixed forward
# ---------------------------------------------------------------------------
def _mixed_inputs():
    """Row 0 decodes token 8, row 1 prefills [8, 12), both over 8 tokens
    of KV: (tokens (2, 16), mixed (2, 4) batch)."""
    toks = TD.lm_batch(9, 2, 16, 256)
    batch = np.zeros((2, 4), np.int32)
    batch[0, 0] = toks[0, 8]
    batch[1, :4] = toks[1, 8:12]
    return toks, batch


def _port_forward(tm, tp, cache, toks, offs, lens, pages=None, dec=None):
    t = torch.from_numpy
    return tm.forward_serve(
        tp, {"tokens": t(np.ascontiguousarray(toks)).long()}, cache,
        t(np.asarray(offs, np.int32)), seq_lens=t(np.asarray(lens, np.int32)),
        pages=None if pages is None else t(np.asarray(pages, np.int32)),
        decode_rows=None if dec is None else t(np.asarray(dec)))


PAGES = [[1, 2, 3, -1], [4, 5, 6, -1]]


@pytest.mark.parametrize("paged", [False, True])
def test_forward_decode_rows_equals_separate_dispatches(kernel_models, paged):
    """On the port's kernel path one mixed forward gives, bit for bit, the
    logits (and, paged, the pool bytes outside the trash page) of a
    separate decode dispatch and a separate prefill dispatch."""
    _, tm, tp = kernel_models
    toks, batch = _mixed_inputs()
    pages = PAGES if paged else None

    def seeded():
        cache = (tm.init_cache(2, 32, page_size=8, num_pages=9) if paged
                 else tm.init_cache(2, 32, ragged=True))
        _port_forward(tm, tp, cache, toks[:, :8], [0, 0], [8, 8], pages)
        return cache

    with torch.inference_mode():
        cache_m = seeded()
        lm, _ = _port_forward(tm, tp, cache_m, batch, [8, 8], [1, 4], pages,
                              [True, False])
        cache_s = seeded()
        # the idle row of each separate dispatch writes nothing it keeps:
        # to the trash page (paged), or past its row's fill (dense)
        ld, _ = _port_forward(tm, tp, cache_s, batch[:, :1], [8, 8 if paged else 12],
                              [1, 0], pages)
        lp, _ = _port_forward(tm, tp, cache_s, batch, [0 if paged else 9, 8],
                              [0, 4], pages)
    assert torch.equal(lm[0], ld[0]) and torch.equal(lm[1], lp[1])
    if paged:
        for key in ("blocks", "tail"):
            for a, b in zip(cache_m[key], cache_s[key]):
                for f in ("k_q", "v_q", "k_scale", "v_scale"):
                    assert torch.equal(getattr(a, f)[:, 1:], getattr(b, f)[:, 1:])


def test_forward_decode_rows_matches_jax_kernel_path(models, kernel_models):
    """The mixed forward's logits on the port's kernel path (plain
    versions) against JAX's (Pallas kernels in interpret mode)."""
    _, jp, _, _ = models
    jm, tm, tp = kernel_models
    toks, batch = _mixed_inputs()
    pages = jnp.asarray(PAGES, jnp.int32)
    jc = jm.init_cache(2, 32, ragged=True, page_size=8, num_pages=9)
    _, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc,
                                jnp.zeros(2, jnp.int32),
                                seq_lens=jnp.asarray([8, 8]), pages=pages)
    jl, _, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(batch)}, jc,
                                jnp.asarray([8, 8], jnp.int32),
                                seq_lens=jnp.asarray([1, 4]), pages=pages,
                                decode_rows=jnp.asarray([True, False]))
    with torch.inference_mode():
        tc = tm.init_cache(2, 32, page_size=8, num_pages=9)
        _port_forward(tm, tp, tc, toks[:, :8], [0, 0], [8, 8], PAGES)
        tl, _ = _port_forward(tm, tp, tc, batch, [8, 8], [1, 4], PAGES,
                              [True, False])
    j = np.asarray(jl, np.float64)
    assert np.abs(tl.double().numpy() - j).max() / np.abs(j).max() <= 1e-4


def test_kernel_path_sharing_and_mixed_identities(kernel_models):
    """The port's kernel path: streams with sharing on == off == mixed
    fused == mixed paired on the pool, and dense fused == dense, bit for
    bit (a shared prefix of two 8-token pages, one exact duplicate)."""
    _, tm, tp = kernel_models
    base = TD.lm_batch(3, 3, 24, 256)
    prefix = base[2, :16].tolist()
    trace = [(prefix + base[0, :3].tolist(), 5), (base[1, :20].tolist(), 4),
             (prefix + base[0, 3:7].tolist(), 6),
             (prefix + base[0, :3].tolist(), 3)]
    kw = dict(max_batch_slots=2, max_len=48, decode_chunk=4)
    paged = dict(kw, page_size=8)
    mixed = dict(mixed_steps=True, prefill_chunk_budget=BUDGET)

    def serve(**extra):
        sched = TS.Scheduler(tm, tp, **extra)
        return _drive(sched, trace, audit=True), sched

    off, _ = serve(**paged)
    on, s_on = serve(**paged, prefix_sharing=True)
    fused, _ = serve(**paged, prefix_sharing=True, **mixed)
    paired, _ = serve(**paged, prefix_sharing=True, mixed_dispatch="paired",
                      **mixed)
    assert on == off == fused == paired
    assert s_on.prefix_hits >= 2 and s_on.n_cow_copies >= 1
    dense, _ = serve(**kw)
    dense_fused, _ = serve(**kw, **mixed)
    assert dense_fused == dense


# ---------------------------------------------------------------------------
# a row's bits do not depend on the rows batched with it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 7, 2047, 2048])
def test_pairwise_row_sum_is_a_fixed_order_sum(n):
    """The card's RMSNorm sums a row by halving it (`pairwise_row_sum`):
    within float32 rounding of the exact sum, at odd widths too, and a
    row's bits are the same alone or among other rows."""
    x = torch.from_numpy(np.random.RandomState(n).randn(5, n).astype(np.float32))
    s = L.pairwise_row_sum(x)
    assert s.shape == (5, 1)
    np.testing.assert_allclose(s[:, 0].double().numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    for i in range(5):
        assert torch.equal(L.pairwise_row_sum(x[i:i + 1]), s[i:i + 1])


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_norm_row_bits_do_not_depend_on_row_count(cuda_device):
    """On the card a row's RMSNorm is bit-equal alone and among 8, 64 and
    2048 rows: torch's mean split rows differently with the row count, and
    a decode row in a fused mixed step (8 x 256 rows) took other bits than
    in a decode step (8 rows), which parted a served stream."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(2048, 2048, generator=gen, device=cuda_device)
         * torch.rand(2048, 1, generator=gen, device=cuda_device) * 8).to(torch.bfloat16)
    scale = {"scale": torch.rand(2048, generator=gen, device=cuda_device) + 0.5}
    alone = torch.cat([L.norm_apply(scale, x[i:i + 1], "rmsnorm") for i in range(8)])
    for n in (8, 64, 2048):
        assert torch.equal(L.norm_apply(scale, x[:n], "rmsnorm")[:8], alone)
