"""Speculative decoding in the port's Scheduler against the JAX package's,
on the CPU (and one test of kernel 2's served verify rows on the card).

  * the n-gram proposer: the reference's unit cases and hypothesis
    property (`tests/test_speculative.py`), and equal to JAX's proposer;
  * `forward_serve` with `verify_len` and `logit_positions`: every verify
    column of a decode row equals, bit for bit, the single-token step it
    replaces on the port's kernel path, and the (B, P, V) logits agree
    with JAX's kernel path (Pallas in interpret mode) to rel 1e-4;
  * greedy speculative streams equal the non-speculative ones and JAX's
    speculative streams, with equal `spec_*` stats: behavioral path dense,
    paged, with prefix sharing, with fused and paired mixed steps; kernel
    path on one short trace;
  * the accept rule (`spec_accept`) equal to the reference's
    `make_spec_step_fn` on the same logits, greedy and sampled (a stub
    model hands both the logits);
  * sampled speculative streams and stats equal JAX's (rejection sampling
    on the (request, index) key stream), and zero-draft rows equal the
    non-speculative sampler;
  * the adaptive draft length stays within [1, draft_len]; proposals stay
    inside their slot, budget and capacity; the reference's validation
    errors.

SMOKE internlm2-1.8b in float32 at the ideal ADC, parameters from the JAX
package's seeded `init` through `from_jax_params`.  Streams and stats
must be equal; logits against JAX within rel 1e-4 (measured about 5e-7).
The two models' float32 differences can flip an int8 KV code (one of the
prefill's codes here), which moves later logits by about 2e-3: a sampled
draw whose truncation boundary lies that close then parts (ROADMAP.md
§3), so the sampled Scheduler runs use truncations at which this trace's
draws are decided far from it, and the accept rule itself is held on
shared logits.
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
from repro_torch.runtime import prng
from repro_torch.runtime import serve_lib as TS
from repro_torch.runtime.serve_lib import propose_draft_tokens

ARCH = "internlm2-1.8b"
MAX_LEN = 64


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
# the proposer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ctx,k,kw,want", [
    ([5, 6, 7, 8, 5, 6, 7], 4, {}, [8, 5, 6, 7]),        # suffix 3-gram recurs
    ([5, 6, 7, 8, 5, 6, 7], 2, {}, [8, 5]),
    ([1, 2, 9, 1, 2, 8, 1, 2], 1, {}, [8]),              # rightmost match wins
    ([7, 1, 2, 3, 7], 2, dict(max_ngram=3), [1, 2]),     # shorter n-grams
    ([], 4, {}, []), ([3], 4, {}, []), ([1, 2, 3, 4], 0, {}, []),
    ([1, 2, 3, 4, 5], 4, {}, []),                        # nothing repeats
    ([1, 2, 0, 3, 1, 2], 4, dict(eos_id=0), [0]),        # cut at EOS, inclusive
    ([1, 2, 5, 3, 1, 2], 4, dict(eos_id=0), [5, 3, 1, 2]),
])
def test_proposer_cases(ctx, k, kw, want):
    assert propose_draft_tokens(ctx, k, **kw) == want
    assert JS.propose_draft_tokens(ctx, k, **kw) == want


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 30), min_size=0, max_size=60), st.integers(0, 8),
       st.one_of(st.none(), st.integers(0, 30)))
def test_proposer_properties(ctx, k, eos):
    out = propose_draft_tokens(ctx, k, eos_id=eos)
    assert out == propose_draft_tokens(ctx, k, eos_id=eos)       # deterministic
    assert out == JS.propose_draft_tokens(ctx, k, eos_id=eos)    # the reference's
    assert len(out) <= k
    assert set(out) <= set(ctx)                                  # own context only
    if eos is not None and eos in out:
        assert out.index(eos) == len(out) - 1


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------
P = 4
PAGES = [[1, 2, 3, -1], [4, 5, 6, -1], [7, 8, -1, -1]]


def _verify_inputs():
    """Three slots over 8 tokens of KV (row 2 over 6): row 0 verifies its
    token and 3 drafts at position 8, row 1 its token and 1 draft, row 2
    prefills a 4-token chunk at 6.  Returns (context tokens (3, 12), the
    step's (3, 4) tokens, offsets, seq_lens, decode rows, (3, P) logit
    positions)."""
    toks = TD.lm_batch(12, 3, 12, 256)
    step = np.zeros((3, 4), np.int32)
    step[0] = toks[0, 8:12]
    step[1, :2] = toks[1, 8:10]
    step[2] = toks[2, 6:10]
    offs, lens = np.array([8, 8, 6]), np.array([4, 2, 4])
    dec = np.array([True, True, False])
    pos = np.array([[0, 1, 2, 3], [0, 1, 1, 1], [3, 3, 3, 3]])
    return toks, step, offs, lens, dec, pos


def _port_forward(tm, tp, cache, toks, offs, lens, pages=None, **kw):
    t = torch.from_numpy
    return tm.forward_serve(
        tp, {"tokens": t(np.ascontiguousarray(toks)).long()}, cache,
        t(np.asarray(offs, np.int32)), seq_lens=t(np.asarray(lens, np.int32)),
        pages=None if pages is None else t(np.asarray(pages, np.int32)),
        **{k: t(np.asarray(v)) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})


def _seeded(tm, tp, toks, paged):
    cache = (tm.init_cache(3, 32, page_size=8, num_pages=9) if paged
             else tm.init_cache(3, 32, ragged=True))
    _port_forward(tm, tp, cache, toks[:, :8], [0, 0, 0], [8, 8, 6],
                  PAGES if paged else None)
    return cache


def _row_by_row_unembed(params, x):
    """The unembed one row at a time: the CPU's float32 GEMM blocks a row's
    sum differently with the number of rows (on the card
    `layers.unembed_apply` runs products of a fixed row count), so the CPU
    tests unembed row by row to hold the rest of the forward bit for
    bit."""
    w = params["table"].to(x.dtype).t()
    rows = x.reshape(-1, x.shape[-1])
    return torch.cat([rows[i:i + 1] @ w for i in range(rows.shape[0])]).reshape(
        *x.shape[:-1], -1)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_columns_equal_single_token_steps(kernel_models, paged, monkeypatch):
    """On the port's kernel path every verify column of a decode row gets
    the logits of the single-token decode step it replaces, bit for bit,
    and the chunk row those of its separate prefill."""
    monkeypatch.setattr(L, "unembed_apply", _row_by_row_unembed)
    _, tm, tp = kernel_models
    toks, step, offs, lens, dec, pos = _verify_inputs()
    pages = PAGES if paged else None
    with torch.inference_mode():
        lv, _ = _port_forward(tm, tp, _seeded(tm, tp, toks, paged), step, offs, lens,
                              pages, decode_rows=dec, logit_positions=pos, verify_len=P)
        assert tuple(lv.shape) == (3, P, 256)
        cache = _seeded(tm, tp, toks, paged)
        for j in range(P):
            # one token a step for rows 0-1; row 2 idle (length 0)
            one = np.zeros((3, 1), np.int32)
            one[:2, 0] = step[:2, j]
            live = np.array([1, 1 if j < 2 else 0, 0])
            ls, _ = _port_forward(tm, tp, cache, one, [8 + j, 8 + j, 0 if paged else 12],
                                  live, pages)
            assert torch.equal(lv[0, j], ls[0])
            if j < 2:
                assert torch.equal(lv[1, j], ls[1])
        cache = _seeded(tm, tp, toks, paged)
        lp, _ = _port_forward(tm, tp, cache, step, [0 if paged else 12, 0 if paged else 12, 6],
                              [0, 0, 4], pages)
    assert all(torch.equal(lv[2, j], lp[2]) for j in range(P))


def test_verify_forward_matches_jax_kernel_path(models, kernel_models):
    """(B, P, V) logits of a verify forward on the port's kernel path
    (plain versions) against JAX's (Pallas kernels in interpret mode)."""
    _, jp, _, _ = models
    jm, tm, tp = kernel_models
    toks, step, offs, lens, dec, pos = _verify_inputs()
    pages = jnp.asarray(PAGES, jnp.int32)
    jc = jm.init_cache(3, 32, ragged=True, page_size=8, num_pages=9)
    _, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc,
                                jnp.zeros(3, jnp.int32),
                                seq_lens=jnp.asarray([8, 8, 6]), pages=pages)
    jl, _, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(step)}, jc,
                                jnp.asarray(offs, jnp.int32), seq_lens=jnp.asarray(lens),
                                pages=pages, decode_rows=jnp.asarray(dec),
                                logit_positions=jnp.asarray(pos), verify_len=P)
    with torch.inference_mode():
        tl, _ = _port_forward(tm, tp, _seeded(tm, tp, toks, True), step, offs, lens,
                              PAGES, decode_rows=dec, logit_positions=pos, verify_len=P)
    j = np.asarray(jl, np.float64)
    assert tl.shape == j.shape
    assert np.abs(tl.double().numpy() - j).max() / np.abs(j).max() <= 1e-4


# ---------------------------------------------------------------------------
# the accept rule on fixed logits
# ---------------------------------------------------------------------------
class _FixedLogits:
    """A model whose serve forward returns its `params` as the logits: the
    reference's speculative step then applies its accept rule to given
    logits, free of the two models' float differences."""

    def forward_serve(self, params, batch, cache, offset, **kw):
        return params, cache, None


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (0.8, 40, 0.95), (0.5, 2, 1.0), (1.0, 0, 1.0), (0.7, 0, 0.5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_accept_equals_jax_rule(temperature, top_k, top_p, seed):
    """`spec_accept` against the reference's `make_spec_step_fn` on the
    same logits: rows of 4 drafts drawn from the logits' own argmax chain
    (mostly accepted) or at random (mostly rejected), 1-3 drafts, none,
    and a chunk row.  Tokens and accepted counts equal."""
    n, P, V = 6, 5, 64
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, P, V) * 3).astype(np.float32)
    toks = rng.randint(0, V, (n, 8)).astype(np.int32)
    toks[:2, 1:P] = logits[:2, :P - 1].argmax(-1)
    seq = np.array([5, 5, 3, 2, 1, 6])
    dec = np.array([True] * 5 + [False])
    rids, gens = np.arange(n) * 3, rng.randint(0, 40, n)
    fn = JS.make_spec_step_fn(_FixedLogits(), n, 8, P, temperature, top_k, top_p)
    _, out, n_emit, _ = fn(jnp.asarray(logits), jnp.asarray(toks), jnp.zeros(1),
                           jnp.zeros(n, jnp.int32), jnp.asarray(seq), jnp.asarray(dec),
                           jnp.asarray(rids), jnp.asarray(gens), jax.random.PRNGKey(seed),
                           jnp.zeros(n, bool))
    t = torch.from_numpy
    sampling = TS.Sampling(temperature, top_k, top_p, prng.PRNGKey(seed))
    t_out, acc = TS.spec_accept(t(logits), t(toks), t(seq.astype(np.int32)), t(dec),
                                t(rids), t(gens), sampling)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(out))
    np.testing.assert_array_equal(acc.numpy() + 1, np.asarray(n_emit))


# ---------------------------------------------------------------------------
# speculative Scheduler streams
# ---------------------------------------------------------------------------
def _trace(budget=16):
    """Agent-style prompts: a short unit repeated, so the proposer has
    matches from the first step; one prompt cycles 4 tokens."""
    rng = np.random.default_rng(0)
    out = [((rng.integers(5, 40, size=4 + i).tolist()) * 3, budget) for i in range(3)]
    return out + [([7, 8, 9, 10] * 5, 24)]


def _run(sched, trace, audit=False):
    rids = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        if audit:
            sched.audit()
    return [res.get(r, []) for r in rids]


BASE = dict(max_batch_slots=3, decode_chunk=2)
MODES = {
    "dense": {},
    "paged": dict(page_size=8),
    "shared": dict(page_size=8, prefix_sharing=True),
    "mixed_fused": dict(mixed_steps=True, prefill_chunk_budget=4),
    "mixed_paired": dict(page_size=8, mixed_steps=True, prefill_chunk_budget=4,
                         mixed_dispatch="paired"),
}
SAMPLED = {"accepting": dict(temperature=0.5, top_k=2),
           "rejecting": dict(temperature=0.8, top_k=20, top_p=0.9)}
SPEC_RUNS = ([(f"greedy-{m}", m, {}) for m in MODES]
             + [(f"sampled-{s}-{m}", m, kw) for s, kw in SAMPLED.items()
                for m in ("paged", "mixed_fused")])


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every speculative run through the JAX Scheduler: {name: (streams,
    stats)}, with the greedy non-speculative streams of the trace."""
    jm, jp, _, _ = models
    out = {"plain": _run(JS.Scheduler(jm, jp, max_len=MAX_LEN, **BASE), _trace())}
    for name, mode, kw in SPEC_RUNS:
        sched = JS.Scheduler(jm, jp, max_len=MAX_LEN, speculate=True, draft_len=4,
                             rng=jax.random.PRNGKey(11), **BASE, **MODES[mode], **kw)
        out[name] = (_run(sched, _trace()), sched.stats)
    return out


@pytest.mark.parametrize("name,mode,kw", SPEC_RUNS, ids=[r[0] for r in SPEC_RUNS])
def test_spec_scheduler_matches_jax(models, jax_runs, name, mode, kw):
    _, _, tm, tp = models
    sched = TS.Scheduler(tm, tp, max_len=MAX_LEN, speculate=True, draft_len=4,
                         rng=prng.PRNGKey(11), **BASE, **MODES[mode], **kw)
    streams = _run(sched, _trace(), audit=True)
    j_streams, j_stats = jax_runs[name]
    assert streams == j_streams
    st_ = sched.stats
    assert st_ == {k: j_stats[k] for k in st_}
    assert st_["spec_steps"] > 0 and st_["spec_proposed"] > 0
    assert st_["spec_proposed"] == st_["spec_accepted"] + st_["spec_rejected"]
    if not kw:
        assert streams == jax_runs["plain"]            # greedy: bit-identical
        assert st_["spec_accepted"] > 0
    if name.startswith("sampled-accepting"):
        assert st_["spec_accepted"] > 0
    if sched.paged:
        sched.clear_prefix_cache()
        assert len(sched.free_pages) == sched.num_pages - 1


def test_greedy_spec_kernel_path_matches_jax(models, kernel_models):
    """The kernel path (JAX's Pallas kernels in interpret mode, the port's
    plain versions): speculative == non-speculative == JAX, on the pool
    with prefix sharing."""
    jm, tm, tp = kernel_models
    _, jp, _, _ = models
    trace = [(p, 6) for p, _ in _trace()[1:3]]
    kw = dict(max_batch_slots=2, decode_chunk=2, page_size=8, prefix_sharing=True)
    js = JS.Scheduler(jm, jp, max_len=MAX_LEN, speculate=True, draft_len=3, **kw)
    j = _run(js, trace)
    ts = TS.Scheduler(tm, tp, max_len=MAX_LEN, speculate=True, draft_len=3, **kw)
    t = _run(ts, trace, audit=True)
    assert t == j
    assert ts.stats == {k: js.stats[k] for k in ts.stats}
    assert ts.stats["spec_accepted"] > 0
    assert t == _run(TS.Scheduler(tm, tp, max_len=MAX_LEN, **kw), trace)


def test_spec_emits_more_tokens_per_model_step(models):
    _, _, tm, tp = models
    trace = [([7, 8, 9, 10] * 5, 24)]
    kw = dict(max_batch_slots=1, max_len=96, decode_chunk=1)
    s0 = TS.Scheduler(tm, tp, **kw)
    s1 = TS.Scheduler(tm, tp, speculate=True, draft_len=4, **kw)
    assert _run(s0, trace) == _run(s1, trace)
    assert s1.stats["model_steps"] < s0.stats["model_steps"]
    assert s1.stats["spec_accepted"] > 0


def test_zero_draft_rows_equal_the_plain_sampler(models):
    """Budget 1 caps every draft at 0: a speculative scheduler then samples
    exactly the non-speculative stream (the bonus draw uses the plain
    key), as JAX's does."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    trace = [(rng.integers(5, 250, size=9).tolist(), 1) for _ in range(3)]
    kw = dict(max_batch_slots=3, temperature=0.7)
    ref = _run(TS.Scheduler(tm, tp, max_len=MAX_LEN, rng=prng.PRNGKey(5), **kw), trace)
    sched = TS.Scheduler(tm, tp, max_len=MAX_LEN, rng=prng.PRNGKey(5), speculate=True,
                         draft_len=4, **kw)
    assert _run(sched, trace) == ref
    assert sched.stats["spec_proposed"] == 0
    assert ref == _run(JS.Scheduler(jm, jp, max_len=MAX_LEN, rng=jax.random.PRNGKey(5),
                                    speculate=True, draft_len=4, **kw), trace)


def test_adaptive_k_stays_bounded(models):
    _, _, tm, tp = models
    sched = TS.Scheduler(tm, tp, max_batch_slots=1, max_len=96, speculate=True,
                         draft_len=4)
    sched.submit([7, 8, 9, 10] * 5, 24)
    sched.step()
    r = next(q for q in sched.slot_req if q is not None)
    ks = []
    while any(q is not None for q in sched.slot_req):
        sched.step()
        sched.audit()
        if r.spec_k is not None:
            ks.append(r.spec_k)
            assert 1 <= r.spec_k <= 4
    assert ks


def test_proposals_stay_in_their_slot(models):
    """Two slots with disjoint alphabets: each proposal comes from its own
    slot's context and respects the budget and capacity caps."""
    _, _, tm, tp = models
    sched = TS.Scheduler(tm, tp, max_batch_slots=2, max_len=48, speculate=True,
                         draft_len=4)
    sched.submit([5, 6, 7, 5, 6, 7, 5, 6], 8)
    sched.submit([20, 21, 22, 20, 21, 22, 20], 8)
    sched.step()
    for slot in np.flatnonzero(sched.active):
        r = sched.slot_req[slot]
        d = sched._propose(int(slot))
        assert set(d) <= set(r.prompt + r.tokens)
        assert len(d) <= int(sched.remaining[slot]) - 1
        assert len(d) <= sched.max_len - int(sched.lengths[slot]) - 1


def test_validation_errors(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="draft_len"):
        TS.Scheduler(tm, tp, speculate=True, draft_len=0)
    with pytest.raises(ValueError, match="draft_mode"):
        TS.Scheduler(tm, tp, speculate=True, draft_mode="magic")
    with pytest.raises(ValueError, match="continuous_batching"):
        TS.generate(tm, tp, {"tokens": torch.tensor([[1, 2, 3]])}, 4, 32, speculate=True)
    TS.Scheduler(tm, tp, draft_len=0)        # inert without speculate


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel 2 has no CPU build)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [(128, 256), (2048, 92544)])
def test_cuda_unembed_row_bits_do_not_depend_on_row_count(cuda_device, dtype, width):
    """On the card a row's logits take the same bits alone and among 3,
    15, 40 and 70 rows (cuBLAS's own float32 product of 15 rows rounds a
    row otherwise than that of 3)."""
    D, V = width
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(70, D, generator=gen, device=cuda_device).to(dtype)
    head = {"table": torch.randn(V, D, generator=gen, device=cuda_device) * 0.02}
    alone = torch.cat([L.unembed_apply(head, x[i:i + 1]) for i in range(8)])
    for n in (3, 15, 40, 70):
        assert torch.equal(L.unembed_apply(head, x[:n])[:8], alone[:min(n, 8)]), n
    assert torch.equal(L.unembed_apply(head, x[:40].view(8, 5, D)).flatten(0, 1),
                       L.unembed_apply(head, x[:40]))


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_served_verify_rows_equal_single_steps(cuda_device, paged):
    """Kernel 2 serving verify rows (Sq 5 at 4/2 heads: 10 packed rows, two
    row tiles) inside a speculative forward gives each column the logits
    of the single-token step it replaces, bit for bit, on the card."""
    from repro_torch.kernels import _build
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_impl="kernel",
                               compute_dtype="float32", decode_block_k=8)
    tm = build_model(tcfg, cuda_device)
    tp = tm.init(seed=0)
    toks = TD.lm_batch(12, 3, 16, 256)
    pages = torch.tensor([[1, 2, 3, -1], [4, 5, 6, -1], [7, 8, 9, -1]],
                         dtype=torch.int32, device=cuda_device) if paged else None
    d = cuda_device

    def cache_with_context():
        cache = (tm.init_cache(3, 32, page_size=8, num_pages=10) if paged
                 else tm.init_cache(3, 32, ragged=True))
        tm.forward_serve(tp, {"tokens": torch.from_numpy(toks[:, :8]).long().to(d)}, cache,
                         torch.zeros(3, dtype=torch.int32, device=d),
                         seq_lens=torch.full((3,), 8, dtype=torch.int32, device=d),
                         pages=pages)
        return cache

    V = 5
    step = torch.from_numpy(toks[:, 8:8 + V]).long().to(d)
    lens = torch.tensor([5, 3, 1], dtype=torch.int32, device=d)
    offs = torch.full((3,), 8, dtype=torch.int32, device=d)
    pos = torch.minimum(torch.arange(V, device=d)[None, :], (lens - 1)[:, None])
    with torch.inference_mode():
        before = _build.LAUNCHES["pim_decode"]
        lv, _ = tm.forward_serve(tp, {"tokens": step}, cache_with_context(), offs,
                                 seq_lens=lens, pages=pages,
                                 decode_rows=torch.ones(3, dtype=torch.bool, device=d),
                                 logit_positions=pos, verify_len=V)
        assert _build.LAUNCHES["pim_decode"] - before == tcfg.num_layers
        cache = cache_with_context()
        for j in range(V):
            live = (lens > j).int()
            ls, _ = tm.forward_serve(tp, {"tokens": step[:, j:j + 1]}, cache, offs + j,
                                     seq_lens=live, pages=pages)
            for b in range(3):
                if j < int(lens[b]):
                    assert torch.equal(lv[b, j], ls[b]), (b, j)
