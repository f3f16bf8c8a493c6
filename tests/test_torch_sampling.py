"""Sampled streams of the port against the JAX package's, on the CPU.

The sampler draws with the reference's threefry keys
(`repro_torch.runtime.prng`), so at temperature > 0 the port's tokens
equal JAX's token for token, not only in distribution:

  * `sample_logits` (one key for a batch) and `sample_logits_per_row`
    (`_row_keys`: (request id, token index) folded into a base key), with
    top_k and top_p, and the key grids, on fixed logits; the nucleus'
    cumulative sum (`blocked_cumsum`) equal to `jnp.cumsum` bit for bit;
  * the classic `generate` against JAX `generate(..., rng=PRNGKey(s))`;
  * the Scheduler's sampled streams and `stats` against JAX's: dense
    slots, the paged pool, prefix sharing, fused and paired mixed steps,
    and a starved pool that evicts (a continuation re-prefills with the
    same (request, index) keys);
  * the CLI's `--seed`, which seeds the sampler as the JAX CLI does.

SMOKE internlm2-1.8b in float32 at the ideal ADC on the behavioral path,
parameters from the JAX package's seeded `init` through
`from_jax_params`: logits agree with JAX's to about 5e-7 of their range,
far inside the gaps that decide a draw on these traces.  Tolerance: none,
the token streams and stats must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TD
from repro_torch.launch import serve as tserve
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import prng
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
MAX_LEN = 64
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
SEED = 3


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


# ---------------------------------------------------------------------------
# the sampler on fixed logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("V", [5, 16, 17, 256, 1000, 92544])
def test_blocked_cumsum_equals_jax_bit_for_bit(V):
    x = np.random.RandomState(V).rand(3, V).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    np.testing.assert_array_equal(TS.blocked_cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))


TRUNCATIONS = [(0, 1.0), (20, 1.0), (0, 0.9), (50, 0.95), (1, 1.0), (0, 1e-6)]


@pytest.mark.parametrize("top_k,top_p", TRUNCATIONS)
def test_sample_logits_equals_jax(top_k, top_p):
    l = np.random.RandomState(2).randn(4, 256).astype(np.float32) * 3
    l[:, 10] = l[:, 11]                          # a tie
    tl = torch.from_numpy(l)
    for s in range(6):
        j = JS.sample_logits(jnp.asarray(l), jax.random.PRNGKey(s), 0.8, top_k, top_p)
        t = TS.sample_logits(tl, prng.PRNGKey(s), 0.8, top_k, top_p)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(TS.sample_logits(tl, None), torch.argmax(tl, dim=-1))


@pytest.mark.parametrize("top_k,top_p", TRUNCATIONS)
def test_sample_logits_per_row_and_key_grids_equal_jax(top_k, top_p):
    l = np.random.RandomState(3).randn(5, 256).astype(np.float32) * 3
    rids, gens = np.array([0, 5, -1, 7, 2 ** 20]), np.array([0, 3, 2, 9, 40])
    for base in (0, 11):
        jk = JS._row_keys(jax.random.PRNGKey(base), jnp.asarray(rids), jnp.asarray(gens))
        tk = TS._row_keys(prng.PRNGKey(base), torch.from_numpy(rids),
                          torch.from_numpy(gens))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(
            TS.sample_logits_per_row(torch.from_numpy(l), tk, 0.7, top_k, top_p).numpy(),
            np.asarray(JS.sample_logits_per_row(jnp.asarray(l), jk, 0.7, top_k, top_p)))
        jg = JS._row_key_grid(jax.random.PRNGKey(base), jnp.asarray(rids),
                              jnp.asarray(gens), 5)
        tg = TS._row_key_grid(prng.PRNGKey(base), torch.from_numpy(rids),
                              torch.from_numpy(gens), 5)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# classic generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,top_k,top_p", [(5, 20, 0.9), (7, 0, 1.0)])
def test_classic_generate_sampled_equals_jax(models, seed, top_k, top_p):
    jm, jp, tm, tp = models
    toks = TD.lm_batch(1, 2, 8, 256)
    j = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 8, 16, temperature=0.8,
                    top_k=top_k, top_p=top_p, rng=jax.random.PRNGKey(seed))
    t = TS.generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 8, 16,
                    temperature=0.8, top_k=top_k, top_p=top_p,
                    rng=prng.PRNGKey(seed))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert not torch.equal(t, TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks)},
                                                 8, 16))


# ---------------------------------------------------------------------------
# the Scheduler
# ---------------------------------------------------------------------------
def _trace():
    """4 requests: 3 open with one 16-token system prompt (two pages of 8),
    one shares nothing."""
    full = TD.lm_batch(5, 5, 40, 256)
    system = full[0, :16].tolist()
    return [(system + full[1, :6].tolist(), 6), (system + full[2, :12].tolist(), 9),
            (full[3, :9].tolist(), 5), (system + full[4, :14].tolist(), 12)]


def _starved_trace():
    """Two 30-token prompts through 2 slots of a pool of 5 usable pages:
    stalls, then an eviction."""
    full = TD.lm_batch(4, 2, 30, 256)
    return [(full[0].tolist(), 24), (full[1].tolist(), 8)]


SCENARIOS = {
    "dense": (_trace, dict(max_batch_slots=3, decode_chunk=4)),
    "paged": (_trace, dict(max_batch_slots=3, decode_chunk=4, page_size=8)),
    "shared": (_trace, dict(max_batch_slots=3, decode_chunk=4, page_size=8,
                            prefix_sharing=True)),
    "mixed_fused": (_trace, dict(max_batch_slots=3, decode_chunk=4, mixed_steps=True,
                                 prefill_chunk_budget=8)),
    "mixed_paired": (_trace, dict(max_batch_slots=3, decode_chunk=4, page_size=8,
                                  prefix_sharing=True, mixed_steps=True,
                                  prefill_chunk_budget=8, mixed_dispatch="paired")),
    "starved": (_starved_trace, dict(max_batch_slots=2, page_size=16, num_pages=6,
                                     decode_chunk=8)),
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


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every scenario through the JAX Scheduler, sampled: {name: (streams,
    stats)}."""
    jm, jp, _, _ = models
    out = {}
    for name, (trace, kw) in SCENARIOS.items():
        sched = JS.Scheduler(jm, jp, max_len=MAX_LEN, rng=jax.random.PRNGKey(SEED),
                             **SAMPLED, **kw)
        out[name] = (_drive(sched, trace()), sched.stats)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sampled_scheduler_matches_jax(models, jax_runs, name):
    _, _, tm, tp = models
    trace, kw = SCENARIOS[name]
    sched = TS.Scheduler(tm, tp, max_len=MAX_LEN, rng=prng.PRNGKey(SEED), **SAMPLED, **kw)
    streams = _drive(sched, trace(), audit=True)
    j_streams, j_stats = jax_runs[name]
    assert streams == j_streams
    assert [len(s) for s in streams] == [b for _, b in trace()]
    assert sched.stats == {k: j_stats[k] for k in sched.stats}
    if name == "starved":
        assert sched.n_evictions >= 1
    if name == "shared":
        assert sched.prefix_hits >= 2
    if sched.paged:
        sched.clear_prefix_cache()
        assert len(sched.free_pages) == sched.num_pages - 1


def test_sampled_streams_do_not_depend_on_batching(models, jax_runs):
    """A request's tokens depend on its (id, index) keys only: served alone
    through one slot it samples the same stream as among the trace."""
    _, _, tm, tp = models
    trace = _trace()
    alone = TS.Scheduler(tm, tp, max_len=MAX_LEN, max_batch_slots=1, decode_chunk=2,
                         rng=prng.PRNGKey(SEED), **SAMPLED)
    assert _drive(alone, trace) == jax_runs["dense"][0]


def test_generate_continuous_sampled_equals_jax(models):
    jm, jp, tm, tp = models
    toks = TD.lm_batch(0, 3, 8, 256)
    kw = dict(continuous_batching=True, page_size=8, temperature=0.8, top_k=20)
    j = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 6, 32,
                    rng=jax.random.PRNGKey(9), **kw)
    t = TS.generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 6, 32,
                    rng=prng.PRNGKey(9), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_seed_seeds_the_sampler(monkeypatch):
    """`--seed s` samples under PRNGKey(s) (the weights stay those of seed
    0, as in the JAX CLI); another seed gives another stream."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "5", "--temperature", "0.8",
            "--top-k", "20"]
    out7 = tserve.main(args + ["--seed", "7"])
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu")
    toks = torch.from_numpy(TD.lm_batch(0, 2, 8, cfg.vocab_size)).long()
    want = TS.generate(model, model.init(seed=0), {"tokens": toks}, 5, 13,
                       temperature=0.8, top_k=20, rng=prng.PRNGKey(7))
    assert torch.equal(out7, want)
    assert not torch.equal(out7, tserve.main(args + ["--seed", "8"]))
    out = tserve.main(args + ["--seed", "7", "--continuous-batching", "--page-size", "8"])
    assert torch.equal(out, TS.generate(model, model.init(seed=0), {"tokens": toks}, 5, 13,
                                        temperature=0.8, top_k=20, rng=prng.PRNGKey(7),
                                        continuous_batching=True, page_size=8))
