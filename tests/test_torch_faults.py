"""Fault injection and the full `audit()` in the port's Scheduler, against
the JAX package's, on the CPU.

SMOKE internlm2-1.8b in float32 at the ideal ADC on the behavioral path,
parameters from the JAX package's seeded `init` through
`from_jax_params`; greedy throughout.  The port's `FaultPlan` fires from the
reference's stream: the same fires, `fired` counts and rng state for one
sequence of queries.  Each targeted fault of the reference's tests (forced
evictions on the pool and on dense slots, failed allocations, delayed
restores, refcount corruptions that `audit()` must detect, NaN logits on
the decode, paged, speculative and mixed paths) runs once through the JAX
Scheduler (a module-scoped fixture on one set of shapes) and once through
the port's, audited after every step: streams, statuses, overload `stats`
and `fired` must be equal, and the streams equal to the fault-free run's
(the poisoned request's a prefix of it).  A seeded sweep of 25 chaos cases
holds the port against its own fault-free baselines; the crash and the
bit flip of a spilled page fire as JAX's do.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import fault as JF
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TD
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import fault as TF
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
STATS = ("steps", "evictions", "spills", "restores", "spilled_pages",
         "recompute_fallbacks", "refcount_corruptions_detected", "poisoned",
         "victim_pool_pages_used", "spec_steps", "model_steps")


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


def _trace(idx: int):
    base = TD.lm_batch(11 + idx, 6, 24, 256)
    if idx == 0:       # uniform short
        return [(base[i, :6 + i].tolist(), 8) for i in range(4)]
    if idx == 1:       # a 2-page shared prefix and distinct tails
        prefix = base[5, :16].tolist()
        return [(prefix + base[i, :3 + i].tolist(), 10) for i in range(4)]
    # long and short prompts that starve the small pool
    return [(base[i, :4 + 4 * i].tolist(), 12) for i in range(4)]


def _options(paged=True, sharing=False, mixed=False, victim=0, **extra):
    kw = dict(max_batch_slots=2, max_len=48, decode_chunk=4, **extra)
    if paged:
        kw.update(page_size=8, num_pages=7, prefix_sharing=sharing,
                  victim_pool_pages=victim)
    if mixed:
        kw.update(mixed_steps=True, prefill_chunk_budget=8)
    return kw


def _run(mod, model, params, trace, opts, plan_kw, audit):
    plan = None if plan_kw is None else mod.FaultPlan(**plan_kw)
    sched = mod.Scheduler(model, params, fault_plan=plan,
                          audit_every_step=audit, **opts)
    rids = [sched.submit(p, b) for p, b in trace]
    res = sched.run()
    sched.audit()
    state = dict(
        streams=[res.get(r, []) for r in rids],
        results=[sched.results()[r] for r in rids],
        status=[sched.requests[r].status for r in rids],
        stats={k: sched.stats[k] for k in STATS},
        fired=None if plan is None else dict(sched._faults.fired))
    return state, sched


def _cases():
    """name -> (trace index, scheduler options, plan or None)."""
    return {
        "base_paged": (0, _options(), None),
        "evict_paged": (0, _options(victim=32), dict(evict_steps=(2, 3, 5))),
        "base_dense": (0, _options(paged=False), None),
        "evict_dense": (0, _options(paged=False), dict(evict_steps=(2, 4))),
        "base_starved": (2, _options(), None),
        "alloc_fail": (2, _options(victim=32),
                       dict(seed=9, alloc_fail_rate=0.25)),
        "restore_delay": (2, _options(victim=32),
                          dict(seed=4, evict_rate=0.3, restore_delay_rate=0.5)),
        "corrupt": (0, _options(), dict(corrupt_refcount_steps=(1, 2, 3))),
        "nan_dense": (0, _options(paged=False), dict(nan_logit_steps=(2,))),
        "nan_paged": (0, _options(victim=32), dict(nan_logit_steps=(2,))),
        "base_spec": (0, _options(paged=False, speculate=True, draft_len=3),
                      None),
        "nan_spec": (0, _options(paged=False, speculate=True, draft_len=3),
                     dict(nan_logit_steps=(2,))),
        "base_mixed": (1, _options(sharing=True, mixed=True), None),
        "nan_mixed": (1, _options(sharing=True, mixed=True),
                      dict(nan_logit_steps=(2,))),
    }


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, jp, _, _ = models
    return {name: _run(JS, jm, jp, _trace(t), opts, plan, audit=False)[0]
            for name, (t, opts, plan) in _cases().items()}


def _matches_jax(models, jax_runs, name):
    _, _, tm, tp = models
    t, opts, plan = _cases()[name]
    state, sched = _run(TS, tm, tp, _trace(t), opts, plan, audit=True)
    assert state == jax_runs[name]
    return state, sched


# ---------------------------------------------------------------------------
# the plan's stream
# ---------------------------------------------------------------------------
def _queries(state):
    out = []
    for step in range(1, 40):
        out.append((state.force_evict(step), state.fail_alloc(step),
                    state.delay_restore(step), state.corrupt_refcount(step),
                    state.poison_nan(step)))
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=42, evict_rate=0.3, alloc_fail_rate=0.2, restore_delay_rate=0.1),
    dict(seed=7, evict_steps=(3, 9), alloc_fail_rate=0.5,
         corrupt_refcount_steps=(2,), nan_logit_steps=(5,), max_faults=12),
    dict(evict_rate=1.0, max_faults=3)])
def test_faultplan_stream_matches_jax(kw):
    """One sequence of queries fires the same faults in both packages,
    with the same `fired` counts, the same rng state after it and the
    `max_faults` cap; a plan's two states are independent."""
    js, ts = JF.FaultPlan(**kw).start(), TF.FaultPlan(**kw).start()
    assert _queries(ts) == _queries(js)
    assert ts.fired == js.fired
    a, b = ts._rng.get_state(), js._rng.get_state()
    assert a[0] == b[0] and a[2:] == b[2:]
    np.testing.assert_array_equal(a[1], b[1])
    assert _queries(TF.FaultPlan(**kw).start()) == _queries(
        TF.FaultPlan(**kw).start())
    if kw.get("max_faults") == 3:
        assert sum(ts.fired.values()) == 3


# ---------------------------------------------------------------------------
# targeted faults against JAX
# ---------------------------------------------------------------------------
def test_forced_evictions_paged_match_jax(models, jax_runs):
    base, _ = _matches_jax(models, jax_runs, "base_paged")
    state, sched = _matches_jax(models, jax_runs, "evict_paged")
    assert state["fired"]["evict"] >= 1 and state["stats"]["spills"] >= 1
    assert state["streams"] == base["streams"]
    assert not sched._victim


def test_forced_evictions_dense_match_jax(models, jax_runs):
    """Dense slots have no pages to spill: a forced eviction re-queues a
    recompute continuation, and the streams hold."""
    base, _ = _matches_jax(models, jax_runs, "base_dense")
    state, _ = _matches_jax(models, jax_runs, "evict_dense")
    assert state["fired"]["evict"] >= 1
    assert state["streams"] == base["streams"]


def test_alloc_fail_and_restore_delay_match_jax(models, jax_runs):
    base, _ = _matches_jax(models, jax_runs, "base_starved")
    fail, _ = _matches_jax(models, jax_runs, "alloc_fail")
    delay, _ = _matches_jax(models, jax_runs, "restore_delay")
    assert fail["fired"]["alloc_fail"] >= 1
    assert delay["fired"]["evict"] >= 1
    assert fail["streams"] == delay["streams"] == base["streams"]


def test_corrupt_refcount_detected_like_jax(models, jax_runs):
    """Every injected refcount corruption is caught by `audit()` and rolled
    back; the run's streams are the fault-free ones."""
    base, _ = _matches_jax(models, jax_runs, "base_paged")
    state, _ = _matches_jax(models, jax_runs, "corrupt")
    assert state["fired"]["corrupt"] == 3
    assert 1 <= state["stats"]["refcount_corruptions_detected"] <= 3
    assert state["streams"] == base["streams"]


@pytest.mark.parametrize("name,base", [("nan_dense", "base_dense"),
                                       ("nan_paged", "base_paged"),
                                       ("nan_spec", "base_spec"),
                                       ("nan_mixed", "base_mixed")])
def test_nan_poison_quarantines_one_request_like_jax(models, jax_runs, name,
                                                     base):
    """NaN logits at step 2 retire only the occupied request with the lowest
    rid (`status="poisoned"`, its tokens a prefix of the fault-free
    stream, no sentinel); every other request equals the fault-free run."""
    clean, _ = _matches_jax(models, jax_runs, base)
    state, _ = _matches_jax(models, jax_runs, name)
    assert state["status"][0] == "poisoned"
    assert state["status"][1:] == ["done"] * 3
    assert state["stats"]["poisoned"] == 1 and state["fired"]["nan"] == 1
    assert state["results"][1:] == clean["results"][1:]
    got = state["results"][0]
    assert got == clean["results"][0][:len(got)] and all(t >= 0 for t in got)


# ---------------------------------------------------------------------------
# chaos sweep, port only
# ---------------------------------------------------------------------------
def test_scheduler_chaos_sweep(models):
    """25 seeded cases over every class (dense / paged x sharing x mixed x
    victim pool) with random fault rates, audited after every step: the
    streams equal the fault-free baseline's, and the end state drains (no
    leaked page, an empty victim pool)."""
    _, _, tm, tp = models
    baselines = {}
    rng = np.random.RandomState(1234)
    for i in range(25):
        t, paged = i % 3, (i % 4) != 3
        sharing, mixed = bool(i & 1) and paged, bool(i & 2)
        key = (t, paged, sharing, mixed)
        if key not in baselines:
            baselines[key] = _run(TS, tm, tp, _trace(t),
                                  _options(paged, sharing, mixed), None,
                                  audit=False)[0]["streams"]
        plan = dict(seed=int(rng.randint(0, 10_000)),
                    evict_rate=float(rng.uniform(0.0, 0.4)),
                    alloc_fail_rate=float(rng.uniform(0.0, 0.25)),
                    restore_delay_rate=float(rng.uniform(0.0, 0.4)),
                    corrupt_refcount_steps=(2, 5) if i % 3 == 1 else (),
                    max_faults=64)
        victim = 32 if (i % 5) and paged else 0
        state, s = _run(TS, tm, tp, _trace(t),
                        _options(paged, sharing, mixed, victim), plan,
                        audit=True)
        assert state["streams"] == baselines[key], i
        if paged:
            s.clear_prefix_cache()
            s.audit()
            assert len(s.free_pages) == s.num_pages - 1
            assert int(s.page_ref.sum()) == 0
        assert s._victim_used == 0 and not s._victim


# ---------------------------------------------------------------------------
# what the port refuses, and the audit switch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(crash_at_step=3),
                                dict(evict_steps=(2,),
                                     bitflip_spilled_page_steps=(2,))],
                         ids=["crash", "bitflip"])
def test_recovery_faults_fire_like_jax(models, kw):
    """The recovery faults as JAX's Scheduler fires them: the crash at the
    start of its step (one `CrashInjected`, no token of that step), a
    spilled page's bit flip detected at the restore under integrity."""
    jm, jp, tm, tp = models
    opts = _options(victim=8, integrity="checksum")
    got = []
    for mod, model, params in ((TS, tm, tp), (JS, jm, jp)):
        sched = mod.Scheduler(model, params, fault_plan=mod.FaultPlan(**kw),
                              **opts)
        for p, b in _trace(0):
            sched.submit(p, b)
        try:
            sched.run()
            crashed = None
        except (TF.CrashInjected, JF.CrashInjected) as e:
            crashed = str(e)
        got.append((crashed, sched.results(), dict(sched._faults.fired),
                    sched.stats["corruptions_detected"],
                    sched.stats["bitflips_injected"]))
    assert got[0] == got[1]
    fired = got[0][2]
    assert fired["crash"] + fired["bitflip"] == 1
    if "crash_at_step" in kw:
        assert got[0][0] == "injected crash at step 3"
    else:
        assert got[0][3] == got[0][4] == 1


def test_audit_every_step_defaults_from_environment(models, monkeypatch):
    """`audit_every_step=None` reads REPRO_AUDIT, as the reference does, and
    an audited run catches a refcount broken between steps."""
    _, _, tm, tp = models
    monkeypatch.setenv("REPRO_AUDIT", "1")
    s = TS.Scheduler(tm, tp, **_options())
    assert s._audit_every
    s.submit(_trace(0)[0][0], 8)
    s.step()
    s.page_ref[int(s.page_table[0, 0])] += 1
    with pytest.raises(TS.AuditError, match="refcount"):
        s.step()
    monkeypatch.setenv("REPRO_AUDIT", "0")
    assert not TS.Scheduler(tm, tp, **_options())._audit_every
