"""Crash recovery, KV-page integrity and the SLA ladder in the port's
Scheduler, against the JAX package's, on the CPU.

SMOKE internlm2-1.8b in float32 at the ideal ADC, parameters from the JAX
package's seeded `init` through `from_jax_params`, the port on one torch
thread.  One trace and one set of shapes per scheduler kind, so that JAX
compiles few functions:

  * `snapshot()` / `restore()`: a run with periodic snapshots crashes at a
    planned step (`CrashInjected`), a fresh scheduler of the same
    configuration restores the newest snapshot and runs out, and its
    streams equal the uncrashed run's, on dense slots, the paged pool,
    sharing + sampling, mixed steps, speculation, 4-bit KV, the kernel
    path and with a victim record inside the snapshot; each uncrashed run
    equals JAX's Scheduler on the same trace;
  * a snapshot of another configuration is refused, snapshots need a
    directory;
  * integrity: a bit flipped in a spilled page is detected and the request
    recomputed, with `stats` equal to JAX's; the paranoid audit catches a
    flipped victim byte; a quarantined prefix never re-enters the
    directory; integrity needs a paged cache;
  * the ladder escalates and releases on an injected clock with the
    transitions of JAX's, streams bit-identical, off by default;
  * the new faults fire as JAX's do (`fired`, rng state);
  * `page_checksums` / `cache_page_checksums` equal JAX's crcs at kv8 and
    kv4, on the live pool and on a fetched tree.
On the card (`gpu`): a snapshot / restore round trip on the kernel path.
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
from repro.runtime import fault as JF
from repro.runtime import serve_lib as JS
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.core import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import fault as TF
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [2, 4, 6, 8, 10, 12], [3, 1, 4],
           [9, 9, 9, 9], [5, 4, 3, 2, 1, 6, 7]]
PLANES = ("k_q", "v_q", "k_scale", "v_scale")
BASE = dict(max_batch_slots=2, max_len=48, decode_chunk=4)
PAGED = dict(page_size=8, num_pages=40)
SAMPLED = dict(temperature=0.8, top_k=20)
STATS = ("steps", "model_steps", "evictions", "spills", "restores",
         "spilled_pages", "recompute_fallbacks", "corruptions_detected",
         "bitflips_injected", "poisoned", "quarantined_prefixes",
         "ladder_level", "ladder_escalations", "ladder_deescalations",
         "ladder_paused_steps", "ladder_transitions", "spec_steps")


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
    """{impl: (jax model, jax params, port model, port params)}."""
    jp, out = None, {}
    for impl in ("behavioral", "kernel"):
        kw = dict(attn_impl=impl, compute_dtype="float32")
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
        jm = jax_build(jcfg)
        if jp is None:
            jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        out[impl] = (jm, jp, build_model(tcfg, "cpu"),
                     from_jax_params(jp, tcfg, "cpu"))
    return out


def _sched(mod, model, params, n_req=4, budget=8, **kw):
    kw = dict(BASE, **kw)
    if "temperature" in kw:
        seed = kw.pop("seed", 7)
        kw["rng"] = (jax.random.PRNGKey(seed) if mod is JS
                     else TS.prng.PRNGKey(seed))
    if kw.get("fault_plan") is not None:
        kw["fault_plan"] = mod.FaultPlan(**kw["fault_plan"])
    s = mod.Scheduler(model, params, **kw)
    for p in PROMPTS[:n_req]:
        s.submit(p, budget)
    return s


def _state(s):
    st = s.stats
    return dict(results=s.results(),
                status={r: q.status for r, q in s.requests.items()},
                stats={k: st[k] for k in STATS},
                fired=None if s._faults is None else dict(s._faults.fired))


# name -> (impl, options): each crashes at step 3 after snapshots every 2
ROUNDTRIPS = {
    "dense": ("behavioral", {}),
    "paged": ("behavioral", PAGED),
    "sharing_sampled": ("behavioral", dict(PAGED, prefix_sharing=True,
                                           integrity="checksum", **SAMPLED)),
    "mixed": ("behavioral", dict(PAGED, prefix_sharing=True, mixed_steps=True,
                                 prefill_chunk_budget=4, n_req=6, budget=10)),
    "speculative": ("behavioral", dict(speculate=True, draft_len=3, n_req=6,
                                       budget=10)),
    "kv4": ("behavioral", dict(PAGED, kv_bits=4)),
    "kernel": ("kernel", dict(PAGED, prefix_sharing=True, **SAMPLED)),
}
MID_SPILL = dict(page_size=8, num_pages=24, victim_pool_pages=16,
                 integrity="checksum", n_req=3, budget=10)


@pytest.fixture(scope="module")
def jax_runs(models):
    """name -> `_state` of the uncrashed run through JAX's Scheduler."""
    out = {}
    for name, (impl, opts) in ROUNDTRIPS.items():
        jm, jp, _, _ = models[impl]
        s = _sched(JS, jm, jp, **opts)
        s.run()
        out[name] = _state(s)
    jm, jp, _, _ = models["behavioral"]
    s = _sched(JS, jm, jp, fault_plan=dict(evict_steps=(2,)), **MID_SPILL)
    s.run()
    out["mid_spill"] = _state(s)
    return out


def _roundtrip(tm, tp, tmp_path, crash_at=3, every=2, plan=None,
               restored=None, **opts):
    """(uncrashed scheduler, restored scheduler, crashed scheduler): a run
    with snapshots every `every` steps crashes at `crash_at`, a fresh
    scheduler restores the newest snapshot (`restored(it)` looks at it
    then) and runs out."""
    plan = dict(plan or {})
    ref = _sched(TS, tm, tp, audit_every_step=True,
                 fault_plan=plan or None, **opts)
    ref.run()
    d = str(tmp_path / "snap")
    crash_plan = dict(plan, crash_at_step=crash_at)
    crash = _sched(TS, tm, tp, audit_every_step=True, snapshot_dir=d,
                   snapshot_every=every, fault_plan=crash_plan, **opts)
    with pytest.raises(TF.CrashInjected):
        crash.run()
    assert crash._faults.fired["crash"] == 1
    s2 = _sched(TS, tm, tp, audit_every_step=True, snapshot_dir=d,
                snapshot_every=every, fault_plan=crash_plan, **opts)
    step = s2.restore()
    assert step == tckpt.latest_step(d) >= 1
    if restored is not None:
        restored(s2)
    s2.run()                               # the plan's crash never fires again
    assert s2.results() == ref.results()
    assert {r: q.status for r, q in s2.requests.items()} == \
        {r: q.status for r, q in ref.requests.items()}
    s2.audit()
    return ref, s2, crash


@pytest.mark.parametrize("name", list(ROUNDTRIPS))
def test_crash_restore_round_trip(models, jax_runs, tmp_path, name):
    impl, opts = ROUNDTRIPS[name]
    _, _, tm, tp = models[impl]
    ref, s2, _ = _roundtrip(tm, tp, tmp_path, **opts)
    assert _state(ref) == jax_runs[name]
    assert s2.stats["snapshots"] >= 1
    if ref.paged:
        s2.clear_prefix_cache()
        assert s2.pages_in_use() == 0 and not s2._victim


def test_crash_restore_mid_spill(models, jax_runs, tmp_path):
    """A snapshot taken while a victim record is live carries its host
    bytes: the restored run restores the continuation from the record."""
    _, _, tm, tp = models["behavioral"]
    held = []

    def restored(s):
        held.extend((r.n_host, len(r.crcs)) for r in s._victim.values())

    ref, s2, crash = _roundtrip(tm, tp, tmp_path, every=1,
                                plan=dict(evict_steps=(2,)), restored=restored,
                                **MID_SPILL)
    assert crash.n_spills >= 1 and ref.n_restores >= 1
    assert held and all(n == c > 0 for n, c in held)
    assert s2.n_restores == ref.n_restores and s2.n_recompute_fallbacks == 0
    assert _state(ref) == jax_runs["mid_spill"]


def test_restore_refuses_config_mismatch(models, tmp_path):
    _, _, tm, tp = models["behavioral"]
    d = str(tmp_path / "snap")
    s = _sched(TS, tm, tp, snapshot_dir=d, **PAGED)
    s.step()
    s.snapshot()
    other = _sched(TS, tm, tp, snapshot_dir=d, temperature=0.5, **PAGED)
    with pytest.raises(ValueError, match="config mismatch"):
        other.restore()
    kv4 = _sched(TS, tm, tp, snapshot_dir=d, kv_bits=4, **PAGED)
    with pytest.raises(ValueError):
        kv4.restore()
    with pytest.raises(FileNotFoundError):
        _sched(TS, tm, tp).restore(str(tmp_path / "empty"))


def test_generate_restore_from_continues(models, tmp_path):
    """`generate(restore_from=...)` resumes a snapshot, then serves its own
    batch: the snapshot's requests finish as in an uncrashed run."""
    _, _, tm, tp = models["behavioral"]
    d = str(tmp_path / "snap")
    ref = _sched(TS, tm, tp, **PAGED)
    ref.run()
    s = _sched(TS, tm, tp, snapshot_dir=d, **PAGED)
    s.step()
    s.snapshot()
    batch = {"tokens": torch.tensor([PROMPTS[4]])}
    out = TS.generate(tm, tp, batch, 4, 48, continuous_batching=True,
                      max_batch_slots=2, decode_chunk=4, restore_from=d,
                      snapshot_dir=d, **PAGED)
    assert out.shape == (1, 4)
    s2 = _sched(TS, tm, tp, snapshot_dir=d, **PAGED)
    s2.restore()
    s2.run()
    assert s2.results() == ref.results()


# ---------------------------------------------------------------------------
# integrity: checksums, bit flips, quarantine
# ---------------------------------------------------------------------------
def _spill_sched(mod, model, params, **kw):
    s = mod.Scheduler(
        model, params, max_batch_slots=2, max_len=48, decode_chunk=4,
        page_size=8, num_pages=24, victim_pool_pages=16, temperature=0.8,
        top_k=20, rng=(jax.random.PRNGKey(3) if mod is JS
                       else TS.prng.PRNGKey(3)),
        **{k: (mod.FaultPlan(**v) if k == "fault_plan" else v)
           for k, v in kw.items()})
    for p in [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [7, 8, 9, 10, 11, 12],
              [2, 4, 6]]:
        s.submit(p, 10)
    return s


FLIP = dict(evict_steps=(2,), bitflip_spilled_page_steps=(2,))


@pytest.fixture(scope="module")
def jax_flips(models):
    jm, jp, _, _ = models["behavioral"]
    out = {}
    for name, kw in (("base", dict(integrity="checksum",
                                   fault_plan=dict(evict_steps=(2,)))),
                     ("flip", dict(integrity="checksum", fault_plan=FLIP)),
                     ("flip_off", dict(fault_plan=FLIP)),
                     ("chaos", dict(integrity="checksum", fault_plan=dict(
                         FLIP, nan_logit_steps=(4,))))):
        s = _spill_sched(JS, jm, jp, **kw)
        s.run()
        out[name] = (_state(s), s._faults._rng.get_state())
    return out


def test_bitflip_detected_and_recovered_like_jax(models, jax_flips):
    """A flipped byte of a spilled page is detected at re-admission and
    the request recomputed from its prompt: streams equal the same
    eviction schedule without the flip, and stats equal JAX's.  Without
    integrity the flip goes unseen."""
    _, _, tm, tp = models["behavioral"]
    states = {}
    for name, kw in (("base", dict(integrity="checksum",
                                   fault_plan=dict(evict_steps=(2,)))),
                     ("flip", dict(integrity="checksum", fault_plan=FLIP)),
                     ("flip_off", dict(fault_plan=FLIP))):
        s = _spill_sched(TS, tm, tp, audit_every_step=True, **kw)
        s.run()
        s.audit()
        states[name] = _state(s)
        assert states[name] == jax_flips[name][0], name
    flip = states["flip"]
    assert flip["stats"]["spills"] >= 1 and flip["stats"]["bitflips_injected"] == 1
    assert flip["stats"]["corruptions_detected"] > 0
    assert flip["stats"]["recompute_fallbacks"] >= 1
    assert flip["results"] == states["base"]["results"]
    assert states["flip_off"]["stats"]["corruptions_detected"] == 0


def test_paranoid_audit_catches_victim_flip(models):
    _, _, tm, tp = models["behavioral"]
    s = _spill_sched(TS, tm, tp, integrity="paranoid",
                     fault_plan=dict(evict_steps=(2,)))
    while not s._victim and (s.queue or any(s.slot_req)):
        s.step()
    assert s._victim
    s.audit()
    s._bitflip_victim_page()
    with pytest.raises(AssertionError, match="spill-time checksums"):
        s.audit()


def test_quarantined_prefix_never_reenters(models):
    """A quarantined key never re-enters the directory: the same prompt
    again is prefilled afresh and does not register it; `audit()` holds
    the invariant.  A paranoid hit whose page was corrupted on the device
    is quarantined, not served, as JAX's is."""
    _, _, tm, tp = models["behavioral"]
    jm, jp, _, _ = models["behavioral"]
    shared = list(range(1, 17))              # two full pages
    kw = dict(max_batch_slots=2, max_len=48, decode_chunk=4,
              audit_every_step=True, page_size=8, num_pages=24,
              prefix_sharing=True, integrity="paranoid")
    s = TS.Scheduler(tm, tp, **kw)
    s.submit(shared + [30], 6)
    s.run()
    key = next(iter(s.prefix_dir))
    s._quarantine_entry(key)
    assert key not in s.prefix_dir
    s.audit()
    s.submit(shared + [31], 6)
    s.run()
    assert key not in s.prefix_dir and key in s.quarantined
    assert s.stats["quarantined_prefixes"] == 1
    s.audit()

    def corrupted_hit(mod, model, params):
        sched = mod.Scheduler(model, params, **kw)
        sched.submit(shared + [30], 6)
        sched.run()
        page = sched.prefix_dir[next(iter(sched.prefix_dir))][0][0]
        if mod is TS:
            sched.cache["blocks"][0].k_q[0, page, 0, 0, 0] += 1
        else:
            pool = sched.cache["blocks"][0]
            sched.cache["blocks"] = (pool._replace(
                k_q=pool.k_q.at[0, page, 0, 0, 0].add(1)),)
        sched.submit(shared + [31], 6)
        sched.run()
        sched.audit()
        return _state(sched)

    got = corrupted_hit(TS, tm, tp)
    assert got == corrupted_hit(JS, jm, jp)
    assert got["stats"]["corruptions_detected"] >= 1
    assert got["stats"]["quarantined_prefixes"] >= 1


# ---------------------------------------------------------------------------
# the SLA degradation ladder
# ---------------------------------------------------------------------------
def _ladder_run(mod, model, params, dt):
    t = [0.0]

    def clock():
        t[0] += dt[0]
        return t[0]

    s = mod.Scheduler(model, params, max_batch_slots=2, max_len=64,
                      decode_chunk=2, speculate=True, draft_len=3,
                      mixed_steps=True, prefill_chunk_budget=8, page_size=8,
                      num_pages=80, mixed_dispatch="paired",
                      tbt_target_ms=5.0, ladder_cooldown_steps=1, clock=clock,
                      audit_every_step=mod is TS)
    for p in PROMPTS:
        s.submit(p, 24)
    levels = []
    while s.queue or any(r is not None for r in s.slot_req):
        s.step()
        levels.append(s.ladder_level)
        if s.ladder_level == 3 and dt[0] > 0.01:
            assert s._effective_chunk_budget() == 4        # halved at >= 2
            dt[0] = 0.0001                                 # pressure clears
    return s, levels


def test_ladder_escalates_and_releases_like_jax(models):
    jm, jp, tm, tp = models["behavioral"]
    s, levels = _ladder_run(TS, tm, tp, [0.2])
    j, jlevels = _ladder_run(JS, jm, jp, [0.2])
    assert levels == jlevels
    assert 3 in levels and levels[-1] < 3
    assert _state(s) == _state(j)
    tr = s.stats["ladder_transitions"]
    assert all(tr[r] >= 1 for r in TS.LADDER_RUNGS)
    assert s.ladder_deescalations >= 1 and s.stats["ladder_paused_steps"] >= 1
    assert s.stats["tbt_p95_ms"] == j.stats["tbt_p95_ms"]
    s.audit()


@pytest.mark.parametrize("opts", [
    dict(speculate=True, draft_len=3),
    dict(mixed_steps=True, prefill_chunk_budget=8, **PAGED, **SAMPLED)],
    ids=["greedy_speculative", "sampled_mixed"])
def test_ladder_streams_bit_identical(models, opts):
    """Rungs change scheduling only: a degraded run's streams equal the
    run without the ladder (greedy with speculation: the speculation rung
    keeps the argmax chain; sampled without it: the chunk and admission
    rungs keep the per-(request, token) keys)."""
    _, _, tm, tp = models["behavioral"]
    base = _sched(TS, tm, tp, audit_every_step=True, **opts).run()
    t = [0.0]

    def slow():
        t[0] += 0.5
        return t[0]

    lad = _sched(TS, tm, tp, audit_every_step=True, tbt_target_ms=1.0,
                 ladder_cooldown_steps=1, clock=slow, **opts)
    assert lad.run() == base
    assert lad.ladder_escalations >= 1


def test_ladder_off_by_default(models):
    _, _, tm, tp = models["behavioral"]
    s = _sched(TS, tm, tp)
    s.run()
    assert s.ladder_level == 0 and s.ladder_escalations == 0
    assert s.stats["tbt_p95_ms"] == 0.0 and s.stats["snapshots"] == 0


# ---------------------------------------------------------------------------
# the new faults fire as the reference's do
# ---------------------------------------------------------------------------
def test_new_faults_fire_like_jax(models, jax_flips):
    """Bit flip, eviction and NaN poison together: `fired`, the plan's rng
    state, the counters and every stream equal JAX's, and a second run of
    the port equals the first."""
    _, _, tm, tp = models["behavioral"]
    plan = dict(FLIP, nan_logit_steps=(4,))

    def run():
        s = _spill_sched(TS, tm, tp, integrity="checksum",
                         audit_every_step=True, fault_plan=plan)
        s.run()
        return _state(s), s._faults._rng.get_state()

    (got, rng), (want, jrng) = run(), jax_flips["chaos"]
    assert got == want and got == run()[0]
    assert got["stats"]["poisoned"] == 1 and got["fired"]["bitflip"] == 1
    assert rng[0] == jrng[0] and rng[2:] == jrng[2:]
    np.testing.assert_array_equal(rng[1], jrng[1])
    js, ts = JF.FaultPlan(**plan).start(), TF.FaultPlan(**plan).start()
    assert [ts.bitflip_spilled_page(i) for i in range(5)] == \
        [js.bitflip_spilled_page(i) for i in range(5)]


# ---------------------------------------------------------------------------
# page checksums against JAX
# ---------------------------------------------------------------------------
def _random_planes(shape_kv, shape_s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(-128, 128, shape_kv).astype(np.int8),
            rng.randint(-128, 128, shape_kv).astype(np.int8),
            rng.rand(*shape_s).astype(np.float32),
            rng.rand(*shape_s).astype(np.float32))


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("layers", [None, 3])
def test_page_checksums_equal_jax(kv_bits, layers):
    P, ps, Hkv, Dh = 7, 4, 2, 8
    lead = () if layers is None else (layers,)
    planes = _random_planes(lead + (P, ps, Hkv, Dh * kv_bits // 8),
                            lead + (P, ps, Hkv), 3)
    axis = 0 if layers is None else 1
    pages = [5, 1, 5, 0]
    seeds = np.array([1, 2, 3, 2**32 - 1], np.uint32)
    jpool = JA.PagedKVCache(*map(jnp.asarray, planes))
    tpool = TA.PagedKVCache(*map(torch.tensor, planes))
    for s in (None, seeds):
        want = JA.page_checksums(jpool, pages, page_axis=axis, seeds=s)
        got = TA.page_checksums(tpool, pages, page_axis=axis, seeds=s)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_cache_page_checksums_equal_jax(kv_bits):
    """Every layer's pool chained into one crc a page, live (page ids) and
    on a fetched host tree (positions), equal to JAX's; a changed byte in
    any layer changes its page's crc only."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), kv_bits=kv_bits)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), kv_bits=kv_bits)
    tm = build_model(tcfg, "cpu")
    jc = jax_build(jcfg).init_cache(2, 32, ragged=True, page_size=8,
                                    num_pages=9)
    tc = tm.init_cache(2, 32, page_size=8, num_pages=9)
    fill = []
    for i, tp in enumerate(tc["blocks"]):
        planes = _random_planes(tp.k_q.shape, tp.k_scale.shape, 30 + i)
        for f, x in zip(PLANES, planes):
            getattr(tp, f).copy_(torch.from_numpy(x))
        fill.append(JA.PagedKVCache(*map(jnp.asarray, planes)))
    jc = dict(jc, blocks=tuple(fill))
    pages = [4, 7, 2, 8, 1]
    live = TT.cache_page_checksums(tc, pages)
    np.testing.assert_array_equal(live, JT.cache_page_checksums(jc, pages))
    src = pages + [TA.TRASH_PAGE] * 3
    jdata = jax.device_get(JT.cache_fetch_pages(jc, jnp.asarray(src)))
    tdata = TS.page_fetch(tm, tc, src)
    pos = list(range(len(pages)))
    np.testing.assert_array_equal(TT.cache_page_checksums(tdata, pos),
                                  JT.cache_page_checksums(jdata, pos))
    np.testing.assert_array_equal(TT.cache_page_checksums(tdata, pos), live)
    tc["blocks"][0].v_scale[2, 7, 3, 1] += 1.0       # layer 2, page 7
    moved = TT.cache_page_checksums(tc, pages)
    assert [a != b for a, b in zip(moved, live)] == [False, True, False,
                                                     False, False]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and copies run on the "
                    "card)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_snapshot_restore_round_trip(cuda_device, tmp_path):
    """On the card, on the kernel path at 4-bit KV with a victim record in
    the snapshot: the restored run equals the uncrashed one token for
    token."""
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_impl="kernel",
                               compute_dtype="float32", decode_block_k=8)
    tm = build_model(tcfg, cuda_device)
    tp = tm.init(seed=0)
    ref, s2, crash = _roundtrip(tm, tp, tmp_path, every=1,
                                plan=dict(evict_steps=(2,)),
                                **dict(MID_SPILL, kv_bits=4))
    assert crash.n_spills >= 1 and s2.n_restores >= 1
    assert s2.model.cfg.kv_bits == 4 and s2.model.device == cuda_device
