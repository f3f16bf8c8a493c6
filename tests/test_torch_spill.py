"""Host-memory spill and admission control in the port's Scheduler, against
the JAX package's, on the CPU.

SMOKE internlm2-1.8b in float32 at the ideal ADC, parameters from the JAX
package's seeded `init` through `from_jax_params`.  The cases of the
reference's spill tests run once through the JAX Scheduler (a
module-scoped fixture, one cache length, page size and slot count so that
JAX compiles few shapes) and once through the port's, audited after every
step: streams, request statuses, every overload `stats` key, the free list
and the refcounts must be equal.  Covered: page fetch / restore byte for
byte (flat and layer-stacked pools, both KV precisions, the all-layer
tree), spill against recompute on the behavioral and the kernel path,
greedy and sampled, a kernel-path recompute continuation parting from its
unstarved stream exactly as the reference's does, with mixed steps and with prefix sharing, a victim cap
that forces recompute, typed rejections and `Overloaded`, ttl and
`deadline_ms` shedding under an injected clock, a shed spilled
continuation releasing its record, reclaim stalls, and the CLI flags.  On
the card (`gpu`): the spill's host round trip and spill parity at smoke
width.
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
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
BASE = dict(max_batch_slots=3, max_len=32, decode_chunk=4, page_size=8,
            num_pages=6)
PLANES = ("k_q", "v_q", "k_scale", "v_scale")
SAMPLED = dict(temperature=0.8, top_k=20)
OVERLOAD_KEYS = ("steps", "evictions", "spills", "restores", "spilled_pages",
                 "spill_bytes", "recompute_fallbacks", "deadline_misses",
                 "rejections", "reclaim_stalls", "victim_pool_pages_used",
                 "refcount_corruptions_detected", "queue_depth_p50",
                 "queue_depth_p95")


def _cfgs(impl):
    kw = dict(attn_impl=impl, compute_dtype="float32")
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend (a run takes ten times longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{impl: (jax model, jax params, port model, port params)}."""
    jp, out = None, {}
    for impl in ("behavioral", "kernel"):
        jcfg, tcfg = _cfgs(impl)
        jm = jax_build(jcfg)
        if jp is None:
            jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        out[impl] = (jm, jp, build_model(tcfg, "cpu"),
                     from_jax_params(jp, tcfg, "cpu"))
    return out


def _starved(n=5, budget=10):
    base = TD.lm_batch(3, n, 16, 256)
    return [(base[i, :6 + 2 * i].tolist(), budget) for i in range(n)]


def _shared(budget=8):
    base = TD.lm_batch(5, 6, 40, 256)
    prefix = base[5, :16].tolist()               # 2 shared pages at ps 8
    return [(prefix + base[i, :3 + i].tolist(), budget) for i in range(4)]


def _parting():
    """A trace on which a recompute continuation of the kernel path parts
    from its unstarved stream (request 2, in JAX's Scheduler too)."""
    rng = np.random.RandomState(7)
    base = TD.lm_batch(7, 5, 16, 256)
    return [(base[i, :rng.randint(6, 17)].tolist(), 14) for i in range(5)]


def _scenarios():
    """name -> (impl, scheduler options, trace, submit options)."""
    spill = dict(victim_pool_pages=32)
    return {
        "recompute": ("behavioral", {}, _starved(), {}),
        "spill": ("behavioral", spill, _starved(), {}),
        "sampled_recompute": ("behavioral", SAMPLED, _starved(), {}),
        "sampled_spill": ("behavioral", dict(spill, **SAMPLED), _starved(), {}),
        "mixed_spill": ("behavioral", dict(spill, mixed_steps=True,
                                           prefill_chunk_budget=8),
                        _starved(), {}),
        "cap": ("behavioral", dict(victim_pool_pages=1), _starved(), {}),
        "shared": ("behavioral", dict(prefix_sharing=True), _shared(), {}),
        "shared_spill": ("behavioral", dict(spill, prefix_sharing=True),
                         _shared(), {}),
        "shed_spilled": ("behavioral", spill, _starved(), dict(ttl_steps=3)),
        "kernel_recompute": ("kernel", {}, _starved(n=4), {}),
        "kernel_spill": ("kernel", spill, _starved(n=4), {}),
        "kernel_unstarved": ("kernel", dict(num_pages=0), _parting(), {}),
        "kernel_parting": ("kernel", {}, _parting(), {}),
        "kernel_parting_spill": ("kernel", spill, _parting(), {}),
    }


def _serve(sched, trace, submit_kw, audit):
    rids = [sched.submit(p, b, **submit_kw) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        if audit:
            sched.audit()
    return [res.get(r, []) for r in rids], rids


def _state(sched, rids):
    """Everything the two schedulers must agree on after a run."""
    return dict(
        status=[sched.requests[r].status for r in rids],
        stats={k: sched.stats[k] for k in OVERLOAD_KEYS},
        peak=sched.peak_pages_in_use, victim_records=len(sched._victim),
        victim_used=sched._victim_used,
        free=[int(p) for p in sched.free_pages],
        page_ref=[int(r) for r in sched.page_ref])


def _sched(mod, model, params, opts):
    kw = dict(BASE, **opts)
    if "temperature" in kw:
        kw["rng"] = (jax.random.PRNGKey(7) if mod is JS else
                     TS.prng.PRNGKey(7))
    return mod.Scheduler(model, params, **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """name -> (streams, state) of every scenario through JAX's Scheduler."""
    out = {}
    for name, (impl, opts, trace, submit_kw) in _scenarios().items():
        jm, jp, _, _ = models[impl]
        sched = _sched(JS, jm, jp, opts)
        streams, rids = _serve(sched, trace, submit_kw, audit=False)
        out[name] = (streams, _state(sched, rids))
    return out


def _port(models, name):
    impl, opts, trace, submit_kw = _scenarios()[name]
    _, _, tm, tp = models[impl]
    sched = _sched(TS, tm, tp, dict(opts, audit_every_step=True))
    streams, rids = _serve(sched, trace, submit_kw, audit=True)
    return streams, _state(sched, rids), sched


def _matches_jax(models, jax_runs, name):
    streams, state, sched = _port(models, name)
    j_streams, j_state = jax_runs[name]
    assert streams == j_streams
    assert state == j_state
    return streams, state, sched


# ---------------------------------------------------------------------------
# page fetch / restore, byte for byte
# ---------------------------------------------------------------------------
def _random_planes(shape_kv, shape_s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(-128, 128, shape_kv).astype(np.int8),
            rng.randint(-128, 128, shape_kv).astype(np.int8),
            rng.rand(*shape_s).astype(np.float32),
            rng.rand(*shape_s).astype(np.float32))


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("layers", [None, 3])
def test_fetch_restore_pages_bytes_match_jax(kv_bits, layers):
    """Fetch pages 3 and 5 with two trash lanes, then restore them into
    pages 1 and 6: the fetched planes and the pool after the restore equal
    JAX's byte for byte, and nothing fetched aliases the pool."""
    P, ps, Hkv, Dh = 7, 4, 2, 8
    lead = () if layers is None else (layers,)
    planes = _random_planes(lead + (P, ps, Hkv, Dh * kv_bits // 8),
                            lead + (P, ps, Hkv), 1)
    axis = 0 if layers is None else 1
    src = [3, 5, TA.TRASH_PAGE, TA.TRASH_PAGE]
    dst = [1, 6, TA.TRASH_PAGE, TA.TRASH_PAGE]
    jpool = JA.PagedKVCache(*map(jnp.asarray, planes))
    jf = JA.fetch_pages(jpool, jnp.asarray(src), page_axis=axis)
    jr = JA.restore_pages(jpool, jnp.asarray(dst), jf, page_axis=axis)
    tpool = TA.PagedKVCache(*map(torch.tensor, planes))
    tf = TA.fetch_pages(tpool, torch.tensor(src), page_axis=axis)
    for f in PLANES:
        np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                      np.asarray(getattr(jf, f)))
        assert getattr(tf, f).untyped_storage().data_ptr() != \
            getattr(tpool, f).untyped_storage().data_ptr()
    TA.restore_pages(tpool, torch.tensor(dst), tf, page_axis=axis)
    for f in PLANES:
        np.testing.assert_array_equal(getattr(tpool, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    np.testing.assert_array_equal(tpool.k_q.select(axis, 6).numpy(),
                                  np.take(planes[0], 5, axis=axis))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_cache_fetch_restore_pages_bytes_match_jax(kv_bits):
    """One fetch of the SMOKE model's pools (every layer), moved through
    the host as a spill moves it, and restored into other pages, equals
    JAX's `cache_fetch_pages` / `cache_restore_pages` byte for byte."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), kv_bits=kv_bits)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), kv_bits=kv_bits)
    tm = build_model(tcfg, "cpu")
    jc = jax_build(jcfg).init_cache(2, 32, ragged=True, page_size=8,
                                    num_pages=9)
    tc = tm.init_cache(2, 32, page_size=8, num_pages=9)
    fill = []
    for i, tp in enumerate(tc["blocks"]):
        planes = _random_planes(tp.k_q.shape, tp.k_scale.shape, 20 + i)
        for f, x in zip(PLANES, planes):
            getattr(tp, f).copy_(torch.from_numpy(x))
        fill.append(JA.PagedKVCache(*map(jnp.asarray, planes)))
    jc = dict(jc, blocks=tuple(fill))
    src, dst = [4, 7, 2, TA.TRASH_PAGE], [5, 1, 8, TA.TRASH_PAGE]
    jdata = jax.device_get(JT.cache_fetch_pages(jc, jnp.asarray(src)))
    tdata = TS.page_fetch(tm, tc, src)
    assert set(tdata) == set(jdata) and len(tdata["tail"]) == len(jdata["tail"])
    for jp, tp in zip(jdata["blocks"], tdata["blocks"]):
        for f in PLANES:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))
    jc = JT.cache_restore_pages(jc, jnp.asarray(dst), jdata)
    TS.page_restore(tm, tc, dst, tdata)
    for jp, tp in zip(jc["blocks"], tc["blocks"]):
        for f in PLANES:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))


# ---------------------------------------------------------------------------
# spill -> restore against JAX
# ---------------------------------------------------------------------------
def test_spill_restore_parity_behavioral(models, jax_runs):
    base, s0, _ = _matches_jax(models, jax_runs, "recompute")
    spill, s1, sched = _matches_jax(models, jax_runs, "spill")
    assert s0["stats"]["evictions"] > 0 and s0["stats"]["spills"] == 0
    assert spill == base
    st = s1["stats"]
    assert st["spills"] > 0 and st["restores"] == st["spills"]
    assert st["spill_bytes"] == st["spilled_pages"] * sched._page_bytes > 0
    assert st["recompute_fallbacks"] == 0
    assert len(sched.free_pages) == sched.num_pages - 1
    assert int(sched.page_ref.sum()) == 0 and not sched._victim


def test_spill_restore_parity_kernel_path(models, jax_runs):
    base, s0, _ = _matches_jax(models, jax_runs, "kernel_recompute")
    spill, s1, _ = _matches_jax(models, jax_runs, "kernel_spill")
    assert s0["stats"]["evictions"] > 0 and s1["stats"]["restores"] > 0
    assert spill == base


def test_recompute_continuation_parts_like_jax(models, jax_runs):
    """On the kernel path a recompute continuation re-prefills through the
    prefill kernel the tokens that the decode kernel produced, whose
    online LUT steps round otherwise: its stream may part from the
    unstarved one after the eviction.  The reference's does, in the same
    request at the same token; a spilled continuation never parts."""
    u, _, _ = _matches_jax(models, jax_runs, "kernel_unstarved")
    r, state, _ = _matches_jax(models, jax_runs, "kernel_parting")
    s, _, _ = _matches_jax(models, jax_runs, "kernel_parting_spill")
    assert state["stats"]["evictions"] > 0 and state["stats"]["spills"] == 0
    assert [i for i, (a, b) in enumerate(zip(r, u)) if a != b] == [2]
    assert s == u


def test_spill_restore_parity_sampled(models, jax_runs):
    """temperature > 0: the restored continuation draws the tokens the
    recompute continuation draws (per-(request, token index) keys)."""
    base, _, _ = _matches_jax(models, jax_runs, "sampled_recompute")
    spill, s1, _ = _matches_jax(models, jax_runs, "sampled_spill")
    assert s1["stats"]["restores"] > 0
    assert spill == base


def test_spill_restore_parity_mixed_steps(models, jax_runs):
    spill, s1, _ = _matches_jax(models, jax_runs, "mixed_spill")
    assert s1["stats"]["restores"] > 0
    assert spill == jax_runs["recompute"][0]


def test_spill_with_prefix_sharing_keeps_shared_pages(models, jax_runs):
    """Directory-held prefix pages stay resident: a spill moves only the
    victim's private pages, and the record holds the shared ones."""
    off, _, _ = _matches_jax(models, jax_runs, "shared")
    on, state, sched = _matches_jax(models, jax_runs, "shared_spill")
    assert on == off
    st = state["stats"]
    assert st["spills"] > 0 and st["restores"] == st["spills"]
    longest = max(len(p) for p, _ in _shared()) + 8
    assert st["spilled_pages"] <= st["spills"] * (sched._pages_for(longest) - 2)
    sched.clear_prefix_cache()
    sched.audit()
    assert len(sched.free_pages) == sched.num_pages - 1
    assert int(sched.page_ref.sum()) == 0


def test_victim_pool_cap_falls_back_to_recompute(models, jax_runs):
    out, state, _ = _matches_jax(models, jax_runs, "cap")
    assert out == jax_runs["recompute"][0]
    assert state["stats"]["recompute_fallbacks"] > 0
    assert state["victim_used"] == 0


def test_shed_spilled_continuation_releases_victim_record(models, jax_runs):
    """Requests with ttl_steps 3 on a starved pool: the starved tail is
    shed, and a spilled continuation among it releases its record."""
    streams, state, sched = _matches_jax(models, jax_runs, "shed_spilled")
    st = state["stats"]
    assert st["deadline_misses"] > 0 and st["spills"] > st["restores"]
    assert "deadline_missed" in state["status"] and "done" in state["status"]
    assert not sched._victim and sched._victim_used == 0
    assert len(sched.free_pages) == sched.num_pages - 1


def test_victim_pool_requires_paged(models):
    jm, jp, tm, tp = models["behavioral"]
    with pytest.raises(ValueError) as jerr:
        JS.Scheduler(jm, jp, max_batch_slots=2, max_len=32, victim_pool_pages=8)
    with pytest.raises(ValueError, match="victim_pool_pages") as terr:
        TS.Scheduler(tm, tp, max_batch_slots=2, max_len=32, victim_pool_pages=8)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# submit: typed rejections, back-pressure, deadlines
# ---------------------------------------------------------------------------
def test_submit_typed_rejections_and_overloaded(models):
    """The reference's typed rejections, and a full bounded queue refusing
    with `Overloaded` (counted) while the queued work completes."""
    jm, jp, tm, tp = models["behavioral"]
    out = []
    for mod, m, p in ((JS, jm, jp), (TS, tm, tp)):
        s = mod.Scheduler(m, p, max_batch_slots=2, max_len=32, page_size=8,
                          num_pages=9, max_queue=2)
        kinds = []
        for prompt, budget in (([], 4), ([1, 2, 3], 0), ([1, 2, 3], -2),
                               (list(range(32)), 4)):
            with pytest.raises(mod.SubmitError) as err:
                s.submit(prompt, budget)
            kinds.append(type(err.value).__name__)
        s.submit([1, 2], 2)
        s.submit([3, 4], 2)
        with pytest.raises(mod.Overloaded):
            s.submit([5, 6], 2)
        out.append((kinds, s.run(), s.stats["rejections"],
                    [r.status for r in s.requests.values()]))
    assert out[1] == out[0]
    assert out[1][0] == ["EmptyPrompt", "InvalidBudget", "InvalidBudget",
                         "PromptTooLong"]
    assert out[1][2] == 1 and len(out[1][1]) == 2
    assert issubclass(TS.PromptTooLong, ValueError)
    assert issubclass(TS.Overloaded, RuntimeError)


def test_ttl_and_deadline_shedding_with_injected_clock(models):
    """A request with ttl_steps 0 is shed at the first step; one whose
    deadline_ms passed on the injected clock is shed too; an admitted
    request past its ttl retires with the tokens it has."""
    jm, jp, tm, tp = models["behavioral"]
    out = []
    for mod, m, p in ((JS, jm, jp), (TS, tm, tp)):
        now = [0.0]
        s = mod.Scheduler(m, p, **dict(BASE, max_batch_slots=2),
                          clock=lambda: now[0])
        rids = [s.submit(list(range(10, 16)), 8),
                s.submit(list(range(30, 36)), 8, ttl_steps=0),
                s.submit(list(range(40, 46)), 4, deadline_ms=50.0),
                s.submit(list(range(50, 58)), 12, ttl_steps=2)]
        now[0] = 0.2                          # 200 ms > 50 ms
        res = s.run()
        out.append(([res.get(r) for r in rids],
                    [s.requests[r].status for r in rids],
                    s.stats["deadline_misses"]))
    assert out[1] == out[0]
    streams, status, misses = out[1]
    assert status == ["done", "deadline_missed", "deadline_missed",
                      "deadline_missed"]
    assert misses == 3 and len(streams[0]) == 8
    assert streams[1] is None and streams[2] is None
    assert 0 < len(streams[3]) < 12


def test_reclaim_stalls_on_slot_pinned_directory(models):
    """A directory whose pages live slots also hold frees nothing: reclaim
    stops with a stall instead of churning; entries only the directory
    holds are still reclaimed."""
    _, _, tm, tp = models["behavioral"]
    s = TS.Scheduler(tm, tp, max_batch_slots=2, max_len=32, page_size=8,
                     num_pages=9, prefix_sharing=True)
    prompt = list(range(50, 66))
    assert s._alloc_slot(0, len(prompt))
    s.slot_req[0] = TS.Request(0, prompt, 4)
    s.lengths[0] = len(prompt)
    s._register_prefixes(0, prompt, exact=False)
    n_dir, free_before = len(s.prefix_dir), len(s.free_pages)
    assert n_dir > 0
    s._reclaim(free_before + 1)
    assert s.n_reclaim_stalls == 1 and s.stats["reclaim_stalls"] == 1
    assert len(s.prefix_dir) == n_dir and len(s.free_pages) == free_before
    s.audit()
    s._free_slot_pages(0)                     # directory-only holds now
    s.slot_req[0] = None
    s.lengths[0] = 0
    s._reclaim(free_before + 2)
    assert len(s.free_pages) >= free_before + 2 and s.n_reclaim_stalls == 1
    s.audit()


def test_reclaim_livelock_of_a_directory_holding_every_page(models):
    """The reference's behaviour, matched: on a pool of one full sequence
    + the trash page, prefix sharing can leave every page held only by
    directory entries that share them, none the last holder of a page, so
    `_reclaim` frees nothing, no slot runs and the queue head waits for
    good (with a victim pool the same trace drains).  Both schedulers
    reach the same stuck state within 10 steps."""
    jm, jp, tm, tp = models["behavioral"]
    kw = dict(BASE, max_batch_slots=2, num_pages=5, prefix_sharing=True)
    states = []
    for mod, m, p in ((JS, jm, jp), (TS, tm, tp)):
        s = mod.Scheduler(m, p, **kw)
        for prompt, budget in _shared():
            s.submit(prompt, budget)
        for _ in range(10):
            s.step()
        states.append(([r.rid for r in s.queue], s.slot_req, len(s.free_pages),
                       sorted(set(p for v in s.prefix_dir.values() for p in v[0])),
                       s.n_evictions))
        stalls = s.n_reclaim_stalls
        s.step()
        assert s.n_reclaim_stalls == stalls + 1
    assert states[1] == states[0]
    queue, slots, free, held, _ = states[1]
    assert queue and slots == [None, None] and free == 0 and held == [1, 2, 3, 4]


def test_serve_cli_overload_flags_on_cpu():
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
            "--prompt-len", "8", "--new-tokens", "4", "--continuous-batching",
            "--max-batch-slots", "2", "--page-size", "8"]
    base = tserve.main(args)
    spill = tserve.main(args + ["--num-pages", "3", "--victim-pool-pages",
                                "8", "--deadline-ms", "60000"])
    assert torch.equal(base, spill)
    refused = tserve.main(args + ["--max-queue", "2"])
    assert torch.equal(refused[:2], base[:2]) and not refused[2].any()
    for bad in (["--continuous-batching", "--victim-pool-pages", "4"],
                ["--continuous-batching", "--page-size", "8",
                 "--victim-pool-pages", "-1"],
                ["--continuous-batching", "--deadline-ms", "-5"],
                ["--continuous-batching", "--max-queue", "-1"],
                ["--deadline-ms", "100"], ["--max-queue", "4"]):
        with pytest.raises(SystemExit):
            tserve.parse_args(["--arch", ARCH] + bad)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spill's copies run on the card)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_fetch_restore_round_trip(cuda_device):
    """A spill's host copy of pool pages holds their bytes, in host memory
    that aliases nothing of the pool, and the restore puts them back into
    other pages bit for bit."""
    tcfg = get_config(ARCH, smoke=True)
    tm = build_model(tcfg, cuda_device)
    cache = tm.init_cache(2, 32, page_size=8, num_pages=9)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pool = cache["blocks"][0]
    pool.k_q.copy_(torch.randint(-128, 128, pool.k_q.shape, generator=gen,
                                 device=cuda_device, dtype=torch.int8))
    pool.v_scale.copy_(torch.rand(pool.v_scale.shape, generator=gen,
                                  device=cuda_device))
    want = [getattr(pool, f).clone() for f in PLANES]
    data = TS.page_fetch(tm, cache, [3, 5, 0, 0])
    got = data["blocks"][0]
    for f, w in zip(PLANES, want):
        assert getattr(got, f).device.type == "cpu"
        assert torch.equal(getattr(got, f), w[:, [3, 5, 0, 0]].cpu())
    TS.page_restore(tm, cache, [1, 6, 0, 0], data)
    torch.cuda.synchronize()
    for f, w in zip(PLANES, want):
        assert torch.equal(getattr(pool, f)[:, [1, 6]], w[:, [3, 5]])
        assert torch.equal(getattr(pool, f)[:, 2], w[:, 2])


@pytest.mark.gpu
def test_cuda_spill_parity_at_smoke_width(cuda_device):
    """On the card, on the kernel path: a starved pool that spills serves
    the streams of an unstarved pool token for token, restores every
    spill and drains."""
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_impl="kernel",
                               compute_dtype="float32", decode_block_k=8)
    tm = build_model(tcfg, cuda_device)
    tp = tm.init(seed=0)
    trace = _starved()
    kw = dict(BASE, audit_every_step=True)
    kw.pop("num_pages")
    unstarved, _ = _serve(TS.Scheduler(tm, tp, **kw), trace, {}, True)
    sched = TS.Scheduler(tm, tp, num_pages=6, victim_pool_pages=32, **kw)
    spilled, _ = _serve(sched, trace, {}, True)
    assert spilled == unstarved
    assert sched.n_spills > 0 and sched.n_restores == sched.n_spills
    assert len(sched.free_pages) == sched.num_pages - 1 and not sched._victim
