"""The port's continuous-batching Scheduler against the JAX package's, on
the CPU.

SMOKE internlm2-1.8b in float32 on the behavioral path, parameters from
the JAX package's seeded `init` through `from_jax_params`.  Both
schedulers decode greedily and must produce identical token streams, on
ragged dense slots and on the paged pool: equal-length prompts against
classic generation, mixed lengths with slot reuse, EOS mid-chunk, a
starved pool that stalls and evicts, and the `generate` entry point.
Also: the page accounting (`audit()`), typed rejections, the sharing and
mixed-step options refusing what the reference refuses, `prefill_bucket`,
and every reference option that is not ported yet (4-bit KV, snapshots,
integrity, the SLA ladder, recovery faults) raising NotImplementedError.
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
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
MAX_LEN = 64


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


def _trace(seed, lens, budgets):
    full = TD.lm_batch(seed, len(lens), max(lens), 256)
    return [(full[i, :n].tolist(), b) for i, (n, b) in enumerate(zip(lens, budgets))]


def _serve(sched, trace):
    rids = [sched.submit(p, b) for p, b in trace]
    res = sched.run()
    return [res[r] for r in rids]


def _both(models, trace, **kw):
    """The trace through the JAX Scheduler and the port's (audited after
    every step); returns (jax streams, port streams, port scheduler)."""
    jm, jp, tm, tp = models
    js = _serve(JS.Scheduler(jm, jp, max_len=MAX_LEN, **kw), trace)
    sched = TS.Scheduler(tm, tp, max_len=MAX_LEN, **kw)
    rids = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        sched.audit()
    assert res == sched.results()
    return js, [res[r] for r in rids], sched


@pytest.mark.parametrize("page_size", [0, 16])
def test_mixed_lengths_slot_reuse_match_jax(models, page_size):
    """4 mixed-length requests through 2 slots (queueing + slot reuse), on
    dense slots and on a 9-page pool; every page returns to the pool."""
    trace = _trace(1, [5, 17, 24, 9], [4, 7, 10, 13])
    kw = dict(max_batch_slots=2, page_size=page_size,
              num_pages=9 if page_size else 0)
    js, ts, sched = _both(models, trace, **kw)
    assert ts == js
    assert [len(t) for t in ts] == [4, 7, 10, 13]
    if page_size:
        assert sorted(sched.free_pages) == list(range(1, 9))
        assert sched.peak_pages_in_use > 0


def test_starved_pool_stalls_and_evicts_like_jax(models):
    """A pool of one full sequence + 1 pages forces stalls and an eviction;
    the continuation resumes the same greedy stream as the reference's."""
    trace = _trace(4, [30, 30], [24, 8])
    kw = dict(max_batch_slots=2, page_size=16, num_pages=6, decode_chunk=8)
    js, ts, sched = _both(models, trace, **kw)
    assert ts == js
    assert sched.n_evictions >= 1
    assert len(sched.free_pages) == sched.num_pages - 1


def test_eos_retires_mid_chunk_like_jax(models):
    """A stream emitting eos_id mid-chunk stops there (inclusive) and the
    freed slot admits the queued request."""
    jm, jp, tm, tp = models
    trace = _trace(2, [12, 12], [8, 3])
    stream = _serve(TS.Scheduler(tm, tp, max_batch_slots=1, max_len=32),
                    trace[:1])[0]
    eos = stream[3]
    js, ts, _ = _both(models, trace, max_batch_slots=1, eos_id=eos)
    assert ts == js
    assert ts[0] == stream[:stream.index(eos) + 1]


@pytest.mark.parametrize("page_size", [0, 8])
def test_generate_entry_point_matches_jax_and_classic(models, page_size):
    jm, jp, tm, tp = models
    toks = TD.lm_batch(0, 3, 8, 256)
    jo = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 6, 32,
                     continuous_batching=True, page_size=page_size)
    to = TS.generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 6, 32,
                     continuous_batching=True, page_size=page_size)
    classic = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 6, 32)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), classic.numpy())


def test_undersized_pool_and_bad_requests_raise(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="full-length"):
        TS.Scheduler(tm, tp, max_batch_slots=2, max_len=64, page_size=16,
                     num_pages=3)
    sched = TS.Scheduler(tm, tp, max_batch_slots=2, max_len=16)
    with pytest.raises(TS.EmptyPrompt):
        sched.submit([], 4)
    with pytest.raises(TS.InvalidBudget):
        sched.submit([1, 2], 0)
    with pytest.raises(TS.PromptTooLong):
        sched.submit(list(range(16)), 4)
    with pytest.raises(ValueError, match="continuous_batching"):
        TS.generate(tm, tp, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    2, 8, page_size=8)


def test_audit_catches_broken_page_accounting(models):
    _, _, tm, tp = models
    sched = TS.Scheduler(tm, tp, max_batch_slots=2, max_len=32, page_size=8)
    sched.submit(list(range(1, 12)), 20)
    sched.step()
    sched.audit()
    p = int(sched.page_table[0, 0])
    sched.page_ref[p] += 1
    with pytest.raises(TS.AuditError, match="refcount"):
        sched.audit()
    sched.page_ref[p] -= 1
    sched.free_pages.append(0)
    with pytest.raises(TS.AuditError, match="trash"):
        sched.audit()


@pytest.mark.parametrize("options", [
    dict(prefix_sharing=True),
    dict(mixed_steps=True, mixed_dispatch="paired"),
    dict(mixed_steps=True, mixed_dispatch="bogus", page_size=8),
    dict(mixed_steps=True, prefill_chunk_budget=-1),
    dict(prefix_sharing=True, mixed_steps=True, page_size=0)])
def test_sharing_and_mixed_options_validate_like_jax(models, options):
    """Each refused combination raises the reference's ValueError in both
    schedulers."""
    jm, jp, tm, tp = models
    with pytest.raises(ValueError) as jerr:
        JS.Scheduler(jm, jp, max_batch_slots=2, max_len=32, **options)
    with pytest.raises(ValueError) as terr:
        TS.Scheduler(tm, tp, max_batch_slots=2, max_len=32, **options)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("page_size", [0, 8])
def test_prefill_bucket_gives_jax_admission_widths(models, page_size):
    """A non-default `prefill_bucket` pads admission waves to the widths
    the reference's does (and, capped at max_len, never wider)."""
    jm, jp, tm, tp = models
    kw = dict(max_batch_slots=2, prefill_bucket=12, page_size=page_size)
    j = JS.Scheduler(jm, jp, max_len=MAX_LEN, **kw)
    t = TS.Scheduler(tm, tp, max_len=MAX_LEN, **kw)
    for n in (1, 12, 13, 25, 48, 63):
        assert t._bucket(n) == j._bucket(n)
    trace = _trace(3, [5, 13, 30], [3, 4, 5])
    js, ts, _ = _both(models, trace, **kw)
    assert ts == js


def _classic(tm, tp, **kw):
    return TS.generate(tm, tp, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                       2, 8, **kw)


@pytest.mark.parametrize("case", [
    "unknown_integrity", "integrity_dense", "snapshot_every_no_dir",
    "snapshot_no_dir", "restore_no_dir", "classic_restore_from",
    "classic_integrity", "unknown_option"])
def test_recovery_option_validation(models, case):
    """The reference's validations of the recovery options: an unknown
    integrity mode, integrity on dense slots, snapshots without a
    directory, the Scheduler's options on the classic path, and an option
    the Scheduler does not have."""
    _, _, tm, tp = models
    kw = dict(max_batch_slots=2, max_len=32)
    if case == "unknown_integrity":
        with pytest.raises(ValueError, match="unknown integrity mode"):
            TS.Scheduler(tm, tp, page_size=8, integrity="bogus", **kw)
    elif case == "integrity_dense":
        with pytest.raises(ValueError, match="page_size"):
            TS.Scheduler(tm, tp, integrity="checksum", **kw)
    elif case == "snapshot_every_no_dir":
        with pytest.raises(ValueError, match="snapshot_every requires"):
            TS.Scheduler(tm, tp, snapshot_every=2, **kw)
    elif case in ("snapshot_no_dir", "restore_no_dir"):
        sched = TS.Scheduler(tm, tp, **kw)
        with pytest.raises(ValueError, match="needs a directory"):
            getattr(sched, case.split("_")[0])()
    elif case == "classic_restore_from":
        with pytest.raises(ValueError, match="continuous_batching"):
            _classic(tm, tp, restore_from="snapshots")
    elif case == "classic_integrity":
        with pytest.raises(ValueError, match="continuous_batching"):
            _classic(tm, tp, integrity="checksum")
        with pytest.raises(ValueError, match="continuous_batching"):
            _classic(tm, tp, tbt_target_ms=5.0)
    else:
        with pytest.raises(TypeError):
            TS.Scheduler(tm, tp, no_such_option=1)
        with pytest.raises(TypeError):
            TS.Scheduler(tm, tp, **kw).submit([1, 2], 3, integrity="checksum")


def test_serve_cli_continuous_batching_on_cpu():
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
            "--prompt-len", "8", "--new-tokens", "4", "--continuous-batching",
            "--max-batch-slots", "2"]
    dense = tserve.main(args)
    paged = tserve.main(args + ["--page-size", "8", "--num-pages", "9"])
    shared = tserve.main(args + ["--page-size", "8", "--prefix-cache",
                                 "--prefix-cache-pages", "4", "--mixed-steps",
                                 "--prefill-chunk-budget", "3",
                                 "--mixed-dispatch", "paired"])
    mixed = tserve.main(args + ["--mixed-steps", "--prefill-chunk-budget", "5"])
    assert tuple(dense.shape) == (3, 4)
    assert torch.equal(dense, paged)
    assert torch.equal(dense, shared)
    assert torch.equal(dense, mixed)
    for bad in (["--page-size", "8"], ["--continuous-batching", "--num-pages", "9"],
                ["--continuous-batching", "--prefix-cache"],
                ["--continuous-batching", "--page-size", "8",
                 "--prefix-cache-pages", "4"],
                ["--mixed-steps"],
                ["--continuous-batching", "--prefill-chunk-budget", "8"],
                ["--continuous-batching", "--mixed-steps", "--mixed-dispatch",
                 "paired"]):
        with pytest.raises(SystemExit):
            tserve.parse_args(["--arch", ARCH] + bad)
