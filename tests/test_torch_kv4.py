"""4-bit KV in the port's Scheduler (`kv_bits=4`), against the JAX
package's, on the CPU.

SMOKE internlm2-1.8b in float32 at the ideal ADC, parameters from the JAX
package's seeded `init` through `from_jax_params`, the port on one torch
thread.  The reference's 4-bit scheduler tests: `kv_bits=8` given
explicitly changes nothing, a 4-bit paged pool serves the streams of
4-bit dense slots, and page and spill bytes follow the stored precision;
then 4-bit streams, stats and spilled page bytes equal JAX's on a starved
pool (behavioral path) and on the kernel path, where paged == dense at
decode_block_k == page size.  On the card (`gpu`): a 4-bit Scheduler on
the kernel path serves the streams of its dense run.
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
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
PLANES = ("k_q", "v_q", "k_scale", "v_scale")
STATS = ("steps", "model_steps", "evictions", "spills", "restores",
         "spilled_pages", "spill_bytes", "kv_bytes_per_token",
         "recompute_fallbacks", "victim_pool_pages_used")


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
    """{impl: (jax model, jax params, port model, port params)}, all kv8:
    the Scheduler rebuilds them at kv_bits=4."""
    jp, out = None, {}
    for impl in ("behavioral", "kernel"):
        kw = dict(attn_impl=impl, compute_dtype="float32", decode_block_k=16)
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
        jm = jax_build(jcfg)
        if jp is None:
            jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        out[impl] = (jm, jp, build_model(tcfg, "cpu"),
                     from_jax_params(jp, tcfg, "cpu"))
    return out


PROMPTS = np.random.RandomState(0).randint(1, 256, (4, 12))
GEN = dict(continuous_batching=True, max_batch_slots=4, decode_chunk=4)


def _generate(mod, model, params, **kw):
    tokens = (jnp.asarray(PROMPTS) if mod is JS
              else torch.from_numpy(PROMPTS).long())
    out = mod.generate(model, params, {"tokens": tokens}, 6, 24, **GEN, **kw)
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


def test_scheduler_kv8_override_bit_identical(models):
    """kv_bits=8 given explicitly is the default path, token for token."""
    _, _, tm, tp = models["behavioral"]
    base = _generate(TS, tm, tp, page_size=8, num_pages=16)
    np.testing.assert_array_equal(
        _generate(TS, tm, tp, page_size=8, num_pages=16, kv_bits=8), base)


def test_scheduler_kv4_paged_matches_dense_and_jax(models):
    """4-bit behavioral Scheduler: the paged pool serves the streams of
    dense slots, and both equal JAX's 4-bit streams; 4-bit moves them off
    the 8-bit ones."""
    jm, jp, tm, tp = models["behavioral"]
    paged = _generate(TS, tm, tp, page_size=8, num_pages=16, kv_bits=4)
    dense = _generate(TS, tm, tp, kv_bits=4)
    np.testing.assert_array_equal(paged, dense)
    np.testing.assert_array_equal(
        paged, _generate(JS, jm, jp, page_size=8, num_pages=16, kv_bits=4))
    assert not np.array_equal(paged, _generate(TS, tm, tp, page_size=8,
                                               num_pages=16))


def test_scheduler_kv4_byte_accounting(models):
    """Page and spill bytes follow the stored precision: 4-bit halves the
    value bytes (the f32 scale planes stay), as in JAX's Scheduler; the
    caller's model and device are kept."""
    jm, jp, tm, tp = models["behavioral"]
    cfg = tm.cfg
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(max_batch_slots=2, max_len=64, page_size=16, num_pages=16)
    s8, s4 = TS.Scheduler(tm, tp, **kw), TS.Scheduler(tm, tp, kv_bits=4, **kw)
    j4 = JS.Scheduler(jm, jp, kv_bits=4, **kw)
    assert s4.model.cfg.kv_bits == 4 and tm.cfg.kv_bits == 8
    assert s4.model.device == tm.device
    assert s4.cache["blocks"][0].k_q.shape[-1] == dh // 2
    assert s4.cache["blocks"][0].k_q.shape == j4.cache["blocks"][0].k_q.shape
    bpt8 = cfg.num_layers * (2 * hkv * dh + 8 * hkv)
    bpt4 = cfg.num_layers * (2 * hkv * (dh // 2) + 8 * hkv)
    assert s8.stats["kv_bytes_per_token"] == bpt8
    assert s4.stats["kv_bytes_per_token"] == bpt4 == j4.stats["kv_bytes_per_token"]
    assert (s8._page_bytes, s4._page_bytes) == (16 * bpt8, 16 * bpt4)
    assert s4._page_bytes == j4._page_bytes


def _starved(mod, model, params, impl_kw):
    s = mod.Scheduler(model, params, max_batch_slots=3, max_len=32,
                      decode_chunk=4, page_size=8, kv_bits=4, **impl_kw)
    rng = np.random.RandomState(3)
    for i in range(5):
        s.submit(rng.randint(1, 256, 6 + 2 * i).tolist(), 10)
    spilled = []
    spill = s._spill

    def keep(slot, r):
        ok = spill(slot, r)
        if ok and s._victim[r.rid].data is not None:
            d = s._victim[r.rid].data["blocks"][0]
            spilled.append([np.asarray(getattr(d, f)) for f in PLANES])
        return ok

    s._spill = keep
    s.run()
    s.audit()
    return s, spilled


@pytest.mark.parametrize("impl,extra", [
    ("behavioral", dict(num_pages=6, victim_pool_pages=32)),
    ("behavioral", dict(num_pages=6)),
    ("kernel", dict(num_pages=6, victim_pool_pages=32)),
], ids=["spill", "recompute", "kernel_spill"])
def test_kv4_starved_streams_stats_and_spill_bytes_equal_jax(models, impl, extra):
    """A starved 4-bit pool: streams, stats (spilled bytes at 4-bit) and
    every spilled page's 4-bit codes equal JAX's; its f32 scales (absmax /
    127 of the K / V projections) within 1e-6 relative, the distance of
    the port's float32 forward from JAX's jitted one (ROADMAP.md §3); a
    spilled continuation's stream equals the unstarved run's."""
    jm, jp, tm, tp = models[impl]
    t, t_sp = _starved(TS, tm, tp, extra)
    j, j_sp = _starved(JS, jm, jp, extra)
    assert t.results() == j.results()
    assert {k: t.stats[k] for k in STATS} == {k: j.stats[k] for k in STATS}
    assert t.stats["evictions"] > 0
    assert len(t_sp) == len(j_sp) == t.stats["spills"]
    for a, b in zip(t_sp, j_sp):
        for f, x, y in zip(PLANES, a, b):
            if x.dtype == np.int8:
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=0,
                                           err_msg=f)
    if extra.get("victim_pool_pages"):
        assert t.stats["spills"] > 0
        assert t.stats["spill_bytes"] == t.stats["spilled_pages"] * t._page_bytes
        unstarved, _ = _starved(TS, tm, tp, dict(num_pages=0))
        assert t.results() == unstarved.results()


def test_kv4_kernel_path_paged_equals_dense(models):
    """On the kernel path at decode_block_k == page size, a 4-bit pool
    serves the streams of 4-bit dense slots (prompts within a page)."""
    _, _, tm, tp = models["kernel"]
    paged = _generate(TS, tm, tp, page_size=16, num_pages=16, kv_bits=4)
    np.testing.assert_array_equal(paged, _generate(TS, tm, tp, kv_bits=4))


@pytest.mark.gpu
def test_cuda_kv4_scheduler_equals_dense():
    """On the card, on the kernel path at 4-bit KV: the paged pool (kernel
    1 over 4-bit pages at admission, kernel 2 in decode) serves the
    streams of dense slots, and both launch their kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card)")
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda", 0)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_impl="kernel",
                               compute_dtype="float32", decode_block_k=16)
    tm = build_model(tcfg, dev)
    tp = tm.init(seed=0)
    _build.LAUNCHES.clear()
    paged = _generate(TS, tm, tp, page_size=16, num_pages=16, kv_bits=4)
    assert _build.LAUNCHES.get("pim_attention") and _build.LAUNCHES.get("pim_decode")
    np.testing.assert_array_equal(paged, _generate(TS, tm, tp, kv_bits=4))
