"""Cache trees with a dense prefix (deepseek-moe-16b's SMOKE config: one
dense layer, two stacked MoE layers), against the JAX package, on the CPU.

Every cache visitor of `models/transformer.py` walks the "dense_prefix"
key beside "blocks" and "tail": page copies, page fetches and restores
equal JAX's byte for byte over every layer's pool; `cache_page_checksums`
equals JAX's crcs, visiting the keys sorted (blocks, dense_prefix, tail),
live and on a fetched tree, and a byte changed in the dense prefix's pool
changes its page's crc only; `cache_scatter` moves the prefix's rows too;
the port reads a JAX checkpoint of the paged cache tree and JAX reads the
port's, bit for bit; the serve CLI serves the MoE archs on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.core import attention as JA
from repro.models import transformer as JT
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.core import attention as TA
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import serve_lib as TS

ARCH = "deepseek-moe-16b"
PLANES = ("k_q", "v_q", "k_scale", "v_scale")
NUM_PAGES = 9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_planes(pool, seed):
    rng = np.random.RandomState(seed)
    kv, s = tuple(pool.k_q.shape), tuple(pool.k_scale.shape)
    return (rng.randint(-128, 128, kv).astype(np.int8),
            rng.randint(-128, 128, kv).astype(np.int8),
            rng.rand(*s).astype(np.float32), rng.rand(*s).astype(np.float32))


def _caches(kv_bits=8):
    """(jax paged cache, port paged cache, port model) holding the same
    random planes in every pool."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), kv_bits=kv_bits)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), kv_bits=kv_bits)
    tm = build_model(cfg, "cpu")
    tc = tm.init_cache(2, 32, page_size=8, num_pages=NUM_PAGES)
    jc = JT.init_cache(jcfg, 2, 32, ragged=True, page_size=8, num_pages=NUM_PAGES)
    assert sorted(tc) == sorted(jc) == ["blocks", "dense_prefix", "tail"]
    out = {}
    for key in tc:
        pools = []
        for i, tp in enumerate(tc[key]):
            planes = _random_planes(tp, 10 * len(key) + i)
            for f, x in zip(PLANES, planes):
                getattr(tp, f).copy_(torch.from_numpy(x))
            pools.append(JA.PagedKVCache(*map(jnp.asarray, planes)))
        out[key] = tuple(pools)
    return out, tc, tm


def _same(tc, jc):
    for key in tc:
        for tp, jp in zip(tc[key], jc[key]):
            for f in PLANES:
                np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                              np.asarray(getattr(jp, f)))


def test_page_copies_match_jax():
    jc, tc, _ = _caches()
    src, dst = [2, 5, 3], [7, 1, 8]
    jc = JT.cache_copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    TT.cache_copy_pages(tc, torch.tensor(src), torch.tensor(dst))
    _same(tc, jc)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_fetch_restore_and_checksums_match_jax(kv_bits):
    """Fetch pages with trash lanes, restore them into other pages; the
    fetched tree, the pools after the restore and the crcs equal JAX's."""
    jc, tc, tm = _caches(kv_bits)
    pages = [4, 7, 2]
    src = pages + [TA.TRASH_PAGE] * 2
    live = TT.cache_page_checksums(tc, pages)
    np.testing.assert_array_equal(live, JT.cache_page_checksums(jc, pages))
    jdata = jax.device_get(JT.cache_fetch_pages(jc, jnp.asarray(src)))
    tdata = TS.page_fetch(tm, tc, src)
    assert sorted(tdata) == ["blocks", "dense_prefix", "tail"]
    _same(tdata, jdata)
    pos = list(range(len(pages)))
    np.testing.assert_array_equal(TT.cache_page_checksums(tdata, pos),
                                  JT.cache_page_checksums(jdata, pos))
    np.testing.assert_array_equal(TT.cache_page_checksums(tdata, pos), live)
    dst = [1, 6, 8, TA.TRASH_PAGE, TA.TRASH_PAGE]
    jc = JT.cache_restore_pages(jc, jnp.asarray(dst), jdata)
    TS.page_restore(tm, tc, dst, tdata)
    _same(tc, jc)
    tc["dense_prefix"][0].k_q[7, 3, 1, 0] += 1      # the dense layer, page 7
    moved = TT.cache_page_checksums(tc, pages)
    assert [a != b for a, b in zip(moved, live)] == [False, True, False]


def test_cache_scatter_moves_the_dense_prefix_rows():
    cfg = get_config(ARCH, smoke=True)
    tm = build_model(cfg, "cpu")
    big = tm.init_cache(4, 16, ragged=True)
    sub = tm.init_cache(2, 8, ragged=True)
    for c in TT._caches(sub):
        for f in PLANES:
            x = getattr(c, f)
            x.copy_(torch.randint(-100, 100, x.shape).to(x.dtype))
        c.length.copy_(torch.tensor([5, 7], dtype=c.length.dtype))
    TT.cache_scatter(big, sub, torch.tensor([3, 1]))
    b, s = big["dense_prefix"][0], sub["dense_prefix"][0]
    for f in PLANES:
        assert torch.equal(getattr(b, f)[[3, 1], :, :8], getattr(s, f))
    assert b.length.tolist() == [0, 7, 0, 5]
    assert torch.equal(big["blocks"][0].length, b.length)


def test_checkpoints_of_a_dense_prefix_cache_both_ways(tmp_path):
    """JAX's generation of the paged cache tree read into the port's tree,
    and the port's read by JAX: every plane bit for bit."""
    jc, tc, tm = _caches()
    jckpt.save(str(tmp_path / "jax"), 5, {"cache": jc})
    like = {"cache": tm.init_cache(2, 32, page_size=8, num_pages=NUM_PAGES)}
    got, step = tckpt.restore_latest(str(tmp_path / "jax"), like)
    assert step == 5
    _same(got["cache"], jc)
    tckpt.save(str(tmp_path / "port"), 6, {"cache": tc})
    jlike = {"cache": jax.tree.map(jnp.zeros_like, jc)}
    jgot, step = jckpt.restore_latest(str(tmp_path / "port"), jlike)
    assert step == 6
    _same(tc, jgot["cache"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_serve_cli_serves_the_moe_archs_on_cpu(arch):
    out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 3)
    out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--continuous-batching", "--page-size", "8",
                       "--batch", "3", "--prompt-len", "10", "--new-tokens", "4"])
    assert tuple(out.shape) == (3, 4)
    assert int(out.min()) >= 0 and int(out.max()) < 256
