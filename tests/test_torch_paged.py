"""The port's ragged and paged KV storage and the paged mode of its two
attention kernels, against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
  * cache writes (ragged drop mode, paged trash routing) and the gathered
    view: bit-exact, planes and lengths;
  * the plain paged kernels against `pim_attention_pallas` /
    `pim_decode_pallas` with a page table (interpret mode) over random
    permuted tables: rel <= 1e-5 (float32 sums of exps times V reorder),
    iteration maps equal;
  * the port's own identities bit for bit: paged == dense at block_k ==
    page_size, for both plain versions and the behavioral path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PIMConfig as JPim
from repro.core import attention as JA
from repro.kernels import ops as JO
from repro.kernels.pim_attention import pim_attention_pallas
from repro.kernels.pim_decode import pim_decode_pallas
from repro_torch.configs.base import LUTSoftmaxConfig as TLut, PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.kernels import ops as TO
from repro_torch.kernels.pim_attention import pim_attention
from repro_torch.kernels.pim_decode import pim_decode

REL = 1e-5


def _heads_last(x: torch.Tensor) -> np.ndarray:
    """A port dense plane (B, Hkv, S, ...) in the reference's (B, S, Hkv, ...)."""
    return x.transpose(1, 2).numpy()


def random_table(rng, lens, ps, n_tables):
    """A random permutation page table covering `lens` tokens per row, -1
    past each row's pages; page 0 (trash) is never handed out."""
    B = len(lens)
    P = B * n_tables + 1
    perm = rng.permutation(np.arange(1, P))
    pt = np.full((B, n_tables), -1, np.int32)
    i = 0
    for b in range(B):
        for j in range(-(-int(lens[b]) // ps)):
            pt[b, j] = perm[i]
            i += 1
    return pt, P


def paired(seed, lens, max_len, Hkv, Dh, ps, kv_bits=8):
    """The same K/V written into a dense ragged cache and a paged pool
    (random table) by both packages.  Returns the port's (dense, pool, pt)
    and the reference's (dense, pool, pt)."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    k = (rng.randn(B, max_len, Hkv, Dh) * 0.5).astype(np.float32)
    v = (rng.randn(B, max_len, Hkv, Dh) * 0.5).astype(np.float32)
    pt, P = random_table(rng, lens, ps, max_len // ps)
    zeros, lens_np = np.zeros(B, np.int32), np.asarray(lens, np.int32)
    jd = JA.cache_write_ragged(
        JA.init_kv_cache(B, max_len, Hkv, Dh, ragged=True, kv_bits=kv_bits),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(zeros), JPim(),
        seq_lens=jnp.asarray(lens_np))
    jp = JA.paged_cache_write(
        JA.init_paged_kv_cache(P, ps, Hkv, Dh, kv_bits=kv_bits),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(zeros), JPim(),
        jnp.asarray(pt), seq_lens=jnp.asarray(lens_np))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    td = TA.cache_write_ragged(
        TA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits, ragged=True),
        tk, tv, torch.from_numpy(zeros), TPim(),
        seq_lens=torch.from_numpy(lens_np))
    tp = TA.paged_cache_write(
        TA.init_paged_kv_cache(P, ps, Hkv, Dh, kv_bits=kv_bits), tk, tv,
        torch.from_numpy(zeros), TPim(), torch.from_numpy(pt),
        seq_lens=torch.from_numpy(lens_np))
    return (td, tp, torch.from_numpy(pt)), (jd, jp, jnp.asarray(pt))


def _q(seed, B, Sq, H, Dh):
    return (np.random.RandomState(seed + 100).randn(B, Sq, H, Dh) * 0.5
            ).astype(np.float32)


def _rel(t, j):
    t, j = t.numpy().astype(np.float64), np.asarray(j, np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------
def test_cache_write_ragged_bytes_and_lengths():
    B, max_len, Hkv, Dh = 3, 32, 2, 8
    r = np.random.RandomState(3)
    k = r.randn(B, 4, Hkv, Dh).astype(np.float32)
    v = r.randn(B, 4, Hkv, Dh).astype(np.float32)
    pos, sl = np.array([0, 5, 20], np.int32), np.array([4, 2, 0], np.int32)
    j = JA.cache_write_ragged(JA.init_kv_cache(B, max_len, Hkv, Dh, ragged=True),
                              jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                              JPim(), jnp.asarray(sl))
    t = TA.cache_write_ragged(TA.init_kv_cache(B, max_len, Hkv, Dh, ragged=True),
                              torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos), TPim(), torch.from_numpy(sl))
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_heads_last(getattr(t, f)),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))
    assert t.length.dtype == torch.int32


@pytest.mark.parametrize("pos,sl", [([6], [4]), ([9], [2]), ([8], [1])])
def test_cache_write_ragged_overflow_drops_like_jax(pos, sl):
    """Tokens past max_len vanish, the in-bounds prefix is written, nothing
    is clamped onto the last position and the length is capped."""
    B, max_len, Hkv, Dh = 1, 8, 2, 4
    r = np.random.RandomState(1)
    k0, v0 = (r.randn(2, B, max_len, Hkv, Dh)).astype(np.float32)
    k1, v1 = (r.randn(2, B, 4, Hkv, Dh)).astype(np.float32)
    j = JA.cache_write_ragged(JA.init_kv_cache(B, max_len, Hkv, Dh, ragged=True),
                              jnp.asarray(k0), jnp.asarray(v0),
                              jnp.asarray([0]), JPim())
    j = JA.cache_write_ragged(j, jnp.asarray(k1), jnp.asarray(v1),
                              jnp.asarray(pos), JPim(), seq_lens=jnp.asarray(sl))
    t = TA.init_kv_cache(B, max_len, Hkv, Dh, ragged=True)
    TA.cache_write_ragged(t, torch.from_numpy(k0), torch.from_numpy(v0),
                          torch.tensor([0]), TPim())
    TA.cache_write_ragged(t, torch.from_numpy(k1), torch.from_numpy(v1),
                          torch.tensor(pos), TPim(), seq_lens=torch.tensor(sl))
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_heads_last(getattr(t, f)),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))


def test_cache_write_ragged_overflow_debug_raises():
    k = torch.randn(2, 4, 2, 4)
    cache = TA.init_kv_cache(2, 8, 2, 4, ragged=True)
    with pytest.raises(ValueError, match="overflow"):
        TA.cache_write_ragged(cache, k, k, torch.tensor([0, 6]), TPim(),
                              seq_lens=torch.tensor([4, 4]), debug=True)
    assert int(cache.k_q.abs().sum()) == 0          # raised before any write
    TA.cache_write_ragged(cache, k, k, torch.tensor([0, 4]), TPim(),
                          seq_lens=torch.tensor([4, 4]), debug=True)


def test_paged_cache_write_routing_and_trash_isolation():
    """Row 1's tokens past its allocated page go to the trash page and do
    not clobber row 0's page 1; every page but the trash page (whose bytes
    nobody reads) equals the reference's."""
    B, Hkv, Dh, ps = 2, 2, 8, 4
    r = np.random.RandomState(0)
    k = r.randn(B, 6, Hkv, Dh).astype(np.float32)
    v = r.randn(B, 6, Hkv, Dh).astype(np.float32)
    pt = np.array([[3, 1], [2, -1]], np.int32)
    sl = np.array([6, 3], np.int32)
    j = JA.paged_cache_write(JA.init_paged_kv_cache(5, ps, Hkv, Dh),
                             jnp.asarray(k), jnp.asarray(v), jnp.zeros(B, jnp.int32),
                             JPim(), jnp.asarray(pt), seq_lens=jnp.asarray(sl))
    t = TA.paged_cache_write(TA.init_paged_kv_cache(5, ps, Hkv, Dh),
                             torch.from_numpy(k), torch.from_numpy(v),
                             torch.zeros(B, dtype=torch.int32), TPim(),
                             torch.from_numpy(pt), seq_lens=torch.from_numpy(sl))
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(t, f)[1:].numpy(),
                                      np.asarray(getattr(j, f))[1:])
    kq, _, _, _ = TA.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), TPim())
    assert torch.equal(t.k_q[1, :2], kq[0, 4:6])
    assert int(t.k_q[4].abs().sum()) == 0           # in no table: untouched


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_pool_and_gather_match_jax_and_dense(kv_bits):
    lens = [50, 17, 0]
    (td, tp, tpt), (jd, jp, jpt) = paired(4, lens, 64, 2, 32, 16, kv_bits)
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tp, f)[1:].numpy(),
                                      np.asarray(getattr(jp, f))[1:])
    g = TA.paged_gather(tp, tpt, torch.tensor(lens, dtype=torch.int32))
    jg = JA.paged_gather(jp, jpt, jnp.asarray(lens, jnp.int32))
    np.testing.assert_array_equal(g.length.numpy(), np.asarray(jg.length))
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        gf, df, jf = getattr(g, f), getattr(td, f), np.asarray(getattr(jg, f))
        for b, n in enumerate(lens):        # the gathered view == dense rows
            np.testing.assert_array_equal(_heads_last(gf)[b, :n], jf[b, :n])
            assert torch.equal(gf[b, :, :n], df[b, :, :n])


# ---------------------------------------------------------------------------
# paged kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_plain_kernels_match_pallas(seed):
    """Decode (Sq 1), verify rows (Sq 3) and a ragged prefill chunk (Sq 8)
    over a random permuted table, held to the Pallas kernels' paged mode."""
    B, max_len, H, Hkv, Dh, ps = 3, 64, 4, 2, 32, 16
    lens = np.array([[50, 17, 0], [64, 1, 33], [16, 15, 17]][seed], np.int32)
    (_, tp, tpt), (_, jp, jpt) = paired(seed, lens, max_len, Hkv, Dh, ps)
    jk = JO.paged_kernel_layout(jp)
    tk = (tp.k_q, tp.k_scale, tp.v_q, tp.v_scale)
    t_l = torch.from_numpy(lens)
    for Sq, fn, jfn, kw in ((1, pim_decode, pim_decode_pallas, {}),
                            (3, pim_decode, pim_decode_pallas, {}),
                            (8, pim_attention, pim_attention_pallas,
                             dict(block_q=8))):
        q = _q(seed + Sq, B, Sq, H, Dh)
        offs = np.maximum(lens - Sq, 0).astype(np.int32)
        ql = np.minimum(lens, Sq).astype(np.int32)
        jq, jqs = JO._q_kernel_layout(jnp.asarray(q), 8)
        tq, tqs = TO._q_kernel_layout(torch.from_numpy(q), 8)
        oj, ij = jfn(jq, jqs, jk[0], jk[1], jk[2], jk[3], jnp.asarray(offs),
                     jnp.asarray(lens), interpret=True, return_iters=True,
                     page_table=jpt, q_len=jnp.asarray(ql), **kw)
        ot, it = fn(tq, tqs, *tk, torch.from_numpy(offs), t_l,
                    return_iters=True, page_table=tpt,
                    q_len=torch.from_numpy(ql), **kw)
        valid = np.repeat(np.arange(Sq)[None] < ql[:, None], H, axis=0)
        o_t = np.where(valid[..., None], ot.numpy(), 0.0)
        o_j = np.where(valid[..., None], np.asarray(oj), 0.0)
        assert np.abs(o_t - o_j).max() <= REL * np.abs(o_j).max()
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_equals_dense_bit_for_bit(kv_bits):
    """At block_k == page_size the page walk visits the same tiles in the
    same order as the dense launch, and unallocated pages add exact zeros:
    both plain kernels and the behavioral path agree bit for bit."""
    B, max_len, H, Hkv, Dh, ps = 3, 64, 4, 2, 32, 16
    lens = np.array([33, 64, 5], np.int32)
    (td, tp, tpt), _ = paired(7, lens, max_len, Hkv, Dh, ps, kv_bits)
    t_l = torch.from_numpy(lens)
    for Sq in (1, 4, 8):
        q = torch.from_numpy(_q(Sq, B, Sq, H, Dh))
        offs = torch.from_numpy(np.maximum(lens - Sq, 0).astype(np.int32))
        for force in (False, True):
            if force and Sq == 8:
                continue
            o_d = TO.pim_flash_attention(q, td, offs, decode_block_k=ps,
                                         out_dtype=torch.float32,
                                         force_decode_kernel=force)
            o_p = TO.pim_paged_flash_attention(q, tp, tpt, t_l, offs,
                                               out_dtype=torch.float32,
                                               force_decode_kernel=force)
            if Sq > 1 and not force:    # the dense prefill launch at bk == ps
                q_q, qs = TO._q_kernel_layout(q, 8)
                dense_ops = TO.kernel_attention_layout(q, td)
                o_d = pim_attention(*dense_ops, offs, td.length, block_k=ps)
                o_p = pim_attention(q_q, qs, tp.k_q, tp.k_scale, tp.v_q,
                                    tp.v_scale, offs, t_l, page_table=tpt)
            assert torch.equal(o_d, o_p), (Sq, force)
    if kv_bits == 8:
        q = torch.from_numpy(_q(0, B, 1, H, Dh))
        offs = torch.from_numpy(np.maximum(lens - 1, 0).astype(np.int32))
        o_d = TA.pim_attention(q, td, TPim(), TLut(), offs,
                               out_dtype=torch.float32)
        o_p = TA.pim_attention(q, TA.paged_gather(tp, tpt, t_l), TPim(),
                               TLut(), offs,
                               out_dtype=torch.float32)
        assert torch.equal(o_d, o_p)


def test_paged_decode_zero_compute_and_page_boundaries():
    """Slot b runs exactly Hkv * ceil(len_b / ps) partitions (the page
    boundary lengths ps-1, ps, ps+1, 2ps and an empty slot), unallocated
    entries none, and the output equals the dense launch bit for bit."""
    ps, H, Hkv, Dh = 16, 4, 2, 32
    lens = np.array([ps - 1, ps, ps + 1, 2 * ps, 0], np.int32)
    B = len(lens)
    (td, tp, tpt), (jd, jp, jpt) = paired(5, lens, 4 * ps, Hkv, Dh, ps)
    q = _q(5, B, 1, H, Dh)
    offs = np.maximum(lens - 1, 0).astype(np.int32)
    q_q, qs = TO._q_kernel_layout(torch.from_numpy(q), 8)
    o_p, it = pim_decode(q_q, qs, tp.k_q, tp.k_scale, tp.v_q, tp.v_scale,
                         torch.from_numpy(offs), torch.from_numpy(lens),
                         return_iters=True, page_table=tpt)
    per_slot = it.reshape(B, Hkv, -1).sum(dim=(1, 2)).numpy()
    np.testing.assert_array_equal(per_slot, [Hkv * -(-int(n) // ps) for n in lens])
    assert not bool(it.reshape(B, Hkv, -1)[(tpt < 0)[:, None].expand(B, Hkv, -1)].any())
    assert int(o_p.reshape(B, H, Dh)[4].abs().sum()) == 0
    dense_ops = TO.kernel_attention_layout(torch.from_numpy(q), td)
    o_d = pim_decode(*dense_ops, torch.from_numpy(offs), td.length, block_k=ps)
    assert torch.equal(o_d, o_p)
    jk = JO.paged_kernel_layout(jp)
    jq, jqs = JO._q_kernel_layout(jnp.asarray(q), 8)
    _, ij = pim_decode_pallas(jq, jqs, *jk, jnp.asarray(offs), jnp.asarray(lens),
                              interpret=True, return_iters=True, page_table=jpt)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_page_table_on_the_cpu_takes_the_plain_path_and_bad_tables_raise():
    (_, tp, tpt), _ = paired(9, [20, 3], 32, 2, 32, 16)
    q_q, qs = TO._q_kernel_layout(torch.from_numpy(_q(9, 2, 1, 4, 32)), 8)
    ops = (q_q, qs, tp.k_q, tp.k_scale, tp.v_q, tp.v_scale)
    pim_decode(*ops, torch.tensor([19, 2]), torch.tensor([20, 3]), page_table=tpt)
    with pytest.raises(ValueError):
        pim_decode(*ops, 19, 20, page_table=tpt.long())
    with pytest.raises(ValueError):
        pim_attention(*ops, 19, 20, page_table=torch.cat([tpt, tpt[:1]]))
    with pytest.raises(TypeError):
        pim_attention(*ops, np.array([19, 2]), 20, page_table=tpt)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("heads", [(4, 2, 32), (2, 2, 128), (8, 2, 64)],
                         ids=["qpk2-dh32", "qpk1-dh128", "qpk4-dh64"])
def test_cuda_paged_kernels_match_plain_versions(cuda_device, kv_bits, heads):
    """On the card: the paged mode of each CUDA kernel against its plain
    version (rel <= 1e-5, iteration maps equal) and against the dense
    launch at block_k == page_size (bit for bit), at head dims 32-128 and
    groups of 1-4 q heads, with lengths (33, 64, 0) that are not a multiple
    of the prefill kernel's 64-row stage and a row of q_len 0."""
    from repro_torch.kernels.pim_attention import pim_attention_plain
    from repro_torch.kernels.pim_decode import pim_decode_plain
    H, Hkv, Dh = heads
    B, max_len, ps = 3, 64, 16
    lens = np.array([33, 64, 0], np.int32)
    (td, tp, tpt), _ = paired(11, lens, max_len, Hkv, Dh, ps, kv_bits)
    dev = cuda_device
    pool = [t.to(dev) for t in (tp.k_q, tp.k_scale, tp.v_q, tp.v_scale)]
    td = TA.KVCache(td.k_q.to(dev), td.v_q.to(dev), td.k_scale.to(dev),
                    td.v_scale.to(dev), td.length.to(dev))
    pt, t_l = tpt.to(dev), torch.from_numpy(lens).to(dev)
    for Sq, fn, plain in ((1, pim_decode, pim_decode_plain),
                          (4, pim_decode, pim_decode_plain),
                          (8, pim_attention, pim_attention_plain),
                          (40, pim_attention, pim_attention_plain)):
        q = torch.from_numpy(_q(Sq, B, Sq, H, Dh)).to(dev)
        offs = torch.clamp(t_l - Sq, min=0)
        ql = torch.clamp(t_l, max=Sq)
        q_q, qs = TO._q_kernel_layout(q, 8)
        o_k, it_k = fn(q_q, qs, *pool, offs, t_l, return_iters=True,
                       page_table=pt, q_len=ql)
        o_p, it_p = plain(q_q, qs, *pool, offs, t_l, return_iters=True,
                          page_table=pt, q_len=ql)
        assert float((o_k - o_p).abs().max()) <= REL * float(o_p.abs().max())
        assert torch.equal(it_k, it_p)
        o_d, it_d = fn(*TO.kernel_attention_layout(q, td), offs, t_l,
                       return_iters=True, block_k=ps, q_len=ql)
        assert torch.equal(o_k, o_d) and torch.equal(it_k, it_d)
