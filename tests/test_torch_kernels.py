"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
Inputs are made with numpy from a seed; both sides quantize them with
their own (bit-exact) code.  Outputs agree to max relative error 1e-5
(the float32 sums of exps times V are taken in another order); iteration
maps are equal.  The port's own identities (pruned == unpruned, verify
rows == single-step decodes) hold bit for bit.  The CUDA kernels are held
to the plain versions on the card by the `gpu` test below and by
`chip_smoke.py`.
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
from repro_torch.configs.base import PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.core.attention import expected_kv_block_iters
from repro_torch.kernels import ops as TO
from repro_torch.kernels.pim_attention import pim_attention, pim_attention_plain
from repro_torch.kernels.pim_decode import pim_decode, pim_decode_plain

REL = 1e-5


def _setup(seed, B, Sq, max_len, kv_len, H, Hkv, Dh, kv_bits=8,
           with_jax=True):
    """Same numpy inputs through both packages: (q, jax cache, port cache,
    jax kernel operands, port kernel operands); the JAX half is None
    without `with_jax`."""
    r = np.random.RandomState(seed)
    q = (r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32)
    k = (r.randn(B, kv_len, Hkv, Dh) * 0.5).astype(np.float32)
    v = (r.randn(B, kv_len, Hkv, Dh) * 0.5).astype(np.float32)
    tc = TA.cache_write(TA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits),
                        torch.from_numpy(k), torch.from_numpy(v), 0, TPim())
    tl = TO.kernel_attention_layout(torch.from_numpy(q), tc)
    if not with_jax:
        return q, None, tc, None, tl
    jc = JA.cache_write(JA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits),
                        jnp.asarray(k), jnp.asarray(v), 0, JPim())
    jl = JO.kernel_attention_layout(jnp.asarray(q), jc)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    return q, jc, tc, jl, tl


def _rel(t, j, valid=None):
    t, j = t.numpy().astype(np.float64), np.asarray(j, np.float64)
    if valid is not None:
        t, j = np.where(valid, t, 0.0), np.where(valid, j, 0.0)
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
# prefill kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    # (Sq, max_len, kv_len, q_offset, q_len, window, kv_bits)
    (40, 64, 40, 0, None, 0, 8),                 # causal, padded q blocks
    (40, 64, 40, 0, None, 20, 8),                # sliding window
    (24, 64, 40, 16, None, 0, 8),                # kv_len < Sk, offset > 0
    (40, 64, 40, [0, 5], [40, 17], 0, 8),        # ragged q_len / offsets
    (40, 64, 40, 0, None, 0, 4),                 # 4-bit KV
])
def test_prefill_plain_matches_pallas(case):
    Sq, max_len, kv_len, off, ql, window, kv_bits = case
    B, H, Hkv, Dh = 2, 4, 2, 32
    _, jc, tc, jl, tl = _setup(sum(map(int, np.ravel([Sq, kv_len, window]))),
                               B, Sq, max_len, kv_len, H, Hkv, Dh, kv_bits)
    kw = dict(window=window, block_q=16, block_k=16, return_iters=True)
    jq = None if ql is None else jnp.asarray(ql, jnp.int32)
    tq = None if ql is None else torch.tensor(ql)
    oj, ij = pim_attention_pallas(*jl, jnp.asarray(off, jnp.int32), jc.length,
                                  interpret=True, q_len=jq, **kw)
    ot, it = pim_attention(*tl, torch.tensor(off), tc.length, q_len=tq, **kw)
    valid = np.ones((B * H, Sq, 1), bool)
    if ql is not None:
        for b in range(B):
            valid[b * H:(b + 1) * H, ql[b]:] = False
    assert _rel(ot, oj, valid) <= REL
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("window", [0, 24])
def test_prefill_pruned_equals_unpruned_bit_for_bit(window):
    B, S, H, Hkv, Dh = 1, 64, 2, 1, 32
    _, _, tc, _, tl = _setup(1, B, S, S, S, H, Hkv, Dh, with_jax=False)
    kw = dict(window=window, block_q=16, block_k=16, return_iters=True)
    o_p, it_p = pim_attention(*tl, 0, tc.length, prune=True, **kw)
    o_d, it_d = pim_attention(*tl, 0, tc.length, prune=False, **kw)
    assert torch.equal(o_p, o_d)
    assert int(it_p.sum()) == B * H * expected_kv_block_iters(
        S, S, 0, 16, 16, window=window) < int(it_d.sum())


# ---------------------------------------------------------------------------
# split-K decode kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    # (Sq, kv_len, q_offset, q_len, window, kv_bits)
    (1, 90, 89, None, 0, 8),
    (3, 90, [88, 87], [2, 3], 0, 8),             # verify rows, ragged
    (1, 90, 89, [1, 0], 0, 8),                   # a q_len 0 row
    (1, 90, 89, None, 40, 8),                    # sliding window
    (3, 90, 87, None, 0, 4),                     # verify rows at 4 bits
])
def test_decode_plain_matches_pallas(case):
    Sq, kv_len, off, ql, window, kv_bits = case
    B, max_len, H, Hkv, Dh = 2, 128, 4, 2, 32
    _, jc, tc, jl, tl = _setup(kv_len + Sq + window, B, Sq, max_len, kv_len,
                               H, Hkv, Dh, kv_bits)
    kw = dict(window=window, block_k=32, return_iters=True)
    jq = None if ql is None else jnp.asarray(ql, jnp.int32)
    tq = None if ql is None else torch.tensor(ql)
    oj, ij = pim_decode_pallas(*jl, jnp.asarray(off, jnp.int32), jc.length,
                               interpret=True, q_len=jq, **kw)
    ot, it = pim_decode(*tl, torch.tensor(off), tc.length, q_len=tq, **kw)
    valid = np.ones((B * H, Sq, 1), bool)
    if ql is not None:
        for b in range(B):
            valid[b * H:(b + 1) * H, ql[b]:] = False
    assert _rel(ot, oj, valid) <= REL
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_verify_rows_bit_identical_to_single_steps():
    B, max_len, kv_len, Sq, H, Hkv, Dh = 2, 128, 90, 3, 4, 2, 32
    q, _, tc, _, _ = _setup(11, B, Sq, max_len, kv_len, H, Hkv, Dh, with_jax=False)
    q = torch.from_numpy(q)
    off = kv_len - Sq
    o_multi = TO.pim_flash_attention(q, tc, off, out_dtype=torch.float32,
                                     force_decode_kernel=True)
    for l in range(Sq):
        o_one = TO.pim_flash_attention(q[:, l:l + 1], tc, off + l,
                                       out_dtype=torch.float32)
        assert torch.equal(o_multi[:, l], o_one[:, 0])


@pytest.mark.parametrize("ql", [0, 1, 2, 4])
def test_decode_iteration_probe_matches_analytic(ql):
    B, max_len, kv_len, Sq, H, Hkv, Dh, bk = 1, 256, 100, 4, 2, 1, 32, 32
    _, _, tc, _, tl = _setup(13, B, Sq, max_len, kv_len, H, Hkv, Dh, with_jax=False)
    _, iters = pim_decode(*tl, kv_len - max(ql, 1), tc.length, block_k=bk,
                          return_iters=True, q_len=torch.full((B,), ql))
    exp = 0 if ql == 0 else expected_kv_block_iters(
        Sq, max_len, kv_len - ql, Sq, bk, kv_valid_len=kv_len, q_valid_len=ql)
    np.testing.assert_array_equal(iters.sum(dim=1).numpy(), exp)


@pytest.mark.parametrize("route", ["decode", "forced_decode", "prefill_kernel"])
def test_flash_attention_dispatch_matches_jax(route):
    """`ops.pim_flash_attention` routes like the reference: Sq == 1 (or
    force_decode_kernel) to the decode kernel, else the prefill kernel."""
    Sq = 3 if route == "forced_decode" else 1
    q, jc, tc, _, _ = _setup(5, 1, Sq, 96, 96, 4, 2, 32)
    kw = dict(force_decode_kernel=route == "forced_decode",
              decode_kernel=route != "prefill_kernel")
    oj = JO.pim_flash_attention(jnp.asarray(q), jc, 96 - Sq,
                                out_dtype=jnp.float32, **kw)
    ot = TO.pim_flash_attention(torch.from_numpy(q), tc, 96 - Sq,
                                out_dtype=torch.float32, **kw)
    assert _rel(ot, oj) <= REL


# ---------------------------------------------------------------------------
# no silent fallback
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", [pim_attention, pim_decode])
def test_wrapper_refuses_devices_without_a_kernel(fn):
    """Only CPU tensors take the plain version; anything else launches a
    kernel or raises."""
    ops = [torch.zeros(4, 1, 32, dtype=torch.int8, device="meta"),
           torch.zeros(4, 1, device="meta"),
           torch.zeros(2, 8, 32, dtype=torch.int8, device="meta"),
           torch.zeros(2, 8, device="meta"),
           torch.zeros(2, 8, 32, dtype=torch.int8, device="meta"),
           torch.zeros(2, 8, device="meta")]
    with pytest.raises(ValueError):
        fn(*ops, 7, 8)


def test_dense_operands_with_a_page_table_raise():
    """Paged mode (tests/test_torch_paged.py) reads the pool's own
    (P, page_size, Hkv, Dh) planes; dense operands given a page table raise
    instead of being misread."""
    _, _, tc, _, tl = _setup(3, 1, 1, 32, 16, 2, 1, 32, with_jax=False)
    for fn in (pim_attention, pim_decode):
        with pytest.raises(ValueError):
            fn(*tl, 15, 16, page_table=torch.zeros(1, 1, dtype=torch.int32))


def _paged_setup(seed, lens, Sq, H, Hkv, Dh, kv_bits, ps=16, max_len=320,
                 holes=False):
    """The same K/V in a paged pool of `ps`-token pages (a random permuted
    table, page 0 the trash page; with `holes`, an unallocated page inside
    each slot of more than two pages) and in a dense ragged cache: (paged
    operands, table, dense operands, (B,) lengths), on the CPU."""
    r = np.random.RandomState(seed)
    B = len(lens)
    q = torch.from_numpy((r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32))
    k = torch.from_numpy((r.randn(B, max_len, Hkv, Dh) * 0.5).astype(np.float32))
    v = torch.from_numpy((r.randn(B, max_len, Hkv, Dh) * 0.5).astype(np.float32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    zeros = torch.zeros(B, dtype=torch.int32)
    dense = TA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits, ragged=True)
    TA.cache_write_ragged(dense, k, v, zeros, TPim(), seq_lens=lens_t)
    n_tables = max_len // ps
    perm = r.permutation(np.arange(1, B * n_tables + 1))
    pt = np.full((B, n_tables), -1, np.int32)
    for b, n in enumerate(lens):
        pt[b, :-(-n // ps)] = perm[b * n_tables:b * n_tables - (-n // ps)]
        if holes and -(-n // ps) > 2:
            pt[b, r.randint(1, -(-n // ps) - 1)] = -1
    pt = torch.from_numpy(pt)
    pool = TA.init_paged_kv_cache(B * n_tables + 1, ps, Hkv, Dh, kv_bits=kv_bits)
    TA.paged_cache_write(pool, k, v, zeros, TPim(), pt, seq_lens=lens_t)
    q_q, qs = TO._q_kernel_layout(q, 8)
    return ((q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale), pt,
            TO.kernel_attention_layout(q, dense), lens_t)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("heads", [(4, 2, 64), (4, 4, 32), (8, 2, 128), (2, 2, 256),
                                   (16, 1, 256), (2, 2, 96), (4, 1, 96)],
                         ids=["qpk2-dh64", "qpk1-dh32", "qpk4-dh128", "qpk1-dh256",
                              "qpk16-dh256", "qpk1-dh96", "qpk4-dh96"])
def test_cuda_kernels_match_plain_versions(cuda_device, kv_bits, heads):
    """On the card: each CUDA kernel against its plain version, at head
    dims 32-256 (96 too) and groups of 1-16 q heads, over a kv_len (300) that is not a
    multiple of the prefill kernel's 64-row stage, with a sequence that has
    no valid query (q_len 0), and prefill blocks of 8 (eight to a stage) and
    128 rows (two stages each), and decode at block_k 64 and at block
    sizes the kernel does not pack (8, 48, 192).  Then decode over a pool
    of 16-token pages (slot lengths 0, 1, 17 and 300, unallocated pages
    past them), single steps and verify rows (Sq 4), against the plain
    version and, bit for bit, against the dense cache at block_k 16; and
    with an unallocated page inside the longer slots' pages, against the
    plain version."""
    H, Hkv, Dh = heads
    B, Sq, max_len = 2, 40, 300
    q, _, tc, _, tl = _setup(21, B, Sq, max_len, 300, H, Hkv, Dh, kv_bits, with_jax=False)
    tl = [t.to(cuda_device) for t in tl]
    ql = torch.tensor([Sq, 0], dtype=torch.int32, device=cuda_device)
    for fn, plain, kw in [
            (pim_attention, pim_attention_plain, dict(window=50)),
            (pim_attention, pim_attention_plain, dict(q_len=ql)),
            (pim_attention, pim_attention_plain, dict(block_k=8)),
            (pim_attention, pim_attention_plain, dict(block_k=128, window=70)),
            (pim_decode, pim_decode_plain, dict(block_k=64)),
            (pim_decode, pim_decode_plain, dict(block_k=8)),
            (pim_decode, pim_decode_plain, dict(block_k=48, window=50)),
            (pim_decode, pim_decode_plain, dict(block_k=192))]:
        o_k, it_k = fn(*tl, 300 - Sq, 300, return_iters=True, **kw)
        o_p, it_p = plain(*tl, 300 - Sq, 300, return_iters=True, **kw)
        assert float((o_k - o_p).abs().max()) <= REL * float(o_p.abs().max())
        assert torch.equal(it_k, it_p)
    for Sq in (1, 4):
        paged, pt, dense, lens = _paged_setup(Sq, [0, 1, 17, 300], Sq, H, Hkv,
                                              Dh, kv_bits)
        paged, dense = ([t.to(cuda_device) for t in ops] for ops in (paged, dense))
        pt, lens = pt.to(cuda_device), lens.to(cuda_device)
        offs, ql = torch.clamp(lens - Sq, min=0), torch.clamp(lens, max=Sq)
        kw = dict(q_len=ql, return_iters=True)
        o_k, it_k = pim_decode(*paged, offs, lens, page_table=pt, **kw)
        o_p, it_p = pim_decode_plain(*paged, offs, lens, page_table=pt, **kw)
        assert float((o_k - o_p).abs().max()) <= REL * float(o_p.abs().max())
        assert torch.equal(it_k, it_p)
        o_d, it_d = pim_decode(*dense, offs, lens, block_k=16, **kw)
        assert torch.equal(o_k, o_d) and torch.equal(it_k, it_d)
        paged, pt, _, lens = _paged_setup(Sq, [0, 1, 50, 300], Sq, H, Hkv, Dh,
                                          kv_bits, holes=True)
        assert all(bool((pt[b, :-(-n // 16)] < 0).any()) for b, n in ((2, 50), (3, 300)))
        paged = [t.to(cuda_device) for t in paged]
        pt, lens = pt.to(cuda_device), lens.to(cuda_device)
        offs, ql = torch.clamp(lens - Sq, min=0), torch.clamp(lens, max=Sq)
        kw = dict(q_len=ql, return_iters=True)
        o_k, it_k = pim_decode(*paged, offs, lens, page_table=pt, **kw)
        o_p, it_p = pim_decode_plain(*paged, offs, lens, page_table=pt, **kw)
        assert float((o_k - o_p).abs().max()) <= REL * float(o_p.abs().max())
        assert torch.equal(it_k, it_p)
