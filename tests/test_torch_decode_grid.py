"""The decode kernel's grid, combine and PV order, on the CPU.

The CUDA kernel (`kernels/csrc/pim_decode.cu`) cannot run here.  What it
decides in Python and in integer arithmetic is replayed in torch:
- `launch_plan` covers every packed row once and fits the card;
- `needed_range` gives exactly the partitions `block_needed` allows, and
  the runs of `cta_runs` visit each needed partition (allocated pages of
  the range) exactly once: the iteration map of `pim_decode_plain`;
- the kernel's combine, over the needed partitions only and in order,
  equals `combine_plain` over all of them bit for bit, whatever the
  records of unallocated pages hold (the kernel never writes them);
- the kernel's PV order (keys split over warps, 16 a warp a 128-row stage,
  fused multiply-add in key order, warp sums added in warp order; a
  block_k other than 16, 32, 64 or a multiple of 128 padded to whole
  stages)
  stays within REL of the plain version, and keeps verify rows equal to
  single steps and paged equal to dense at block_k == page size, bit for
  bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core import attention as TA
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.kernels import ops as TO
from repro_torch.kernels.pim_attention import (
    MAX_SMEM, _NEG, block_needed, cdiv, kv_blocks, scalar_table)
from repro_torch.kernels.pim_decode import (
    KEYS, KV_ROWS, TILE_ROWS, WARPS, blocks_a_unit, combine_plain, cta_runs,
    launch_plan, needed_range, pim_decode_plain, unit_rows)

REL = 1e-5
LUT = LUTSoftmaxConfig()
# slot lengths, with pages of 16: empty, one token, a page less / exactly /
# one more, and a few hundred
LENS = (0, 1, 15, 16, 17, 300, 333)


def _slots(seed, n, Sq):
    """n random (kv_len, q_len) slots: lengths from LENS, q_len 0..Sq."""
    r = np.random.RandomState(seed)
    kv = r.choice(LENS, n)
    ql = np.minimum(r.randint(0, Sq + 1, n), np.maximum(kv, 0))
    return kv.astype(np.int32), ql.astype(np.int32)


def _table(lens, n_tables, ps, seed, holes=True):
    """A random permuted (B, n_tables) page table over pages 1.., -1 past
    each slot's pages and, with `holes`, at a random page inside them."""
    r = np.random.RandomState(seed)
    pt = np.full((len(lens), n_tables), -1, np.int32)
    perm = r.permutation(np.arange(1, len(lens) * n_tables + 1))
    for b, n in enumerate(lens):
        k = -(-int(n) // ps)
        pt[b, :k] = perm[b * n_tables:b * n_tables + k]
        if holes and k > 2:
            pt[b, r.randint(1, k - 1)] = -1
    return torch.from_numpy(pt)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R", [1, 2, 3, 8, 9, 40, 160])
@pytest.mark.parametrize("dh,block_k,paged", [(128, 256, False), (128, 16, True),
                                             (64, 32, False), (32, 64, True),
                                             (128, 8, True), (64, 48, False),
                                             (128, 192, False), (96, 256, False),
                                             (96, 16, True)])
def test_launch_plan_covers_rows_and_fits(R, dh, block_k, paged):
    n_k = 256 if paged else 16
    plan = launch_plan(R, dh, dh, block_k, n_k, 32, paged, 132)
    assert plan.rows in TILE_ROWS and plan.rows >= min(R, TILE_ROWS[-1])
    assert (plan.row_tiles - 1) * plan.rows < R <= plan.row_tiles * plan.rows
    assert 1 <= plan.chunks <= cdiv(n_k, blocks_a_unit(block_k))
    assert plan.dsplit in (1, dh // 32) and plan.dsplit * 32 <= dh
    assert plan.smem <= MAX_SMEM


def test_launch_plan_at_the_served_shapes():
    """internlm2-1.8b (16 over 8 heads, head_dim 128): the classic request
    (B 4, one 256-row partition a head) takes one CTA a head and 32-dim
    slice of the output, four a head; kv_len 4096
    cuts each head's 16 partitions over about two CTAs an SM; the paged
    trace (8 slots, 32 pages: four units of 8 pages) and verify rows (Sq 4:
    8 rows, one tile)."""
    p = launch_plan(2, 128, 128, 256, 1, 32, False, 132)
    assert (p.rows, p.row_tiles, p.dsplit, p.chunks) == (2, 1, 4, 1)
    p = launch_plan(2, 128, 64, 256, 1, 32, False, 132)     # 4-bit: no slices
    assert (p.rows, p.row_tiles, p.dsplit, p.chunks) == (2, 1, 1, 1)
    p = launch_plan(2, 128, 128, 256, 16, 32, False, 132)
    assert (p.rows, p.row_tiles, p.dsplit, p.chunks) == (2, 1, 1, 9)
    p = launch_plan(2, 128, 128, 16, 32, 64, True, 132)
    assert (p.rows, p.row_tiles, p.dsplit, p.chunks) == (2, 1, 1, 4)
    p = launch_plan(8, 128, 128, 16, 256, 32, True, 132)
    assert (p.rows, p.row_tiles, p.dsplit, p.chunks) == (8, 1, 1, 9)


@pytest.mark.parametrize("args", [
    (2, 80, 80, 256, 16, 32, False, 132),     # head_dim outside 32 / 64 / 96 / 128 / 256
    (2, 128, 48, 256, 16, 32, False, 132),    # stored width neither int8 nor 4 bits
    (2, 128, 128, 0, 16, 32, False, 132),     # block_k not positive
    (2, 128, 128, -16, 16, 32, False, 132),
    (8, 128, 128, 1 << 14, 16, 32, False, 132),  # a block's codes past shared memory
    (2, 128, 128, 16, 60000, 32, True, 132),  # a page table past shared memory
    (160, 128, 128, 256, 16, 4000, False, 132),  # past the grid's 65535 tiles
])
def test_launch_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        launch_plan(*args)


# ---------------------------------------------------------------------------
# the needed range and the runs of the grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("bk", [8, 16, 32, 64, 256])
def test_needed_range_is_block_needed(bk, window):
    """Over random slots (lengths LENS, q_len 0-4, offsets at and before
    the cache's end, causal and not), [lo, hi] holds exactly the partitions
    block_needed allows, for slots with a query."""
    kv, ql = _slots(bk + window, 64, 4)
    r = np.random.RandomState(window)
    q_pos = torch.from_numpy(np.maximum(kv - ql - r.randint(0, 3, 64), 0))
    kv, ql = torch.from_numpy(kv).long(), torch.from_numpy(ql).long()
    n_k = cdiv(400, bk)
    k_idx = torch.arange(n_k)
    for causal in (True, False):
        lo, hi = needed_range(q_pos.long(), kv, ql, 4, bk, n_k, causal, window)
        got = (k_idx >= lo[:, None]) & (k_idx <= hi[:, None])
        n_valid = torch.clamp(ql, max=4)
        want = (ql[:, None] > 0) & block_needed(
            k_idx[None] * bk, bk, q_pos[:, None], (q_pos + n_valid - 1)[:, None],
            kv[:, None], causal, window)
        assert torch.equal(got, want)


@pytest.mark.parametrize("chunks", [1, 2, 3, 5, 13, 64])
@pytest.mark.parametrize("bk", [8, 16, 32, 48, 64, 128, 192, 256])
def test_cta_runs_cover_the_range_once(bk, chunks):
    nbu = blocks_a_unit(bk)
    for lo, hi in [(0, 0), (0, 20), (3, 17), (5, 4), (7, 255), (30, 31)]:
        runs = cta_runs(lo, hi, bk, chunks)
        assert len(runs) <= chunks
        units = [u for u0, u1 in runs for u in range(u0, u1)]
        if hi < lo:
            assert runs == []
            continue
        assert all(u1 > u0 for u0, u1 in runs)
        assert units == list(range(lo // nbu, hi // nbu + 1))


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("Sq", [1, 4])
def test_grid_visits_the_plain_iteration_map(Sq, window):
    """The kernel's grid replayed over random paged slots (lengths LENS,
    q_len 0-4, unallocated pages inside the table): the partitions its CTAs
    visit are `pim_decode_plain`'s iteration map, each once, at the chunk
    counts of 1, 8 and 132 SMs."""
    B, H, Hkv, Dh, ps, n_tables = 6, 4, 2, 32, 16, 24
    kv, ql = _slots(Sq * 7 + window, B, Sq)
    kv_t, ql_t = torch.from_numpy(kv), torch.from_numpy(ql)
    q_pos = torch.clamp(kv_t - ql_t, min=0)
    pt = _table(kv, n_tables, ps, Sq + window)
    r = np.random.RandomState(3)
    q_q = torch.from_numpy(r.randint(-127, 128, (B * H, Sq, Dh)).astype(np.int8))
    qs = torch.ones(B * H, Sq)
    P = B * n_tables + 1
    k_q = torch.from_numpy(r.randint(-127, 128, (P, ps, Hkv, Dh)).astype(np.int8))
    ks = torch.ones(P, ps, Hkv)
    _, iters = pim_decode_plain(q_q, qs, k_q, ks, k_q, ks, q_pos, kv_t, window=window,
                                page_table=pt, q_len=ql_t, return_iters=True)
    sc = scalar_table(q_pos, kv_t, ql_t, "cpu", B)
    lo, hi = needed_range(sc[0].long(), sc[1].long(), sc[2].long(), Sq, ps,
                          n_tables, True, window)
    nbu = blocks_a_unit(ps)
    for sms in (1, 8, 132):
        plan = launch_plan(Sq * H // Hkv, Dh, Dh, ps, n_tables, B * Hkv, True, sms)
        for bhkv in range(B * Hkv):
            b = bhkv // Hkv
            seen = torch.zeros(n_tables, dtype=torch.int32)
            for u0, u1 in cta_runs(int(lo[b]), int(hi[b]), ps, plan.chunks):
                for ki in range(u0 * nbu, u1 * nbu):
                    if lo[b] <= ki <= hi[b] and pt[b, ki] >= 0:
                        seen[ki] += 1
            assert torch.equal(seen, iters[bhkv])


# ---------------------------------------------------------------------------
# the combine
# ---------------------------------------------------------------------------
def combine_needed(part_m, part_den, part_acc, needed, lut_cfg):
    """The kernel's combine: the rows' maxima over the needed partitions,
    then only those, in partition order, with separately rounded multiply
    and add.  A record that is not needed is never read as a maximum (its
    m taken as -2^24, its rescale 0), and adds nothing."""
    table, frac = build_exp_table(lut_cfg, part_m.device)
    m_glob = torch.where(needed[..., None], part_m, _NEG).amax(dim=1)
    den = torch.zeros_like(part_den[:, 0])
    acc = torch.zeros_like(part_acc[:, 0])
    for p in range(part_m.shape[1]):
        m_p = torch.where(needed[:, p, None], part_m[:, p], _NEG)
        rs = table.float()[torch.clamp(m_glob - m_p, 0, 255).long()] * (1.0 / (1 << frac))
        rs = torch.where(m_p <= _NEG / 2, 0.0, rs)
        use = needed[:, p, None]
        den = torch.where(use, den + part_den[:, p] * rs, den)
        acc = torch.where(use[..., None], acc + part_acc[:, p] * rs[..., None], acc)
    return acc / torch.clamp_min(den, 1.0)[..., None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_over_needed_partitions_equals_combine_plain(seed):
    """Random partials with the reference's skipped partitions (exact zeros
    and m = -2^24), rows masked in some partitions and rows with no score
    at all: combining only the needed partitions, in order, equals
    combine_plain over every partition bit for bit."""
    r = np.random.RandomState(seed)
    N, n_k, R, Dh = 8, 32, 4, 16
    needed = torch.from_numpy(r.rand(N, n_k) < 0.6)
    part_m = torch.from_numpy(r.randint(-128, 128, (N, n_k, R))).float()
    part_m = torch.where(torch.from_numpy(r.rand(N, n_k, R) < 0.2), _NEG, part_m)
    part_m[:, :, R - 1] = _NEG                             # a row with no score
    empty = part_m <= _NEG / 2
    part_den = torch.from_numpy(r.randint(1, 1 << 20, (N, n_k, R))).float()
    part_acc = torch.from_numpy(r.randn(N, n_k, R, Dh).astype(np.float32)) * 1e4
    part_den = torch.where(empty, 0.0, part_den)
    part_acc = torch.where(empty[..., None], 0.0, part_acc)
    # the kernel's records of skipped partitions were never written: any
    # bytes (here maxima far above every written one, NaN and inf sums)
    junk_m = torch.from_numpy(r.randint(1 << 20, 1 << 30, (N, n_k, R))).float()
    junk = torch.from_numpy(r.choice([np.nan, np.inf, -3e38], (N, n_k, R))).float()
    k_m = torch.where(needed[..., None], part_m, junk_m)
    k_den = torch.where(needed[..., None], part_den, junk)
    k_acc = torch.where(needed[..., None, None], part_acc, junk[..., None])
    part_m = torch.where(needed[..., None], part_m, _NEG)
    part_den = torch.where(needed[..., None], part_den, 0.0)
    part_acc = torch.where(needed[..., None, None], part_acc, 0.0)
    out = combine_needed(k_m, k_den, k_acc, needed, LUT)
    assert torch.equal(out, combine_plain(part_m, part_den, part_acc, LUT))
    assert bool((out[:, R - 1] == 0).all())


# ---------------------------------------------------------------------------
# the PV order
# ---------------------------------------------------------------------------
def replay_decode(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_pos, kv_len,
                  q_len, bk, window=0, page_table=None):
    """The kernel's arithmetic in torch: per partition the plain version's
    codes, maxima, exps and den; acc with the keys split over warps (16
    keys a warp in each 128-row stage; a short block takes bk / 16 warps),
    each warp summing fl(e * v + a) in key order (a fused multiply-add,
    taken in float64, where e * v is exact), the warp sums added in warp
    order; a block_k the kernel does not pack is padded with zero keys to
    whole stages; then `combine_needed`."""
    BH, Sq, Dh = q_q.shape
    scalars = scalar_table(q_pos, kv_len, q_len, "cpu",
                           1 if page_table is None else page_table.shape[0])
    nb = scalars.shape[1]
    BHkv = (page_table.shape[0] * k_q.shape[2] if page_table is not None
            else k_q.shape[0])
    G, R = BH // BHkv, Sq * BH // BHkv
    qg = q_q.reshape(BHkv, G, Sq, Dh).transpose(1, 2).reshape(BHkv, R, Dh)
    qsg = q_scale.reshape(BHkv, G, Sq).transpose(1, 2).reshape(BHkv, R)
    rows = torch.arange(BHkv)
    seq = rows // (BHkv // nb)
    head = rows if page_table is None else rows % (BHkv // nb)
    kv, ks, vv, vs, alloc = kv_blocks(k_q, k_scale, v_q, v_scale, page_table,
                                      seq, head, bk, Dh)
    n_k = kv.shape[1]
    vdeq = vv.float() * vs[..., None]
    sc = scalars.long()[:, seq]
    qp, kvl, ql = sc[0], sc[1], sc[2]
    lo, hi = needed_range(qp, kvl, ql, Sq, bk, n_k, True, window)
    k_idx = torch.arange(n_k)
    needed = alloc & (k_idx >= lo[:, None]) & (k_idx <= hi[:, None])
    k_pos = (k_idx[:, None] * bk + torch.arange(bk))[None]
    table, _ = build_exp_table(LUT, "cpu")
    table = table.float()
    qmax = 127.0
    if blocks_a_unit(bk) > 1:
        S, W = 1, bk // KEYS
    else:
        S, W = unit_rows(bk) // KV_ROWS, WARPS
    pad = S * W * KEYS - bk     # zero keys: their e and V are exact zeros

    def by_warp(x):   # (BHkv, n_k, bk[, Dh]) -> (BHkv, n_k, S, W, KEYS[, Dh])
        z = torch.zeros(x.shape[:2] + (pad,) + x.shape[3:], dtype=x.dtype)
        return torch.cat([x, z], dim=2).reshape(x.shape[:2] + (S, W, KEYS) + x.shape[3:])

    v_w = by_warp(vdeq)
    part_m = torch.full((BHkv, n_k, R), _NEG)
    part_den = torch.zeros((BHkv, n_k, R))
    part_acc = torch.zeros((BHkv, n_k, R, Dh))
    for r in range(R):
        l = r // G
        s_int = torch.einsum("bd,bnkd->bnk", qg[:, r].double(), kv.double()).float()
        codes = torch.clamp(torch.round(s_int * qsg[:, r, None, None] * ks
                                        * (1.0 / Dh ** 0.5) / LUT.score_scale),
                            -qmax - 1.0, qmax)
        pos = (qp + l)[:, None, None]
        mask = ((k_pos < kvl[:, None, None]) & (l < torch.clamp(ql, max=Sq))[:, None, None]
                & (k_pos <= pos))
        if window:
            mask = mask & (k_pos > pos - window)
        codes = torch.where(mask, codes, _NEG)
        m = codes.amax(dim=-1)
        e = torch.where(mask, table[torch.clamp(m[..., None] - codes, 0, 255).long()], 0.0)
        e_w = by_warp(e)
        a = torch.zeros((BHkv, n_k, W, Dh))
        for s in range(S):
            for j in range(KEYS):
                a = (e_w[:, :, s, :, j, None].double() * v_w[:, :, s, :, j].double()
                     + a.double()).float()
        acc = a[:, :, 0]
        for w in range(1, W):
            acc = acc + a[:, :, w]
        part_m[:, :, r] = torch.where(needed, m, _NEG)
        part_den[:, :, r] = torch.where(needed, e.sum(dim=-1), 0.0)
        part_acc[:, :, r] = torch.where(needed[..., None], acc, 0.0)
    out = combine_needed(part_m, part_den, part_acc, needed, LUT)
    return out.reshape(BHkv, Sq, G, Dh).transpose(1, 2).reshape(BH, Sq, Dh)


def _operands(seed, B, Sq, H, Hkv, Dh, lens, kv_bits=8, ps=16, max_len=336):
    """Random q and K/V written into a dense ragged cache and, through a
    random table with a hole, a pool of `ps`-token pages: (dense operands,
    paged operands, table, (B,) lengths)."""
    r = np.random.RandomState(seed)
    q = torch.from_numpy((r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32))
    k = torch.from_numpy((r.randn(B, max_len, Hkv, Dh) * 0.5).astype(np.float32))
    v = torch.from_numpy((r.randn(B, max_len, Hkv, Dh) * 0.5).astype(np.float32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    zeros = torch.zeros(B, dtype=torch.int32)
    dense = TA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits, ragged=True)
    TA.cache_write_ragged(dense, k, v, zeros, PIMConfig(), seq_lens=lens_t)
    pt = _table(lens, max_len // ps, ps, seed, holes=False)
    pool = TA.init_paged_kv_cache(B * (max_len // ps) + 1, ps, Hkv, Dh, kv_bits=kv_bits)
    TA.paged_cache_write(pool, k, v, zeros, PIMConfig(), pt, seq_lens=lens_t)
    q_q, qs = TO._q_kernel_layout(q, 8)
    return (TO.kernel_attention_layout(q, dense),
            (q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale), pt, lens_t)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("bk,window", [(256, 0), (128, 40), (64, 40), (32, 0), (16, 0),
                                       (8, 0), (48, 40), (192, 0)])
def test_pv_key_split_order_within_rel_of_plain(bk, window, kv_bits):
    """The kernel's PV order against the plain version (REL of max|plain|),
    over slots of lengths 0, 17, 300 and 333 with q_len 1 and verify rows
    (Sq 4, ragged q_len); its verify rows equal its single steps bit for
    bit."""
    B, H, Hkv, Dh, Sq = 4, 4, 2, 32, 4
    lens = [0, 17, 300, 333]
    dense, _, _, lens_t = _operands(bk + kv_bits, B, Sq, H, Hkv, Dh, lens, kv_bits)
    ql = torch.tensor([0, 4, 3, 4], dtype=torch.int32)
    offs = torch.clamp(lens_t - ql, min=0)
    o_r = replay_decode(*dense, offs, lens_t, ql, bk, window)
    o_p = pim_decode_plain(*dense, offs, lens_t, window=window, block_k=bk, q_len=ql)
    valid = (torch.arange(Sq)[None] < ql[:, None]).repeat_interleave(H, 0)[..., None]
    o_r, o_p = torch.where(valid, o_r, 0.0), torch.where(valid, o_p, 0.0)
    assert float((o_r - o_p).abs().max()) <= REL * float(o_p.abs().max())
    for l in range(Sq):
        q1 = tuple(t[:, l:l + 1] for t in dense[:2])
        o_1 = replay_decode(*q1, *dense[2:], offs + l, lens_t,
                            (ql > l).to(torch.int32), bk, window)
        assert torch.equal(o_r[:, l][valid[:, l, 0]], o_1[:, 0][valid[:, l, 0]])


@pytest.mark.parametrize("Sq", [1, 4])
def test_pv_key_split_paged_equals_dense_at_page_size(Sq):
    """At block_k == page size the replayed kernel gives the pool and the
    dense cache the same partitions and order: equal bit for bit."""
    B, H, Hkv, Dh = 4, 4, 2, 32
    lens = [1, 16, 150, 333]
    dense, paged, pt, lens_t = _operands(Sq, B, Sq, H, Hkv, Dh, lens)
    ql = torch.full((B,), Sq, dtype=torch.int32)
    offs = lens_t - ql
    o_d = replay_decode(*dense, offs, lens_t, ql, 16)
    o_p = replay_decode(*paged, offs, lens_t, ql, 16, page_table=pt)
    assert torch.equal(o_d, o_p)
