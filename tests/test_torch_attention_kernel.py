"""The prefill kernel's launch plan and its staged online update, on the CPU.

The CUDA kernel (`kernels/csrc/pim_attention.cu`) cannot run here.  What
it decides in Python, its `launch_plan`, is checked over the served shapes:
every (q head, reference q block) is covered by exactly one CTA, a stage
holds whole reference blocks, and the plan fits the card's shared memory.
Its order of work is written below in torch, the way the kernel takes it:
the block maxima of a unit first (a 64-row stage at a time, stages masked
for every row skipped), then one online step per needed block in block
order, then the exps and the denominator block by block.  On random codes
with masked and unallocated blocks it gives the running max, the exps and
the rescale factors of `pim_attention_plain`'s per-block step bit for bit.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs.base import LUTSoftmaxConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.kernels.pim_attention import (
    KV_ROWS, MAX_ACC, MAX_SMEM, THREADS, _NEG, cdiv, launch_plan,
    lut_online_step)


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
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("block_k", [256, 16], ids=["dense", "paged"])
@pytest.mark.parametrize("q_per_kv", [1, 2, 4])
@pytest.mark.parametrize("dh", [32, 64, 96, 128])
def test_launch_plan_covers_each_head_and_q_block_once(dh, q_per_kv, block_k,
                                                       kv_bits):
    dhk = dh if kv_bits == 8 else dh // 2
    B, Hkv, Sq = 2, 2, 72
    BH = B * Hkv * q_per_kv
    for bq in (32, 8):      # the served block_q, and a short prompt's
        plan = launch_plan(dh, dhk, bq, q_per_kv, block_k)
        n_q = cdiv(Sq, bq)
        seen = collections.Counter()
        for y in range(BH // q_per_kv * plan.splits):
            heads = plan.cta_heads(y, q_per_kv)
            assert len({h // q_per_kv for h in heads}) == 1   # one KV group
            for h in heads:
                for qi in range(n_q):
                    seen[(h, qi)] += 1
        assert seen == {(h, qi): 1 for h in range(BH) for qi in range(n_q)}
        assert plan.rows in (16, 32, 64, 128)
        assert plan.heads_per_cta * bq <= plan.rows
        assert plan.rows * dh <= MAX_ACC * THREADS
        assert plan.smem <= MAX_SMEM
        # a stage holds whole reference blocks, or a whole part of one
        assert KV_ROWS % block_k == 0 or block_k % KV_ROWS == 0
        assert plan.unit_rows == plan.blocks_per_unit * block_k
        assert plan.unit_rows % KV_ROWS == 0


def test_launch_plan_at_the_served_shapes():
    """internlm2-1.8b (16 over 8 heads, head_dim 128): one CTA of 64 rows
    per KV group; a group of 4 heads takes two such CTAs; SMOKE (head_dim
    32) takes a group of 4 in one CTA of 128 rows."""
    p = launch_plan(128, 128, 32, 2, 256)
    assert (p.rows, p.heads_per_cta, p.splits) == (64, 2, 1)
    assert (p.unit_rows, p.blocks_per_unit) == (256, 1)
    p = launch_plan(128, 128, 32, 4, 16)
    assert (p.rows, p.heads_per_cta, p.splits) == (64, 2, 2)
    assert (p.unit_rows, p.blocks_per_unit) == (KV_ROWS, 4)
    p = launch_plan(32, 16, 32, 4, 256)
    assert (p.rows, p.heads_per_cta, p.splits) == (128, 4, 1)


@pytest.mark.parametrize("args", [
    (80, 80, 32, 2, 256),     # head_dim outside 32 / 64 / 96 / 128 / 256
    (128, 48, 32, 2, 256),    # stored width neither int8 nor 4 bits
    (128, 128, 32, 2, 24),    # block_k neither 8 / 16 / 32 nor 64k
    (128, 128, 32, 2, 96),
    (128, 128, 128, 1, 256),  # 128 rows x head_dim 128 pass 32 accumulators
])
def test_launch_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        launch_plan(*args)


# ---------------------------------------------------------------------------
# the staged online update
# ---------------------------------------------------------------------------
def staged_update(m, den, codes, needed, table, frac, bk, kv_rows=KV_ROWS):
    """The kernel's online steps over (rows, n_blocks * bk) masked codes
    (_NEG where masked) and the (n_blocks,) map of needed blocks.  Returns
    the final (m, den) and {block: (m_new, r, e)} of the blocks stepped."""
    unit = max(bk, kv_rows)
    nbu = unit // bk
    steps = {}
    for u0 in range(0, codes.shape[1], unit):
        blocks = [u0 // bk + i for i in range(nbu) if needed[u0 // bk + i]]
        if not blocks:
            continue
        # block maxima, one stage at a time; a stage masked for every row is
        # never loaded (only where a stage is part of one block)
        bmax = torch.full((codes.shape[0], nbu), _NEG)
        for s0 in range(u0, u0 + unit, kv_rows):
            stage = codes[:, s0:s0 + kv_rows]
            if bk >= kv_rows and bool((stage == _NEG).all()):
                continue
            part = stage.reshape(len(stage), -1, min(bk, kv_rows)).amax(-1)
            first = (s0 - u0) // bk
            bmax[:, first:first + part.shape[1]] = torch.maximum(
                bmax[:, first:first + part.shape[1]], part)
        if bk >= kv_rows and bool((codes[:, u0:u0 + unit] == _NEG).all()):
            continue        # no stage loaded: the unit is skipped
        # one step per needed block, in block order
        mblk, rblk = {}, {}
        for ki in blocks:
            m_new = torch.maximum(m, bmax[:, ki - u0 // bk])
            r = table[torch.clamp(m_new - m, 0, 255).long()] * (1.0 / (1 << frac))
            rblk[ki] = torch.where(m <= _NEG / 2, 0.0, r)
            mblk[ki] = m = m_new
        # exps and the denominator, block by block
        for ki in blocks:
            c = codes[:, ki * bk:(ki + 1) * bk]
            e = torch.where(c == _NEG, 0.0, table[torch.clamp(
                mblk[ki][:, None] - c, 0, 255).long()])
            den = den * rblk[ki] + e.sum(-1)
            steps[ki] = (mblk[ki], rblk[ki], e)
    return m, den, steps


@pytest.mark.parametrize("bk", [8, 16, 32, 64, 256])
def test_staged_update_equals_per_block_steps(bk):
    """Random codes with masked scores, fully masked rows and blocks, rows
    that see nothing for a while (m unset) and unallocated blocks: the
    kernel's staged order equals `pim_attention_plain`'s step per block,
    bit for bit; a block it skips (every score masked) is one whose step
    rescales by exactly 1 or 0 and adds nothing."""
    table, frac = build_exp_table(LUTSoftmaxConfig(), "cpu")
    table = table.float()
    rng = np.random.RandomState(bk)
    rows, n_cols = 24, 16 * max(bk, KV_ROWS)
    n_blocks = n_cols // bk
    codes = torch.from_numpy(rng.randint(-128, 128, (rows, n_cols))).float()
    mask = torch.from_numpy(rng.rand(rows, n_cols) < 0.7)
    mask[:, :max(bk, 2 * KV_ROWS)] = False                 # m unset at first
    mask[: rows // 2, max(bk, 2 * KV_ROWS):n_cols // 2] &= \
        torch.from_numpy(rng.rand(rows // 2, 1) < 0.5)      # rows masked long
    for ki in rng.choice(n_blocks, n_blocks // 4, replace=False):
        mask[:, ki * bk:(ki + 1) * bk] = False               # blocks masked
    needed = rng.rand(n_blocks) < 0.8                        # unallocated
    codes = torch.where(mask, codes, _NEG)
    m0, den0 = torch.full((rows,), _NEG), torch.zeros(rows)

    m_s, den_s, steps = staged_update(m0, den0, codes, needed, table, frac, bk)
    m, den = m0, den0
    for ki in range(n_blocks):
        if not needed[ki]:
            continue
        c, mk = codes[:, ki * bk:(ki + 1) * bk], mask[:, ki * bk:(ki + 1) * bk]
        m_new, resc, e = lut_online_step(m, c, mk, table, frac)
        if ki in steps:
            sm, sr, se = steps[ki]
            assert torch.equal(sm, m_new) and torch.equal(sr, resc)
            assert torch.equal(se, e)
        else:
            assert not bool(mk.any()) and bool(((resc == 1.0) | (m <= _NEG / 2)).all())
        den = den * resc + e.sum(-1)
        m = m_new
    assert torch.equal(m_s, m) and torch.equal(den_s, den)
    assert len(steps) > n_blocks // 4
