"""The port's LUT softmax (kernel 4) on the edges of its CUDA kernel's
regimes, against the JAX package on the CPU; the kernel's launch plan and
operand maps; and, on the card, the kernel against its plain version.

On the CPU the wrapper runs its plain version.  Inputs are made with numpy
from a seed.  Bounds: bit for bit against the oracle `JR.lut_softmax_ref`
(every row sum here stays below 2^24, where its float32 sum is exact), and
within 1 code of the Pallas kernel in interpret mode, which sums a row's
exps chunk by chunk (the bound of tests/test_kernels.py).  On the card the
kernel equals the plain version bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LUTSoftmaxConfig as JLut
from repro.kernels import ref as JR
from repro.kernels.lut_softmax import lut_softmax_pallas
from repro_torch.kernels import lut_softmax as K
from repro_torch.kernels.lut_softmax import lut_softmax, lut_softmax_plain

# the longest rows that `_plan` stages in shared memory
STAGED_MAX_S = {4: 46_208, 1: 115_520}


def _codes(seed, shape, dtype=np.int32):
    r = np.random.RandomState(seed)
    return np.clip(np.round(r.randn(*shape) * 32), -128, 127).astype(dtype)


def _mask(seed, shape, p=0.9):
    return np.random.RandomState(seed + 1).rand(*shape) < p


def _oracle(s, mask):
    """JR.lut_softmax_ref over the rows of (..., S) int codes and a full
    mask, in the scores' shape."""
    S = s.shape[-1]
    ref = JR.lut_softmax_ref(jnp.asarray(s.reshape(-1, S), jnp.int32),
                             jnp.asarray(np.broadcast_to(mask, s.shape).reshape(-1, S)),
                             JLut())
    return np.asarray(ref).reshape(s.shape)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# S of 1, 31 and 33 (around a warp's 32 lanes and a lane's 4 positions), and
# the warp-per-row limit (1024) and one either side; one row, and row counts
# that are not a multiple of 8 rows a CTA
@pytest.mark.parametrize("rows,S", [(1, 1), (3, 31), (5, 33), (9, 1023), (2, 1024),
                                    (7, 1025)])
def test_plain_matches_pallas_and_oracle_at_regime_edges(rows, S):
    s, mask = _codes(rows * 7 + S, (rows, S)), _mask(rows * 7 + S, (rows, S))
    if rows > 1:
        mask[1] = False                                  # an all-masked row
    t = lut_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    assert t.dtype == torch.int32 and t.shape == (rows, S)
    if rows > 1:
        assert int(t[1].abs().max()) == 0
    np.testing.assert_array_equal(t.numpy(), _oracle(s, mask))
    j_k = lut_softmax_pallas(jnp.asarray(s), jnp.asarray(mask), interpret=True)
    assert np.abs(t.numpy() - np.asarray(j_k)).max() <= 1


@pytest.mark.parametrize("rows,S", [(4, 33), (5, 160), (3, 1025)])
def test_int8_codes_match_oracle(rows, S):
    s8 = np.random.RandomState(S).randint(-128, 128, (rows, S)).astype(np.int8)
    mask = _mask(S, (rows, S))
    mask[-1] = False
    t = lut_softmax(torch.from_numpy(s8), torch.from_numpy(mask))
    np.testing.assert_array_equal(t.numpy(), _oracle(s8, mask))
    assert torch.equal(t, lut_softmax(torch.from_numpy(s8.astype(np.int32)),
                                      torch.from_numpy(mask)))


def _attention_operands(dtype, B=2, Hkv=2, G=3, cq=5, Sk=37):
    """(B, Hkv, G, cq, Sk) score codes and the behavioral attention's mask:
    (B, cq, Sk) valid-and-causal positions broadcast over the heads."""
    s = _codes(11, (B, Hkv, G, cq, Sk), dtype)
    kv_len = np.where(np.arange(B) % 2 == 0, Sk, 20)
    q_pos = kv_len[:, None] - cq + np.arange(cq)
    k_pos = np.arange(Sk)
    m3 = (k_pos < kv_len[:, None, None]) & (k_pos <= q_pos[:, :, None])
    m3[1, 0] = False                                      # an all-masked row
    return s, m3


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_attention_layout_with_broadcast_mask_matches_oracle(dtype):
    s, m3 = _attention_operands(dtype)
    mask = torch.from_numpy(m3)[:, None, None].expand(s.shape)
    t = lut_softmax(torch.from_numpy(s), mask)
    assert t.shape == s.shape
    np.testing.assert_array_equal(t.numpy(), _oracle(s, m3[:, None, None]))


def test_integer_sum_past_2_24_in_a_warp_row():
    """1024 table maxima (a warp's longest row) sum to 2^25: every code is
    exactly 2^16 / 1024 = 64."""
    s = torch.zeros((3, 1024), dtype=torch.int8)
    assert torch.equal(lut_softmax(s, torch.ones_like(s, dtype=torch.bool)),
                       torch.full(s.shape, 64, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("score_bytes", [1, 4])
def test_plan_covers_every_row_once_within_shared_memory(score_bytes):
    limit = STAGED_MAX_S[score_bytes]
    lengths = (list(range(1, 1100)) + [1500, 2047, 2048, 4095, 4096, 4097, 8192]
               + [limit - 1, limit, limit + 1, 2 * limit])
    for S in lengths:
        for rows in (1, 7, 64, 130, 1000, 1056, 1057, 8192):
            p = K._plan(rows, S, score_bytes)
            assert 0 < p.smem <= K.SMEM_MAX
            assert p.threads % 32 == 0 and 64 <= p.threads <= 1024
            if S <= K.ROWS_MAX_S and rows > 8 * 132:
                assert p.regime == "rows" and p.threads == 32 * p.rows_per_cta
                assert p.chunks in (8, 16, 32) and 32 * p.chunks >= S
                assert p.chunks == 8 or 16 * p.chunks < S
                owner = (np.arange(p.grid)[:, None] * p.rows_per_cta
                         + np.arange(p.rows_per_cta)).ravel()
                np.testing.assert_array_equal(owner[owner < rows], np.arange(rows))
                assert (p.grid - 1) * p.rows_per_cta < rows   # no idle CTA
                continue
            assert p.rows_per_cta == 1 and p.grid == rows and p.chunks == 0
            if S <= 4096:   # a thread holds at most 4 positions
                assert p.regime == "held" and S <= 4 * p.threads
                continue
            assert p.threads == 1024
            staged = 1408 + _pad16(S * score_bytes) + _pad16(S) <= K.SMEM_MAX
            assert staged == (S <= limit)
            assert p.regime == ("staged" if staged else "stream")
            if staged:   # room for the row's scores and mask bytes
                assert p.smem >= 1024 + S * (score_bytes + 1)


def _pad16(n):
    return -(-n // 16) * 16


# ---------------------------------------------------------------------------
# the operands' row maps
# ---------------------------------------------------------------------------
def _gather(t, pairs):
    """The (rows, S) rows the kernel reads from `t` through its row map."""
    S = t.shape[-1]
    r = torch.arange(t.numel() // S)
    off = torch.zeros_like(r)
    for size, stride in reversed(pairs):
        off += (r % size) * stride
        r = r // size
    flat = t.as_strided((int(off.max()) + S,), (1,))
    return flat[off[:, None] + torch.arange(S)]


def _masks():
    g = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.rand(shape, generator=g) < 0.7

    return {
        # the behavioral attention's: (B, cq, Sk) over (B, Hkv, G, cq, Sk)
        "attention": (rand(2, 5, 37)[:, None, None].expand(2, 4, 3, 5, 37), True),
        # ops.lut_softmax's: (4, 128) broadcast to (2, 3, 4, 128)
        "ops": (rand(4, 128).expand(2, 3, 4, 128), True),
        "full": (rand(2, 3, 4, 128), True),
        "non-contiguous": (rand(6, 5, 40).transpose(0, 1), True),
        "one element into its storage": (rand(7 * 33 + 1)[1:].view(7, 33), True),
        "strided positions": (rand(4, 80)[:, ::2], False),
        "more dims than the kernel maps": (
            rand(3, 2, 3, 2, 3, 8).permute(1, 0, 3, 2, 4, 5), False),
    }


@pytest.mark.parametrize("case", list(_masks()))
def test_row_map_gathers_the_broadcast_rows(case):
    m, in_place = _masks()[case]
    t, pairs = K._operand(m)
    assert len(pairs) <= K.MAX_DIMS and t.shape == m.shape
    assert (t.data_ptr() == m.data_ptr()) == in_place
    S = m.shape[-1]
    assert torch.equal(_gather(t, pairs), m.expand(m.shape).reshape(-1, S))


def test_attention_mask_needs_three_pairs():
    m = torch.ones(2, 5, 37, dtype=torch.bool)[:, None, None].expand(2, 4, 3, 5, 37)
    assert K._row_map(m) == [(2, 5 * 37), (12, 0), (5, 37)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_at_every_regime(cuda_device):
    """On the card: the kernel against its plain version bit for bit at each
    regime's boundaries (rows of 1-1024 positions held by a warp or a CTA,
    CTA rows held up to 4096 positions, staged up to the shared-memory
    limit and streamed past it), int32 and int8 codes, a score view one
    element into its storage, an all-masked row, and the attention's
    broadcast mask."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    lengths = [1, 3, 4, 5, 31, 32, 33, 127, 128, 129, 160, 255, 257, 511, 512, 513,
               1023, 1024, 1025, 4096, 4097]
    for dtype, nbytes in ((torch.int32, 4), (torch.int8, 1)):
        limit = STAGED_MAX_S[nbytes]
        for S in lengths + [limit, limit + 1]:
            for rows in (1, 9) + ((1100,) if S in (160, 1024) else ()):
                flat = torch.randint(-128, 128, (rows * S + 1,), generator=g,
                                     device=dev).to(dtype)
                for s in (flat[:-1].view(rows, S), flat[1:].view(rows, S)):
                    mask = torch.rand((rows, S), generator=g, device=dev) < 0.9
                    mask[rows // 2] = False
                    assert torch.equal(lut_softmax(s, mask), lut_softmax_plain(s, mask)), \
                        (dtype, S, rows, s.storage_offset())
        s, m3 = _attention_operands(np.int8 if nbytes == 1 else np.int32, B=4, Hkv=16,
                                    G=1, cq=128, Sk=160)
        s = torch.from_numpy(s).to(dev)
        mask = torch.from_numpy(m3).to(dev)[:, None, None].expand(s.shape)
        assert torch.equal(lut_softmax(s, mask), lut_softmax_plain(s, mask))
