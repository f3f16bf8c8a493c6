"""The port's PIM matmul and LUT softmax kernels, and the paper-fidelity
serving path they carry, against the JAX package on the CPU.

On the CPU the kernels' wrappers run their plain versions.  Inputs are made
with numpy from a seed.  Bounds:
  * the PIM matmul (both ADC modes) is bit-exact against the Pallas kernel in
    interpret mode and against the oracle: the ADC codes are integers and
    every float32 sum here is exact;
  * the LUT softmax is exact against the oracle and within 1 code of the
    Pallas kernel, which sums a row's exps chunk by chunk (the bound of
    tests/test_kernels.py);
  * the quantized-ADC behavioral attention is exact against JAX's in float32
    (JAX run eagerly: see the ADC test below), dense, ragged and paged;
  * the SMOKE model under `adc_mode="quantized"` and behavioral attention,
    float32: logits within rel 1e-4 of JAX, greedy streams identical, and
    the Scheduler on the paged pool identical to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import LUTSoftmaxConfig as JLut, PIMConfig as JPim
from repro.core import attention as JA
from repro.core import pim as JP
from repro.core import quant as JQ
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.lut_softmax import lut_softmax_pallas
from repro.kernels.pim_matmul import pim_matmul_int_pallas
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import LUTSoftmaxConfig as TLut, PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.core import pim as TP
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels.lut_softmax import lut_softmax, lut_softmax_plain
from repro_torch.core import quant as TQ
from repro_torch.kernels.pim_matmul import (
    PSUM_MAX, _adc_constants, _fma_f32, adc_kernel_codes, adc_table, adc_thresholds,
    pim_matmul_int, pim_matmul_int_plain, split_k, tile_m)
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "internlm2-1.8b"
QUANT = dict(adc_mode="quantized")


def _int8(seed, shape):
    return np.random.RandomState(seed).randint(-128, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# kernel 3: the PIM matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 64, 32), (130, 200, 96), (1, 128, 128),
                                   (27, 129, 130)])
@pytest.mark.parametrize("adc_mode", ["ideal", "quantized"])
def test_pim_matmul_plain_matches_pallas_and_oracle(shape, adc_mode):
    M, K, N = shape
    x, w = _int8(M * 7 + K, (M, K)), _int8(K + N, (K, N))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    t = pim_matmul_int(tx, tw, TPim(adc_mode=adc_mode))
    assert t.dtype == torch.float32 and t.shape == (M, N)
    j = pim_matmul_int_pallas(jnp.asarray(x), jnp.asarray(w),
                              JPim(adc_mode=adc_mode), interpret=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(JR.pim_matmul_int_ref(jnp.asarray(x), jnp.asarray(w),
                                                    JPim(adc_mode=adc_mode))))
    np.testing.assert_array_equal(
        t.numpy(), TR.pim_matmul_int_ref(tx, tw, TPim(adc_mode=adc_mode)).numpy())


def test_pim_matmul_reads_weights_as_stored():
    """A layer view of stacked row-major weights and the deployed (K, N) view
    of an (N, K) store give the same result as a contiguous copy; and the
    core linear's quantized mode goes through the same function."""
    K, N = 200, 48
    stack = torch.from_numpy(_int8(3, (3, K, N)))
    x = torch.from_numpy(_int8(4, (5, K)))
    cfg = TPim(**QUANT)
    want = pim_matmul_int_plain(x, stack[1].clone(), cfg)
    assert stack[1].storage_offset() == K * N
    assert torch.equal(pim_matmul_int(x, stack[1], cfg), want)
    deployed = stack[1].t().contiguous().t()
    assert deployed.stride() == (1, K)
    assert torch.equal(pim_matmul_int(x, deployed, cfg), want)
    assert torch.equal(TP.pim_matmul_int(x.view(1, 5, K), deployed, cfg),
                       want.view(1, 5, N))


def test_pim_matmul_integer_code_sum_at_large_k():
    """At K = 8192 the reference's float32 sum of code * step passes 2^24;
    the port sums the codes as integers and multiplies once, so the result
    is the exact sum rounded once (and equals the reference where its sum is
    exact, as in the tests above)."""
    x = np.full((2, 8192), 127, np.int8)
    w = np.full((8192, 3), 127, np.int8)
    w[:, 1] = -127
    w[:, 2] = 0
    w[::16, 2] = 64
    cfg = TPim(**QUANT)
    t = pim_matmul_int(torch.from_numpy(x), torch.from_numpy(w), cfg).numpy()
    step = np.float32(0.125 * 16 * 127 * 127 / 32)
    # columns 0 and 1 saturate the ADC in every group (codes 31 and -32);
    # column 2's groups sum to 127 * 64 = 8128, code 8
    for col, codes in ((0, 31 * 512), (1, -32 * 512), (2, 8 * 512)):
        assert t[0, col] == np.float32(codes) * step


@pytest.mark.parametrize("M,N,K,splits", [(4, 2048, 2048, 8), (4, 1024, 2048, 8),
                                          (4, 2048, 8192, 16), (4, 8192, 2048, 4),
                                          (12, 2048, 2048, 8), (512, 1024, 2048, 4),
                                          (512, 2048, 2048, 2), (2048, 8192, 2048, 1),
                                          (1, 24, 200, 1), (4, 2048, 2000, 8)])
def test_split_k_covers_k_in_64_row_ranges(M, N, K, splits):
    """The kernel's K split: 64-row-aligned ranges of at least 256 rows
    (four stages), every row of K in exactly one split, and the decode
    grids (M <= 16: 8 or 16 token rows by 128 weight rows a tile) at about
    two CTAs per SM of an H100 (132 SMs) unless K runs out of ranges."""
    n, k_split = split_k(M, N, K, 132)
    assert (n, k_split % 64) == (splits, 0)
    assert k_split >= min(256, -(-K // 64) * 64)
    assert (n - 1) * k_split < K <= n * k_split
    tiles = -(-N // 128) * -(-M // tile_m(M))
    assert tile_m(M) == (8 if M <= 8 else 16 if M <= 16 else 64)
    assert n == 1 or tiles * n <= 2 * 132
    if M <= 16 and n < -(-K // 256):
        assert tiles * n >= 132


ADC_CONFIGS = [dict(adc_bits=b, adc_range_frac=f) for b in (4, 6, 8)
               for f in (0.125, 0.05, 0.3, 1.0)]


def _all_psums():
    """Every partial sum a 16-row group of int8 products can reach."""
    return torch.arange(-PSUM_MAX, PSUM_MAX + 1, dtype=torch.int32)


@pytest.mark.parametrize("kw", ADC_CONFIGS, ids=lambda kw: "b{adc_bits}-f{adc_range_frac}".format(**kw))
def test_adc_thresholds_reproduce_the_adc(kw):
    """code(p) = lo + #{c : T[c] <= p} over the whole partial-sum range,
    steps dyadic (0.125: 16129 / 2^k) or not (0.05, 0.3)."""
    cfg = TPim(adc_mode="quantized", **kw)
    p = _all_psums()
    codes = TQ.adc_code(p, cfg.adc_bits, TQ.adc_full_range(cfg)).to(torch.int32)
    t = adc_thresholds(cfg)
    assert t.shape == ((1 << cfg.adc_bits) - 1,)
    lo = -(1 << (cfg.adc_bits - 1))
    assert torch.equal(lo + torch.searchsorted(t, p, right=True).to(torch.int32), codes)
    # and JAX's ADC (eager), over the same range
    rng = TQ.adc_full_range(cfg)
    np.testing.assert_array_equal(
        np.asarray(JQ.adc_transfer(jnp.asarray(p.numpy()), cfg.adc_bits, rng)),
        TQ.adc_transfer(p, cfg.adc_bits, rng).numpy())


@pytest.mark.parametrize("kw", ADC_CONFIGS, ids=lambda kw: "b{adc_bits}-f{adc_range_frac}".format(**kw))
def test_adc_guess_and_correct_rule_is_exact(kw):
    """The kernel's division-free ADC, in its own float32 operations (a
    saturating fma guess one code low at most, corrected by one threshold),
    gives every code of the reference, and its guess does need the
    correction somewhere."""
    cfg = TPim(adc_mode="quantized", **kw)
    p = _all_psums()
    codes = TQ.adc_code(p, cfg.adc_bits, TQ.adc_full_range(cfg)).to(torch.int32)
    assert torch.equal(adc_kernel_codes(p, cfg), codes)
    table, _ = adc_table(cfg)
    assert table.dtype == torch.float32 and table.shape == (1 << cfg.adc_bits,)
    # the guess alone is the code or one below it
    a, b, w, c = _adc_constants(cfg)
    s = _fma_f32((p + 12582912).float(), a, b).clamp(0.0, 1.0)
    guess = _fma_f32(s, w, c).view(torch.int32) - torch.tensor(12582912.0).view(torch.int32)
    assert set((codes - guess).unique().tolist()) == {0, 1}


def test_fma_emulation_rounds_once():
    """The guess's float32 fma, emulated through float64, rounds once even
    where the float64 sum lands on a float32 tie."""
    from fractions import Fraction
    w, c = 63.0, 12582880.0
    # s * w just above or below k + 1/2: the float64 sum rounds the excess off
    s = torch.tensor([(k + 0.5) / w for k in range(60)], dtype=torch.float32)
    s = torch.cat([s, torch.nextafter(s, torch.ones(())), torch.nextafter(s, torch.zeros(()))])
    got = _fma_f32(s, w, c)
    for si, gi in zip(s.tolist(), got.tolist()):
        exact = Fraction(si) * Fraction(w) + Fraction(c)
        lo = Fraction(int(exact))           # float32 integers near 1.5 * 2^23
        want = lo + (1 if exact - lo > Fraction(1, 2) or
                     (exact - lo == Fraction(1, 2) and int(lo) % 2) else 0)
        assert gi == float(want), (si, gi, float(want))


def test_adc_table_refuses_a_guess_that_misses():
    """An ADC step of about 2 (8 bits over 1/1000 of the group's range):
    the guess's float32 rounding can miss by two codes, so the kernel's
    table is refused rather than used."""
    with pytest.raises(ValueError):
        adc_table(TPim(adc_mode="quantized", adc_bits=8, adc_range_frac=0.001))


def test_ops_pim_matmul_matches_jax():
    r = np.random.RandomState(5)
    x = r.randn(4, 10, 256).astype(np.float32)
    w = (r.randn(256, 128) * 0.05).astype(np.float32)
    for mode in ("ideal", "quantized"):
        jw, js = JP.quantize_weights(jnp.asarray(w), JPim(adc_mode=mode))
        j = JO.pim_matmul(jnp.asarray(x), jw, js, JPim(adc_mode=mode),
                          out_dtype=jnp.float32)
        t = TO.pim_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jw)),
                          torch.from_numpy(np.asarray(js)), TPim(adc_mode=mode),
                          out_dtype=torch.float32)
        assert t.shape == (4, 10, 128)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_adc_division_eager_and_jitted():
    """The port's ADC equals JAX's eager one on every partial sum a 16-row
    group can produce near a code boundary; it runs no reciprocal multiply,
    whatever XLA does to the division under jit."""
    step = 0.125 * 16 * 127 * 127 / 32
    psum = np.arange(-258064, 258065, 7, dtype=np.int32)
    half = np.round((np.arange(-33, 33) + 0.5) * step).astype(np.int32)
    psum = np.concatenate([psum, half - 1, half, half + 1])
    t = TQ.adc_transfer(torch.from_numpy(psum), 6, step * 32)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(JQ.adc_transfer(jnp.asarray(psum), 6, step * 32)))
    jitted = np.asarray(jax.jit(lambda p: JQ.adc_transfer(p, 6, step * 32))(
        jnp.asarray(psum)))
    # a reciprocal multiply may move a code only where psum / step lies
    # within a float32 rounding of a half
    assert np.abs(jitted - t.numpy()).max() <= step


# ---------------------------------------------------------------------------
# kernel 4: the LUT softmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 128), (10, 512), (3, 1000)])
def test_lut_softmax_plain_matches_pallas_and_oracle(shape):
    R, S = shape
    r = np.random.RandomState(R * 31 + S)
    s = np.clip(np.round(r.randn(R, S) * 32), -128, 127).astype(np.int32)
    mask = r.rand(R, S) < 0.9
    mask[0] = False                                     # an all-masked row
    t = lut_softmax(torch.from_numpy(s), torch.from_numpy(mask), TLut())
    assert t.dtype == torch.int32 and int(t[0].abs().max()) == 0
    j_ref = JR.lut_softmax_ref(jnp.asarray(s), jnp.asarray(mask), JLut())
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_ref))
    j_k = lut_softmax_pallas(jnp.asarray(s), jnp.asarray(mask), interpret=True)
    assert np.abs(t.numpy() - np.asarray(j_k)).max() <= 1
    np.testing.assert_array_equal(
        t.numpy(), TR.lut_softmax_ref(torch.from_numpy(s), torch.from_numpy(mask),
                                      TLut()).numpy())


def test_lut_softmax_int8_input_and_leading_dims():
    s8 = _int8(7, (2, 3, 4, 128))
    mask = np.random.RandomState(8).rand(4, 128) < 0.8   # broadcast by ops
    t = TO.lut_softmax(torch.from_numpy(s8), torch.from_numpy(mask))
    assert t.shape == s8.shape
    j = JO.lut_softmax(jnp.asarray(s8), jnp.asarray(mask))
    assert np.abs(t.numpy() - np.asarray(j)).max() <= 1
    full = np.broadcast_to(mask, s8.shape).reshape(-1, 128)
    np.testing.assert_array_equal(
        t.numpy().reshape(-1, 128),
        np.asarray(JR.lut_softmax_ref(jnp.asarray(s8.reshape(-1, 128), jnp.int32),
                                      jnp.asarray(full), JLut())))


def test_lut_softmax_integer_sum_past_2_24():
    """A flat row of 1024 table maxima sums to 2^25: the port's integer sum
    gives every position exactly 2^16 / 1024 = 64."""
    s = torch.zeros((1, 1024), dtype=torch.int32)
    mask = torch.ones_like(s, dtype=torch.bool)
    assert torch.equal(lut_softmax_plain(s, mask), torch.full_like(s, 64))


def test_lut_softmax_refuses_what_the_kernel_lacks():
    s, m = torch.zeros(2, 8, dtype=torch.int32), torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        lut_softmax(s, m, TLut(mode="paper"))
    with pytest.raises(ValueError):
        lut_softmax(s, m[:, :4])
    with pytest.raises(ValueError):
        lut_softmax(s.to(torch.device("meta")), m.to(torch.device("meta")))
    with pytest.raises(ValueError):
        pim_matmul_int(torch.zeros(2, 8, dtype=torch.int8, device="meta"),
                       torch.zeros(8, 4, dtype=torch.int8, device="meta"))


# ---------------------------------------------------------------------------
# the quantized-ADC behavioral attention
# ---------------------------------------------------------------------------
def _kv(r, B, S, Hkv, Dh):
    return [(r.randn(B, S, Hkv, Dh) * 0.5).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("case", [
    # (Sq, q_offset, kv_len, window); Sq 4 shares JAX's compiled query loop
    # with the ragged test below (same shapes)
    (1, 11, 12, 0), (4, 8, 12, 5)])
def test_quantized_behavioral_attention_matches_jax(case):
    Sq, off, kv_len, window = case
    r = np.random.RandomState(9)
    B, H, Hkv, Dh, S = 3, 4, 2, 32, 48
    k, v = _kv(r, B, kv_len, Hkv, Dh)
    jc = JA.cache_write(JA.init_kv_cache(B, S, Hkv, Dh), jnp.asarray(k),
                        jnp.asarray(v), 0, JPim())
    tc = TA.cache_write(TA.init_kv_cache(B, S, Hkv, Dh), torch.from_numpy(k),
                        torch.from_numpy(v), 0, TPim())
    q = (r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32)
    j = JA.pim_attention(jnp.asarray(q), jc, JPim(**QUANT), JLut(), off,
                         window=window, out_dtype=jnp.float32)
    t = TA.pim_attention(torch.from_numpy(q), tc, TPim(**QUANT), TLut(), off,
                         window=window, out_dtype=torch.float32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ideal = TA.pim_attention(torch.from_numpy(q), tc, TPim(), TLut(), off,
                             window=window, out_dtype=torch.float32)
    assert not torch.equal(t, ideal)       # the ADC really ran


def test_quantized_behavioral_ragged_and_paged_match_jax():
    """Ragged (B,) offsets and lengths over dense slots, and the same tokens
    in a paged pool read through `paged_gather`: equal to JAX's and to each
    other, bit for bit."""
    r = np.random.RandomState(10)
    B, H, Hkv, Dh, S, ps = 3, 4, 2, 32, 48, 16
    lens = np.array([40, 17, 1], np.int32)
    k, v = _kv(r, B, S, Hkv, Dh)
    zeros = np.zeros(B, np.int32)
    jd = JA.cache_write_ragged(JA.init_kv_cache(B, S, Hkv, Dh, ragged=True),
                               jnp.asarray(k), jnp.asarray(v), jnp.asarray(zeros),
                               JPim(), seq_lens=jnp.asarray(lens))
    td = TA.cache_write_ragged(TA.init_kv_cache(B, S, Hkv, Dh, ragged=True),
                               torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(zeros), TPim(),
                               seq_lens=torch.from_numpy(lens))
    pt = torch.tensor([[3, 1, 5], [2, 6, -1], [4, -1, -1]], dtype=torch.int32)
    pool = TA.paged_cache_write(TA.init_paged_kv_cache(7, ps, Hkv, Dh),
                                torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(zeros), TPim(), pt,
                                seq_lens=torch.from_numpy(lens))
    Sq = 4
    q = (r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32)
    off = np.maximum(lens - Sq, 0)
    j = JA.pim_attention(jnp.asarray(q), jd, JPim(**QUANT), JLut(),
                         jnp.asarray(off), out_dtype=jnp.float32)
    kw = dict(out_dtype=torch.float32)
    t = TA.pim_attention(torch.from_numpy(q), td, TPim(**QUANT), TLut(),
                         torch.from_numpy(off), **kw)
    tp = TA.pim_attention(torch.from_numpy(q),
                          TA.paged_gather(pool, pt, torch.from_numpy(lens)),
                          TPim(**QUANT), TLut(), torch.from_numpy(off), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # rows at or past a slot's length are garbage its caller drops (their
    # V-scale fold reads past the slot's tokens, which the two storages fill
    # differently)
    for b in range(B):
        n = min(Sq, int(lens[b]) - int(off[b]))
        assert torch.equal(tp[b, :n], t[b, :n])


# ---------------------------------------------------------------------------
# the SMOKE model at the paper's fidelity
# ---------------------------------------------------------------------------
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
    """(jax model, jax params, port model, port params) of SMOKE
    internlm2-1.8b with the quantized ADC and behavioral attention, f32."""
    kw = dict(attn_impl="behavioral", compute_dtype="float32",
              pim=JPim(**QUANT))
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **{
        **kw, "pim": TPim(**QUANT)})
    jm = jax_build(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg, "cpu")
    return jm, jp, tm, from_jax_params(jp, tcfg, "cpu")


def test_paper_fidelity_logits_and_greedy_stream_match_jax(models):
    """Prefill logits within rel 1e-4 of JAX's; greedy streams of 4 tokens
    equal.  The 6-bit ADC turns an ulp of float32 arithmetic into a whole
    code when a partial sum lies at a code boundary, and jitted, XLA
    rewrites some float32 divisions into reciprocal multiplies (ROADMAP.md
    section 3): longer streams of this random-weight model part between
    JAX's own jitted and eager runs, so the stream checks here are short."""
    jm, jp, tm, tp = models
    toks = np.random.RandomState(11).randint(0, 256, (2, 8)).astype(np.int32)
    jl, _, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks)},
                                jm.init_cache(2, 12), 0)
    tl, _ = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks).long()},
                             tm.init_cache(2, 12), 0)
    jl = np.asarray(jl, np.float64)
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
    js = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 4, 16)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 4, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _trace(lens, budgets):
    full = TD.lm_batch(1, 3, 20, 256)
    return [(full[i, :n].tolist(), b) for i, (n, b) in enumerate(zip(lens, budgets))]


def test_paper_fidelity_paged_scheduler_matches_jax(models):
    """The Scheduler on the paged pool (2 slots, queueing, slot reuse)
    against JAX's; dense slots give the same streams."""
    jm, jp, tm, tp = models
    trace = _trace([5, 20], [6, 4]) + [(_trace([5], [1])[0][0][:3], 5)]
    kw = dict(max_len=48, max_batch_slots=2, page_size=16, num_pages=7)
    jsched = JS.Scheduler(jm, jp, **kw)
    jr = [jsched.submit(p, b) for p, b in trace]
    jres = jsched.run()
    sched = TS.Scheduler(tm, tp, **kw)
    tr = [sched.submit(p, b) for p, b in trace]
    tres = sched.run()
    sched.audit()
    assert [tres[r] for r in tr] == [jres[r] for r in jr]
    assert [len(tres[r]) for r in tr] == [6, 4, 5]
    assert sorted(sched.free_pages) == list(range(1, 7))
    dense = TS.Scheduler(tm, tp, max_len=48, max_batch_slots=2)
    dr = [dense.submit(p, b) for p, b in trace]
    dres = dense.run()
    assert [dres[r] for r in dr] == [tres[r] for r in tr]


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 512])
def test_cuda_adc_kernels_match_plain_versions(cuda_device, M):
    """On the card: kernels 3 and 4 against their plain versions, bit for
    bit: kernel 3 at decode (the weights as the MMA's A operand, split K)
    and prefill widths, K 1000 and 2000 (not multiples of 64), the deployed
    weight layout and a row-major layer view, and an x whose rows are not
    16-byte aligned."""
    def check(x, w):
        for mode in ("ideal", "quantized"):
            cfg = TPim(adc_mode=mode)
            assert torch.equal(pim_matmul_int(x, w, cfg), pim_matmul_int_plain(x, w, cfg))

    x = torch.from_numpy(_int8(13, (M, 1000))).to(cuda_device)
    check(x, torch.from_numpy(_int8(14, (96, 1000))).to(cuda_device).t())
    stack = torch.from_numpy(_int8(17, (2, 2000, 320))).to(cuda_device)
    x = torch.from_numpy(_int8(18, (M, 2000))).to(cuda_device)
    check(x, stack[1])                                   # row-major layer view
    check(x, stack[1].t().contiguous().t())              # deployed view
    flat = torch.from_numpy(_int8(19, (M * 2000 + 1,))).to(cuda_device)
    x = flat[1:].view(M, 2000)
    assert x.data_ptr() % 16 != 0
    check(x, stack[0].t().contiguous().t())
    s = torch.from_numpy(_int8(15, (6, 300)).astype(np.int32)).to(cuda_device)
    m = torch.from_numpy(np.random.RandomState(16).rand(6, 300) < 0.7).to(cuda_device)
    m[2] = False
    assert torch.equal(lut_softmax(s, m), lut_softmax_plain(s, m))
