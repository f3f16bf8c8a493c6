"""Parity of the PyTorch port's numerics core with the JAX package, on CPU.

Inputs are made with numpy from a seed and go through both.  Integer
results (quantization codes and scales, KV4 packing, the exp table, LUT
softmax codes, PIM integer matmuls, KV cache planes, iteration counts) must
be bit-exact, in float32 and in bfloat16; float attention outputs are held
to the tolerances stated beside them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LUTSoftmaxConfig as JLut, PIMConfig as JPim
from repro.core import attention as JA
from repro.core import lut_softmax as JS
from repro.core import pim as JP
from repro.core import quant as JQ
from repro.kernels import ref as JR
from repro_torch.configs.base import LUTSoftmaxConfig as TLut, PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.core import lut_softmax as TS
from repro_torch.core import pim as TP
from repro_torch.core import quant as TQ
from repro_torch.kernels import ref as TR

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _exact(j, t):
    np.testing.assert_array_equal(_np(j), _np(t))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, None])
def test_quantize_codes_and_scales_bit_exact(dtype, axis):
    x = (np.random.RandomState(0).randn(6, 5, 64) * 3).astype(np.float32)
    x[0, 0] = 0.0                                   # the eps floor
    jx, tx = _both(x, dtype)
    js = JQ.symmetric_max_scale(jx, 8, axis=axis)
    ts = TQ.symmetric_max_scale(tx, 8, axis=axis)
    _exact(js, ts)
    _exact(JQ.quantize(jx, js, 8), TQ.quantize(tx, ts, 8))
    _exact(JQ.quantize(jx, js, 4), TQ.quantize(tx, ts, 4))


def test_adc_transfer_exact():
    psum = np.random.RandomState(1).randint(-40000, 40000, (7, 33)).astype(np.int32)
    _exact(JQ.adc_transfer(jnp.asarray(psum), 6, 32258.0),
           TQ.adc_transfer(torch.from_numpy(psum), 6, 32258.0))


def test_kv4_tables_bit_exact():
    np.testing.assert_array_equal(JQ.create_dynamic_map(), TQ.create_dynamic_map())
    np.testing.assert_array_equal(JQ.KV4_LEVELS, TQ.KV4_LEVELS)
    np.testing.assert_array_equal(JQ._KV4_MIDPOINTS, TQ._KV4_MIDPOINTS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv4_pack_encode_decode_bit_exact(dtype):
    r = np.random.RandomState(2)
    codes = r.randint(0, 16, (3, 4, 32)).astype(np.int32)
    jp = JQ.pack_codes4(jnp.asarray(codes))
    tp = TQ.pack_codes4(torch.from_numpy(codes))
    _exact(jp, tp)
    _exact(JQ.unpack_codes4(jp), TQ.unpack_codes4(tp))
    np.testing.assert_array_equal(_np(TQ.unpack_codes4(tp)), codes)
    _exact(JQ.kv4_decode_int8(jp), TQ.kv4_decode_int8(tp))
    x = r.randn(3, 4, 32).astype(np.float32)
    jx, tx = _both(x, dtype)
    js, ts = JQ.symmetric_max_scale(jx, 8, -1), TQ.symmetric_max_scale(tx, 8, -1)
    _exact(JQ.kv4_encode(jx, js), TQ.kv4_encode(tx, ts))


# ---------------------------------------------------------------------------
# LUT softmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["shifted", "paper"])
def test_exp_table_bit_exact(mode):
    jt, jf = JS.build_exp_table(JLut(mode=mode))
    tt, tf = TS.build_exp_table(TLut(mode=mode))
    assert jf == tf
    _exact(jt, tt)


def test_lut_softmax_codes_and_uint8_bit_exact():
    r = np.random.RandomState(3)
    s = r.randint(-128, 128, (5, 7, 40)).astype(np.int32)
    mask = r.rand(5, 7, 40) > 0.3
    mask[0, 0] = False                               # an all-masked row
    jc = JS.lut_softmax_codes(jnp.asarray(s), JLut(), mask=jnp.asarray(mask))
    tc = TS.lut_softmax_codes(torch.from_numpy(s), TLut(), mask=torch.from_numpy(mask))
    _exact(jc, tc)
    _exact(JS.probs_to_uint8(jc, JLut()), TS.probs_to_uint8(tc, TLut()))


# ---------------------------------------------------------------------------
# PIM matmul and linears
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adc_mode", ["ideal", "quantized"])
def test_pim_matmul_int_exact(adc_mode):
    r = np.random.RandomState(4)
    x = r.randint(-128, 128, (2, 3, 200)).astype(np.int8)   # K not a multiple of 16
    w = r.randint(-128, 128, (200, 24)).astype(np.int8)
    j = JP.pim_matmul_int(jnp.asarray(x), jnp.asarray(w), JPim(adc_mode=adc_mode))
    t = TP.pim_matmul_int(torch.from_numpy(x), torch.from_numpy(w), TPim(adc_mode=adc_mode))
    _exact(j, t)


def test_pim_matmul_int_large_k_exact():
    """A K = 8192 dot exceeds 2^24: the port stays integer-exact."""
    x = np.full((2, 8192), 127, np.int8)
    w = np.full((8192, 8), 127, np.int8)
    t = TP.pim_matmul_int(torch.from_numpy(x), torch.from_numpy(w), TPim())
    assert t.dtype == torch.float32 and float(t[0, 0]) == float(8192 * 127 * 127)
    _exact(JP.pim_matmul_int(jnp.asarray(x), jnp.asarray(w), JPim()), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pim_linear_bit_exact(dtype):
    r = np.random.RandomState(5)
    x = r.randn(2, 5, 64).astype(np.float32)
    w = (r.randn(64, 48) / 8).astype(np.float32)
    jx, tx = _both(x, dtype)
    jq, js = JP.quantize_weights(jnp.asarray(w).astype(jx.dtype), JPim())
    tq, ts = TP.quantize_weights(torch.from_numpy(w).to(tx.dtype), TPim())
    _exact(jq, tq)
    _exact(js, ts)
    j = JP.pim_linear_apply({"w": jnp.asarray(w)}, jx, JPim())
    _exact(j, TP.pim_linear_apply({"w": torch.from_numpy(w)}, tx, TPim()))
    _exact(j, TP.pim_linear_apply(TP.deploy_params({"w": torch.from_numpy(w)},
                                                   TPim(), dtype=tx.dtype), tx, TPim()))


# ---------------------------------------------------------------------------
# KV cache and attention
# ---------------------------------------------------------------------------
def _caches(r, B, S, max_len, Hkv, Dh, kv_bits, dtype, pos=0):
    k = (r.randn(B, S, Hkv, Dh) * 0.5).astype(np.float32)
    v = (r.randn(B, S, Hkv, Dh) * 0.5).astype(np.float32)
    (jk, tk), (jv, tv) = _both(k, dtype), _both(v, dtype)
    jc = JA.cache_write(JA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits),
                        jk, jv, pos, JPim())
    tc = TA.cache_write(TA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits),
                        tk, tv, pos, TPim())
    return jc, tc, k, v


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_write_planes_bit_exact(kv_bits, dtype):
    jc, tc, _, _ = _caches(np.random.RandomState(6), 2, 5, 12, 2, 32,
                           kv_bits, dtype, pos=3)
    # the port's planes are head-major: (B, Hkv, S, ...) for (B, S, Hkv, ...)
    for f in ("k_q", "v_q", "k_scale", "v_scale"):
        _exact(getattr(jc, f), getattr(tc, f).transpose(1, 2))
    assert int(jc.length) == tc.length == 8


def test_cache_write_overflow_raises():
    tc = TA.init_kv_cache(1, 4, 1, 8)
    with pytest.raises(ValueError):
        TA.cache_write(tc, torch.zeros(1, 3, 1, 8), torch.zeros(1, 3, 1, 8), 2,
                       TPim())


@pytest.mark.parametrize("case", [
    # (Sq, q_offset, kv_len, window, kv_bits, dtype)
    (12, 0, 12, 0, 8, "float32"),
    (1, 11, 12, 0, 8, "float32"),
    (12, 0, 12, 5, 8, "float32"),
    (6, 4, 10, 0, 4, "float32"),
    (12, 0, 12, 0, 8, "bfloat16"),
])
def test_behavioral_pim_attention_matches_jax(case):
    """Behavioral attention: integer codes throughout, so the only float
    differences come from einsum reorderings (none at these sizes)."""
    Sq, off, kv_len, window, kv_bits, dtype = case
    r = np.random.RandomState(7)
    B, H, Hkv, Dh = 2, 4, 2, 32
    jc, tc, _, _ = _caches(r, B, kv_len, 16, Hkv, Dh, kv_bits, dtype)
    q = (r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32)
    jq, tq = _both(q, dtype)
    run = functools.partial(JA.pim_attention, pim_cfg=JPim(), lut_cfg=JLut(),
                            q_offset=off, window=window, out_dtype=jnp.float32)
    # jit fuses bf16 roundings away, so the bf16 case runs eagerly
    j = (run if dtype == "bfloat16" else jax.jit(run))(jq, jc)
    t = TA.pim_attention(tq, tc, TPim(), TLut(), off, window=window,
                         out_dtype=torch.float32)
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-6)


def test_fp_attention_matches_jax():
    r = np.random.RandomState(8)
    q, k, v = (r.randn(2, 9, 4, 16).astype(np.float32),
               r.randn(2, 9, 2, 16).astype(np.float32),
               r.randn(2, 9, 2, 16).astype(np.float32))
    j = jax.jit(functools.partial(JA.fp_attention, window=4, kv_valid_len=8))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = TA.fp_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), window=4, kv_valid_len=8)
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args", [
    (128, 128, 0, 16, 16, True, 0, None, None),
    (40, 256, 0, 8, 32, True, 0, 40, None),
    (128, 128, 0, 16, 16, True, 24, None, None),
    (4, 256, 96, 4, 32, True, 0, 100, 2),
    (1, 512, 99, 1, 64, True, 40, 100, None),
])
def test_expected_kv_block_iters_equal(args):
    q_len, k_len, off, bq, bk, causal, window, kvl, qvl = args
    kw = dict(causal=causal, window=window, kv_valid_len=kvl, q_valid_len=qvl)
    assert (TA.expected_kv_block_iters(q_len, k_len, off, bq, bk, **kw)
            == JA.expected_kv_block_iters(q_len, k_len, off, bq, bk, **kw))


def test_attention_ref_matches_jax():
    r = np.random.RandomState(9)
    jc, tc, _, _ = _caches(r, 1, 20, 24, 2, 32, 8, "float32")
    from repro.kernels import ops as JO
    from repro_torch.kernels import ops as TO
    q = (r.randn(1, 6, 4, 32) * 0.5).astype(np.float32)
    # eager: under jit XLA turns the f32 division by 127 into a reciprocal multiply
    jl = JO.kernel_attention_layout(jnp.asarray(q), jc)
    tl = TO.kernel_attention_layout(torch.from_numpy(q), tc)
    for a, b in zip(jl, tl):
        _exact(a, b)
    j = jax.jit(functools.partial(JR.pim_attention_ref, q_offset=14, kv_len=20,
                                  window=8))(*jl)
    t = TR.pim_attention_ref(*tl, 14, 20, window=8)
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_layout_bit_exact(kv_bits, dtype):
    """The kernels' int8 operands and float32 scales, from q and K/V in the
    compute dtype."""
    from repro.kernels import ops as JO
    from repro_torch.kernels import ops as TO
    r = np.random.RandomState(10)
    jc, tc, _, _ = _caches(r, 2, 7, 9, 2, 32, kv_bits, dtype)
    jq, tq = _both((r.randn(2, 5, 4, 32) * 0.7).astype(np.float32), dtype)
    for a, b in zip(JO.kernel_attention_layout(jq, jc),
                    TO.kernel_attention_layout(tq, tc)):
        assert b.dtype in (torch.int8, torch.float32)
        _exact(a, b)
