"""whisper-tiny served by the port against the JAX package on the CPU.

SMOKE whisper-tiny: 2 encoder and 2 decoder layers, d_model 64, 2/2 heads
of 32, GELU d_ff 128, layernorm, absolute positions, vocab 256, 12 encoder
frames (the published model: 4 + 4 layers, d_model 384, 6 heads of 64,
1,500 frames).  Parameters come from the reference's seeded `init`
through `from_jax_params`, at the ideal ADC, on one torch thread; the
attention paths are JAX's Pallas kernels in interpret mode against the
port's kernels through their plain versions.  Bounds:
  * the encoder's sinusoid table bit for bit (float32);
  * an encoder block, and a cross-attention block's prefill and decode
    (its output and its self and cross K/V planes), bit for bit against
    the reference's eager blocks in bf16 on shared inputs, within rel
    1e-6 in float32 (the layernorm's float32 means sum in another order);
    the cross planes the port wrote once at the prefill equal those the
    reference rewrites at a decode step;
  * `encode` within rel 1e-5 in float32 and 5e-2 in bf16 (the reference's
    `lax.scan` over the encoder compiles its bf16 blocks with XLA, which
    fuses away roundings); teacher-forced logits within rel 1e-5 in
    float32 and 0.1 in bf16;
  * greedy streams equal to `greedy_generate`'s on the inputs of the
    reference's `test_whisper_generate_with_frames`, behavioral and kernel
    paths in float32, behavioral in bf16 (the jitted reference fuses bf16
    roundings away, which parts its kernel-path stream from its own eager
    run's, and the port's, at the 8th token: `tools/whisper_jit_gap.py`),
    and with 40 frames at decode_block_k 16 (the cross decode's last
    partition holds 8 of 16 rows);
  * the absolute-position embedding (int and per-row offsets, clamped into
    the table) bit for bit, `init`'s tree, the parameter count, and the
    refusals (the Scheduler, a cross cache never written, the CLI's
    `--continuous-batching`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import pipeline as JD
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import _to_torch, build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "whisper-tiny"
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(dtype: str = "bfloat16", impl: str = "kernel", **extra):
    """(jax model, jax params, port model, port params) of SMOKE whisper at
    `dtype` on the `impl` attention path, decode_block_k 8 (and `extra`
    config fields), from the reference's init at PRNGKey(3); built once a
    module."""
    key = (dtype, impl) + tuple(sorted(extra.items()))
    if key not in _MODELS:
        kw = dict(dict(compute_dtype=dtype, attn_impl=impl, decode_block_k=8), **extra)
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(3))
        _MODELS[key] = (jm, jp, build_model(tcfg, "cpu"),
                        from_jax_params(jp, tcfg, "cpu"))
    return _MODELS[key]


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _bits(t, j):
    return np.array_equal(t.float().numpy(), np.asarray(jnp.asarray(j, jnp.float32)))


def _prompt(cfg, n_frames=None):
    """The inputs of the reference's `test_whisper_generate_with_frames`:
    lm_batch(3, 2, 4) tokens and RandomState(0) frames."""
    n_frames = n_frames or cfg.encoder_seq_len
    return (JD.lm_batch(3, B, 4, cfg.vocab_size),
            np.random.RandomState(0).randn(B, n_frames, cfg.d_model).astype(np.float32))


def _planes(state, name):
    """A cross-attention state's self or cross planes in the reference's
    (B, S, Hkv, ...) layout (the port's dense caches are head-major)."""
    c = state[name]
    return [getattr(c, f).transpose(1, 2).numpy()
            for f in ("k_q", "v_q", "k_scale", "v_scale")]


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,d", [(12, 64), (40, 64), (1500, 384)],
                         ids=["smoke", "frames40", "whisper-tiny"])
def test_sinusoidal_positions_bit_for_bit(seq, d):
    """The reference's exp, sinf and cosf: torch's own differ in an ulp
    here and there (2-13 % of the published table)."""
    t = TL.sinusoidal_positions(seq, d)
    assert t.dtype == torch.float32 and tuple(t.shape) == (seq, d)
    np.testing.assert_array_equal(t.numpy(), np.asarray(JL.sinusoidal_positions(seq, d)))


@pytest.mark.parametrize("offset", [0, 5, 126, [0, 7], [3, 200]],
                         ids=["prefill", "decode", "clamped", "ragged", "ragged-clamped"])
def test_absolute_position_embedding_bit_for_bit(offset):
    """Token embedding plus the `pos_embed` rows of the step's positions in
    bf16: an int offset slices rows [offset, offset + S) (a slice past the
    128-row table clamped to its end, as `dynamic_slice` clamps), (B,)
    offsets gather each row's positions, each clamped into the table."""
    jm, jp, _, tp = _models()
    S = 1 if offset == 5 else 3
    toks = JD.lm_batch(1, B, S, 256)
    joff = jnp.asarray(offset, jnp.int32) if isinstance(offset, list) else offset
    toff = torch.tensor(offset, dtype=torch.int32) if isinstance(offset, list) else offset
    j = JT._embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jm.cfg, offset=joff)
    t = TT._embed_inputs(tp, {"tokens": torch.from_numpy(toks).long()},
                         get_config(ARCH, smoke=True), offset=toff)
    assert t.dtype == torch.bfloat16
    assert _bits(t, j)


# ---------------------------------------------------------------------------
# the blocks on shared inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encoder_block_matches_jax_eager(dtype):
    """The port's encoder block against the reference's
    `attn_block_fwd_train(causal=False)`, run eagerly, on the first
    encoder layer."""
    jm, jp, tm, tp = _models(dtype)
    x = jnp.asarray(np.random.RandomState(1).randn(B, 12, 64).astype(np.float32)
                    ).astype(jnp.dtype(dtype))
    j, _ = JB.attn_block_fwd_train(jax.tree.map(lambda a: a[0], jp["enc_blocks"]), x,
                                   jnp.arange(12), jm.cfg, causal=False)
    t = TB.attn_block_fwd_encode(TT._index(tp["enc_blocks"], 0),
                                 _to_torch(np.asarray(x), "cpu"), tm.cfg)
    assert _bits(t, j) if dtype == "bfloat16" else _rel(t, j) <= 1e-6


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["behavioral", "kernel"])
def test_xattn_block_prefill_and_decode_match_jax_eager(impl, dtype):
    """A 5-token prefill with the encoder output and a decode step without
    it, against the reference's eager `xattn_block_fwd_serve`, which
    re-projects and re-writes the cross K/V at its decode step: outputs
    and the self and cross planes (the cross planes after the port's
    prefill equal the reference's after its decode step)."""
    jm, jp, tm, tp = _models(dtype, impl)
    r = np.random.RandomState(2)
    dt = jnp.dtype(dtype)

    def same(rows):
        x = jnp.asarray(r.randn(B, rows, 64).astype(np.float32)).astype(dt)
        return x, _to_torch(np.asarray(x), "cpu")

    (je, te), (jx, tx), (j1, t1) = same(12), same(5), same(1)
    jpl = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    tpl = TT._index(tp["blocks"][0], 0)
    js = JB.xattn_block_init_state(jm.cfg, B, 16)
    ts = TT._state_init("xattn", tm.cfg, B, 16, "cpu")
    jo, js = JB.xattn_block_fwd_serve(jpl, jx, js, 0, jm.cfg, enc_out=je)
    to = TB.xattn_block_fwd_serve(tpl, tx, ts, 0, tm.cfg, enc_out=te)
    prefill_cross = [p.copy() for p in _planes(ts, "cross")]
    ts["self"].length = 5
    jo1, js = JB.xattn_block_fwd_serve(jpl, j1, js, 5, jm.cfg, enc_out=je)
    to1 = TB.xattn_block_fwd_serve(tpl, t1, ts, 5, tm.cfg)
    for t, j in ((to, jo), (to1, jo1)):
        assert _bits(t, j) if dtype == "bfloat16" else _rel(t, j) <= 1e-6
    for name in ("self", "cross"):
        jp_ = [np.asarray(getattr(js[name], f)) for f in ("k_q", "v_q", "k_scale", "v_scale")]
        for i, (t, j) in enumerate(zip(_planes(ts, name), jp_)):
            if dtype == "bfloat16" or i < 2 or name == "cross":
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    for t, j in zip(prefill_cross, _planes(ts, "cross")):
        np.testing.assert_array_equal(t, j)


def test_cross_cache_needs_the_frames():
    """A step without frames over a cross cache never written raises."""
    _, _, tm, tp = _models()
    with pytest.raises(ValueError, match="frames"):
        tm.forward_serve(tp, {"tokens": torch.zeros(B, 3, dtype=torch.long)},
                         tm.init_cache(B, 8), 0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jm, jp, tm, tp = _models(dtype)
    _, frames = _prompt(tm.cfg)
    j = JT.encode(jp, jnp.asarray(frames), jm.cfg)
    t = TT.encode(tp, torch.from_numpy(frames), tm.cfg)
    assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == (B, 12, 64)
    assert _rel(t, j) <= (1e-5 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("dtype,impl", [("float32", "behavioral"), ("float32", "kernel"),
                                        ("bfloat16", "kernel")])
def test_teacher_forced_logits_match_jax(dtype, impl):
    """The prefill with the frames, then two decode steps fed the same
    tokens (the reference's steps given its prefill's encoder output);
    the self caches hold offset + S tokens, the cross caches the 12
    frames."""
    jm, jp, tm, tp = _models(dtype, impl)
    toks, frames = _prompt(tm.cfg)
    nxt = JD.lm_batch(4, B, 2, 256)
    tol = 1e-5 if dtype == "float32" else 0.1
    jl, jc, enc = jm.forward_serve(jp, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(frames)},
                                   jm.init_cache(B, 12), 0)
    tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks).long(),
                                   "frames": torch.from_numpy(frames)},
                              tm.init_cache(B, 12), 0)
    assert _rel(tl, jl) <= tol
    for t in range(2):
        jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(nxt[:, t:t + 1])}, jc,
                                     4 + t, enc_out=enc)
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(nxt[:, t:t + 1]).long()},
                                  tc, 4 + t)
        assert tl.shape == jl.shape and _rel(tl, jl) <= tol
    state = tc["blocks"][0]
    assert state["self"].length == 6 and state["cross"].length == 12


@pytest.mark.parametrize("dtype,impl", [("float32", "behavioral"), ("float32", "kernel"),
                                        ("bfloat16", "behavioral")])
def test_greedy_stream_identical_to_jax(dtype, impl):
    """The reference's `test_whisper_generate_with_frames` inputs, 8 new
    tokens over a cache of 12.  (In bf16 on the kernel path the port's
    stream equals the reference's eager run, and its jitted `generate`
    parts from both at the 8th token: `tools/whisper_jit_gap.py`.)"""
    jm, jp, tm, tp = _models(dtype, impl)
    toks, frames = _prompt(tm.cfg)
    js = JS.greedy_generate(jm, jp, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)}, 8, 12)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks).long(),
                                     "frames": torch.from_numpy(frames)}, 8, 12)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_greedy_stream_over_a_partial_cross_partition():
    """40 frames at decode_block_k 16, kernel path, float32: every cross
    decode reads three partitions, the last holding 8 of its 16 rows."""
    jm, jp, tm, tp = _models("float32", "kernel", encoder_seq_len=40, decode_block_k=16)
    toks, frames = _prompt(tm.cfg, 40)
    js = JS.greedy_generate(jm, jp, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)}, 8, 12)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks).long(),
                                     "frames": torch.from_numpy(frames)}, 8, 12)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_init_draws_the_reference_tree():
    """The port's own `init` gives the tree `from_jax_params` makes of the
    reference's: the same leaves, shapes and dtypes (`pos_embed` float32,
    layernorm biases, `enc_blocks`, `enc_norm`, each block's `norm_x` and
    `xattn`)."""
    _, jp, tm, tp = _models()

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in shapes(tree[key], path + (key,)).items()}
        if isinstance(tree, (tuple, list)):
            return {k: v for i, x in enumerate(tree) for k, v in shapes(x, path + (i,)).items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    got = shapes(tm.init(seed=0))
    assert got == shapes(tp)
    assert got[("pos_embed",)] == ((128, 64), torch.float32)
    assert got[("enc_norm", "bias")] == ((64,), torch.float32)
    assert ("blocks", 0, "xattn", "wk", "w_q") in got


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_equals_jax(smoke):
    assert get_config(ARCH, smoke).param_count() == jax_config(ARCH, smoke).param_count()


def test_scheduler_refuses_the_arch():
    """As the reference's: encoder-decoder archs need per-request encoder
    features, so the slot scheduler serves them not."""
    assert not TS.scheduler_supported(get_config(ARCH))
    assert not JS.scheduler_supported(jax_config(ARCH))
    _, _, tm, tp = _models()
    with pytest.raises(NotImplementedError):
        TS.Scheduler(tm, tp, max_batch_slots=2, max_len=16)


@pytest.mark.parametrize("extra", [[], ["--attn-impl", "kernel"], ["--continuous-batching"]],
                         ids=["classic", "kernel", "continuous-batching"])
def test_serve_cli(extra):
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "3", "--device", "cpu"] + extra
    if "--continuous-batching" in extra:
        with pytest.raises(NotImplementedError):
            tserve.main(argv)
        return
    out = tserve.main(argv)
    assert tuple(out.shape) == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < 256
