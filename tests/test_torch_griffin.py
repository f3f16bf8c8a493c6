"""The port's Griffin pieces against the JAX package, on the CPU: the ring
(sliding-window) caches, the RG-LRU block and recurrentgemma-9b served.

SMOKE recurrentgemma-9b: 3 layers (rglru, rglru, attn_local), d_model 64,
2 q heads over 1 KV head of 32, lru_width 64, conv width 4, window 16, so
that a cache of more than 16 tokens is a ring.  Parameters come from the
reference's seeded `init` through `from_jax_params`, at the ideal ADC, and
the port runs on one torch thread.  Bounds:
  * ring writes: codes, scales, positions and length bit for bit (the
    port's planes are head-major and are transposed to compare);
  * `pim_attention_ring`: rel 1e-5 (the integer products are exact and
    both packages round the same float32 ops, so it is bit for bit here);
  * the RG-LRU pieces in float32: rel 1e-5; the gates' (w, w) float32
    products and XLA's sigmoid / log-sigmoid round unlike torch's;
  * `forward_serve`, teacher-forced along JAX's greedy stream: every
    step's logits within rel 1e-4 in float32, past the window, on both
    attention paths and with and without a ring; bf16 within the bound of
    `test_forward_serve_logits_match_jax` (0.1).  Greedy streams are not
    compared: a float32 ulp of an RG-LRU output can flip an int8 code in
    the next attention layer (ROADMAP §3) and part them.
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
from repro.models import blocks as JB
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import LUTSoftmaxConfig as TLut, PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "recurrentgemma-9b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_build(jax_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0)))


def _cfgs(**kw):
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _j(t):
    """A port (B, Hkv, S, ...) plane in the reference's (B, S, Hkv, ...)."""
    return t.transpose(1, 2).numpy()


# ---------------------------------------------------------------------------
# ring caches
# ---------------------------------------------------------------------------
def _ring_pair(B=2, W=16, Hkv=1, Dh=32):
    return (JA.init_kv_cache(B, W, Hkv, Dh, ring=True),
            TA.init_kv_cache(B, W, Hkv, Dh, ring=True))


@pytest.mark.parametrize("writes", [[(0, 5), (5, 1), (6, 1)], [(0, 16), (16, 1)],
                                    [(0, 23), (23, 1), (24, 1)]],
                         ids=["S<W", "S=W", "S>W"])
def test_cache_write_ring_bit_identical_to_jax(writes):
    """A prefill of S tokens from position 0 and decode writes after it:
    the slots, codes, scales, positions and length of every write."""
    jc, tc = _ring_pair()
    r = np.random.RandomState(sum(s for _, s in writes))
    for off, S in writes:
        k = (r.randn(2, S, 1, 32) * 0.7).astype(np.float32)
        v = (r.randn(2, S, 1, 32) * 0.7).astype(np.float32)
        jc = JA.cache_write_ring(jc, jnp.asarray(k), jnp.asarray(v), off, JPim())
        TA.cache_write_ring(tc, torch.from_numpy(k), torch.from_numpy(v), off, TPim())
        for f in ("k_q", "v_q", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_j(getattr(tc, f)), np.asarray(getattr(jc, f)))
        np.testing.assert_array_equal(tc.positions.numpy(), np.asarray(jc.positions))
        assert tc.length == int(jc.length) == off + S


@pytest.mark.parametrize("adc_mode", ["ideal", "quantized"])
@pytest.mark.parametrize("heads,window,fill", [((2, 1), 16, 30), ((4, 2), 16, 9),
                                               ((2, 1), 12, 40)],
                         ids=["mqa-wrapped", "gqa-partial", "window<ring"])
def test_pim_attention_ring_matches_jax(adc_mode, heads, window, fill):
    """A ring of 16 slots filled through `fill` positions (wrapped, partly
    empty), one decode query at position `fill`, and a window narrower than
    the ring (slots past it masked by their positions)."""
    H, Hkv = heads
    B, W, Dh = 2, 16, 32
    jc, tc = _ring_pair(B, W, Hkv, Dh)
    r = np.random.RandomState(fill + H)
    k = (r.randn(B, fill + 1, Hkv, Dh) * 0.7).astype(np.float32)
    v = (r.randn(B, fill + 1, Hkv, Dh) * 0.7).astype(np.float32)
    jpim, tpim = JPim(adc_mode=adc_mode), TPim(adc_mode=adc_mode)
    jc = JA.cache_write_ring(jc, jnp.asarray(k), jnp.asarray(v), 0, jpim)
    TA.cache_write_ring(tc, torch.from_numpy(k), torch.from_numpy(v), 0, tpim)
    q = (r.randn(B, 1, H, Dh) * 0.7).astype(np.float32)
    jo = JA.pim_attention_ring(jnp.asarray(q), jc, jpim, JLut(), fill, window,
                               out_dtype=jnp.float32)
    to = TA.pim_attention_ring(torch.from_numpy(q), tc, tpim, TLut(), fill,
                               window, out_dtype=torch.float32)
    assert to.shape == jo.shape
    assert _rel(to, jo) <= 1e-5


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rglru_block(jax_params):
    _, tcfg = _cfgs(compute_dtype="float32")
    blk = jax.tree.map(lambda a: a[0], jax_params["blocks"][0])
    return blk, TT._index(from_jax_params(jax_params, tcfg, "cpu")["blocks"][0], 0)


def test_rglru_pieces_match_jax(rglru_block):
    """`_causal_conv1d` (bf16 u against the float32 taps, with a carry),
    `_rglru_gates` and `_lru_scan` (11 steps: the odd/even recursion's
    uneven levels) in float32."""
    blk, tblk = rglru_block
    r = np.random.RandomState(3)
    u = (r.randn(2, 11, 64)).astype(np.float32)
    carry = (r.randn(2, 3, 64)).astype(np.float32)
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jo, jcar = JB._causal_conv1d(jnp.asarray(u, dt), blk["conv_w"], blk["conv_b"],
                                     carry=jnp.asarray(carry))
        to, tcar = TB._causal_conv1d(torch.from_numpy(u).to(tdt), tblk["conv_w"],
                                     tblk["conv_b"], carry=torch.from_numpy(carry))
        assert to.dtype == tdt and _rel(to, jo) <= 1e-6
        np.testing.assert_array_equal(tcar.float().numpy(),
                                      np.asarray(jcar.astype(jnp.float32)))
    jla, jb = JB._rglru_gates(blk, jnp.asarray(u))
    tla, tb = TB._rglru_gates(tblk, torch.from_numpy(u))
    assert _rel(tla, jla) <= 1e-5 and _rel(tb, jb) <= 1e-5
    h0 = r.randn(2, 64).astype(np.float32)
    jh = JB._lru_scan(jla, jb, jnp.asarray(h0))
    th = TB._lru_scan(torch.from_numpy(np.asarray(jla)),
                      torch.from_numpy(np.asarray(jb)), torch.from_numpy(h0))
    assert _rel(th, jh) <= 1e-6


def test_rglru_block_prefill_then_decode_matches_jax(rglru_block):
    """A 13-token prefill, then 3 decode steps on the carried state."""
    blk, tblk = rglru_block
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    r = np.random.RandomState(4)
    js = JB.rglru_block_init_state(jcfg, 2, 32)
    ts = TT._state_init("rglru", tcfg, 2, 32, "cpu")
    for off, S in ((0, 13), (13, 1), (14, 1), (15, 1)):
        x = r.randn(2, S, 64).astype(np.float32)
        jo, js = JB.rglru_block_fwd_serve(blk, jnp.asarray(x), js, off, jcfg)
        to = TB.rglru_block_fwd_serve(tblk, torch.from_numpy(x), ts, tcfg)
        assert _rel(to, jo) <= 1e-5
        assert _rel(ts["h"], js["h"]) <= 1e-5 and _rel(ts["conv"], js["conv"]) <= 1e-5


# ---------------------------------------------------------------------------
# recurrentgemma-9b served
# ---------------------------------------------------------------------------
def _teacher_forced(jcfg, tcfg, jp, tp, prompt_len, steps, max_len, seed):
    """JAX's greedy stream from a prefill of `prompt_len` tokens and
    `steps` decode steps; the port fed the same tokens.  Returns each
    step's (jax logits, port logits).  The reference's forward runs
    jitted, one compile a shape: its logits equal its eager run's bit for
    bit on every path and dtype here (its layer scan compiles the blocks
    in both), at a tenth of the time of a decode step."""
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    fwd = jax.jit(jm.forward_serve)
    jp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.RandomState(seed).randint(0, 256, (2, prompt_len)).astype(np.int32)
    jl, jc, _ = fwd(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, max_len), 0)
    tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks).long()},
                              tm.init_cache(2, max_len), 0)
    out = [(jl, tl)]
    for t in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc, _ = fwd(jp, {"tokens": jnp.asarray(nxt)}, jc, prompt_len + t)
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(nxt).long()}, tc,
                                  prompt_len + t)
        out.append((jl, tl))
    return out, tc


@pytest.mark.parametrize("impl", ["behavioral", "kernel"])
@pytest.mark.parametrize("prompt_len,steps,max_len,ring",
                         [(8, 24, 32, True), (24, 8, 32, True), (8, 7, 15, False)],
                         ids=["ring-decode-past-window", "ring-prefill-past-window",
                              "no-ring"])
def test_forward_serve_teacher_forced_matches_jax(jax_params, impl, prompt_len,
                                                  steps, max_len, ring):
    """Float32.  With a ring (max_len 32 > window 16) the decode runs the
    ring write and `pim_attention_ring`, past the window; a 24-token
    prompt prefills through kernel 1 / the behavioral pass with the window
    and writes its last 16 tokens.  Below the window the cache holds the
    whole context (max_len 15: the reference takes
    a cache of exactly `window` slots for a ring and cannot serve it):
    decode through kernel 2 (or the behavioral pass) with
    the window mask."""
    jcfg, tcfg = _cfgs(attn_impl=impl, compute_dtype="float32")
    tp = from_jax_params(jax_params, tcfg, "cpu")
    steps_out, tc = _teacher_forced(jcfg, tcfg, jax_params, tp, prompt_len, steps,
                                    max_len, seed=prompt_len + max_len)
    cache = tc["blocks"][2]
    assert (cache.positions is not None) == ring
    assert cache.k_q.shape[-2] == (16 if ring else max_len)
    for j, t in steps_out:
        assert t.shape == j.shape
        assert _rel(t, j) <= 1e-4


def test_forward_serve_bf16_logits_within_bound(jax_params):
    jcfg, tcfg = _cfgs(attn_impl="kernel")
    tp = from_jax_params(jax_params, tcfg, "cpu")
    steps_out, _ = _teacher_forced(jcfg, tcfg, jax_params, tp, 20, 3, 32, seed=9)
    for j, t in steps_out:
        assert _rel(t, j) <= 0.1


def test_state_tree_and_rglru_init_follow_the_reference(jax_params):
    """The port's own `init` draws the reference's tree (leaf names and
    shapes, the raw float32 leaves kept, the linears deployed), and its
    serve state mirrors `init_cache`'s: {"h", "conv"} per RG-LRU layer,
    a 16-slot int8 ring for the attention layer past the window."""
    _, tcfg = _cfgs(compute_dtype="float32")
    tm = build_model(tcfg, "cpu")
    own, conv = tm.init(seed=0), from_jax_params(jax_params, tcfg, "cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(shapes(v) for v in tree)
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(conv)
    assert own["blocks"][0]["w_input_gate"].dtype == torch.float32
    assert "w_q" in own["blocks"][0]["w_x"]
    jc = jax_build(jax_config(ARCH, smoke=True)).init_cache(2, 40)
    tc = tm.init_cache(2, 40)
    for j, t in zip(jc["blocks"][:2], tc["blocks"][:2]):
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
    ring = tc["blocks"][2]
    assert ring.k_q.dtype == torch.int8 and tuple(ring.positions.shape) == (1, 16)
    np.testing.assert_array_equal(_j(ring.layer(0).k_q),
                                  np.asarray(jc["blocks"][2].k_q[0]))


def test_scheduler_refuses_recurrentgemma_like_jax(jax_params):
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    assert not TS.scheduler_supported(tcfg) and not JS.scheduler_supported(jcfg)
    with pytest.raises(NotImplementedError):
        JS.Scheduler(jax_build(jcfg), jax_params, max_len=32)
    with pytest.raises(NotImplementedError):
        TS.Scheduler(build_model(tcfg, "cpu"),
                     from_jax_params(jax_params, tcfg, "cpu"), max_len=32)
    # the paged and ragged caches have no windows or recurrent states
    with pytest.raises(NotImplementedError):
        build_model(tcfg, "cpu").init_cache(2, 32, page_size=8, num_pages=9)


@pytest.mark.parametrize("impl", ["behavioral", "kernel"])
def test_serve_cli_runs_on_cpu(impl):
    """A 20-token prompt (past the window of 16) and 6 new tokens."""
    out = tserve.main(["--arch", ARCH, "--smoke", "--attn-impl", impl,
                       "--batch", "2", "--prompt-len", "20", "--new-tokens", "6",
                       "--device", "cpu"])
    assert tuple(out.shape) == (2, 6)
    assert int(out.min()) >= 0 and int(out.max()) < 256
