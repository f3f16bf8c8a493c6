"""xlstm-1.3b served by the port against the JAX package on the CPU.

SMOKE xlstm-1.3b: 4 layers (mlstm, slstm, mlstm, slstm), d_model 64, 2
heads, vocab 256; an mLSTM block's inner width is 128 (head dim 64), an
sLSTM block's MLP 128 wide (the published model: 48 layers, 7 mLSTM : 1
sLSTM, d_model 2,048, 4 heads).  Parameters come from the reference's
seeded `init` with nonzero gate and recurrent weights written into both
trees (the reference's init leaves `w_igate`, `w_fgate` and every `r_*`
at zero, under which a wrong gate product or recurrent product would not
show), through `from_jax_params`, at the ideal ADC, on one torch thread.
Bounds:
  * `_mlstm_chunk_scan` (chunks of 4 over 10 steps: two whole chunks and a
    padded one, from a nonzero carried state): h, C and n within rel 1e-6
    of the reference's, m bit for bit (its forget-gate sums are XLA's
    order, `layers.blocked_cumsum`, and its maxima exact); the port's
    products and sums over time round in another order (ulps);
  * a prefill of S steps against S single steps of the port: h and the
    states within rel 1e-5 (the chunk's (T, T) weights against one step's
    running state: float32 roundings, no other difference);
  * one mLSTM and one sLSTM block against the reference's eager blocks, a
    7-token prefill and a decode step: float32 within rel 1e-6, bf16
    outputs bit for bit; their float32 states within rel 1e-6 in both;
  * the SMOKE model: a float32 greedy stream through `generate` equal to
    the reference's jitted `greedy_generate`, teacher-forced logits within
    rel 1e-5 in float32 and 0.15 in bf16: the reference's layer scan
    compiles its bf16 blocks with XLA, which fuses away roundings its
    eager blocks keep (each block here equals the eager one bit for bit;
    the prefill's logits part by 0.106 at the 4th layer's output);
  * `from_jax_params`: float32 leaves kept bit for bit, the eight PIM
    linears deployed as the reference's QAT layer quantizes them on every
    call; the parameter count, `init`'s tree, the refusals (the
    Scheduler in both packages, ragged and paged states) and the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import pim as JP
from repro.models import blocks as JB
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "xlstm-1.3b"
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_nonzero_gates(jp, seed: int = 5):
    """The reference's tree with nonzero mLSTM gate matrices and input-gate
    biases and nonzero sLSTM recurrent blocks (numpy draws)."""
    r = np.random.RandomState(seed)
    jp = jax.tree.map(np.asarray, jp)
    out = []
    for blk in jp["blocks"]:
        blk = dict(blk)
        for name in ("w_igate", "w_fgate", "b_igate", "r_z", "r_i", "r_f", "r_o"):
            if name in blk:
                a = blk[name]
                scale = 1.0 if name == "b_igate" else 1.0 / np.sqrt(a.shape[-2])
                blk[name] = (r.randn(*a.shape) * scale).astype(np.float32)
        out.append(blk)
    return dict(jp, blocks=tuple(out))


@pytest.fixture(scope="module")
def jax_params():
    return _with_nonzero_gates(jax_build(jax_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0)))


_MODELS = {}


def _models(jp, dtype: str):
    """(jax model, port model, port params) of SMOKE xlstm at `dtype`,
    built once a module."""
    if dtype not in _MODELS:
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), compute_dtype=dtype)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=dtype)
        _MODELS[dtype] = (jax_build(jcfg), build_model(tcfg, "cpu"),
                          from_jax_params(jp, tcfg, "cpu"))
    return _MODELS[dtype]


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _bits(t, j):
    return np.array_equal(t.float().numpy(), np.asarray(jnp.asarray(j, jnp.float32)))


def _scan_inputs(S: int = 10, H: int = 2, dh: int = 64, seed: int = 0):
    """q, k, v (B, S, H, dh), log_i, log_f (B, S, H) and a carried state
    {"C", "n", "m"}, float32 numpy."""
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, H, dh).astype(np.float32) for _ in range(3))
    log_i = (r.randn(B, S, H) * 2).astype(np.float32)
    log_f = -np.log1p(np.exp(-(r.randn(B, S, H) + 2))).astype(np.float32)
    state = {"C": (r.randn(B, H, dh, dh) * 0.1).astype(np.float32),
             "n": (r.randn(B, H, dh) * 0.1).astype(np.float32),
             "m": r.randn(B, H).astype(np.float32)}
    return (q, k, v, log_i, log_f), state


def _torch_state(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


# ---------------------------------------------------------------------------
# the mLSTM chunk scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [4, 1024], ids=["chunks-of-4", "one-chunk"])
def test_mlstm_chunk_scan_matches_jax(chunk):
    """10 steps from a nonzero carried state: chunks of 4 (two whole and a
    padded one, log_i = -1e30 on its 2 padded steps) and one chunk of 10
    (T = min(chunk, S))."""
    args, state = _scan_inputs()
    jh, js = JB._mlstm_chunk_scan(*map(jnp.asarray, args),
                                  jax.tree.map(jnp.asarray, state), chunk)
    ts = _torch_state(state)
    th = TB._mlstm_chunk_scan(*map(torch.from_numpy, args), ts, chunk)
    assert th.shape == jh.shape and th.dtype == torch.float32
    assert _rel(th, jh) <= 1e-6
    assert _rel(ts["C"], js["C"]) <= 1e-6 and _rel(ts["n"], js["n"]) <= 1e-6
    np.testing.assert_array_equal(ts["m"].numpy(), np.asarray(js["m"]))


def test_mlstm_prefill_equals_single_steps():
    """The port's scan over 10 steps in chunks of 4 against 10 scans of one
    step each, from the same carried state: h and the end state."""
    args, state = _scan_inputs(seed=1)
    a = [torch.from_numpy(x) for x in args]
    whole, steps = _torch_state(state), _torch_state(state)
    h = TB._mlstm_chunk_scan(*a, whole, 4)
    hs = [TB._mlstm_chunk_scan(*(x[:, t:t + 1] for x in a), steps, 4)
          for t in range(10)]
    h1 = torch.cat(hs, dim=1)
    assert (h1 - h).abs().max() <= 1e-5 * h.abs().max()
    for k in ("C", "n", "m"):
        assert (steps[k] - whole[k]).abs().max() <= 1e-5 * whole[k].abs().max()


def test_slstm_prefill_equals_single_steps(jax_params):
    """An sLSTM block's prefill of 9 tokens against 9 single steps: its
    recurrence runs one step per token either way, so bit for bit (the
    input products are per row, rows of the same values)."""
    _, tm, tp = _models(jax_params, "float32")
    blk = TT._index(tp["blocks"][1], 0)
    x = torch.from_numpy(np.random.RandomState(2).randn(B, 9, 64).astype(np.float32))
    whole = TT._state_init("slstm", tm.cfg, B, 16, "cpu")
    steps = TT._state_init("slstm", tm.cfg, B, 16, "cpu")
    y = TB.slstm_block_fwd_serve(blk, x, whole, tm.cfg)
    y1 = torch.cat([TB.slstm_block_fwd_serve(blk, x[:, t:t + 1], steps, tm.cfg)
                    for t in range(9)], dim=1)
    assert (y1 - y).abs().max() <= 1e-5 * y.abs().max()
    for k in ("c", "n", "m", "h"):
        assert (steps[k] - whole[k]).abs().max() <= 1e-5 * whole[k].abs().max()


# ---------------------------------------------------------------------------
# the blocks against the reference's eager blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,j", [("mlstm", 0), ("slstm", 1)])
def test_block_prefill_and_decode_match_jax_eager(jax_params, kind, j, dtype):
    """A 7-token prefill, then a decode step on the carried state."""
    jm, tm, tp = _models(jax_params, dtype)
    jblk = jax.tree.map(lambda a: a[0], jax_params["blocks"][j])
    tblk = TT._index(tp["blocks"][j], 0)
    js = getattr(JB, f"{kind}_block_init_state")(jm.cfg, B, 16)
    ts = TT._state_init(kind, tm.cfg, B, 16, "cpu")
    r = np.random.RandomState(3)
    for off, S in ((0, 7), (7, 1)):
        x = r.randn(B, S, 64).astype(np.float32)
        jo, js = getattr(JB, f"{kind}_block_fwd_serve")(
            jblk, jnp.asarray(x, dtype), js, off, jm.cfg)
        to = getattr(TB, f"{kind}_block_fwd_serve")(
            tblk, torch.from_numpy(x).to(getattr(torch, dtype)), ts, tm.cfg)
        assert to.dtype == getattr(torch, dtype) and to.shape == jo.shape
        if dtype == "bfloat16":
            assert _bits(to, jo), (kind, off)
        else:
            assert _rel(to, jo) <= 1e-6
        for k in ts:
            assert ts[k].dtype == torch.float32 and _rel(ts[k], js[k]) <= 1e-6, k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_from_jax_params_keeps_float32_leaves_and_deploys_pim_linears(jax_params):
    """Every raw float32 leaf (gate matrices, recurrent blocks, biases,
    norms) is kept bit for bit; the eight PIM linears (w_up, w_gate, wq,
    wk, wv, w_down; the sLSTM MLP's w_in, w_out) hold the int8 codes and
    bf16 scales the reference's QAT layer computes from w in bf16."""
    _, _, tp = _models(jax_params, "bfloat16")
    pim_cfg = jax_config(ARCH, smoke=True).pim
    linears = 0
    for jblk, tblk in zip(jax_params["blocks"], tp["blocks"]):
        for name, leaf in jblk.items():
            got = tblk[name]
            if isinstance(leaf, dict) and "w" in leaf:            # a PIM linear
                w_q, w_s = jax.vmap(lambda w: JP.quantize_weights(
                    w.astype(jnp.bfloat16), pim_cfg))(jnp.asarray(leaf["w"]))
                np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(w_q))
                assert _bits(got["w_scale"], w_s)
                linears += 1
            elif name == "mlp":
                for lin in ("w_in", "w_out"):
                    w_q, _ = jax.vmap(lambda w: JP.quantize_weights(
                        w.astype(jnp.bfloat16), pim_cfg))(jnp.asarray(leaf[lin]["w"]))
                    np.testing.assert_array_equal(got[lin]["w_q"].numpy(), np.asarray(w_q))
                    linears += 1
            elif isinstance(leaf, dict):                          # a norm
                np.testing.assert_array_equal(got["scale"].numpy(), leaf["scale"])
            else:
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), leaf)
    assert linears == 8


def test_init_draws_the_reference_tree(jax_params):
    """The port's own `init` gives the tree `from_jax_params` makes of the
    reference's (leaves, shapes, dtypes), with the reference's zero gates,
    zero recurrent blocks and forget biases of 3; its states mirror the
    reference's `init_cache`."""
    _, tm, tp = _models(jax_params, "bfloat16")

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in shapes(tree[key], path + (key,)).items()}
        if isinstance(tree, (tuple, list)):
            return {k: v for i, x in enumerate(tree) for k, v in shapes(x, path + (i,)).items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    own = tm.init(seed=0)
    assert shapes(own) == shapes(tp)
    m, s = own["blocks"]
    assert not m["w_igate"].any() and not s["r_z"].any()
    assert bool((m["b_fgate"] == 3.0).all()) and bool((s["b_f"] == 3.0).all())
    jc = jax_build(jax_config(ARCH, smoke=True)).init_cache(B, 16)
    tc = tm.init_cache(B, 16)
    for j, t in zip(jc["blocks"], tc["blocks"]):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_float32_greedy_stream_equals_jax(jax_params):
    """A 12-token prompt and 8 new tokens through `generate` against the
    reference's jitted `greedy_generate`."""
    jm, tm, tp = _models(jax_params, "float32")
    jp = jax.tree.map(jnp.asarray, jax_params)
    toks = np.random.RandomState(7).randint(0, 256, (B, 12)).astype(np.int32)
    js = JS.greedy_generate(jm, jp, {"tokens": jnp.asarray(toks)}, 8, 20)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks).long()}, 8, 20)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.15)])
def test_teacher_forced_logits_match_jax(jax_params, dtype, tol):
    """A 10-token prefill and three decode steps fed JAX's greedy tokens;
    the states after them."""
    jm, tm, tp = _models(jax_params, dtype)
    jp = jax.tree.map(jnp.asarray, jax_params)
    fwd = jax.jit(jm.forward_serve)
    toks = np.random.RandomState(8).randint(0, 256, (B, 10)).astype(np.int32)
    jl, jc, _ = fwd(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(B, 16), 0)
    with torch.inference_mode():
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks).long()},
                                  tm.init_cache(B, 16), 0)
        assert tl.shape == jl.shape and _rel(tl, jl) <= tol
        for t in range(3):
            nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
            jl, jc, _ = fwd(jp, {"tokens": jnp.asarray(nxt)}, jc, 10 + t)
            tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(nxt).long()},
                                      tc, 10 + t)
            assert _rel(tl, jl) <= tol
    for j, t in zip(jc["blocks"], tc["blocks"]):
        for k in j:
            assert _rel(t[k], j[k]) <= max(tol, 1e-4), k


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_equals_jax(smoke):
    assert get_config(ARCH, smoke).param_count() == jax_config(ARCH, smoke).param_count()


def test_config_equals_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke)) == \
            dataclasses.asdict(jax_config(ARCH, smoke))


def test_scheduler_and_slot_storage_refuse_the_arch(jax_params):
    """As the reference's: a recurrent state cannot be length-masked per
    slot, so the slot scheduler, ragged slots and the paged pool serve it
    not."""
    assert not TS.scheduler_supported(get_config(ARCH))
    assert not JS.scheduler_supported(jax_config(ARCH))
    jm, tm, tp = _models(jax_params, "bfloat16")
    with pytest.raises(NotImplementedError):
        JS.Scheduler(jm, jax_params, max_batch_slots=2, max_len=16)
    with pytest.raises(NotImplementedError):
        TS.Scheduler(tm, tp, max_batch_slots=2, max_len=16)
    with pytest.raises(NotImplementedError):
        tm.init_cache(B, 16, ragged=True)
    with pytest.raises(NotImplementedError):
        tm.init_cache(B, 16, page_size=8, num_pages=9)


@pytest.mark.parametrize("extra", [[], ["--continuous-batching"]],
                         ids=["classic", "continuous-batching"])
def test_serve_cli(extra):
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "3", "--device", "cpu"] + extra
    if extra:
        with pytest.raises(NotImplementedError):
            tserve.main(argv)
        return
    out = tserve.main(argv)
    assert tuple(out.shape) == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < 256
