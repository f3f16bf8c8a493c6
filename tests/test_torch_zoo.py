"""The zoo's other archs served by the port against the JAX package, on the
CPU: qwen2-72b (QKV bias), mistral-large-123b (rope theta 1e6) and
dbrx-132b (16 experts in the full config; SMOKE: 3 MoE layers of 4 routed
experts, top-2, no shared experts, no dense prefix).

SMOKE configs in float32 at the ideal ADC, parameters from the reference's
seeded `init` through `from_jax_params`, the port on one torch thread.
`forward_serve` logits of a prefill and a decode step within rel 1e-4 of
JAX's, on the dense cache and (dbrx) the paged pool, and a greedy dbrx
stream token for token.  dbrx's SMOKE head_dim is 16, which the kernels
do not take (`HEAD_DIMS`): its kernel path runs at head_dim 32 on both
sides, its behavioral path at 16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TD
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

PAGE = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, **kw):
    kw = dict(compute_dtype="float32", decode_block_k=PAGE, **kw)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, build_model(tcfg, "cpu"), from_jax_params(jp, tcfg, "cpu")


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _dense_steps(jm, jp, tm, tp, toks):
    B, S = toks.shape
    t_toks = torch.from_numpy(toks).long()
    jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(B, S + 4), 0)
    jl2, _, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks[:, :1])}, jc, S)
    tl, tc = tm.forward_serve(tp, {"tokens": t_toks}, tm.init_cache(B, S + 4), 0)
    tl2, _ = tm.forward_serve(tp, {"tokens": t_toks[:, :1]}, tc, S)
    return [(jl, tl), (jl2, tl2)]


def _paged_steps(jm, jp, tm, tp, toks):
    B, S = toks.shape
    mp = -(-(S + 4) // PAGE)
    table = (1 + np.random.RandomState(1).permutation(B * mp)).reshape(B, mp)
    table = table.astype(np.int32)
    jc = jm.init_cache(B, S + 4, ragged=True, page_size=PAGE, num_pages=B * mp + 1)
    tc = tm.init_cache(B, S + 4, page_size=PAGE, num_pages=B * mp + 1)
    out = []
    for toks_i, off in ((toks, 0), (toks[:, :1], S)):
        offs = np.full(B, off, np.int32)
        lens = np.full(B, toks_i.shape[1], np.int32)
        jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks_i)}, jc,
                                     jnp.asarray(offs), seq_lens=jnp.asarray(lens),
                                     pages=jnp.asarray(table))
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks_i).long()},
                                  tc, torch.from_numpy(offs),
                                  seq_lens=torch.from_numpy(lens),
                                  pages=torch.from_numpy(table))
        out.append((jl, tl))
    return out


def _toks(seed=2):
    return np.random.RandomState(seed).randint(0, 256, (2, 8)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen2-72b", "mistral-large-123b"])
def test_attention_archs_forward_serve_logits_match_jax(arch):
    """Kernel path, dense cache: qwen2's QKV biases (held against JAX by no
    other test) and mistral's rope theta reach the logits as JAX's."""
    jm, jp, tm, tp = _models(arch, attn_impl="kernel")
    if arch == "qwen2-72b":
        assert "b" in tp["blocks"][0]["attn"]["wq"]
        assert np.abs(jp["blocks"][0]["attn"]["wq"]["b"]).max() == 0
    for j, t in _dense_steps(jm, jp, tm, tp, _toks()):
        assert t.shape == j.shape
        assert _rel(t, j) <= 1e-4


def test_qwen2_nonzero_qkv_bias_matches_jax():
    """The reference initializes the biases at zero: with random ones the
    biases' adds are held too."""
    jm, jp, tm, tp = _models("qwen2-72b", attn_impl="behavioral")
    rng = np.random.RandomState(3)
    for name in ("wq", "wk", "wv"):
        b = jp["blocks"][0]["attn"][name]["b"]
        jp["blocks"][0]["attn"][name]["b"] = (rng.randn(*b.shape) * 0.5).astype(np.float32)
    tp = from_jax_params(jp, tm.cfg, "cpu")
    for j, t in _dense_steps(jm, jp, tm, tp, _toks(4)):
        assert _rel(t, j) <= 1e-4


@pytest.mark.parametrize("impl,head_dim", [("behavioral", 0), ("kernel", 32)])
def test_dbrx_forward_serve_logits_match_jax(impl, head_dim):
    """Prefill and decode, dense and paged."""
    kw = dict(attn_impl=impl)
    if head_dim:
        kw["head_dim"] = head_dim
    jm, jp, tm, tp = _models("dbrx-132b", **kw)
    assert "shared" not in tp["blocks"][0]["moe"] and "dense_prefix" not in tp
    toks = _toks(5)
    for steps in (_dense_steps, _paged_steps):
        for j, t in steps(jm, jp, tm, tp, toks):
            assert t.shape == j.shape
            assert _rel(t, j) <= 1e-4


def test_dbrx_greedy_generate_stream_identical_to_jax():
    jm, jp, tm, tp = _models("dbrx-132b", attn_impl="kernel", head_dim=32)
    toks = TD.lm_batch(6, 2, 8, 256)
    js = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 8, 16)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 8, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
