"""phi-3-vision-4.2b served by the port against the JAX package on the CPU,
and kernels 1 and 2 at head_dim 96.

SMOKE phi-3-vision-4.2b: 3 layers, d_model 64, 2/2 heads of 32, SwiGLU
d_ff 128, vocab 256, 4 image patches (the published model: 32 heads of 96,
576 patches).  A variant at head_dim 96 (`dataclasses.replace`) runs the
published head dim through both attention paths: JAX's Pallas kernels in
interpret mode, the port's kernels through their plain versions.
Parameters come from the reference's seeded `init` through
`from_jax_params`, at the ideal ADC, on one torch thread.  Bounds:
  * `make_batch` equal to JAX's bit for bit (tokens, frames, image
    embeddings);
  * the bf16 input embedding with the image equal to JAX's eager
    `_embed_inputs` bit for bit, at prompts longer and shorter than the
    patches;
  * float32 logits with the image within rel 1e-4, greedy streams with the
    image identical, at head_dim 32 and 96, behavioral and kernel paths;
  * text-only streams through the paged Scheduler (int8 and 4-bit KV,
    kernel path, head_dim 96) identical to JAX's Scheduler's;
  * the plain versions of kernels 1 and 2 at head_dim 96 (q_per_kv 1 and
    4, windowed, 4-bit, verify rows) within rel 1e-5 of the Pallas kernels
    in interpret mode, iteration maps equal; the launch plans at 96.  The
    CUDA kernels are held to the plain versions by the `gpu` test in
    `test_torch_kernels.py` and by `chip_smoke.py`.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import PIMConfig as JPim
from repro.core import attention as JA
from repro.data import pipeline as JD
from repro.kernels import ops as JO
from repro.kernels.pim_attention import pim_attention_pallas
from repro.kernels.pim_decode import pim_decode_pallas
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import pim_attention as attn_k
from repro_torch.kernels import pim_decode as dec_k
from repro_torch.kernels.pim_attention import pim_attention
from repro_torch.kernels.pim_decode import pim_decode
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "phi-3-vision-4.2b"
REL = 1e-5
V = 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(head_dim: int, impl: str):
    """(jax model, jax params, port model, port params) of SMOKE phi-3 at
    `head_dim` on the `impl` attention path, float32, decode_block_k 8;
    built once a module."""
    key = (head_dim, impl)
    if key not in _MODELS:
        kw = dict(compute_dtype="float32", attn_impl=impl, head_dim=head_dim,
                  decode_block_k=8)
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
        tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[key] = (jm, jp, build_model(tcfg, "cpu"),
                        from_jax_params(jp, tcfg, "cpu"))
    return _MODELS[key]


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _batch(B: int, S: int, step: int = 0):
    """make_batch of the SMOKE config: numpy tokens and image embeddings."""
    shape = types.SimpleNamespace(global_batch=B, seq_len=S)
    return TD.make_batch(get_config(ARCH, smoke=True), shape, step)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


# ---------------------------------------------------------------------------
# the data pipeline and the embedding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lm", "copy"])
@pytest.mark.parametrize("arch,smoke", [(ARCH, True), (ARCH, False),
                                        ("internlm2-1.8b", True),
                                        ("whisper-tiny", True)])
def test_make_batch_equals_jax(arch, smoke, kind):
    """The port's make_batch, given the reference's config (whisper-tiny
    has no port config yet: make_batch reads only its fields), equals the
    reference's bit for bit: tokens, frames, image embeddings, and no
    other key."""
    cfg = jax_config(arch, smoke=smoke)
    shape = types.SimpleNamespace(global_batch=2, seq_len=12)
    for step, seed in ((0, 0), (3, 5)):
        t = TD.make_batch(cfg, shape, step, seed, kind)
        j = JD.make_batch(cfg, shape, step, seed, kind)
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    assert ("image_embeds" in t) == (arch == ARCH)


@pytest.mark.parametrize("S", [8, 3], ids=["S8_past_patches", "S3_within_patches"])
def test_embed_inputs_bf16_bit_identical_to_jax_eager(S):
    """The bf16 input embedding with the image (the projected patches added
    to the first min(4, S) positions) equals the reference's eager
    `_embed_inputs` bit for bit; without the image it is the token
    embedding alone, and positions past the patches do not move."""
    jm, jp, _, _ = _models(32, "behavioral")
    jcfg = dataclasses.replace(jm.cfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype="bfloat16")
    tp = from_jax_params(jp, tcfg, "cpu")
    b = _batch(2, S, step=1)
    j = JT._embed_inputs(jp, _jax(b), jcfg)
    t = TT._embed_inputs(tp, _torch(b), tcfg)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (2, S, 64)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    text = TT._embed_inputs(tp, {"tokens": _torch(b)["tokens"]}, tcfg)
    P = min(4, S)
    assert not torch.equal(t[:, :P], text[:, :P])
    assert torch.equal(t[:, P:], text[:, P:])


# ---------------------------------------------------------------------------
# phi-3 served, with the image
# ---------------------------------------------------------------------------
PATHS = [(32, "behavioral"), (32, "kernel"), (96, "behavioral"), (96, "kernel")]
PATH_IDS = ["dh32-behavioral", "dh32-kernel", "dh96-behavioral", "dh96-kernel"]


@pytest.mark.parametrize("head_dim,impl", PATHS, ids=PATH_IDS)
def test_forward_serve_logits_with_image_match_jax(head_dim, impl):
    """A 10-token prefill carrying the image and two decode steps carrying
    tokens only; the image moves the prefill's logits."""
    jm, jp, tm, tp = _models(head_dim, impl)
    b = _batch(2, 10, step=2)
    jl, jc, _ = jm.forward_serve(jp, _jax(b), jm.init_cache(2, 16), 0)
    tl, tc = tm.forward_serve(tp, _torch(b), tm.init_cache(2, 16), 0)
    assert _rel(tl, jl) <= 1e-4
    text, _ = tm.forward_serve(tp, {"tokens": _torch(b)["tokens"]},
                               tm.init_cache(2, 16), 0)
    assert float((text - tl).abs().max()) > 1e-3
    for t in range(2):
        nxt = b["tokens"][:, t:t + 1]
        jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(nxt)}, jc, 10 + t)
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(nxt).long()}, tc,
                                  10 + t)
        assert tl.shape == jl.shape and _rel(tl, jl) <= 1e-4


@pytest.mark.parametrize("head_dim,impl", PATHS, ids=PATH_IDS)
def test_greedy_stream_with_image_identical_to_jax(head_dim, impl):
    """The classic generate with the image in the prompt batch (the
    prefill takes it, decode steps do not): the reference's stream."""
    jm, jp, tm, tp = _models(head_dim, impl)
    b = _batch(2, 8, step=3)
    js = JS.generate(jm, jp, _jax(b), 6, 14)
    ts = TS.greedy_generate(tm, tp, _torch(b), 6, 14)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_scheduler_text_streams_identical_to_jax(kv_bits):
    """Head_dim 96 on the kernel path: four text requests of mixed lengths
    through 2 slots of the paged pool (8-token pages: kernels 1 and 2 over
    pages, slot reuse) in both schedulers, int8 and 4-bit KV, as the
    reference's Scheduler serves this arch (token lists only); every page
    back at the end."""
    assert TS.scheduler_supported(get_config(ARCH))
    jm, jp, tm, tp = _models(96, "kernel")
    full = TD.lm_batch(4, 4, 20, V)
    trace = [(full[i, :n].tolist(), b) for i, (n, b) in
             enumerate(zip((5, 20, 9, 14), (6, 4, 7, 5)))]
    kw = dict(max_batch_slots=2, max_len=32, page_size=8, decode_chunk=4,
              kv_bits=kv_bits)
    js = JS.Scheduler(jm, jp, **kw)
    jr = [js.submit(p, b) for p, b in trace]
    jres = js.run()
    sched = TS.Scheduler(tm, tp, **kw)
    tr = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        sched.audit()
    assert [res[r] for r in tr] == [jres[r] for r in jr]
    assert len(sched.free_pages) == sched.num_pages - 1
    assert sched.cache["blocks"][0].k_q.shape[-1] == 96 * kv_bits // 8


@pytest.mark.parametrize("extra", [[], ["--attn-impl", "kernel", "--continuous-batching",
                                        "--page-size", "8"]],
                         ids=["classic", "paged-kernel"])
def test_serve_cli_runs_on_cpu(extra):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "3", "--device", "cpu"] + extra)
    assert tuple(out.shape) == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < V


# ---------------------------------------------------------------------------
# kernels 1 and 2 at head_dim 96
# ---------------------------------------------------------------------------
def _setup(seed, B, Sq, max_len, kv_len, H, Hkv, Dh, kv_bits=8):
    r = np.random.RandomState(seed)
    q = (r.randn(B, Sq, H, Dh) * 0.5).astype(np.float32)
    k = (r.randn(B, kv_len, Hkv, Dh) * 0.5).astype(np.float32)
    v = (r.randn(B, kv_len, Hkv, Dh) * 0.5).astype(np.float32)
    tc = TA.cache_write(TA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits),
                        torch.from_numpy(k), torch.from_numpy(v), 0, TPim())
    jc = JA.cache_write(JA.init_kv_cache(B, max_len, Hkv, Dh, kv_bits=kv_bits),
                        jnp.asarray(k), jnp.asarray(v), 0, JPim())
    return (jc, JO.kernel_attention_layout(jnp.asarray(q), jc), tc,
            TO.kernel_attention_layout(torch.from_numpy(q), tc))


@pytest.mark.parametrize("heads,window,kv_bits", [((2, 2), 0, 8), ((4, 1), 20, 8),
                                                  ((2, 2), 0, 4)],
                         ids=["qpk1", "qpk4-window", "qpk1-kv4"])
def test_head_dim_96_plain_versions_match_pallas(heads, window, kv_bits):
    """Kernel 1 (Sq 24 over a 40-token cache at offset 16) and kernel 2
    (verify rows Sq 3 at kv_len 40) at head_dim 96, 4-bit KV stored in 48
    bytes a row."""
    H, Hkv = heads
    jc, jl, tc, tl = _setup(H + window + kv_bits, 1, 24, 48, 40, H, Hkv, 96, kv_bits)
    assert tl[2].shape[-1] == 96 * kv_bits // 8
    kw = dict(window=window, block_q=16, block_k=16, return_iters=True)
    oj, ij = pim_attention_pallas(*jl, jnp.asarray(16, jnp.int32), jc.length,
                                  interpret=True, **kw)
    ot, it = pim_attention(*tl, 16, tc.length, **kw)
    assert _rel(ot, oj) <= REL
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    jc, jl, tc, tl = _setup(7 + H, 1, 3, 48, 40, H, Hkv, 96, kv_bits)
    kw = dict(window=window, block_k=16, return_iters=True)
    oj, ij = pim_decode_pallas(*jl, jnp.asarray(37, jnp.int32), jc.length,
                               interpret=True, **kw)
    ot, it = pim_decode(*tl, 37, tc.length, **kw)
    assert _rel(ot, oj) <= REL
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("args,want", [
    # (dh, dhk, block_q, q_per_kv, block_k) -> (rows, heads_per_cta, splits)
    ((96, 96, 32, 1, 256), (32, 1, 1)),      # phi-3's prefill
    ((96, 96, 16, 1, 256), (16, 1, 1)),      # a prompt of 16 or fewer
    ((96, 96, 32, 2, 256), (64, 2, 1)),
    ((96, 96, 32, 4, 16), (64, 2, 2)),       # 128 rows x 96 pass 32 accumulators
    ((96, 48, 32, 1, 16), (32, 1, 1)),       # 4-bit pages
], ids=["R32", "R16", "R64", "R64-split", "R32-kv4-paged"])
def test_head_dim_96_prefill_launch_plans(args, want):
    p = attn_k.launch_plan(*args)
    assert (p.rows, p.heads_per_cta, p.splits) == want
    assert p.rows * 96 <= attn_k.MAX_ACC * attn_k.THREADS
    assert p.smem == attn_k.smem_bytes(p.rows, 96, args[4]) <= attn_k.MAX_SMEM


@pytest.mark.parametrize("args,want", [
    # (R, dh, dhk, block_k, n_k, bhkv, paged, sms) -> (rows, dsplit, chunks)
    ((1, 96, 96, 16, 42, 128, False, 132), (2, 1, 3)),   # phi-3's classic decode
    ((1, 96, 96, 256, 2, 32, False, 132), (2, 3, 2)),    # a small int8 grid: slices
    ((4, 96, 96, 2048, 2, 32, False, 132), (4, 3, 2)),   # 32/8 heads, kv_len 4096
    ((1, 96, 48, 256, 2, 32, False, 132), (2, 1, 2)),    # 4-bit: no slices
    ((5, 96, 96, 256, 16, 128, False, 132), (8, 1, 3)),  # verify rows Sq 5
    ((1, 96, 96, 16, 256, 128, True, 132), (2, 1, 3)),   # the paged pool
], ids=["classic", "dsplit3", "dsplit3-qpk4", "kv4", "verify", "paged"])
def test_head_dim_96_decode_launch_plans(args, want):
    p = dec_k.launch_plan(*args)
    assert (p.rows, p.dsplit, p.chunks) == want
    assert p.smem <= attn_k.MAX_SMEM
    # a record of RT * (Dh / dsplit + 2) floats: whole 16-byte copies
    assert dec_k.rec_bytes(p.rows, 96 // p.dsplit) % 16 == 0
