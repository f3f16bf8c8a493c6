"""gemma-7b served by the port against the JAX package on the CPU, the
reference's GELU, and kernels 1 and 2 at head_dim 256.

SMOKE gemma-7b: 3 layers, d_model 96, 2/2 heads of 48, GeGLU d_ff 192,
vocab 512, tied embeddings.  Parameters come from the reference's seeded
`init` through `from_jax_params`, at the ideal ADC, on one torch thread.
Head_dim 48 is not a head dim of the card's kernels (32, 64, 96, 128, 256),
so the kernel path runs at head_dim 64 on both sides; the behavioral path
runs the published 48.  Bounds:
  * GELU: bf16 equal to `jax.nn.gelu` bit for bit on 200,000 inputs
    (RandomState(0).randn * 3); float32 within 1e-6 (XLA's tanh against
    torch's);
  * one bf16 gemma block equal to JAX's eager block bit for bit;
  * float32 logits within rel 1e-4, greedy streams identical, classic and
    through the paged Scheduler;
  * the plain versions of kernels 1 and 2 at head_dim 256 (q_per_kv 1 and
    16, windowed, 4-bit, verify rows) within rel 1e-5 of the Pallas
    kernels in interpret mode, iteration maps equal; the CUDA kernels are
    held to them by the `gpu` test here and by `chip_smoke.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import PIMConfig as JPim
from repro.core import attention as JA
from repro.kernels import ops as JO
from repro.kernels.pim_attention import pim_attention_pallas
from repro.kernels.pim_decode import pim_decode_pallas
from repro.models import blocks as JB
from repro.models.model_zoo import build_model as jax_build
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import PIMConfig as TPim
from repro_torch.core import attention as TA
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import pim_attention as attn_k
from repro_torch.kernels import pim_decode as dec_k
from repro_torch.kernels.pim_attention import pim_attention, pim_attention_plain
from repro_torch.kernels.pim_decode import pim_decode, pim_decode_plain
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS

ARCH = "gemma-7b"
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend (and torch's first multi-thread
    float32 tanh of a process can round unlike its later calls)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(**kw):
    kw = dict(compute_dtype="float32", **kw)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jp, build_model(tcfg, "cpu"), from_jax_params(jp, tcfg, "cpu")


@pytest.fixture(scope="module")
def behavioral():
    return _models(attn_impl="behavioral")


@pytest.fixture(scope="module")
def kernel():
    return _models(attn_impl="kernel", head_dim=64)


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


# ---------------------------------------------------------------------------
# the reference's GELU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_matches_jax(dtype):
    x = (np.random.RandomState(0).randn(200_000) * 3).astype(np.float32)
    j = np.asarray(jax.nn.gelu(jnp.asarray(x, dtype)).astype(jnp.float32))
    t = TL.gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(t, j)
    else:
        assert np.abs(t - j).max() <= 1e-6


def test_bf16_block_bit_identical_to_jax_eager(behavioral):
    """One gemma block (GeGLU through the GELU above) in bf16 on the
    behavioral path, prefill from 0 at the published head_dim 48."""
    jm, jp, tm, _ = behavioral
    jcfg = dataclasses.replace(jm.cfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tm.cfg, compute_dtype="bfloat16")
    blk = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    tblk = TT._index(from_jax_params(jp, tcfg, "cpu")["blocks"][0], 0)
    x = np.random.RandomState(1).randn(2, 8, 96).astype(np.float32)
    jo, _ = JB.attn_block_fwd_serve(blk, jnp.asarray(x, jnp.bfloat16),
                                    JA.init_kv_cache(2, 12, 2, 48), 0, jcfg)
    to = TB.attn_block_fwd_serve(tblk, torch.from_numpy(x).bfloat16(),
                                 TA.init_kv_cache(2, 12, 2, 48), 0, tcfg)
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# gemma-7b served
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["behavioral", "kernel"])
def test_forward_serve_logits_match_jax(path, request):
    """A prefill of 10 tokens and two decode steps; tied embeddings
    (`embed` is the head)."""
    jm, jp, tm, tp = request.getfixturevalue(path)
    assert "unembed" not in tp
    toks = np.random.RandomState(2).randint(0, 512, (2, 10)).astype(np.int32)
    jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 16), 0)
    tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks).long()},
                              tm.init_cache(2, 16), 0)
    assert _rel(tl, jl) <= 1e-4
    for t in range(2):
        nxt = toks[:, t:t + 1]
        jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(nxt)}, jc, 10 + t)
        tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(nxt).long()}, tc,
                                  10 + t)
        assert tl.shape == jl.shape and _rel(tl, jl) <= 1e-4


def test_greedy_generate_stream_identical_to_jax(kernel):
    jm, jp, tm, tp = kernel
    toks = TD.lm_batch(3, 2, 8, 512)
    js = JS.generate(jm, jp, {"tokens": jnp.asarray(toks)}, 8, 16)
    ts = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks)}, 8, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_paged_scheduler_streams_identical_to_jax(behavioral):
    """Four requests of mixed lengths through 2 slots of the paged pool
    (slot reuse), in both schedulers; every page back at the end."""
    jm, jp, tm, tp = behavioral
    full = TD.lm_batch(4, 4, 20, 512)
    trace = [(full[i, :n].tolist(), b) for i, (n, b) in
             enumerate(zip((5, 20, 9, 14), (6, 4, 7, 5)))]
    kw = dict(max_batch_slots=2, max_len=32, page_size=8, decode_chunk=4)
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


def test_serve_cli_runs_on_cpu():
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3", "--device", "cpu"])
    assert tuple(out.shape) == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < 512


# ---------------------------------------------------------------------------
# kernels 1 and 2 at head_dim 256
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


@pytest.mark.parametrize("heads,window,kv_bits", [((2, 2), 0, 8), ((16, 1), 20, 8),
                                                  ((2, 2), 0, 4)],
                         ids=["qpk1", "qpk16-window", "qpk1-kv4"])
def test_head_dim_256_plain_versions_match_pallas(heads, window, kv_bits):
    """Kernel 1 (Sq 24 over a 40-token cache at offset 16) and kernel 2
    (verify rows Sq 3 at kv_len 40) at head_dim 256."""
    H, Hkv = heads
    jc, jl, tc, tl = _setup(H + window + kv_bits, 1, 24, 48, 40, H, Hkv, 256, kv_bits)
    kw = dict(window=window, block_q=16, block_k=16, return_iters=True)
    oj, ij = pim_attention_pallas(*jl, jnp.asarray(16, jnp.int32), jc.length,
                                  interpret=True, **kw)
    ot, it = pim_attention(*tl, 16, tc.length, **kw)
    assert _rel(ot, oj) <= REL
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    jc, jl, tc, tl = _setup(7 + H, 1, 3, 48, 40, H, Hkv, 256, kv_bits)
    kw = dict(window=window, block_k=16, return_iters=True)
    oj, ij = pim_decode_pallas(*jl, jnp.asarray(37, jnp.int32), jc.length,
                               interpret=True, **kw)
    ot, it = pim_decode(*tl, 37, tc.length, **kw)
    assert _rel(ot, oj) <= REL
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_head_dim_256_launch_plans():
    """Kernel 1 at head_dim 256 holds 32 MMA rows (one head's q block of
    32, so a group of 16 q heads takes 16 CTAs) in 146,064 bytes of shared
    memory; kernel 2's 8-row tiles take 185,488 bytes over the whole head
    dim, and a small grid is cut into 8 slices of 32 head dims."""
    p = attn_k.launch_plan(256, 256, 32, 16, 256)
    assert (p.rows, p.heads_per_cta, p.splits, p.smem) == (32, 1, 16, 146_064)
    assert attn_k.launch_plan(256, 128, 32, 1, 16).rows == 32
    assert dec_k.smem_bytes(8, 256, 1, 256, 0) == 185_488 <= attn_k.MAX_SMEM
    big = dec_k.launch_plan(80, 256, 256, 16, 128, 2, True, 132)
    assert (big.rows, big.row_tiles, big.dsplit) == (8, 10, 1)
    small = dec_k.launch_plan(1, 256, 256, 16, 2, 4, False, 132)
    assert small.dsplit == 8
    with pytest.raises(ValueError):
        attn_k.launch_plan(48, 48, 32, 1, 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(16, 16), (16, 1)], ids=["qpk1", "qpk16"])
def test_cuda_head_dim_256(cuda_device, heads):
    """On the card at head_dim 256: kernel 1 causal and windowed, kernel 2
    with and without a window and at 4 bits, against the plain versions;
    verify rows (Sq 5) bit-identical to single steps; a paged prefill and
    decode over 16-token pages bit-identical to dense at block_k 16."""
    H, Hkv = heads
    dev = cuda_device
    _, _, tc, tl = _setup(31, 2, 64, 300, 300, H, Hkv, 256)
    tl = [t.to(dev) for t in tl]
    for fn, plain, kw in [(pim_attention, pim_attention_plain, {}),
                          (pim_attention, pim_attention_plain, dict(window=100)),
                          (pim_decode, pim_decode_plain, dict(block_k=16)),
                          (pim_decode, pim_decode_plain, dict(block_k=64, window=50))]:
        o_k, it_k = fn(*tl, 236, 300, return_iters=True, **kw)
        o_p, it_p = plain(*tl, 236, 300, return_iters=True, **kw)
        assert float((o_k - o_p).abs().max()) <= REL * float(o_p.abs().max())
        assert torch.equal(it_k, it_p)
    for kv_bits in (8, 4):
        _, _, tc, tl = _setup(32 + kv_bits, 2, 5, 300, 300, H, Hkv, 256, kv_bits)
        tc = TA.KVCache(*[getattr(tc, f).to(dev) for f in
                          ("k_q", "v_q", "k_scale", "v_scale")], length=300)
        q = torch.from_numpy((np.random.RandomState(5).randn(2, 5, H, 256) * 0.5
                              ).astype(np.float32)).to(dev)
        o_v = TO.pim_flash_attention(q, tc, 295, out_dtype=torch.float32,
                                     decode_block_k=16, force_decode_kernel=True)
        for l in range(5):
            o_1 = TO.pim_flash_attention(q[:, l:l + 1], tc, 295 + l,
                                         out_dtype=torch.float32, decode_block_k=16)
            assert torch.equal(o_v[:, l], o_1[:, 0])
    lens = torch.tensor([300, 47], dtype=torch.int32, device=dev)
    q = torch.from_numpy((np.random.RandomState(6).randn(2, 32, H, 256) * 0.5
                          ).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy((np.random.RandomState(s).randn(2, 304, Hkv, 256) * 0.5
                              ).astype(np.float32)).to(dev) for s in (7, 8))
    zeros = torch.zeros(2, dtype=torch.int32, device=dev)
    dense = TA.init_kv_cache(2, 304, Hkv, 256, device=dev, ragged=True)
    TA.cache_write_ragged(dense, k, v, zeros, TPim(), seq_lens=lens)
    pt = torch.arange(1, 39, dtype=torch.int32, device=dev).view(2, 19)
    pool = TA.init_paged_kv_cache(39, 16, Hkv, 256, device=dev)
    TA.paged_cache_write(pool, k, v, zeros, TPim(), pt, seq_lens=lens)
    offs = lens - 32
    o_p = TO.pim_paged_flash_attention(q, pool, pt, lens, offs, out_dtype=torch.float32)
    o_d = pim_attention(*TO.kernel_attention_layout(q, dense), offs, lens, block_k=16)
    assert torch.equal(o_p, o_d.reshape(2, H, 32, 256).transpose(1, 2))


# sha256 (first 16 hex digits) of each earlier arch's SMOKE `init(seed=0)`
# leaves, bytes, shapes and strides, in bf16 and float32 compute, as the
# port drew them before the Griffin blocks joined `init` (the Griffin archs
# and phi-3-vision-4.2b as the port drew them once its `img_proj` joined)
_EARLIER_INITS = {
    ("internlm2-1.8b", "bfloat16"): "337e97c6aba2aa35",
    ("internlm2-1.8b", "float32"): "10ef9f9792203e11",
    ("deepseek-moe-16b", "bfloat16"): "a0ec287e38a5c315",
    ("deepseek-moe-16b", "float32"): "7eb10318e058e788",
    ("dbrx-132b", "bfloat16"): "9726996224d22c3c",
    ("dbrx-132b", "float32"): "87e54c7b36e958f5",
    ("qwen2-72b", "bfloat16"): "20962289157e0ebe",
    ("qwen2-72b", "float32"): "d5c6042a0f2fd8f5",
    ("gemma-7b", "bfloat16"): "92dc50a31f29dcba",
    ("gemma-7b", "float32"): "293b725ec306875c",
    ("recurrentgemma-9b", "bfloat16"): "2e3b0bbc1718cde8",
    ("recurrentgemma-9b", "float32"): "4e323de1aff5b8bd",
    ("phi-3-vision-4.2b", "bfloat16"): "a3b3c9d8161bc88c",
    ("phi-3-vision-4.2b", "float32"): "21970df66da4ed82",
}


@pytest.mark.parametrize("arch,dtype", sorted(_EARLIER_INITS))
def test_earlier_archs_draw_the_same_seed_0_weights(arch, dtype):
    """Adding block kinds and deploying each linear as it is drawn keeps
    every earlier arch's seed-0 weights leaf for leaf (the chip phases'
    streams depend on them)."""
    import hashlib

    from repro_torch.checkpoint.checkpoint import flatten

    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dtype)
    h = hashlib.sha256()
    for t in flatten(build_model(cfg, "cpu").init(seed=0)):
        if isinstance(t, torch.Tensor):
            c = t.contiguous()
            h.update((c.view(torch.int16) if c.dtype == torch.bfloat16 else c)
                     .view(torch.uint8).numpy().tobytes())
            h.update(str(tuple(t.shape)).encode())
            h.update(str(t.stride()).encode())
    assert h.hexdigest()[:16] == _EARLIER_INITS[(arch, dtype)]
