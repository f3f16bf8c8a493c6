"""The port's serving path against the JAX package, on the SMOKE config of
internlm2-1.8b (4 layers, d_model 128, 4/2 heads, head_dim 32, vocab 256).

Parameters come from the JAX package's `init` (seeded) and reach the port
through `from_jax_params`.  Bounds:
  * float32 compute: logits within rel 1e-4 of JAX (measured ~5e-7), and
    greedy streams identical;
  * bfloat16 compute: one block is bit-identical to the JAX block run
    eagerly; the whole jitted JAX model differs by up to ~6% of the logit
    range because XLA's fusion drops intermediate bf16 roundings, so the
    bound there is rel 0.1.
Also: the package imports neither JAX nor the JAX package, and entry points
without a device raise instead of running on the CPU.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import pipeline as JD
from repro.models import blocks as JB
from repro.models.model_zoo import build_model as jax_build, deploy_tree
from repro.core import attention as JA
from repro.runtime import serve_lib as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import attention as TA
from repro_torch.data import pipeline as TD
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import serve_lib as TS
from repro_torch.runtime import train_lib as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-1.8b"


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
    params = jax_build(jax_config(ARCH, smoke=True)).init(jax.random.PRNGKey(0))
    return jax.device_get(params)


def _cfgs(**kw):
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _tokens(B=2, S=8, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)


def _rel(t, j):
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(jnp.asarray(j, jnp.float32), np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def _prefill_and_step(jcfg, tcfg, jp, tp, toks):
    """Logits of a prefill and of one decode step, through both packages."""
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    B, S = toks.shape
    jl, jc, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(B, S + 4), 0)
    jl2, _, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(toks[:, :1])}, jc, S)
    tl, tc = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks).long()},
                              tm.init_cache(B, S + 4), 0)
    tl2, _ = tm.forward_serve(tp, {"tokens": torch.from_numpy(toks[:, :1]).long()},
                              tc, S)
    return (jl, tl), (jl2, tl2)


@pytest.mark.parametrize("impl", ["kernel", "behavioral"])
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_forward_serve_logits_match_jax(jax_params, impl, dtype, bound):
    jcfg, tcfg = _cfgs(attn_impl=impl, compute_dtype=dtype)
    tp = from_jax_params(jax_params, tcfg, "cpu")
    for j, t in _prefill_and_step(jcfg, tcfg, jax_params, tp, _tokens()):
        assert t.shape == j.shape
        assert _rel(t, j) <= bound


def test_bf16_block_bit_identical_to_jax_eager(jax_params):
    """The behavioral path; the kernel path's bf16 operands are held bit for
    bit by test_torch_core.py::test_kernel_layout_bit_exact."""
    jcfg, tcfg = _cfgs(attn_impl="behavioral")
    blk = jax.tree.map(lambda a: a[0], jax_params["blocks"][0])
    tblk = TT._index(from_jax_params(jax_params, tcfg, "cpu")["blocks"][0], 0)
    x = np.random.RandomState(1).randn(2, 8, 128).astype(np.float32)
    jo, _ = JB.attn_block_fwd_serve(blk, jnp.asarray(x, jnp.bfloat16),
                                    JA.init_kv_cache(2, 12, 2, 32), 0, jcfg)
    to = TB.attn_block_fwd_serve(tblk, torch.from_numpy(x).bfloat16(),
                                 TA.init_kv_cache(2, 12, 2, 32), 0, tcfg)
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo.astype(jnp.float32)))


def test_kv4_forward_matches_jax(jax_params):
    jcfg, tcfg = _cfgs(attn_impl="kernel", compute_dtype="float32", kv_bits=4)
    tp = from_jax_params(jax_params, tcfg, "cpu")
    for j, t in _prefill_and_step(jcfg, tcfg, jax_params, tp, _tokens(seed=2)):
        assert _rel(t, j) <= 1e-4


def test_deployed_jax_tree_is_taken_as_is(jax_params):
    """A deployed tree's int8 weights and scales reach the port unchanged."""
    jcfg, tcfg = _cfgs(attn_impl="kernel", compute_dtype="float32")
    dep = jax.device_get(deploy_tree(jax_params, jcfg))
    tp = from_jax_params(dep, tcfg, "cpu")
    wq = dep["blocks"][0]["attn"]["wq"]
    np.testing.assert_array_equal(tp["blocks"][0]["attn"]["wq"]["w_q"].numpy(),
                                  np.asarray(wq["w_q"]))
    for j, t in _prefill_and_step(jcfg, tcfg, dep, tp, _tokens(seed=3)):
        assert _rel(t, j) <= 1e-4


def test_greedy_generate_stream_identical_to_jax(jax_params):
    jcfg, tcfg = _cfgs(attn_impl="kernel", compute_dtype="float32")
    toks = _tokens(seed=4)
    js = JS.generate(jax_build(jcfg), jax_params, {"tokens": jnp.asarray(toks)}, 8, 16)
    tm = build_model(tcfg, "cpu")
    ts = TS.greedy_generate(tm, from_jax_params(jax_params, tcfg, "cpu"),
                            {"tokens": torch.from_numpy(toks)}, 8, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_lm_batch_identical_to_jax():
    np.testing.assert_array_equal(TD.lm_batch(3, 4, 16, 92544, seed=1),
                                  JD.lm_batch(3, 4, 16, 92544, seed=1))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.6), (7, 0.3)])
def test_truncate_logits_matches_jax(top_k, top_p):
    l = np.random.RandomState(5).randn(3, 40).astype(np.float32)
    j = np.isfinite(np.asarray(JS._truncate_logits(jnp.asarray(l), top_k, top_p)))
    t = torch.isfinite(TS._truncate_logits(torch.from_numpy(l), top_k, top_p))
    np.testing.assert_array_equal(t.numpy(), j)


def test_sampling_stays_inside_the_truncated_set():
    l = torch.from_numpy(np.random.RandomState(6).randn(64, 50).astype(np.float32))
    ids = TS.sample_logits(l, TS.prng.PRNGKey(0), temperature=0.8, top_k=3)
    top3 = torch.topk(l, 3, dim=-1).indices
    assert bool((top3 == ids[:, None]).any(dim=-1).all())
    assert torch.equal(TS.sample_logits(l, None), torch.argmax(l, dim=-1))


def test_serve_cli_runs_on_cpu():
    out = tserve.main(["--arch", ARCH, "--smoke", "--attn-impl", "kernel",
                       "--batch", "2", "--prompt-len", "8", "--new-tokens", "3",
                       "--device", "cpu"])
    assert tuple(out.shape) == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < 256


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of the port, and what chip_smoke.py imports, load
    without JAX or the JAX package."""
    code = (
        "import pkgutil, importlib, sys, runpy\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"runpy.run_path({os.path.join(ROOT, 'chip_smoke.py')!r}, run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('launch.serve', 'launch.train', 'optim.adamw', 'runtime.train_lib'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_without_a_device_raise(monkeypatch, jax_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(jax_params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", ARCH, "--smoke"])


def test_unported_features_raise():
    """What the port does not serve raises: an unknown block kind, and a
    sliding window on the paged or ragged path (the reference has none
    there either).  Windows on the classic path and every arch of the zoo
    are served (tests/test_torch_griffin.py, tests/test_torch_gemma.py,
    tests/test_torch_whisper.py, tests/test_torch_xlstm.py).  What the port
    does not train raises too: a recurrent arch (RG-LRU, mLSTM / sLSTM:
    item 8; MoE, encoder-decoder and image-patch archs train,
    tests/test_torch_train_zoo.py), a mesh or int8 gradient compression
    (item 9)."""
    cfg = get_config(ARCH, smoke=True)
    toks = {"tokens": torch.zeros(2, 4, dtype=torch.long)}
    for arch in ("recurrentgemma-9b", "xlstm-1.3b"):
        tm = build_model(get_config(arch, smoke=True), "cpu")
        with pytest.raises(NotImplementedError, match="item 8"):
            tm.loss({}, toks)
        with pytest.raises(NotImplementedError, match="item 8"):
            tm.forward_train({}, toks)
    tm = build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        TL.make_train_step(tm, TrainConfig(), mesh="data")
    with pytest.raises(NotImplementedError, match="item 9"):
        TL.make_train_step(tm, TrainConfig(grad_compression="int8_ef"))
    with pytest.raises(NotImplementedError, match="item 9"):
        TL.init_opt_state({}, TrainConfig(grad_compression="int8_ef"))
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, block_pattern=("attn", "mamba")), "cpu")
    local = dataclasses.replace(cfg, window=16, block_pattern=("attn_local",))
    model = build_model(local, "cpu")
    with pytest.raises(NotImplementedError):
        model.init_cache(2, 32, page_size=8, num_pages=9)
    params = model.init(seed=0)
    cache = model.init_cache(2, 32, ragged=True)
    with pytest.raises(NotImplementedError):
        model.forward_serve(params, {"tokens": torch.zeros(2, 4, dtype=torch.long)},
                            cache, torch.zeros(2, dtype=torch.int32),
                            seq_lens=torch.full((2,), 4, dtype=torch.int32))
