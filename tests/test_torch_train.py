"""The port's training path against the JAX package on the CPU.

SMOKE internlm2-1.8b (4 layers, d_model 128, 4/2 heads of 32, SwiGLU
d_ff 256, vocab 256) and one qwen2-72b SMOKE block (QKV biases), inputs
and extra weights from numpy seeds, the JAX package's `init` reaching the
port through `from_jax_params(deploy=False)`, on one torch thread.
Bounds:
  * the STE linear (`core/pim.py::_PIMLinearSTE`) against `jax.vjp` of the
    reference's `pim_linear_apply`, eager, in both ADC modes with and
    without a bias: the forward bit for bit in float32 and bf16; float32
    dx, dw and db within rel 1e-6; bf16 gradients within rel 2e-2 (the
    bias's is a bf16 sum over rows, which the two reduce in other orders);
  * `attn_block_fwd_train`'s output and every parameter's gradient in
    float32 against the reference's (jitted vjp): rel 1e-5;
  * `Model.loss` and every leaf's gradient in float32 at B 2, S 16 against
    the reference's jitted `value_and_grad`: the loss within rel 1e-5 and
    each leaf's max error within 1e-4 of that leaf's max |g| at the
    quantized ADC (both remat settings) and with the PIM linears off; at
    the ideal ADC 5e-4 and 5e-2.  There the two forwards part by float32
    ulps (XLA's CPU sums and rsqrt against torch's), and an ulp at a
    rounding boundary flips an int8 activation code of a PIM linear (one
    code at layer 1 on this batch, 219 by the last linear): the
    reference's own jitted and eager runs part by 1.2e-4 in the loss and
    1.1e-2 in a leaf; the port is 1.5e-4 and 1.6e-2 from the jitted one.
    gemma-7b SMOKE (tied embeddings: the table's gradient from the gather
    and the CE head; GeGLU; head_dim 48) at the quantized ADC is held at
    1e-5 and 1e-4 against the reference's eager run: its jitted run parts
    from that by 3.3e-5 and 9.1e-3 (flipped codes again), the port from
    the eager run by 2.3e-7 and 9.8e-7;
  * remat changes no value: the port's loss and gradients with and
    without per-block recompute bit for bit;
  * `chunked_ce_from_hidden` on its chunked branch (S 1,025: two chunks
    of 512) and its one-product branch (S 1,000 and 17): value and the
    gradients of hidden and head table within rel 1e-5;
  * AdamW (`init`, `lr_schedule`, `clip_by_global_norm`, `update`) on a
    random tree of dicts and tuples: within rel 1e-6;
  * three `make_train_step` steps in float32 against the reference's
    jitted step, from the same params and batches at lr 1e-3.  AdamW's
    first updates are about lr x sign(g), so a gradient element within
    roundings of 0 moves a parameter by up to lr in one package and not in
    the other: with plain linears the port runs on from its own state,
    the losses within rel 1e-6 and every parameter within 1e-4 after
    three steps (measured 3.1e-5: one such element).  At the quantized ADC
    each step starts from the reference's state.  The first step's loss
    is bit for bit, the grad norm within rel 1e-5 and AdamW's m and v
    within 1e-5 of each leaf's max (measured 1.2e-6), and a parameter may
    part from the reference's by more than 1e-6 only where its m is within
    1e-4 of its leaf's max (the leaf test's bound; measured 1.4e-5), by at
    most lr, at no more than 1e-3 of the elements (measured 32 of
    656,512).  Once the weights have moved, the roundings flip codes as at
    the ideal ADC above, so steps 2 and 3 are held at that case's bounds:
    loss and grad norm within rel 5e-4, m and v within 5e-2 of each leaf's
    max (measured 3.8e-6, 7.2e-5, 9.7e-3 and 4.4e-3 at step 2);
  * microbatching (4 x 2 rows against 8) and a falling Markov loss, as the
    reference's `tests/test_runtime.py` holds them;
  * `run_restartable` with a crash at step 7 of 10 (a checkpoint every 2
    steps) equal to an uninterrupted run bit for bit, on the reference's
    toy state and on a SMOKE train state; a train state round trip (0-d
    int32 step included) and a JAX-written train checkpoint read into the
    port leaf for leaf; the CLI and its refusals.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import pim as JP
from repro.models import blocks as JB
from repro.models import model_zoo as JZ
from repro.optim import adamw as JADAM
from repro.runtime import train_lib as JT
from repro_torch.checkpoint import checkpoint as TC
from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import pim as TP
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as TB
from repro_torch.models import model_zoo as TZ
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.optim import adamw as TADAM
from repro_torch.runtime import fault as TF
from repro_torch.runtime import train_lib as TT

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
    params = JZ.build_model(jax_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0))
    return jax.device_get(params)


def _cfgs(arch=ARCH, adc="ideal", **kw):
    j, t = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    return tuple(dataclasses.replace(c, pim=dataclasses.replace(c.pim, adc_mode=adc),
                                     **kw) for c in (j, t))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(t, j) -> float:
    t, j = _np(t).astype(np.float64), _np(j).astype(np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _leaf_errors(jtree, ttree) -> list:
    jl, tl = jax.tree.leaves(jtree), flatten(ttree)
    assert len(jl) == len(tl)
    return [_rel(t, j) for j, t in zip(jl, tl)]


def _to_torch(tree):
    return unflatten(tree, [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(tree)])


# ---------------------------------------------------------------------------
# the STE linear
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("adc", ["ideal", "quantized"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ste_linear_matches_jax_vjp(dtype, adc, bias):
    pc = dataclasses.replace(get_config(ARCH, smoke=True).pim, adc_mode=adc)
    jpc = dataclasses.replace(jax_config(ARCH, smoke=True).pim, adc_mode=adc)
    r = np.random.RandomState(3)
    x = r.randn(2, 5, 72).astype(np.float32)
    p = {"w": (r.randn(72, 40) * 0.1).astype(np.float32)}
    if bias:
        p["b"] = (r.randn(40) * 0.1).astype(np.float32)
    g = r.randn(2, 5, 40).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda x, p: JP.pim_linear_apply(p, x, jpc),
                     jnp.asarray(x, jd), jax.tree.map(jnp.asarray, p))
    dx, dp = vjp(jnp.asarray(g, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    yt = TP.pim_linear_apply(pt, xt, pc)
    yt.backward(torch.from_numpy(g).to(td))
    assert yt.dtype == td and xt.grad.dtype == td
    assert all(pt[k].grad.dtype == torch.float32 for k in pt)
    np.testing.assert_array_equal(_np(yt), _np(y))
    bound = 1e-6 if dtype == "float32" else 2e-2
    assert _rel(xt.grad, dx) <= bound
    for k in p:
        assert _rel(pt[k].grad, dp[k]) <= bound, k


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------
def _block_params(cfg, seed: int) -> dict:
    """An attention block's fp tree from numpy draws: N(0, 1/d_in) linears,
    nonzero biases where the config has them, norm scales near 1."""
    r = np.random.RandomState(seed)
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff

    def lin(d_in, d_out, bias=False):
        p = {"w": (r.randn(d_in, d_out) / d_in ** 0.5).astype(np.float32)}
        if bias:
            p["b"] = (r.randn(d_out) * 0.1).astype(np.float32)
        return p

    def norm():
        return {"scale": (1 + 0.1 * r.randn(d)).astype(np.float32)}

    b = cfg.qkv_bias
    return {"norm1": norm(), "norm2": norm(),
            "attn": {"wq": lin(d, cfg.num_heads * dh, b),
                     "wk": lin(d, cfg.num_kv_heads * dh, b),
                     "wv": lin(d, cfg.num_kv_heads * dh, b),
                     "wo": lin(cfg.num_heads * dh, d)},
            "mlp": {"w_gate": lin(d, f), "w_in": lin(d, f), "w_out": lin(f, d)}}


@pytest.mark.parametrize("arch", [ARCH, "qwen2-72b"])
def test_attn_block_train_matches_jax(arch):
    jc, tc = _cfgs(arch, compute_dtype="float32")
    p = _block_params(jc, seed=4)
    r = np.random.RandomState(5)
    x = r.randn(2, 12, jc.d_model).astype(np.float32)
    g = r.randn(2, 12, jc.d_model).astype(np.float32)
    pos = np.arange(12)

    @jax.jit
    def ref(p, x, g):
        (y, aux), vjp = jax.vjp(
            lambda p, x: JB.attn_block_fwd_train(p, x, pos, jc), p, x)
        return y, aux, vjp((g, jnp.float32(0.0)))

    y, aux, (dp, dx) = ref(p, jnp.asarray(x), jnp.asarray(g))
    pt = _to_torch(p)
    for t in flatten(pt):
        t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = TB.attn_block_fwd_train(pt, xt, torch.arange(12), tc)
    yt.backward(torch.from_numpy(g))
    assert float(auxt) == float(aux) == 0.0 and auxt.dtype == torch.float32
    assert _rel(yt, y) <= 1e-5
    assert _rel(xt.grad, dx) <= 1e-5
    errs = _leaf_errors(dp, unflatten(pt, [t.grad for t in flatten(pt)]))
    assert max(errs) <= 1e-5, errs


# ---------------------------------------------------------------------------
# the whole model's loss and gradients
# ---------------------------------------------------------------------------
def _batch(B=2, S=16, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch,adc,remat,linears,loss_bound,leaf_bound", [
    (ARCH, "quantized", "block", True, 1e-5, 1e-4),
    (ARCH, "quantized", "none", True, 1e-5, 1e-4),
    (ARCH, "ideal", "block", False, 1e-5, 1e-4),
    (ARCH, "ideal", "block", True, 5e-4, 5e-2),
    ("gemma-7b", "quantized", "block", True, 1e-5, 1e-4),
])
def test_model_loss_and_grads_match_jax(jax_params, arch, adc, remat, linears,
                                        loss_bound, leaf_bound):
    """internlm2-1.8b against the reference's jitted value_and_grad;
    gemma-7b (tied embeddings, GeGLU, the bf16 GELU's float32 form) against
    its eager run (see the module docstring)."""
    jc, tc = _cfgs(arch, adc=adc, compute_dtype="float32", remat=remat,
                   pim_linears=linears)
    ref = jax.value_and_grad(JZ.build_model(jc).loss, has_aux=True)
    toks = _batch()
    if arch == ARCH:
        (jl, jm), jg = jax.jit(ref)(jax_params, {"tokens": jnp.asarray(toks)})
    else:
        jax_params = jax.device_get(JZ.build_model(jc).init(jax.random.PRNGKey(0)))
        with jax.disable_jit():
            (jl, jm), jg = ref(jax_params, {"tokens": jnp.asarray(toks)})
    model = build_model(tc, "cpu")
    tp = from_jax_params(jax_params, tc, "cpu", deploy=False)
    tg, tl, tm = TT.grad_fn(model)(tp, {"tokens": torch.from_numpy(toks).long()})
    assert set(tm) == set(jm) == {"loss", "ce", "aux"}
    assert abs(float(tl) - float(jl)) <= loss_bound * abs(float(jl))
    errs = _leaf_errors(jg, tg)
    assert len(errs) == 3 - tc.tie_embeddings + 9 and max(errs) <= leaf_bound, errs


def test_remat_changes_no_value(jax_params):
    toks = {"tokens": torch.from_numpy(_batch(seed=2)).long()}
    out = []
    for remat in ("block", "none"):
        _, tc = _cfgs(compute_dtype="float32", remat=remat)
        tp = from_jax_params(jax_params, tc, "cpu", deploy=False)
        out.append(TT.grad_fn(build_model(tc, "cpu"))(tp, toks))
    (ga, la, _), (gb, lb, _) = out
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(flatten(ga), flatten(gb)))


def test_forward_train_and_init_trees(jax_params):
    """forward_train's logits against the reference's in float32;
    init(deploy=False) is the fp tree of init()'s draws, and deploy_tree
    turns it into init()'s serving tree (a MoE arch's:
    tests/test_torch_train_zoo.py)."""
    jc, tc = _cfgs(compute_dtype="float32")
    toks = _batch(B=2, S=8, seed=3)
    jl, jaux = JZ.build_model(jc).forward_train(jax_params, {"tokens": jnp.asarray(toks)})
    model = build_model(tc, "cpu")
    tl, taux = model.forward_train(from_jax_params(jax_params, tc, "cpu", deploy=False),
                                   {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 8, 256) and float(taux) == float(jaux) == 0.0
    assert _rel(tl, jl) <= 1e-4
    fp = model.init(seed=0, deploy=False)
    assert all(t.dtype == torch.float32 for t in flatten(fp))
    assert fp["blocks"][0]["attn"]["wq"]["w"].shape == (4, 128, 128)
    dep, redeployed = model.init(seed=0), TZ.deploy_tree(fp, tc)
    assert TC.describe(redeployed) == TC.describe(dep)
    assert all(torch.equal(a, b) for a, b in zip(flatten(redeployed), flatten(dep)))
    moe = build_model(get_config("deepseek-moe-16b", smoke=True), "cpu").init(deploy=False)
    assert moe["blocks"][0]["moe"]["experts"]["w_in"].shape == (2, 4, 64, 96)


# ---------------------------------------------------------------------------
# the chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1025, 1000, 17])
def test_chunked_ce_matches_jax(S):
    r = np.random.RandomState(S)
    B, D, V = 2, 16, 40
    h = r.randn(B, S, D).astype(np.float32)
    table = (r.randn(V, D) * 0.5).astype(np.float32)
    labels = r.randint(0, V, (B, S)).astype(np.int32)
    jv, (jdh, jdt) = jax.jit(jax.value_and_grad(JZ.chunked_ce_from_hidden,
                                                argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(table), jnp.asarray(labels))
    ht = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tv = TZ.chunked_ce_from_hidden(ht, tt, torch.from_numpy(labels).long())
    tv.backward()
    assert tv.dtype == torch.float32
    assert _rel(tv, jv) <= 1e-5
    assert _rel(ht.grad, jdh) <= 1e-5 and _rel(tt.grad, jdt) <= 1e-5


def test_cross_entropy_mask_matches_jax():
    r = np.random.RandomState(7)
    logits = r.randn(3, 5, 11).astype(np.float32)
    labels = r.randint(0, 11, (3, 5))
    mask = (r.rand(3, 5) > 0.4).astype(np.float32)
    ce = jax.jit(JZ.cross_entropy)
    for m in (None, mask, np.zeros_like(mask)):
        j = ce(jnp.asarray(logits), jnp.asarray(labels),
               None if m is None else jnp.asarray(m))
        t = TZ.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m))
        assert abs(float(t) - float(j)) <= 1e-6 * max(abs(float(j)), 1.0)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _random_tree(seed: int, scale: float = 1.0):
    r = np.random.RandomState(seed)

    def a(*shape):
        return (r.randn(*shape) * scale).astype(np.float32)

    return {"b": (a(3, 4), {"z": a(5), "a": a(2, 2)}), "a": a(6), "c": {"w": a(4, 3)}}


def test_adamw_matches_jax():
    tcfg = dict(learning_rate=3e-3, warmup_steps=3, total_steps=10,
                weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg_ = JTrainConfig(**tcfg), TrainConfig(**tcfg)
    params = _random_tree(0)
    sched = jax.jit(JADAM.lr_schedule, static_argnums=1)
    clip = jax.jit(JADAM.clip_by_global_norm, static_argnums=1)
    upd = jax.jit(JADAM.update, static_argnums=3)
    for s in range(12):
        j = sched(jnp.int32(s), jcfg)
        t = TADAM.lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg_)
        assert t.dtype == torch.float32
        assert abs(float(t) - float(j)) <= 1e-6 * abs(float(j)) + 1e-12
    big = _random_tree(1, scale=3.0)
    jc, jn = clip(big, 1.0)
    tc, tn = TADAM.clip_by_global_norm(_to_torch(big), 1.0)
    assert _rel(tn, jn) <= 1e-6 and max(_leaf_errors(jc, tc)) <= 1e-6
    js, ts = JADAM.init(params), TADAM.init(_to_torch(params))
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert all(not t.any() and t.dtype == torch.float32
               for t in flatten((ts["m"], ts["v"])))
    jp, tp = params, _to_torch(params)
    for s in range(4):
        g = _random_tree(10 + s, scale=0.5 if s % 2 else 3.0)
        jp, js, jmet = upd(g, js, jp, jcfg)
        tp, ts, tmet = TADAM.update(_to_torch(g), ts, tp, tcfg_)
        assert int(ts["step"]) == int(js["step"]) == s + 1
        assert ts["step"].dtype == torch.int32
        for k in ("lr", "grad_norm"):
            assert _rel(tmet[k], jmet[k]) <= 1e-6
        for name, j, t in (("params", jp, tp), ("m", js["m"], ts["m"]),
                           ("v", js["v"], ts["v"])):
            assert max(_leaf_errors(j, t)) <= 1e-6, name


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=100,
                       weight_decay=0.0)
    state = TADAM.init(params)
    for _ in range(100):
        params, state, _ = TADAM.update({"w": 2 * params["w"]}, state, params, tcfg)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule_warmup_and_decay():
    tcfg = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(TADAM.lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg))
           for s in range(101)]
    assert lrs[5] < lrs[10]
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] < 0.15


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _train_state(jp, jo, tc):
    """The JAX train state (params, opt) as the port's, on the CPU."""
    return (from_jax_params(jax.device_get(jp), tc, "cpu", deploy=False),
            {"m": _to_torch(jax.device_get(jo["m"])),
             "v": _to_torch(jax.device_get(jo["v"])),
             "step": torch.tensor(int(jo["step"]), dtype=torch.int32)})


@pytest.mark.parametrize("linears", [False, True])
def test_train_steps_match_jax(jax_params, linears):
    """Three steps, float32, from the same params and batches: with plain
    linears the port runs on from its own state; at the quantized ADC each
    step starts from the reference's state (bounds in the module
    docstring)."""
    jc, tc = _cfgs(adc="quantized", compute_dtype="float32", pim_linears=linears)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jstep = JT.make_train_step(JZ.build_model(jc), JTrainConfig(**kw))
    tstep = TT.make_train_step(build_model(tc, "cpu"), TrainConfig(**kw))
    jp = jax.tree.map(jnp.array, jax_params)
    jo = JT.init_opt_state(jp, JTrainConfig(**kw))
    tp, to = _train_state(jp, jo, tc)
    for s in range(3):
        if linears and s:
            tp, to = _train_state(jp, jo, tc)
        toks = TD.lm_batch(s, 4, 16, 256)
        jp, jo, jmet = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        tp, to, tmet = tstep(tp, to, {"tokens": torch.from_numpy(toks).long()})
        assert _rel(tmet["lr"], jmet["lr"]) <= 1e-6
        assert int(to["step"]) == s + 1 and to["step"].dtype == torch.int32
        for j, t in zip(jax.tree.leaves((jp, jo["m"], jo["v"])),
                        flatten((tp, to["m"], to["v"]))):
            assert t.dtype == torch.float32 and t.shape == j.shape
        if not linears:
            assert _rel(tmet["loss"], jmet["loss"]) <= 1e-6
            continue
        if s:
            # the moved weights' roundings flip codes: the model test's
            # ideal-ADC bounds
            assert _rel(tmet["loss"], jmet["loss"]) <= 5e-4
            assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 5e-4
            for name in ("m", "v"):
                assert max(_leaf_errors(jo[name], to[name])) <= 5e-2, name
            continue
        assert float(tmet["loss"]) == float(jmet["loss"])
        assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-5
        for name in ("m", "v"):
            assert max(_leaf_errors(jo[name], to[name])) <= 1e-5, name
        # AdamW's first update is about lr x sign(g): a parameter may part
        # from the reference's only where its gradient is within the leaf
        # test's bound of 0, and by at most lr
        parted = total = 0
        for j, t, m in zip(jax.tree.leaves(jp), flatten(tp), jax.tree.leaves(jo["m"])):
            d, m = np.abs(t.numpy() - np.asarray(j)), np.abs(np.asarray(m))
            off = d > 1e-6
            assert d.max() <= 1e-3 and not np.any(m[off] > 1e-4 * m.max())
            parted, total = parted + int(off.sum()), total + d.size
        assert parted <= 1e-3 * total, (parted, total)
    if not linears:
        for j, t in zip(jax.tree.leaves(jp), flatten(tp)):
            assert np.abs(t.numpy() - np.asarray(j)).max() <= 1e-4


def test_train_step_with_microbatching_matches_single():
    """The mirror of the reference's test: bf16, ideal ADC, 8 rows as one
    batch and as 4 microbatches of 2."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(seed=0, deploy=False)
    batch = {"tokens": torch.from_numpy(TD.lm_batch(0, 8, 16, cfg.vocab_size)).long()}
    tc1 = TrainConfig(microbatches=1, learning_rate=1e-3)
    tc4 = TrainConfig(microbatches=4, learning_rate=1e-3)
    p1, _, m1 = TT.make_train_step(model, tc1)(params, TT.init_opt_state(params, tc1), batch)
    p4, _, m4 = TT.make_train_step(model, tc4)(params, TT.init_opt_state(params, tc4), batch)
    assert set(m4) == {"loss", "lr", "grad_norm"}
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 2e-3 * float(m1["loss"])
    for a, b in zip(flatten(p1), flatten(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-5)


def test_training_loss_decreases_markov():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(seed=0, deploy=False)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=5, total_steps=50)
    step = TT.make_train_step(model, tcfg)
    opt = TT.init_opt_state(params, tcfg)
    losses = []
    for s in range(50):
        batch = {"tokens": torch.from_numpy(TD.lm_batch(s, 8, 32, cfg.vocab_size)).long()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


# ---------------------------------------------------------------------------
# restarts and checkpoints
# ---------------------------------------------------------------------------
def test_watchdog_flags_straggler():
    t = [0.0]
    events = []
    wd = TF.StepWatchdog(slo_factor=3.0, clock=lambda: t[0],
                         on_straggler=lambda s, dt, med: events.append(s))
    for step in range(10):
        wd.start()
        t[0] += 1.0 if step != 7 else 10.0
        assert wd.stop(step) == (step == 7)
    assert events == [7] and wd.stragglers == 1 and wd.median == 1.0


def _crashing(step_fn, at: int = 7):
    crashed = {"count": 0}

    def step(state, s):
        if s == at and crashed["count"] == 0:
            crashed["count"] += 1
            raise RuntimeError("injected node failure")
        return step_fn(state, s)
    return step, crashed


def _toy():
    def make_state():
        return {"w": torch.zeros(4), "step_sum": torch.zeros(())}

    def step_fn(state, step):
        return {"w": state["w"] + step, "step_sum": state["step_sum"] + 1}, {}
    return make_state, step_fn


def _smoke_train():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10)
    train = TT.make_train_step(model, tcfg)

    def make_state():
        params = model.init(seed=0, deploy=False)
        return {"params": params, "opt": TT.init_opt_state(params, tcfg)}

    def step_fn(state, step):
        toks = torch.from_numpy(TD.lm_batch(step, 2, 8, cfg.vocab_size)).long()
        p, o, m = train(state["params"], state["opt"], {"tokens": toks})
        return {"params": p, "opt": o}, m
    return make_state, step_fn


@pytest.mark.parametrize("state", ["toy", "smoke"])
def test_run_restartable_resumes_after_crash(state):
    make_state, step_fn = {"toy": _toy, "smoke": _smoke_train}[state]()
    crashing, crashed = _crashing(step_fn)
    with tempfile.TemporaryDirectory() as d:
        got, _ = TF.run_restartable(10, make_state, crashing, d, checkpoint_every=2)
        assert TC.list_generations(d) == [5, 7, 9]
    ref = make_state()
    for s in range(10):
        ref, _ = step_fn(ref, s)
    assert crashed["count"] == 1
    a, b = flatten(got), flatten(ref)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def test_train_state_round_trips_and_reads_jax_checkpoints(jax_params, tmp_path):
    """The port's train state round-trips bit for bit (the 0-d int32 step
    included); a train checkpoint written by the JAX package after one
    step restores into the port's tree leaf for leaf."""
    jc, tc = _cfgs()
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1)
    jp = jax.tree.map(jnp.array, jax_params)
    jo = JT.init_opt_state(jp, jt)
    jp, jo, _ = JT.make_train_step(JZ.build_model(jc), jt)(
        jp, jo, {"tokens": jnp.asarray(_batch(B=2, S=8))})
    jstate = jax.device_get({"params": jp, "opt": jo})
    JC.save(str(tmp_path / "jax"), 0, jstate)
    tp = from_jax_params(jax_params, tc, "cpu", deploy=False)
    like = {"params": tp, "opt": TT.init_opt_state(tp, TrainConfig())}
    got, step = TC.restore_latest(str(tmp_path / "jax"), like)
    assert step == 0 and TC.describe(got) == TC.describe(like)
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].dim() == 0
    assert int(got["opt"]["step"]) == 1
    for j, t in zip(jax.tree.leaves(jstate), flatten(got)):
        assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    TC.save(str(tmp_path / "port"), 3, got)
    back, step = TC.restore_latest(str(tmp_path / "port"), like)
    assert step == 3
    assert all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
               for a, b in zip(flatten(back), flatten(got)))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--warmup", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    state, metrics = ttrain.main(argv)
    out = capsys.readouterr().out
    assert "[train] step     0 loss=" in out and "[train] step     3 loss=" in out
    assert "[train] done: final loss" in out
    assert np.isfinite(metrics["loss"]) and set(metrics) == {"loss", "ce", "aux", "lr",
                                                            "grad_norm"}
    assert TC.list_generations(str(tmp_path)) == [1, 3]
    assert int(state["opt"]["step"]) == 4
    # a second run over the same directory resumes past its last step
    again, _ = ttrain.main(argv)
    assert all(torch.equal(a, b) for a, b in zip(flatten(state), flatten(again)))


def test_train_entry_points_refuse(tmp_path, monkeypatch):
    base = ["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 9"):
        ttrain.main(["--arch", ARCH, "--mesh", "2,1"] + base)
    with pytest.raises(NotImplementedError, match="item 9"):
        ttrain.main(["--arch", ARCH, "--compression", "int8_ef"] + base)
    for arch in ("xlstm-1.3b", "recurrentgemma-9b"):
        with pytest.raises(NotImplementedError, match="item 8"):
            ttrain.main(["--arch", arch] + base)
    assert not os.listdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", ARCH, "--smoke", "--ckpt-dir", str(tmp_path)])
