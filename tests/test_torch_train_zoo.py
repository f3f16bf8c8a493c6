"""The port's training of MoE, encoder-decoder, sliding-window and
image-patch stacks against the JAX package on the CPU.

SMOKE deepseek-moe-16b (a dense prefix layer, then 2 MoE layers of 4
routed top-2 experts and 1 shared), dbrx-132b (4 routed top-2, no shared),
whisper-tiny (2 encoder + 2 cross-attention decoder layers, 12 frames) and
phi-3-vision-4.2b (4 image patches), and recurrentgemma-9b's widths for an
`attn_local` block; float32, the reference's `init` reaching the port
through `from_jax_params(deploy=False)` (one JAX init per arch), inputs
from numpy seeds, on one torch thread.  Bounds:
  * the STE over an expert stack (`core/pim.py::_PIMLinearSTE` with a 3-D
    weight) against `jax.vjp` of the reference's `_expert_mm` (the linear
    vmapped over experts) in both ADC modes, the routed (E 4) stack and an
    E 2 shared stack fed by an `expand`: the forward bit for bit, dx and
    dw within rel 1e-6;
  * `moe_ffn_local`'s (y, aux) and the gradients of the router, the
    expert and shared stacks and the input at deepseek and dbrx SMOKE,
    and the chunked `moe_ffn_apply` (`_MOE_TOKEN_CHUNK` patched to 16 on
    both sides): y and the gradients within rel 1e-5, aux within 1e-6.
    The inputs route far from ties: every row's k-th and (k+1)-th router
    probabilities part by at least 1e-3 (checked; a float32 router
    differs from XLA's by ulps);
  * `xattn_block_fwd_train`, `encode` (whisper) and an `attn_local` block
    (S 40 over a window of 16): outputs and gradients within rel 1e-5;
  * `Model.loss` and every leaf's gradient against the reference's jitted
    `value_and_grad` at the quantized ADC: the loss within rel 1e-5, each
    leaf's max error within 1e-4 of that leaf's max |g|, remat on and off
    (deepseek) and once with plain linears (whisper); at the ideal ADC
    (deepseek) 5e-4 and 5e-2, the bounds of `test_torch_train.py`: an ulp
    there flips an int8 activation code, as it parts the reference's own
    jitted and eager runs.  Every router input of these runs is at least
    1e-5 from a top-k tie (checked through the port's `_route`);
  * one `make_train_step` step at the quantized ADC against the
    reference's jitted step, from the same state, at deepseek and whisper
    SMOKE, and 2 microbatches at deepseek (MoE) and whisper (frames): the
    loss within rel 1e-6, AdamW's m and v within 1e-5 of each leaf's max;
    a parameter may part from the reference's by more than 1e-6 only
    where its m is within 1e-4 of its leaf's max (the leaf bound), by at
    most lr, at no more than 1e-3 of the elements (AdamW's first update
    is about lr x sign(g)).  A step from the negated gradient fails that
    bound (checked);
  * `deploy_tree(init(deploy=False))` equals `init()` bit for bit; a train
    checkpoint the JAX package wrote restores leaf for leaf; the train CLI
    runs 4 steps at deepseek and whisper SMOKE.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import blocks as JB
from repro.models import model_zoo as JZ
from repro.models import moe as JM
from repro.models import transformer as JTR
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
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TTR
from repro_torch.models.model_zoo import build_model, from_jax_params
from repro_torch.runtime import train_lib as TT

MOE = ("deepseek-moe-16b", "dbrx-132b")
MARGIN = 1e-3          # least top-k gap of the MoE layer tests' inputs
MODEL_MARGIN = 1e-5    # of every router input of the model tests


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_PARAMS = {}


def jax_params(arch):
    """The reference's SMOKE init of `arch` (PRNGKey 0), once per arch."""
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jax.device_get(
            JZ.build_model(jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0)))
    return _JAX_PARAMS[arch]


def _cfgs(arch, adc="quantized", **kw):
    j, t = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    kw.setdefault("compute_dtype", "float32")
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


def _to_torch(tree, grad=False):
    out = unflatten(tree, [torch.from_numpy(np.array(a, np.float32))
                           for a in jax.tree.leaves(tree)])
    for t in flatten(out):
        t.requires_grad_(grad)
    return out


def _grads(tree):
    return unflatten(tree, [t.grad for t in flatten(tree)])


def _topk_gap(probs: torch.Tensor, k: int) -> float:
    """The least gap between a row's k-th and (k+1)-th probabilities."""
    top = torch.topk(probs.detach(), k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


# ---------------------------------------------------------------------------
# the STE over an expert stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("adc", ["ideal", "quantized"])
def test_expert_stack_ste_matches_jax_vjp(adc, shared):
    jc, tc = _cfgs("deepseek-moe-16b", adc=adc)
    r = np.random.RandomState(11 + shared)
    E, M, K, N = (2, 9, 64, 40) if shared else (4, 7, 64, 40)
    x = r.randn(M, K).astype(np.float32) if shared else \
        r.randn(E, M, K).astype(np.float32)
    w = (r.randn(E, K, N) / K ** 0.5).astype(np.float32)
    g = r.randn(E, M, N).astype(np.float32)

    def ref(x, w):
        xe = jnp.broadcast_to(x, (E,) + x.shape) if shared else x
        return JM._expert_mm(xe, w, jc)

    y, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    xe = xt.expand((E,) + xt.shape) if shared else xt
    yt = TP.pim_linear_apply({"w": wt}, xe, tc.pim)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(yt), _np(y))
    assert _rel(xt.grad, dx) <= 1e-6 and _rel(wt.grad, dw) <= 1e-6


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
def _moe_params(jc, seed):
    """One MoE layer's fp tree (the reference's: bare expert arrays) from
    numpy draws; the router wide enough that rows route far from ties."""
    r = np.random.RandomState(seed)
    m, d, f = jc.moe, jc.d_model, jc.d_ff

    def stack(n):
        return {k: (r.randn(n, a, b) / a ** 0.5).astype(np.float32)
                for k, (a, b) in (("w_gate", (d, f)), ("w_in", (d, f)),
                                  ("w_out", (f, d)))}

    p = {"router": (r.randn(d, m.num_experts) * 0.5).astype(np.float32),
         "experts": stack(m.num_experts)}
    if m.num_shared:
        p["shared"] = stack(m.num_shared)
    return p


def _moe_input(jc, p, T, seed):
    """(T, D) rows whose router probabilities part from a top-k tie by
    MARGIN at least: rows drawn from numpy, those nearer a tie skipped."""
    r = np.random.RandomState(seed)
    x = r.randn(8 * T, jc.d_model).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p["router"]), -1)
    top = torch.topk(probs, jc.moe.top_k + 1, dim=-1).values
    far = (top[:, -2] - top[:, -1] >= MARGIN).numpy()
    assert far.sum() >= T
    return x[far][:T]


def _check_moe(jfn, tfn, p, x, g):
    """(y, aux) and the gradients of every parameter and the input, the
    reference's jitted vjp against the port's autograd."""
    @jax.jit
    def ref(p, x, g):
        (y, aux), vjp = jax.vjp(jfn, p, x)
        return y, aux, vjp((g, jnp.float32(1.0)))

    y, aux, (dp, dx) = ref(p, jnp.asarray(x), jnp.asarray(g))
    pt = _to_torch(p, grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = tfn(pt, xt)
    (torch.sum(yt * torch.from_numpy(g)) + auxt).backward()
    assert auxt.dtype == torch.float32 and float(aux) > 0
    assert _rel(auxt, aux) <= 1e-6
    assert _rel(yt, y) <= 1e-5 and _rel(xt.grad, dx) <= 1e-5
    errs = _leaf_errors(dp, _grads(pt))
    assert max(errs) <= 1e-5, errs
    assert float(pt["router"].grad.abs().max()) > 0
    return errs


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_local_and_grads_match_jax(arch):
    jc, tc = _cfgs(arch)
    p = _moe_params(jc, seed=21)
    x = _moe_input(jc, p, 24, seed=22)
    g = np.random.RandomState(23).randn(24, jc.d_model).astype(np.float32)
    errs = _check_moe(lambda p, x: JM.moe_ffn_local(p, x, jc),
                      lambda p, x: TM.moe_ffn_local(p, x, tc, with_aux=True), p, x, g)
    assert len(errs) == 4 + 3 * bool(jc.moe.num_shared)


def test_chunked_moe_aux_and_grads_match_jax(monkeypatch):
    """B 2, S 24 over chunks of 16 tokens: nc 3 dispatches of 8 + 8 rows,
    the aux averaged as acc + aux / nc in chunk order."""
    monkeypatch.setattr(JM, "_MOE_TOKEN_CHUNK", 16)
    monkeypatch.setattr(TM, "_MOE_TOKEN_CHUNK", 16)
    jc, tc = _cfgs("deepseek-moe-16b")
    p = _moe_params(jc, seed=31)
    x = _moe_input(jc, p, 48, seed=32).reshape(2, 24, jc.d_model)
    g = np.random.RandomState(33).randn(2, 24, jc.d_model).astype(np.float32)
    _check_moe(lambda p, x: JM.moe_ffn_apply(p, x, jc),
               lambda p, x: TM.moe_ffn_apply(p, x, tc, with_aux=True), p, x, g)
    # the serving call drops the term
    y = TM.moe_ffn_apply(_to_torch(p), torch.from_numpy(x), tc)
    assert isinstance(y, torch.Tensor) and y.shape == (2, 24, jc.d_model)


# ---------------------------------------------------------------------------
# the cross-attention, encoder and sliding-window training blocks
# ---------------------------------------------------------------------------
def _block(jc, kind, seed):
    """A block's fp tree from the reference's init, its norms drawn from
    numpy (scales near 1, layernorm biases nonzero)."""
    p = jax.device_get(JTR._block_init(kind, jax.random.PRNGKey(seed), jc))
    r = np.random.RandomState(seed)
    for k in [k for k in p if k.startswith("norm")]:
        p[k] = {n: (v + 0.1 * r.randn(*v.shape)).astype(np.float32)
                for n, v in p[k].items()}
    return p


def _check_block(jfn, tfn, p, args, g):
    """Output and the gradients of every parameter and every input, the
    reference's jitted vjp against the port's autograd."""
    @jax.jit
    def ref(p, args, g):
        y, vjp = jax.vjp(jfn, p, *args)
        return y, vjp(g)

    y, (dp, *dargs) = ref(p, tuple(jnp.asarray(a) for a in args), jnp.asarray(g))
    pt = _to_torch(p, grad=True)
    at = [torch.from_numpy(a).requires_grad_() for a in args]
    yt = tfn(pt, *at)
    yt.backward(torch.from_numpy(g))
    assert _rel(yt, y) <= 1e-5
    for a, d in zip(at, dargs):
        assert _rel(a.grad, d) <= 1e-5
    errs = _leaf_errors(dp, _grads(pt))
    assert max(errs) <= 1e-5, errs


def test_xattn_block_train_matches_jax():
    jc, tc = _cfgs("whisper-tiny")
    p = _block(jc, "xattn", seed=41)
    r = np.random.RandomState(42)
    x, enc = (r.randn(2, 10, jc.d_model).astype(np.float32),
              r.randn(2, 12, jc.d_model).astype(np.float32))
    g = r.randn(2, 10, jc.d_model).astype(np.float32)
    pos = np.arange(10)
    _check_block(lambda p, x, e: JB.xattn_block_fwd_train(p, x, e, pos, jc)[0],
                 lambda p, x, e: TB.xattn_block_fwd_train(p, x, e, torch.arange(10), tc)[0],
                 p, (x, enc), g)


def test_encode_train_matches_jax():
    jc, tc = _cfgs("whisper-tiny")
    jp = jax_params("whisper-tiny")
    r = np.random.RandomState(43)
    p = {"enc_blocks": jp["enc_blocks"],
         "enc_norm": {k: (v + 0.1 * r.randn(*v.shape)).astype(np.float32)
                      for k, v in jp["enc_norm"].items()}}
    frames = r.randn(2, 12, jc.d_model).astype(np.float32)
    g = r.randn(2, 12, jc.d_model).astype(np.float32)
    _check_block(lambda p, f: JTR.encode(p, f, jc), lambda p, f: TTR.encode(p, f, tc),
                 p, (frames,), g)


def test_attn_local_block_train_matches_jax():
    """recurrentgemma-9b's SMOKE widths (2/1 heads of 32, GeGLU), S 40
    over a window of 16, through the kind's dispatch in both packages."""
    jc, tc = _cfgs("recurrentgemma-9b")
    p = _block(jc, "attn_local", seed=44)
    r = np.random.RandomState(45)
    x = r.randn(2, 40, jc.d_model).astype(np.float32)
    g = r.randn(2, 40, jc.d_model).astype(np.float32)
    pos = np.arange(40)
    _check_block(lambda p, x: JTR._block_fwd_train("attn_local", p, x, pos, jc)[0],
                 lambda p, x: TTR._block_fwd_train("attn_local", p, x,
                                                   torch.arange(40), tc)[0],
                 p, (x,), g)


# ---------------------------------------------------------------------------
# the whole model's loss and gradients
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=16, seed=1) -> dict:
    """Tokens, and the frames or image embeddings the config takes."""
    r = np.random.RandomState(seed)
    b = {"tokens": r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        b["frames"] = r.randn(B, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)
    if cfg.num_image_patches:
        b["image_embeds"] = r.randn(B, cfg.num_image_patches,
                                    cfg.d_model).astype(np.float32)
    return b


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.fixture
def router_gaps(monkeypatch):
    """The top-k gap of every router input the port's MoE layers see."""
    gaps = []
    route = TM._route

    def watched(params, xf, cfg):
        probs, gate, idx = route(params, xf, cfg)
        gaps.append(_topk_gap(probs, cfg.moe.top_k))
        return probs, gate, idx

    monkeypatch.setattr(TM, "_route", watched)
    return gaps


@pytest.mark.parametrize("arch,adc,remat,linears,loss_bound,leaf_bound", [
    ("deepseek-moe-16b", "quantized", "block", True, 1e-5, 1e-4),
    ("deepseek-moe-16b", "quantized", "none", True, 1e-5, 1e-4),
    ("deepseek-moe-16b", "ideal", "block", True, 5e-4, 5e-2),
    ("dbrx-132b", "quantized", "block", True, 1e-5, 1e-4),
    ("whisper-tiny", "quantized", "block", True, 1e-5, 1e-4),
    ("whisper-tiny", "quantized", "block", False, 1e-5, 1e-4),
    ("phi-3-vision-4.2b", "quantized", "block", True, 1e-5, 1e-4),
])
def test_model_loss_and_grads_match_jax(router_gaps, arch, adc, remat, linears,
                                        loss_bound, leaf_bound):
    jc, tc = _cfgs(arch, adc=adc, remat=remat, pim_linears=linears)
    jp = jax_params(arch)
    b = _batch(jc)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JZ.build_model(jc).loss, has_aux=True))(
        jp, _jax_batch(b))
    model = build_model(tc, "cpu")
    tp = from_jax_params(jp, tc, "cpu", deploy=False)
    tg, tl, tm = TT.grad_fn(model)(tp, _torch_batch(b))
    assert set(tm) == set(jm) == {"loss", "ce", "aux"}
    assert abs(float(tl) - float(jl)) <= loss_bound * abs(float(jl))
    errs = _leaf_errors(jg, tg)
    assert max(errs) <= leaf_bound, errs
    if jc.moe.num_experts:
        # as the reference's tests/test_models_smoke.py holds its aux
        assert np.isfinite(float(tm["aux"])) and float(tm["aux"]) > 0
        assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-6 * float(jm["aux"])
        moe_layers = jc.num_layers - jc.num_dense_layers
        assert len(router_gaps) == moe_layers * (1 + (remat != "none"))
        assert min(router_gaps) >= MODEL_MARGIN, router_gaps
    else:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    # every leaf the loss reads has a gradient: the encoder's, the cross
    # K/V's and img_proj's included
    for name, leaf in (("img_proj", ("img_proj", "w")), ("enc", ("enc_blocks", "attn", "wq", "w")),
                       ("xattn", ("blocks", 0, "xattn", "wk", "w"))):
        node = tg
        try:
            for k in leaf:
                node = node[k]
        except KeyError:
            continue
        assert float(node.abs().max()) > 0, name


def test_deploy_of_fp_moe_tree_equals_init():
    """init(deploy=False) of deepseek SMOKE holds the reference's bare
    expert arrays; deploy_tree of it is init()'s serving tree bit for
    bit (each expert drawn and quantized alone in both)."""
    tc = get_config("deepseek-moe-16b", smoke=True)
    model = build_model(tc, "cpu")
    fp = model.init(seed=0, deploy=False)
    assert all(t.dtype == torch.float32 for t in flatten(fp))
    stack = fp["blocks"][0]["moe"]["experts"]
    assert set(stack) == {"w_gate", "w_in", "w_out"}
    assert stack["w_in"].shape == (2, 4, 64, 96)
    assert fp["blocks"][0]["moe"]["shared"]["w_out"].shape == (2, 1, 96, 64)
    jdesc = TC.describe(jax_params("deepseek-moe-16b"))
    assert TC.describe(fp) == jdesc
    dep, redeployed = model.init(seed=0), TZ.deploy_tree(fp, tc)
    assert TC.describe(redeployed) == TC.describe(dep)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flatten(redeployed), flatten(dep)))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _train_state(jp, jo, tc):
    return (from_jax_params(jax.device_get(jp), tc, "cpu", deploy=False),
            {"m": _to_torch(jax.device_get(jo["m"])),
             "v": _to_torch(jax.device_get(jo["v"])),
             "step": torch.tensor(int(jo["step"]), dtype=torch.int32)})


def _shape(B, S):
    """The (global_batch, seq_len) record `make_batch` reads."""
    return types.SimpleNamespace(global_batch=B, seq_len=S)


def _step_within_bound(jp, jo, tp, to, lr) -> bool:
    """The bound of one step from the same state (module docstring)."""
    for name in ("m", "v"):
        if max(_leaf_errors(jo[name], to[name])) > 1e-5:
            return False
    parted = total = 0
    for j, t, m in zip(jax.tree.leaves(jp), flatten(tp), jax.tree.leaves(jo["m"])):
        d, m = np.abs(t.numpy() - np.asarray(j)), np.abs(np.asarray(m))
        off = d > 1e-6
        if d.max() > lr or np.any(m[off] > 1e-4 * m.max()):
            return False
        parted, total = parted + int(off.sum()), total + d.size
    return parted <= 1e-3 * total


@pytest.mark.parametrize("arch,microbatches", [
    ("deepseek-moe-16b", 1), ("whisper-tiny", 1),
    ("deepseek-moe-16b", 2), ("whisper-tiny", 2)])
def test_train_step_matches_jax(arch, microbatches):
    """One step of `make_batch`'s batch (4 x 16; whisper's frames split
    with the tokens into microbatches).  A microbatched step is held
    against the reference's microbatched step, not against the single
    batch: capacity routing makes a token's output depend on T."""
    jc, tc = _cfgs(arch)
    lr = 1e-3
    kw = dict(learning_rate=lr, warmup_steps=1, total_steps=3,
              microbatches=microbatches)
    b = TD.make_batch(tc, _shape(4, 16), 0)
    jp = jax.tree.map(jnp.array, jax_params(arch))
    jo = JT.init_opt_state(jp, JTrainConfig(**kw))
    tp, to = _train_state(jp, jo, tc)
    jp, jo, jmet = JT.make_train_step(JZ.build_model(jc), JTrainConfig(**kw))(
        jp, jo, _jax_batch(b))
    model = build_model(tc, "cpu")
    tp2, to2, tmet = TT.make_train_step(model, TrainConfig(**kw))(tp, to, _torch_batch(b))
    assert int(to2["step"]) == 1 and set(tmet) == set(jmet)
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-6
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-5
    assert _step_within_bound(jp, jo, tp2, to2, lr)
    # the bound can fail: a step down the negated gradient parts from it
    flipped = model._replace(loss=lambda p, b: (lambda l, m: (-l, m))(*model.loss(p, b)))
    tp3, to3, _ = TT.make_train_step(flipped, TrainConfig(**kw))(tp, to, _torch_batch(b))
    assert not _step_within_bound(jp, jo, tp3, to3, lr)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------
def test_jax_moe_train_checkpoint_restores(tmp_path):
    """A deepseek SMOKE train state the JAX package wrote after one step
    (bare expert arrays, AdamW moments of the same tree) restores into
    the port's tree leaf for leaf."""
    jc, tc = _cfgs("deepseek-moe-16b")
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1)
    jp = jax.tree.map(jnp.array, jax_params("deepseek-moe-16b"))
    jo = JT.init_opt_state(jp, jt)
    jp, jo, _ = JT.make_train_step(JZ.build_model(jc), jt)(
        jp, jo, _jax_batch(_batch(jc, B=2, S=8)))
    jstate = jax.device_get({"params": jp, "opt": jo})
    JC.save(str(tmp_path), 0, jstate)
    tp = build_model(tc, "cpu").init(seed=0, deploy=False)
    like = {"params": tp, "opt": TT.init_opt_state(tp, TrainConfig())}
    got, step = TC.restore_latest(str(tmp_path), like)
    assert step == 0 and TC.describe(got) == TC.describe(like)
    leaves = jax.tree.leaves(jstate)
    assert len(leaves) == len(flatten(got))
    for j, t in zip(leaves, flatten(got)):
        assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-tiny"])
def test_train_cli_runs_moe_and_encoder_decoder(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--warmup", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    state, metrics = ttrain.main(argv)
    out = capsys.readouterr().out
    assert "[train] step     3 loss=" in out and "[train] done: final loss" in out
    assert np.isfinite(metrics["loss"]) and int(state["opt"]["step"]) == 4
    assert (metrics["aux"] > 0) == (arch == "deepseek-moe-16b")
    assert TC.list_generations(str(tmp_path)) == [1, 3]
