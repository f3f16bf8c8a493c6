"""The port's MoE layer (`models/moe.py`) and kernel 3's expert axis against
the JAX package, on the CPU.

The MoE FFN of deepseek-moe-16b's SMOKE config (4 routed experts, 1 shared,
top-2), and variants of it, with parameters from the reference's seeded
`moe_ffn_init` deployed through `from_jax_params`, on numpy inputs from a
seed.  Bounds:
  * bfloat16: `moe_ffn_local` / `moe_ffn_apply` equal the reference's eager
    run bit for bit, with the routed experts, the kept mask and the
    capacity equal: a step with drops, a step with T * k * cf / E < 1 and
    no shared experts, two shared experts and top-6, and the token-chunk rule
    (`_MOE_TOKEN_CHUNK` patched small on both sides; JAX's scan run eagerly
    under `jax.disable_jit`);
  * float32: within rel 1e-6 of the reference (measured ~1e-7), the
    chunked step too under the jitted scan.
Kernel 3's expert axis: the plain version of an (E, M, K) x (E, K, N) stack
equals E single plain calls and the reference's vmapped `pim_matmul_int`
in both ADC modes; `core/pim.py` runs stacks on the CPU as E products; the
expert stacks deploy to the reference's per-call quantization, codes and
scales; the port's own `init` draws them one expert at a time.  On the card
(`gpu`): the expert launch against its plain version and E single
launches, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import pim as JP
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.configs.base import PIMConfig as TPim
from repro_torch.core import pim as TP
from repro_torch.kernels.pim_matmul import pim_matmul_int, pim_matmul_int_plain
from repro_torch.models import moe as TM
from repro_torch.models import model_zoo
from repro_torch.models.model_zoo import build_model, from_jax_params

ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="bfloat16", **moe):
    out = []
    for cfg in (jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)):
        out.append(dataclasses.replace(
            cfg, compute_dtype=dtype,
            moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _params(jcfg, tcfg, seed=0):
    """(jax moe params as numpy, the port's deployed moe params)."""
    jp = jax.device_get(JM.moe_ffn_init(jax.random.PRNGKey(seed), jcfg))
    tree = {"blocks": ({"moe": jp},), "tail": ()}
    return jp, from_jax_params(tree, tcfg, "cpu")["blocks"][0]["moe"]


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_routing(jp, x, cfg):
    """(idx, keep) of the reference's routing of rows `x`, (T, k) in each
    row's top-k order: its own statements, the kept mask mapped back from
    the sorted order."""
    m = cfg.moe
    T, k, E = x.shape[0], m.top_k, m.num_experts
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    C = max(int(np.ceil(T * k * m.capacity_factor / E)), 1)
    ids = idx.reshape(-1)
    order = jnp.argsort(ids)
    counts = jnp.bincount(ids, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - starts[ids[order]]
    keep = np.zeros(T * k, bool)
    keep[np.asarray(order)] = np.asarray(rank < C)
    return np.asarray(idx), keep.reshape(T, k), C


def _bits(t):
    return t.float().numpy()


# name -> (MoEConfig overrides, rows T): drops at C 5 for 26 picks; C 1
# with T * k * cf / E = 0.3 (16 experts, top-4, one row) and no shared
# experts; two shared experts at top-6 of 8
ROUTING = {
    "drops": (dict(capacity_factor=0.75), 13),
    "under_one_no_shared": (dict(num_experts=16, top_k=4, num_shared=0), 1),
    "shared2_top6": (dict(num_experts=8, num_shared=2, top_k=6), 13),
}


@pytest.mark.parametrize("name", list(ROUTING))
def test_moe_ffn_local_bit_identical_to_jax_eager(name):
    moe, T = ROUTING[name]
    jcfg, tcfg = _cfgs(**moe)
    jp, tp = _params(jcfg, tcfg)
    x = _x((T, jcfg.d_model), seed=T)
    xt = torch.from_numpy(x).bfloat16()
    gate, idx = TM.route(tp, xt, tcfg)
    C = TM.capacity(T, tcfg)
    _, _, keep = TM.dispatch(xt, idx, C, tcfg.moe.num_experts)
    j_idx, j_keep, j_C = _jax_routing(jp, np.asarray(xt.float().numpy()), jcfg)
    assert C == j_C
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    if name == "drops":
        assert not j_keep.all()
    if name == "under_one_no_shared":
        assert C == 1 and T * 4 * 1.25 / 16 < 1 and "shared" not in tp
    jy, _ = JM.moe_ffn_local(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty = TM.moe_ffn_local(tp, xt, tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ty), np.asarray(jy.astype(jnp.float32)))


def test_moe_ffn_local_float32_within_tolerance():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg, tcfg, seed=1)
    x = _x((13, jcfg.d_model), seed=20)
    jy, _ = JM.moe_ffn_local(jp, jnp.asarray(x), jcfg)
    ty = TM.moe_ffn_local(tp, torch.from_numpy(x), tcfg)
    jy = np.asarray(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-6 * np.abs(jy).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_token_chunk_rule_matches_jax(monkeypatch, dtype):
    """A step of 2 x 6 rows over a budget of 4 is routed in 3 chunks of the
    sequence axis on both sides (each chunk its own capacity)."""
    monkeypatch.setattr(JM, "_MOE_TOKEN_CHUNK", 4)
    monkeypatch.setattr(TM, "_MOE_TOKEN_CHUNK", 4)
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=2)
    x = _x((2, 6, jcfg.d_model), seed=3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ty = TM.moe_ffn_apply(tp, xt, tcfg)
    whole = TM.moe_ffn_local(tp, xt.reshape(12, -1), tcfg).reshape(2, 6, -1)
    assert not torch.equal(ty, whole)          # the chunks route otherwise
    if dtype == "bfloat16":
        with jax.disable_jit():                # the scan's body run eagerly
            jy, _ = JM.moe_ffn_apply(jp, jnp.asarray(x, jdt), jcfg)
        np.testing.assert_array_equal(_bits(ty), np.asarray(jy.astype(jnp.float32)))
    else:
        jy, _ = JM.moe_ffn_apply(jp, jnp.asarray(x, jdt), jcfg)
        jy = np.asarray(jy)
        assert np.abs(ty.numpy() - jy).max() <= 1e-6 * np.abs(jy).max()


def test_expert_stacks_deploy_to_the_references_per_call_quantization():
    """Each expert's int8 codes and per-channel scales equal what the
    reference's vmapped QAT linear computes from `w.astype(bf16)`; served
    as (K, N) views of an (N, K) store."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    for stack in ("experts", "shared"):
        for name in ("w_in", "w_gate", "w_out"):
            w = jnp.asarray(jp[stack][name]).astype(jnp.bfloat16)
            q, s = jax.vmap(lambda wc: JP.quantize_weights(wc, jcfg.pim))(w)
            got = tp[stack][name]
            np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(q))
            np.testing.assert_array_equal(_bits(got["w_scale"]),
                                          np.asarray(s.astype(jnp.float32)))
            assert got["w_q"].transpose(-1, -2).is_contiguous()


def test_init_deploys_expert_stacks_one_expert_at_a_time():
    """The port's own `init` deploys every expert slice as it draws it:
    equal to drawing the whole stack slice by slice and deploying it
    after, codes, scales and the served (K, N) view of an (N, K) store;
    a model's tree holds such stacks under its MoE blocks and a dense
    prefix beside them."""
    cfg = get_config(ARCH, smoke=True)
    lead, d_in, d_out, scale = (2, 3), cfg.d_model, cfg.d_ff, 0.125
    got = model_zoo._drawn_experts(torch.Generator().manual_seed(4), cfg, "cpu",
                                   lead, d_in, d_out, scale)
    gen = torch.Generator().manual_seed(4)
    w = torch.stack([torch.randn((d_in, d_out), generator=gen) * scale
                     for _ in range(6)]).view(lead + (d_in, d_out))
    want = TP.deploy_params({"w": w}, cfg.pim, dtype=torch.bfloat16)
    assert torch.equal(got["w_q"], want["w_q"])
    assert torch.equal(got["w_scale"], want["w_scale"])
    assert got["w_q"].transpose(-1, -2).is_contiguous()
    params = build_model(cfg, "cpu").init(seed=0)
    moe = params["blocks"][0]["moe"]
    R = cfg.num_layers - cfg.num_dense_layers
    for stack, n in (("experts", 4), ("shared", 1)):
        w = moe[stack]["w_in"]
        assert w["w_q"].shape == (R, n, cfg.d_model, cfg.d_ff)
        assert w["w_scale"].shape == (R, n, 1, cfg.d_ff)
    assert moe["router"].dtype == torch.float32
    assert len(params["dense_prefix"]) == 1 and "mlp" in params["dense_prefix"][0]


# ---------------------------------------------------------------------------
# kernel 3's expert axis
# ---------------------------------------------------------------------------
def _codes(shape, seed, scale=40.0):
    x = np.random.RandomState(seed).randn(*shape) * scale
    return torch.from_numpy(np.clip(np.round(x), -128, 127).astype(np.int8))


def _stack(E, M, K, N, seed):
    """(E, M, K) codes and an (E, K, N) deployed view of an (E, N, K) store."""
    return (_codes((E, M, K), seed),
            _codes((E, N, K), seed + 1).transpose(1, 2))


@pytest.mark.parametrize("mode", ["ideal", "quantized"])
@pytest.mark.parametrize("E,M,K,N", [(4, 1, 64, 48), (3, 5, 200, 24),
                                     (2, 17, 96, 40)])
def test_plain_expert_stack_equals_single_calls_and_jax(mode, E, M, K, N):
    cfg = TPim(adc_mode=mode)
    x, w = _stack(E, M, K, N, seed=E * M)
    got = pim_matmul_int_plain(x, w, cfg)
    assert got.shape == (E, M, N)
    for e in range(E):
        assert torch.equal(got[e], pim_matmul_int_plain(x[e], w[e], cfg))
    assert torch.equal(pim_matmul_int(x, w, cfg), got)   # CPU: the plain version
    jcfg = dataclasses.replace(jax_config(ARCH).pim, adc_mode=mode)
    want = jax.vmap(lambda a, b: JP.pim_matmul_int(a, b, jcfg))(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_core_pim_runs_stacks_as_expert_products():
    """`core/pim.py` on the CPU: the ideal mode a batched int32 product,
    the quantized one kernel 3's plain version; a stacked linear equals
    its experts' linears, per-token scales taken over each expert's rows."""
    x, w = _stack(3, 6, 64, 32, seed=5)
    for mode in ("ideal", "quantized"):
        cfg = TPim(adc_mode=mode)
        got = TP.pim_matmul_int(x, w, cfg)
        for e in range(3):
            assert torch.equal(got[e], TP.pim_matmul_int(x[e], w[e], cfg))
    xs = torch.from_numpy(_x((3, 6, 64), 6)).bfloat16()
    ws = torch.from_numpy(_x((3, 64, 32), 7))
    lin = {"w": ws}
    y = TP.pim_linear_apply(lin, xs, TPim())
    for e in range(3):
        assert torch.equal(y[e], TP.pim_linear_apply({"w": ws[e]}, xs[e], TPim()))


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so that every worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,K,N", [(64, 1, 2048, 1408), (64, 5, 1408, 2048),
                                     (2, 60, 2048, 1408), (2, 4, 2048, 1024),
                                     (16, 3, 200, 24)])
def test_cuda_expert_launch_matches_plain_and_single_launches(cuda_device, E, M, K, N):
    """On the card: one expert launch == its plain version == E single
    launches, bit for bit, in both ADC modes (deepseek's decode and shared
    shapes, a split-K stack, a K that is not a multiple of 16)."""
    x, w = (t.to(cuda_device) for t in _stack(E, M, K, N, seed=M))
    for mode in ("ideal", "quantized"):
        cfg = TPim(adc_mode=mode)
        got = pim_matmul_int(x, w, cfg)
        assert torch.equal(got, pim_matmul_int_plain(x, w, cfg))
        assert torch.equal(got, torch.stack([pim_matmul_int(x[e], w[e], cfg)
                                             for e in range(E)]))
