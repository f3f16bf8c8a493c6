#!/usr/bin/env python3
"""The prefill / ring-decode gap of recurrentgemma at depth, in the port and
in the JAX package, on the CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/ring_gap.py [--layers 38] \
      [--tokens 40]

SMOKE recurrentgemma-9b (d_model 64, 2 q heads over 1 KV head of 32,
window 16) at `--layers` layers, parameters from the JAX package's seeded
`init` (PRNGKey(2), the key of the reference's
`test_prefill_decode_consistency`) through `from_jax_params`, batch 2 of
random tokens, max_len tokens + 8 (past the window: ring caches).  For each
attention path (behavioral; kernel: JAX's Pallas kernels in interpret mode
beside the port's plain versions) and compute dtype it prints, for each
package, the gap rel = |a - b| / |a| between the logits of token S from one
prefill of S tokens (a) and from a prefill of S - 1 tokens plus one
ring-decode step (b), as the reference's test takes it, and the distance of
the port's a and b from JAX's.  Like the tests, it imports both packages;
the port itself imports no JAX.
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model, from_jax_params  # noqa: E402

ARCH = "recurrentgemma-9b"


def rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9))


def gaps(layers: int, S: int, impl: str, dtype: str) -> dict:
    kw = dict(num_layers=layers, attn_impl=impl, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(2))
    tp = from_jax_params(jp, tcfg, "cpu")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    max_len = S + 8

    def jax_run(tokens, offset, cache):
        logits, cache, _ = jm.forward_serve(jp, {"tokens": jnp.asarray(tokens)}, cache,
                                            offset)
        return np.asarray(logits.astype(jnp.float32)), cache

    def port_run(tokens, offset, cache):
        with torch.inference_mode():
            logits, cache = tm.forward_serve(
                tp, {"tokens": torch.from_numpy(tokens).long()}, cache, offset)
        return logits.float().numpy(), cache

    out = {}
    for name, run, init in (("jax", jax_run, jm.init_cache), ("port", port_run, tm.init_cache)):
        a, _ = run(toks, 0, init(2, max_len))
        _, c = run(toks[:, :S - 1], 0, init(2, max_len))
        b, _ = run(toks[:, S - 1:], S - 1, c)
        out[name] = (a, b)
    (ja, jb), (ta, tb) = out["jax"], out["port"]
    return dict(jax_gap=rel(ja, jb), port_gap=rel(ta, tb), prefill_vs_jax=rel(ja, ta),
                decode_vs_jax=rel(jb, tb))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=38)
    ap.add_argument("--tokens", type=int, default=40)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    print(f"{ARCH} SMOKE widths, {args.layers} layers, {args.tokens} tokens, window "
          f"{get_config(ARCH, smoke=True).window}, CPU", flush=True)
    for impl in ("behavioral", "kernel"):
        for dtype in ("bfloat16", "float32"):
            g = gaps(args.layers, args.tokens, impl, dtype)
            print(f"  {impl:10s} {dtype:8s}: gap JAX {g['jax_gap']:.4f}, port "
                  f"{g['port_gap']:.4f}; port vs JAX: prefill {g['prefill_vs_jax']:.2e}, "
                  f"prefill + ring decode {g['decode_vs_jax']:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
