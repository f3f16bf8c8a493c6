#!/usr/bin/env python3
"""whisper-tiny's greedy streams in bf16: the port against the JAX
package's jitted `generate` and its eager run, on the CPU.

  PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/whisper_jit_gap.py \
      [--tokens 8] [--impl kernel]

SMOKE whisper-tiny at its default bf16, parameters from the JAX package's
seeded `init` (PRNGKey(3)) through `from_jax_params`, on the inputs of the
reference's `test_whisper_generate_with_frames` (`lm_batch(3, 2, 4)`
tokens, RandomState(0) frames), `--tokens` greedy tokens over a cache of
4 + tokens.  Prints three streams: the port's, the reference's jitted
`greedy_generate` (XLA fuses bf16 elementwise chains, dropping roundings)
and the same under `jax.disable_jit()` (op by op: what the port follows),
and the first index where each JAX stream parts from the port's.  The
eager run takes about a minute on the kernel path (Pallas interpret mode).
Like the tests, it imports both packages; the port itself imports no JAX.
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
from repro.data import pipeline as JD  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro.runtime import serve_lib as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model, from_jax_params  # noqa: E402
from repro_torch.runtime import serve_lib as TS  # noqa: E402

ARCH = "whisper-tiny"


def first_diff(a: np.ndarray, b: np.ndarray):
    diff = np.nonzero((a != b).any(axis=0))[0]
    return int(diff[0]) if len(diff) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--impl", default="kernel", choices=["behavioral", "kernel"])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    kw = dict(attn_impl=args.impl, decode_block_k=8)
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm, tp = build_model(tcfg, "cpu"), from_jax_params(jp, tcfg, "cpu")
    toks = JD.lm_batch(3, 2, 4, tcfg.vocab_size)
    frames = np.random.RandomState(0).randn(2, tcfg.encoder_seq_len,
                                            tcfg.d_model).astype(np.float32)
    max_len = 4 + args.tokens
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    port = TS.greedy_generate(tm, tp, {"tokens": torch.from_numpy(toks).long(),
                                       "frames": torch.from_numpy(frames)},
                              args.tokens, max_len).numpy()
    jitted = np.asarray(JS.greedy_generate(jm, jp, jb, args.tokens, max_len))
    with jax.disable_jit():
        eager = np.asarray(JS.greedy_generate(jm, jp, jb, args.tokens, max_len))
    print(f"{ARCH} SMOKE bf16, {args.impl} path, {args.tokens} greedy tokens")
    for name, s in (("port", port), ("JAX jitted", jitted), ("JAX eager", eager)):
        print(f"  {name:>10}: {s.tolist()}")
    print(f"  first token where the jitted stream parts from the port's: "
          f"{first_diff(port, jitted)}; the eager one: {first_diff(port, eager)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
