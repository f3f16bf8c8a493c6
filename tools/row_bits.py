#!/usr/bin/env python3
"""Find the op that gives a served row other bits in another batch.

  python3 tools/row_bits.py [--rid 12] [--pos 437] [--torch-mean]

Serves `chip_smoke.py` phase 10's trace twice at full width: (A) the paged
pool, (C) with prefix sharing and fused mixed steps.  In each run it keeps
the row of request RID in the forward that decodes its token at position
POS (a decode chunk of 8 rows in A, a fused mixed step of 8 x 256 rows in
C): the input and output of every norm, PIM linear, activation and
attention call of that forward.  Prints the first op whose output differs
between the runs, and whether its input did.  `--torch-mean` puts torch's
own mean back into the RMSNorm (`layers.row_mean`), the one that split a
row differently with the number of rows.  Needs a CUDA device and nvcc.
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pim  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import blocks, layers, transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve_lib  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rid", type=int, default=12)
    ap.add_argument("--pos", type=int, default=437)
    ap.add_argument("--torch-mean", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("row_bits: no CUDA device is available")
    if args.torch_mean:
        layers.row_mean = lambda x: x.mean(dim=-1, keepdim=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), attn_impl="kernel",
                              decode_block_k=cs.PAGE)
    model = build_model(cfg, torch.device("cuda", 0))
    params = model.init(seed=0)
    trace, late, _, _ = cs.mixed_trace(cfg.vocab_size)
    st = {"row": None, "recs": [], "sched": None, "inner": False}

    def keep(name, fn, arg, outer=False):
        def call(*a, **k):
            st["inner"] |= outer
            try:
                out = fn(*a, **k)
            finally:
                st["inner"] &= not outer
            r = st["row"]
            if r is not None and (outer or not st["inner"]):
                st["recs"].append((name, a[arg][r, :1].clone(), out[r, :1].clone()))
            return out
        return call

    layers.norm_apply = keep("norm", layers.norm_apply, 1)
    layers._act = keep("activation", layers._act, 0)
    pim.pim_linear_apply = keep("PIM linear", pim.pim_linear_apply, 1)
    blocks._serve_attend_paged = keep("attention", blocks._serve_attend_paged, 0)
    blocks._mixed_attend = keep("attention", blocks._mixed_attend, 0, outer=True)
    forward = transformer.forward_serve

    def watched(params_, batch, cache, offset, cfg_, seq_lens=None, **kw):
        s = st["sched"]
        b = [i for i, r in enumerate(s.slot_req) if r is not None and r.rid == args.rid]
        if (b and seq_lens is not None and offset.shape[0] == s.B
                and int(offset[b[0]]) == args.pos and int(seq_lens[b[0]]) == 1):
            st["row"] = b[0]
        try:
            return forward(params_, batch, cache, offset, cfg_, seq_lens=seq_lens, **kw)
        finally:
            st["row"] = None

    transformer.forward_serve = watched
    runs = {}
    for key, extra in (("A", dict(page_size=cs.PAGE)),
                       ("C", dict(page_size=cs.PAGE, prefix_sharing=True, mixed_steps=True,
                                  prefill_chunk_budget=cs.MIX_BUDGET))):
        st.update(sched=serve_lib.Scheduler(model, params, **cs.MIX_KW, **extra), recs=[])
        streams, _, _ = cs.serve_steps(st["sched"], trace, late)
        runs[key] = (streams, st["recs"])
    (sa, ra), (sc, rc) = runs["A"], runs["C"]
    print(f"{torch.cuda.get_device_name(0)}; RMSNorm mean: "
          f"{'torch' if args.torch_mean else 'layers.row_mean'}; requests whose "
          f"streams part between A and C: {[i for i, (x, y) in enumerate(zip(sa, sc)) if x != y]}; "
          f"ops kept: {len(ra)} / {len(rc)}")
    for i, ((name, ia, oa), (_, ic, oc)) in enumerate(zip(ra, rc)):
        if not torch.equal(oa, oc):
            d = (oa.float() - oc.float()).abs()
            print(f"first op that differs: #{i} ({name}), input equal "
                  f"{torch.equal(ia, ic)}, {(d > 0).sum().item()} of {d.numel()} "
                  f"output elements differ, by up to {d.max().item():.4g}")
            return
    print("every kept op gave the row the same bits in A and C")


if __name__ == "__main__":
    main()
