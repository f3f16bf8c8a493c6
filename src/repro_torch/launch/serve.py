"""Serving entry point of the port: batched prefill + decode over the PIM
KV cache, greedy by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --attn-impl kernel --batch 4 --prompt-len 128 --new-tokens 32

Runs on the GPU; `--device cpu` runs the plain PyTorch versions instead
(use `--smoke` there).  Weights are random, drawn from `--seed`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import pipeline as data
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import serve_lib


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--attn-impl", default="",
                    choices=["", "behavioral", "kernel"])
    ap.add_argument("--no-decode-kernel", action="store_true",
                    help="send Sq == 1 steps to the prefill kernel instead "
                         "of the split-K decode kernel")
    ap.add_argument("--decode-block-k", type=int, default=0,
                    help="KV partition size of the split-K decode grid")
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 4, 8],
                    help="KV-cache precision: 8 = int8, 4 = packed 4-bit "
                         "codes (0 = keep the arch config)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with temperature softmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of sampling")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.no_decode_kernel:
        cfg = dataclasses.replace(cfg, decode_kernel=False)
    if args.decode_block_k:
        cfg = dataclasses.replace(cfg, decode_block_k=args.decode_block_k)
    if args.kv_bits:
        cfg = dataclasses.replace(cfg, kv_bits=args.kv_bits)
    model = build_model(cfg, args.device)
    params = model.init(seed=args.seed)
    tokens = data.lm_batch(0, args.batch, args.prompt_len, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    max_len = args.prompt_len + args.new_tokens
    gen = torch.Generator(device=model.device).manual_seed(args.seed)

    t0 = time.perf_counter()
    out = serve_lib.generate(model, params, batch, args.new_tokens, max_len,
                             temperature=args.temperature, top_k=args.top_k,
                             top_p=args.top_p, generator=gen)
    out = out.cpu()
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"[serve] arch={cfg.name} attn={cfg.attn_impl} device={model.device} "
          f"kv{cfg.kv_bits} temp={args.temperature} top_k={args.top_k} "
          f"top_p={args.top_p} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. prefill and kernel build)")
    print("[serve] first sequences:", out[:2, :12].tolist())
    return out


if __name__ == "__main__":
    main()
