"""Serving entry point of the port: batched prefill + decode over the PIM
KV cache, greedy by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --attn-impl kernel --batch 4 --prompt-len 128 --new-tokens 32

`--arch` takes every arch of `repro_torch.configs.ARCH_NAMES`: the attention
stacks internlm2-1.8b, qwen2-72b, mistral-large-123b and gemma-7b, the MoE
stacks deepseek-moe-16b and dbrx-132b, the hybrid recurrentgemma-9b
(RG-LRU and sliding-window attention; the classic path only), the VLM
phi-3-vision-4.2b (head_dim 96; the classic prefill also takes the batch's
576 random image patch embeddings) and the encoder-decoder whisper-tiny
(the classic prefill encodes the batch's 1,500 random frame embeddings;
the classic path only: `--continuous-batching` raises, as the reference's
does) and xlstm-1.3b (mLSTM and sLSTM blocks; the classic path only)
(`--smoke` for their small variants).
The batch is `data.make_batch(cfg, (batch, prompt_len), step 0)`, as the
JAX package's CLI builds it: the tokens of `lm_batch`, and the modality
stubs a config has.

`--continuous-batching` serves the batch through the slot scheduler
(`--max-batch-slots`, retirement at `--eos-id`); `--page-size N` puts the
slots on the paged KV pool of `--num-pages` pages, where
`--prefix-cache` shares prompt prefixes between requests (refcounted pages
and copy-on-write, the directory capped at `--prefix-cache-pages`);
`--mixed-steps` prefills prompts in chunks of at most
`--prefill-chunk-budget` tokens a step beside the decoding slots, in one
forward (`--mixed-dispatch fused`) or as a chunk wave paired with the
decode chunk (`paired`, paged only); `--speculate` verifies up to
`--draft-len` n-gram drafts a slot and step (`--draft-mode ngram`);
`--victim-pool-pages` spills evicted slots' pages to host memory (paged
only), `--max-queue` bounds the admission queue and `--deadline-ms` sheds
requests older than that; `--kv-bits 4` stores the KV cache as packed
4-bit codes on either path; `--integrity checksum|paranoid` checksums KV
pages (paged only; a corrupt spill is recomputed, never served),
`--tbt-target-ms` turns on the SLA degradation ladder, and
`--snapshot-every N --snapshot-dir D` / `--restore-from D` snapshot the
scheduler and resume from the newest intact snapshot:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --attn-impl kernel --continuous-batching --page-size 16 --batch 8 \
      --prefix-cache --mixed-steps --prefill-chunk-budget 256 --speculate

`--temperature` > 0 samples (with `--top-k` / `--top-p`) from the threefry
key `PRNGKey(--seed)`, as the JAX package's CLI does.  Runs on the GPU;
`--device cpu` runs the plain PyTorch versions instead (use `--smoke`
there).  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import types

import torch

from repro_torch.configs import get_config
from repro_torch.data import pipeline as data
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import prng, serve_lib


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
                    help="sampling rng seed (the key PRNGKey(seed))")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="serve through the ragged slot scheduler (per-"
                         "sequence KV lengths + EOS retirement)")
    ap.add_argument("--max-batch-slots", type=int, default=0,
                    help="KV cache slots for the scheduler (0 = --batch)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="retire sequences on this token id (-1 = never)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page: >0 switches the scheduler to "
                         "the paged pool (requires --continuous-batching)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool pages incl. the reserved trash page "
                         "(0 = match the dense slot footprint)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prefix sharing + copy-on-write pages: "
                         "requests with a common page-aligned prompt prefix "
                         "map the same pages and skip its prefill (requires "
                         "--page-size)")
    ap.add_argument("--prefix-cache-pages", type=int, default=0,
                    help="cap on the distinct pages the prefix directory "
                         "may hold (LRU-evicted; 0 = pool pressure only)")
    ap.add_argument("--mixed-steps", action="store_true",
                    help="chunked prefill: each scheduler step feeds prompt "
                         "chunks beside the decode tokens, so admission "
                         "never stalls decoding slots (requires "
                         "--continuous-batching; identical streams)")
    ap.add_argument("--prefill-chunk-budget", type=int, default=0,
                    help="prompt tokens one mixed step may prefill across "
                         "all prefilling slots (0 = 32)")
    ap.add_argument("--mixed-dispatch", default="fused",
                    choices=["fused", "paired"],
                    help="one (B, L) forward per mixed step ('fused') or a "
                         "chunk wave of the prefilling rows paired with the "
                         "decode chunk ('paired'; requires --page-size)")
    ap.add_argument("--victim-pool-pages", type=int, default=0,
                    help="host-memory victim pool (pages): an eviction "
                         "spills its private KV pages to host memory and "
                         "re-admission restores them instead of recomputing "
                         "the prompt (requires --page-size; 0 = recompute)")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request deadline: requests older than this are "
                         "shed as deadline misses (0 = none)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: submits past this depth "
                         "are refused with back-pressure (0 = unbounded)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decoding: n-gram drafts verified in "
                         "one multi-token decode launch a step (requires "
                         "--continuous-batching; greedy streams unchanged, "
                         "sampling distribution-preserving)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="most drafted tokens a slot and step (the depth "
                         "adapts between 1 and this cap)")
    ap.add_argument("--draft-mode", default="ngram", choices=["ngram"],
                    help="draft proposer: 'ngram' = prompt lookup")
    ap.add_argument("--integrity", default="off",
                    choices=["off", "checksum", "paranoid"],
                    help="KV-page integrity: 'checksum' records each page's "
                         "crc32 when the prefix directory first holds it and "
                         "at spill, and verifies a spill at its restore (a "
                         "mismatch recomputes, never serves); 'paranoid' "
                         "also verifies every prefix hit and directory "
                         "eviction (requires --page-size)")
    ap.add_argument("--tbt-target-ms", type=float, default=0.0,
                    help="p95 time-between-tokens target: turns on the "
                         "degradation ladder (speculation off -> prefill "
                         "chunks halved -> admission paused, released in "
                         "reverse as the pressure clears; 0 = off)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot the scheduler every N steps (requires "
                         "--snapshot-dir; 0 = off)")
    ap.add_argument("--snapshot-dir", default="",
                    help="directory of the scheduler's snapshot generations "
                         "(atomic, checksummed; the newest intact one wins)")
    ap.add_argument("--restore-from", default="",
                    help="resume from the newest intact snapshot in this "
                         "directory before serving (same configuration)")
    args = ap.parse_args(argv)
    if args.page_size and not args.continuous_batching:
        ap.error("--page-size requires --continuous-batching")
    if args.num_pages and not args.page_size:
        ap.error("--num-pages requires --page-size")
    if args.prefix_cache and not args.page_size:
        ap.error("--prefix-cache requires --page-size")
    if args.prefix_cache_pages and not args.prefix_cache:
        ap.error("--prefix-cache-pages requires --prefix-cache")
    if args.mixed_steps and not args.continuous_batching:
        ap.error("--mixed-steps requires --continuous-batching")
    if args.prefill_chunk_budget and not args.mixed_steps:
        ap.error("--prefill-chunk-budget requires --mixed-steps")
    if args.mixed_dispatch == "paired" and not args.page_size:
        ap.error("--mixed-dispatch paired requires --page-size")
    if args.victim_pool_pages and not args.page_size:
        ap.error("--victim-pool-pages requires --page-size")
    if args.victim_pool_pages < 0:
        ap.error("--victim-pool-pages must be >= 0")
    if args.deadline_ms < 0:
        ap.error("--deadline-ms must be >= 0")
    if args.max_queue < 0:
        ap.error("--max-queue must be >= 0")
    if (args.deadline_ms or args.max_queue) and not args.continuous_batching:
        ap.error("--deadline-ms/--max-queue require --continuous-batching")
    if args.speculate and not args.continuous_batching:
        ap.error("--speculate requires --continuous-batching")
    if args.integrity != "off" and not args.page_size:
        ap.error("--integrity requires --page-size (checksums are "
                 "page-granular)")
    if args.tbt_target_ms < 0:
        ap.error("--tbt-target-ms must be >= 0")
    if args.tbt_target_ms and not args.continuous_batching:
        ap.error("--tbt-target-ms requires --continuous-batching")
    if args.snapshot_every < 0:
        ap.error("--snapshot-every must be >= 0")
    if args.snapshot_every and not args.snapshot_dir:
        ap.error("--snapshot-every requires --snapshot-dir")
    if ((args.snapshot_every or args.restore_from)
            and not args.continuous_batching):
        ap.error("--snapshot-every/--restore-from require "
                 "--continuous-batching")
    return args


def main(argv=None):
    args = parse_args(argv)
    # float32 products stay float32 on the card (a MoE router's top-k
    # equals the reference's only without TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    params = model.init(seed=0)
    shape = types.SimpleNamespace(global_batch=args.batch,
                                  seq_len=args.prompt_len)
    batch = {k: torch.from_numpy(v)
             for k, v in data.make_batch(cfg, shape, 0).items()}
    batch["tokens"] = batch["tokens"].long()
    max_len = args.prompt_len + args.new_tokens

    t0 = time.perf_counter()
    out = serve_lib.generate(
        model, params, batch, args.new_tokens, max_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        rng=prng.PRNGKey(args.seed),
        continuous_batching=args.continuous_batching,
        eos_id=None if args.eos_id < 0 else args.eos_id,
        max_batch_slots=args.max_batch_slots or None,
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_sharing=args.prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages,
        mixed_steps=args.mixed_steps,
        prefill_chunk_budget=args.prefill_chunk_budget,
        mixed_dispatch=args.mixed_dispatch, speculate=args.speculate,
        draft_len=args.draft_len, draft_mode=args.draft_mode,
        victim_pool_pages=args.victim_pool_pages, max_queue=args.max_queue,
        deadline_ms=args.deadline_ms or None, integrity=args.integrity,
        tbt_target_ms=args.tbt_target_ms,
        snapshot_every=args.snapshot_every,
        snapshot_dir=args.snapshot_dir or None,
        restore_from=args.restore_from or None)
    out = out.cpu()
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    mode = "classic"
    if args.continuous_batching:
        mode = (f"scheduler({args.max_batch_slots or args.batch} slots"
                + (f", paged ps={args.page_size}" if args.page_size else "")
                + (", prefix cache" if args.prefix_cache else "")
                + (f", mixed {args.mixed_dispatch}" if args.mixed_steps
                   else "")
                + (f", speculate k={args.draft_len}" if args.speculate
                   else "")
                + (f", spill {args.victim_pool_pages} pages"
                   if args.victim_pool_pages else "")
                + (f", integrity {args.integrity}"
                   if args.integrity != "off" else "")
                + (f", tbt target {args.tbt_target_ms} ms"
                   if args.tbt_target_ms else "")
                + (f", snapshot every {args.snapshot_every}"
                   if args.snapshot_every else "")
                + (f", restored from {args.restore_from}"
                   if args.restore_from else "") + ")")
    print(f"[serve] arch={cfg.name} attn={cfg.attn_impl} device={model.device} "
          f"{mode} kv{cfg.kv_bits} temp={args.temperature} top_k={args.top_k} "
          f"top_p={args.top_p} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. prefill and kernel build)")
    print("[serve] first sequences:", out[:2, :12].tolist())
    return out


if __name__ == "__main__":
    main()
