#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

  python3 chip_smoke.py [--out results.json] [--phases 1,2,3]

With no arguments it runs and checks every phase; `--phases` runs a subset
(phase 1 always, and the phases a chosen one needs), for short calls that
iterate on one kernel: `--phases 1,2,3` builds and checks both attention
kernels, dense and paged, `--phases 1,8` the PIM matmul and LUT softmax.

1. Prints the card and builds the CUDA kernels from `src/repro_torch/kernels/csrc`,
   with ptxas's registers and spills, and counts the tensor-core (IMMA)
   instructions, and all instructions, in the SASS of each pim_matmul,
   pim_attention and pim_decode kernel.
2. Holds each kernel against its plain PyTorch version at the widths of
   internlm2-1.8b (16 query heads over 8 KV heads, head_dim 128): causal,
   windowed and 4-bit prefill at Sq 512, and at Sq 512 a group of 4 q
   heads (16 over 4 KV heads) and head_dim 64; split-K decode at kv_len 4096 with
   block_k 256, verify rows (Sq 4 and 5, bit-identical to single-step
   launches), a q_len-0 row and 4-bit KV; iteration
   maps against the analytic count; and decode at the served request's
   own shape (a 160-token cache holding 129..159 tokens, one partial
   partition), with verify rows and 4-bit KV there too.  At head_dim 256
   (gemma-7b's 16/16 heads and recurrentgemma-9b's 16/1): kernel 1 causal
   at Sq 512, windowed (window 128 at Sq 512; window 2048 at Sq 2304,
   16/1) and 4-bit; kernel 2 at kv_len 4096 with and without a window of
   2048, verify rows (Sq 4 and 5, bit-identical to single steps) and
   4-bit; iteration maps against the analytic count; each timed shape
   beside its bound and bf16 SDPA.  At head_dim 96 (phi-3-vision-4.2b's
   32/32 heads, and 32/8 for kernel 1's 64-row CTAs and kernel 2's 32-dim
   slices): kernel 1 causal and windowed (128) at Sq 512 and 4-bit;
   kernel 2 at kv_len 4096 (block_k 256; block_k 2048 at 32/8, dsplit 3),
   verify rows (Sq 4 and 5, bit-identical to single steps) and 4-bit; both
   dsplit 1 and 3 launched.  Times kernel,
   plain version and, as a yardstick only, bf16
   `scaled_dot_product_attention` at the same shapes: device time from
   torch.profiler, and the wall time of back-to-back calls beside it.  A
   decode call runs one device kernel and nothing else.
3. Holds the paged mode of both kernels against their plain versions at
   the same widths, over random permuted page tables of 16-token pages
   (slot lengths 0, 15, 16, 17, 1000, 2048): decode, verify rows (Sq 4)
   and a ragged prefill chunk (Sq 128, per-row offsets), each at int8 and
   4-bit KV, with iteration maps equal, and paged == dense bit for bit at
   block_k == page size.  Times the paged mode at the shapes timed in
   phase 2 (one pim_decode_kernel per decode call), at int8 and over 4-bit
   pages.  Then at head_dim 256 (16/16 and 16/1 heads): decode, verify
   rows and a ragged prefill chunk over 16-token pages, int8 and 4-bit,
   against the plain versions and, bit for bit, against dense at block_k
   16; and the same at head_dim 96 (32/32 and 32/8 heads: page rows of
   3,072 int8 or 1,536 4-bit bytes, a head 96 or 48 bytes into them).
4. Checks the kernel path of a small model against the plain path on the CPU.
5. Runs the continuous-batching Scheduler on the card at that small width
   (float32, kernel path): dense slots, the paged pool and classic greedy
   generation give the same streams, a starved pool stalls and evicts
   without changing them, every page returns to the free list and
   `audit()` passes after every step.
6. Serves internlm2-1.8b at full width and depth (random weights from a
   seed) through `repro_torch.runtime.serve_lib.generate`, batch 4, prompt
   128, 32 new tokens, greedy, counting kernel launches (24 prefill and
   31 x 24 decode launches, no plain-version call).  Then serves the
   request cut to 8 new tokens, once as it is and once under
   torch.profiler, and prints where its device time goes: the busy share
   over the unprofiled wall time, each attention kernel's device time per
   launch (the profiler must see one kernel per wrapper call), kernels 1
   and 2's bounds at the cut's shapes beside them, and the top device
   operators.
7. Serves a 16-request trace (prompts 16-256 tokens, budgets 16-64) through
   the Scheduler at full width, on dense slots and on the paged pool,
   counting kernel launches in each (24 prefill launches a prefill forward,
   no plain-version call); holds served launches of both kernels
   on each storage (every admission wave's ragged prefill and three decode
   steps, on the scheduler's own cache or pool, lengths, q_len and page
   table) against their plain versions; checks budgets, vocabulary, freed
   pages, a repeatable paged stream and, for prompts of one page, dense and
   paged prefill logits equal bit for bit; prints where and by how much
   the two storages' streams and logits part; then profiles the first
   step of the paged run (an admission wave and a decode chunk) as phase
   6 does, with kernels 1 and 2's bounds at the shapes of its calls.
8. (Run right after phase 3, beside the other kernel checks.)  Holds the
   PIM matmul (kernel 3) in both ADC modes and the LUT softmax (kernel 4)
   against their plain versions bit for bit: the linears' shapes (K 2048
   -> N 1024/2048/8192, K 8192 -> N 2048) at M 4, 512 and 2048, a K that
   is not a multiple of 16, a row-major layer view of stacked weights and
   the deployed (K, N) view of an (N, K) store, x rows that are not
   16-byte aligned; softmax rows at every boundary of kernel 4's regimes
   (S 1 to 1025 around the warp rows' limit, 4096, the longest row staged
   in shared memory and one past it), int32 and int8 codes, 1 and 9 rows,
   score views one element into their storage, all-masked rows, the
   served prefill (8192 x 160, also as the attention's broadcast mask) and
   decode (64 x 4096) rows, flat rows whose sum of exps passes 2^24.
   Times kernel 3 at the served shapes (M 4, 512 and 2048, with TOP/s and
   the share of its bound) beside its plain version, its bound and, for the
   ideal mode, `torch._int_mm`; kernel 4 at the served shapes (64 x 160,
   128 x 512, 8192 x 160, 64 x 4096), warm and with L2 flushed, beside its
   plain version and its bound (no one PyTorch call computes the ADC or
   the LUT softmax).
9. Serves internlm2-1.8b at the paper's fidelity, with the phase 6
   weights: `adc_mode="quantized"` (every PIM linear through kernel 3) and
   behavioral attention (kernel 4 once per layer).  The classic request
   and the phase 7 trace on the paged pool, each with its launch counts
   held to 168 and 24 per forward, no plain-version call, the peak device
   memory, a replay of served launches of both kernels (a prefill and a
   decode step) against their plain versions, kernel 4's on its served
   broadcast mask with no other device kernel around it, and a profile as
   in phases 6 and 7, with kernels 3 and 4's bounds at their served
   operands and the device kernels per forward.
10. Serves, with the phase 6 weights cut to their first 6 layers
   (CUT_DEPTH) at decode_block_k 16, a 16-request
   trace through 8 slots of 1,536 tokens: 12 prompts open with one
   256-token system prompt (two pairs of them equal and page-aligned), 3
   share nothing, and a 1,024-token prompt arrives after 3 steps.  Six
   ways: (A) the paged pool, (B) with prefix sharing, (C) with sharing
   and fused mixed steps, (D) with sharing and paired mixed steps (chunk
   budget 256), (E) dense slots, (F) dense slots with fused mixed steps;
   `audit()` after every step.  Checks A == B == C == D and E == F,
   prefix hits, hit tokens, prefill tokens and copies as the trace's
   construction gives them, fewer peak pages with sharing, every page
   back after `clear_prefix_cache()`, 24 + 24 kernel launches per fused
   mixed forward, no plain-version call, and replays a fused mixed step's
   launches of both kernels, a tail prefill at offset 256 over shared
   pages and a paired chunk wave against the plain versions.  Prints each
   run's wall and tokens/s, the step admitting the long prompt in B
   against the longest step while it is chunked in C, and a profile of
   one fused mixed step with kernels 1 and 2's bounds.  Then serves A and
   C once more at the paper's fidelity (behavioral attention, 6-bit ADC)
   and checks A == C there too.
11. Serves, with the phase 6 weights cut to their first 6 layers
   (CUT_DEPTH) at decode_block_k 16, a 16-request
   trace (prompts of 48-400 tokens, 12 of them a repeated motif before a
   random tail; budgets 32-96) through 8 slots of 1,024 tokens on the
   paged pool, seven ways: greedy (G), + speculation with draft_len 4
   (H), + fused mixed steps (I), sampled at temperature 0.8, top_k 50,
   top_p 0.95 under PRNGKey(7) (J), + fused mixed steps (K), +
   speculation (L, served twice); `audit()` after every step.  Checks
   G == H == I, J == K, L == L2, fewer forwards with speculation and
   drafts accepted, kernel 2 launched with verify rows (Sq > 1), no
   plain-version call, and replays a served speculative step's launches
   of both kernels against the plain versions.  Prints each run's wall,
   tokens/s, forwards, tokens per forward and accept rate; profiles one
   sampled speculative step (busy share, kernels 1 and 2's us per launch
   beside their bounds) and times the sampler alone on its logits.
12. Serves, with the phase 6 weights cut to their first 6 layers
   (CUT_DEPTH) at decode_block_k 16, a 16-request
   trace (prompts of 64-384 tokens, budgets 48-128, seed 12) through 8
   slots of 1,024 tokens on 16-token pages, five ways: (U) the unstarved
   pool of 513 pages, (R) a starved pool of 112 pages + the trash page
   with recompute evictions, (S) that pool spilling evicted slots to a
   host victim pool of 256 pages, (C) the victim pool capped at 16 pages
   (spills and recompute fallbacks mix), (F) S under a fault plan (forced
   evictions, failed allocations, delayed restores, refcount corruptions,
   one NaN poison) with a late request of ttl 2 steps; `audit()` after
   every step.  Checks S == U token for token, R and C equal to U but
   where a recompute continuation parts after its re-prefill (printing
   where; the reference's continuations do the same), in F
   every request but the poisoned one (a prefix) equal to U and the late
   one shed, the counts of spills, restores, fallbacks, spill bytes,
   fired faults and detected corruptions, every page back and the victim
   pool empty, no plain-version call; replays kernel 2's launch on the
   first decode after a restore and kernel 1's on a recompute
   continuation's re-prefill against the plain versions.  Prints each
   run's wall, tokens/s, evictions, spills, restores and peak pages, the
   device time of each spill and restore (per page, GB/s), R's and S's
   longest steps, and a profile of a step that restores (kernels 1 and
   2's us per launch beside their bounds).
13. Serves, with the phase 6 weights cut to their first 6 layers
   (CUT_DEPTH) at decode_block_k 16 and kv_bits=4 (the Scheduler rebuilds
   the model: 16-token pages of 104,448 bytes against 202,752 at int8),
   the first 8 requests of phase 12's trace
   through 8 slots of 1,024 tokens: (P4) the default pool, counting
   kernel launches over 4-bit pages and replaying an admission wave's
   kernel 1 and a decode's kernel 2 against the plain versions, with one
   profiled step (the admission wave and a decode chunk: kernels 1 and 2's
   us per launch beside bounds that count 4-bit bytes); (D4) dense slots
   against the pool on the prompts cut to one page, where both run the
   same tiles; (S4) phase 12's starved pool spilling to a host victim
   pool with page checksums, the spill and restore timed; (B4) S4 with
   one byte of a spilled page flipped on the host; (C4) S4 with a
   snapshot every 2 steps, crashed at the step after a snapshot that
   holds a victim record and restored by a fresh scheduler (bytes on
   disk, write and restore times); (L4) P4 with fused mixed steps
   (chunk budget 256) under the SLA ladder at a 12.5 ms target (the 50
   ms of the 24-layer model scaled by the step time's 6 / 24) on the real
   clock, then idle steps.  Checks D4 == P4, S4 == P4, C4 == S4 and
   L4 == P4 token for token, B4's flip detected and its request
   recomputed (equal to P4 up to its re-prefill, the others equal), the
   ladder climbing every rung under load and releasing each once idle,
   `audit()` after every step and no plain-version call.
14. Mixture-of-Experts serving.  (a) Holds kernel 3's expert launch, one
   launch for a stack of E products (E, M, K) x (E, K, N), against its
   plain version and against E single launches, bit for bit, in both ADC
   modes: deepseek-moe-16b's routed experts (E 64, M 1, 5, 60 and 240,
   K 2048 -> N 1408 and K 1408 -> N 2048), its shared ones (E 2, M 4 and
   512) and dbrx-132b's (E 16, M 160, K 6144 -> N 10752); times each beside
   its bound and a loop of E `torch._int_mm` calls (a yardstick the port
   never calls).  (b) Serves deepseek-moe-16b at its published widths and
   full depth (28 layers: a dense prefix layer, 27 MoE layers of 64 routed
   experts top-6 and 2 shared; random weights from seed 0, deployed one
   expert at a time) on the classic request, counting launches (kernel
   3's expert launch 6 times a MoE layer and forward), replaying served
   launches of kernels 1-3 against their plain versions, profiling it
   (busy share, kernels 1-3's us per launch beside their bounds) and
   splitting a MoE layer's device time into router, dispatch, experts and
   combine; dense == paged streams on the request's prompts cut to one
   page, where both run the same tiles and the same batch (so the same
   routing).  (c) Serves 8 requests of phase 7's trace through the
   Scheduler on the paged pool with `audit()` every step.  (d) One prefill
   forward at the paper's fidelity (every linear through the 6-bit ADC:
   the experts through the expert launch's ADC mode).  (e) Serves
   dbrx-132b's first 4 of 40 layers at full width (48 q heads over 8 KV
   heads, 16 experts top-4): the request's prefill and 8 decode tokens,
   replayed, profiled and split as in (b).
15. The Griffin family at published widths and full depth, random
   weights from seed 0, bf16, int8 KV, the kernel path at the ideal ADC,
   decode_block_k 16.  gemma-7b (28 layers, d_model 3,072, 16/16 heads of
   256, GeGLU d_ff 24,576, vocab 256,000, tied): the classic request
   (28 kernel-1 and 31 x 28 kernel-2 launches, no plain-version call,
   served launches replayed), its 8-token cut profiled, dense == paged on
   one-page prompts, 8 requests of phase 7's trace through the paged
   Scheduler with every page back, a paper-fidelity request (prompt 128,
   4 new tokens: kernel 3 in every linear, kernel 4 at head_dim 256).
   recurrentgemma-9b (26 RG-LRU and 12 local-attention layers, lru_width
   4,096, 16 q heads over 1 KV head of 256, window 2,048): (a) batch 2,
   prompts of 2,304 tokens, 32 new tokens, over rings of 2,048 slots: 12
   windowed kernel-1 launches in the prefill (the iteration map skips the
   blocks before the window), 12 kernel-4 launches and no kernel 2 a
   decode forward, a served ring-decode kernel-4 launch replayed bit for
   bit, the cut profiled; (c) the reference's prefill / prefill + one
   ring-decode identity at full width within rel 0.05 (behavioral path;
   the kernel path's value printed); (b) the classic request at max_len
   160 (no ring: kernel 2 with the window at q_per_kv 16), profiled; the
   device time of an RG-LRU layer and a ring-attention layer at prefill
   and decode; a paper-fidelity request.
16. phi-3-vision-4.2b at published widths and full depth (32 layers,
   d_model 3,072, 32/32 heads of 96, SwiGLU d_ff 8,192, vocab 32,064, 576
   image patches), random weights from seed 0, bf16, int8 KV, the kernel
   path at the ideal ADC, decode_block_k 16: the image moves the prefill's
   input embedding at every position below 576 and none after it; the
   classic request (batch 4, a 640-token prompt from `make_batch` with its
   (4, 576, 3,072) image embeddings, 32 new tokens: 32 kernel-1 and 31 x
   32 kernel-2 launches, no plain-version call, served launches replayed),
   its 8-token cut profiled, dense == paged on one-page prompts (text
   only), 8 requests of phase 7's trace through the paged Scheduler over an
   int8 and a 4-bit pool with every page back, a paper-fidelity request
   with the image (4 new tokens: kernel 3 in every linear, `img_proj` at M
   2,304 included, kernel 4 at head_dim 96).
17. whisper-tiny: (a) kernels 1 and 2 at its heads (6/6 of 64, batch 4)
   against their plain versions and timed beside their bounds and
   non-causal bf16 SDPA: kernel 1 not causal at Sq 32 and 448 over the
   1,500-token cross cache, kernel 2 not causal over it at block_k 256
   (int8 and 4-bit; the query's offset bounds nothing) and causal at
   kv_len 4096; (b) whisper-tiny at published widths and full depth (4
   encoder and 4 decoder layers, d_model 384, 6/6 heads of 64, GELU d_ff
   1,536, layernorm, absolute positions, vocab 51,865), random weights from
   seed 0, bf16, int8 KV, the kernel path: the encoder timed, the cross
   K/V planes unchanged by decode steps, the classic request (batch 4,
   1,500 frames and a 32-token prompt from `make_batch`, 96 new tokens: 4
   + 4 kernel-1 launches a prefill, 4 + 4 kernel-2 launches a decode
   forward, no plain-version call, a served launch of each of the four
   attention dispatches replayed), its 8-token cut profiled; (c) the
   request at the paper's fidelity (4 new tokens: kernel 3 in every
   linear, the encoder's at M 6,000 included, kernel 4 on self rows and on
   cross rows of 1,500 positions, launches counted and replayed bit for
   bit), and the Scheduler refusing the arch.
18. xlstm-1.3b: (c) kernel 3 at M 4 on its linears (2048 -> 4096, 4096 ->
   4096, 4096 -> 2048) in both ADC modes, bit for bit and timed beside
   its bounds and `torch._int_mm`; (a) xlstm-1.3b at published widths and
   full depth (42 mLSTM and 6 sLSTM layers, d_model 2,048, 4 heads; the
   mLSTM's inner width 4,096 in heads of 1,024; vocab 50,304), random
   weights from seed 0, bf16, the ideal ADC (no kernel of the port's: the
   PIM linears on cuBLAS's int8 GEMM): the classic request (batch 4, a
   1,100-token prompt, so the chunk scan runs a whole 1,024-step chunk
   and a padded one, 16 new tokens), its launches per forward and its
   8-token cut profiled; (d) one mLSTM and one sLSTM layer's device time
   at the prefill and at decode; (e) token 1,100's logits from one
   prefill against a prefill of 1,099 and a decode step, within 0.05 at
   one 7:1 repetition (8 layers), printed at 48; (b) the request at the
   paper's fidelity (4 new tokens: kernel 3 in all 264 linears of a
   forward, served launches replayed bit for bit), and the Scheduler
   refusing the arch.
19. Training: (a) internlm2-1.8b at full width and depth, float32
   master weights from a CUDA generator (seed 0), bf16 compute, the 6-bit
   ADC, per-block remat: 3 AdamW steps (lr 3e-4, warmup 1) of `lm_batch`
   at 4 x 1,025 tokens (the chunked CE's two chunks of 512), each with
   336 kernel-3 launches (168 PIM linears a forward and again in the
   recompute) and no plain-version call, finite losses and grad norms,
   the parameters moved; step 0's first 7 kernel-3 launches (layer 0's
   forward: every K x N of the stack at M 4,100) replayed against its
   plain version bit for bit, then timed (kernel 3's us per launch at M
   4,100, the mean of the 7, beside its mean bound over a step's
   launches); step ms, training tokens/s, peak memory; a fourth step under
   torch.profiler (busy share, the step's top device kernels).  (b) Its first 2 layers at batch 1 x 129: the loss
   and every gradient through kernel 3 equal those through its plain
   version on the card bit for bit (deterministic algorithms on).  (c)
   SMOKE, 50 steps at lr 1e-2 lower the loss by 0.5 in both ADC modes;
   each trained tree, deployed, serves 8 tokens on kernels 1 and 2.  (d)
   The train CLI at SMOKE with a crash injected at step 7 ends bit for
   bit where an uninterrupted run ends.
20. Training of MoE, encoder-decoder and image-patch stacks: (a)
   deepseek-moe-16b at full width, cut to its dense layer and first two
   MoE layers (d_model 2,048, 16/16 heads of 128, 64 routed experts top-6
   and 2 shared of d_ff 1,408, vocab 102,400), float32 master weights
   from a CUDA generator (seed 0), bf16, the 6-bit ADC, per-block remat:
   3 AdamW steps (lr 3e-4, warmup 1) of `make_batch` at 4 x 1,025 tokens,
   each with 47 kernel-3 launches (the dense layer's 7 once; a MoE
   layer's 4 attention linears and 6 expert stacks, routed at E 64 M 481
   and shared at E 2 M 4,100, twice with the recompute) and no
   plain-version call, finite losses, aux terms and grad norms, the
   router, every stack and the dense layer moved; step 0's dense, routed
   and shared launches replayed against kernel 3's plain version bit for
   bit and timed beside their bounds; step ms, training tokens/s, peak
   memory, a profiled step's busy share.  (b) whisper-tiny at full width
   and depth (4 + 4 layers, d_model 384, 6/6 heads of 64, vocab 51,865),
   4 x 1,500 stub frames and 4 x 1,025 tokens a step: 104 kernel-3
   launches a step (the encoder's 24 once, 10 a decoder layer twice), the
   same checks and prints, the encoder and the cross wk / wv moved.  (c)
   deepseek's dense layer and first MoE layer at batch 1 x 129, then
   phi-3-vision-4.2b's first 2 layers at 1 x 641 with its 576 image
   patches (`img_proj` through kernel 3: 29 launches): the loss and
   every gradient through kernel 3 equal those through its plain version
   bit for bit (deterministic algorithms on).  (d) deepseek-moe-16b,
   dbrx-132b (at head_dim 32), whisper-tiny and phi-3-vision-4.2b SMOKE:
   50 steps at lr 1e-2 at the 6-bit ADC lower each loss by 0.5; each
   trained tree, deployed, serves 8 tokens on kernels 1 and 2 (whisper
   with its frames, phi-3 with its image), launches counted.
Phases 10-12 first run a row probe: RMSNorm, the bf16 unembed, the
top-k / top-p truncation, its softmax and the Gumbel arg-max must give a
row the same bits alone and among other rows (up to 40 = 8 slots x 5
verify columns).

Exits non-zero, printing no result, when there is no GPU or any check
fails.  The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint.checkpoint import flatten as ckpt_flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import PIMConfig  # noqa: E402
from repro_torch.core import attention as A  # noqa: E402
from repro_torch.core.attention import expected_kv_block_iters  # noqa: E402
from repro_torch.core.lut_softmax import build_exp_table, lut_softmax_codes  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.core import pim as core_pim  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import lut_softmax as sm_k  # noqa: E402
from repro_torch.kernels import pim_attention as attn_k  # noqa: E402
from repro_torch.kernels import pim_decode as dec_k  # noqa: E402
from repro_torch.kernels import pim_matmul as mm_k  # noqa: E402
from repro_torch.kernels.pim_attention import (  # noqa: E402
    pim_attention, pim_attention_plain)
from repro_torch.kernels.pim_decode import pim_decode, pim_decode_plain  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.runtime import serve_lib  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 tensor-core
# ops/s, float32 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_OPS = 67e12
# |kernel - plain| <= REL_TOL * max|plain|: the two reorder float32 sums of
# LUT exps times dequantized V (score codes and block sums are exact)
REL_TOL = 1e-5


PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20)
# what a phase needs run first: kernel entries (2, 8) or the small model (4)
NEEDS = {3: {2}, 5: {4}, 6: {2}, 7: {2}, 9: {8}}


class CheckFailed(SystemExit):
    pass


T0 = time.perf_counter()
# s of idle host time before and after the profiled calls, by attempt: late
# in the script the profiler dropped some or all device events of short
# sessions, and a retry gives the session more room at its edges
PROFILE_PADS = (0.0, 0.05, 0.2, 0.5)
# the measurements that no padded profile saw, timed with CUDA events instead
EVENT_TIMED = []


def stamp(what: str) -> None:
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(f"chip_smoke: check failed: {what}")


def sass_imma(name: str) -> dict:
    """{kernel: (IMMA, MUFU.RCP, all) instruction counts} in the SASS of the
    built library `name`, from the toolkit's cuobjdump ({} without it)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"  no cuobjdump beside nvcc: SASS of {name} not counted")
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += "IMMA" in line
            counts[fn][1] += "MUFU.RCP" in line
            counts[fn][2] += line.strip().startswith("/*") and ";" in line
    for fn, (imma, rcp, n) in counts.items():
        print(f"  SASS {name}: {imma} IMMA, {rcp} MUFU.RCP, {n} instructions in {fn[:96]}")
    check(bool(counts) and all(c[0] > 0 for c in counts.values()),
          f"every {name} kernel runs on the tensor cores (IMMA in its SASS)")
    return counts


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(events) -> dict:
    """{device kernel or copy: (self device us, count)} of a profile's
    `key_averages()`."""
    return {e.key: (e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def raw_device_us(prof) -> tuple:
    """(`device_us`, cudaLaunchKernel calls) of a profile read from its raw
    events: `key_averages()` builds a tree of every host event first, which
    took 40-50 s over a served step of 70,000 launches."""
    times, host = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                us, n = times.get(e.name(), (0.0, 0))
                times[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
        elif e.name() == "cudaLaunchKernel":
            host += 1
    return times, host


def check_raw_reader(prof) -> None:
    """`raw_device_us` of a short profile against its `key_averages()`:
    the same kernels, launches and (to float rounding) device time."""
    raw, host = raw_device_us(prof)
    events = prof.key_averages()
    avg = device_us(events)
    ok = (raw.keys() == avg.keys() and all(raw[k][1] == avg[k][1] for k in raw)
          and all(abs(raw[k][0] - avg[k][0]) <= 1e-3 * max(avg[k][0], 1.0) for k in raw)
          and host == sum(e.count for e in events if e.key == "cudaLaunchKernel"))
    check(ok, f"the raw profile reader equals key_averages() ({len(raw)} device "
          f"kernels, {sum(n for _, n in raw.values())} launches, {host} cudaLaunchKernel)")


def kernel_us(times: dict, kernel: str):
    """(device us, launches) of the device kernel named `kernel` (any
    template instance)."""
    hits = [v for k, v in times.items() if f"{kernel}(" in k or f"{kernel}<" in k]
    return sum(us for us, _ in hits), sum(n for _, n in hits)


def profiled(fn, iters: int, check_reader: bool = False, pad_s: float = 0.0) -> dict:
    """`device_us` of `iters` calls of `fn`, after one warm-up call, with
    `pad_s` idle before and after the calls inside the session (with
    `check_reader`, the raw reader held against `key_averages()`)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    if check_reader:
        check_raw_reader(prof)
    return raw_device_us(prof)[0]


def profiled_until(fn, iters: int, seen, what: str):
    """`profiled(fn, iters)` once `seen(times)` holds, the session padded
    more at each attempt (`PROFILE_PADS`); None if no attempt saw it."""
    for pad in PROFILE_PADS:
        times = profiled(fn, iters, pad_s=pad)
        if seen(times):
            return times
        print(f"  profiler ({pad} s idle at the edges) missed {what}: profiling again",
              flush=True)
    return None


def event_timed(fn, iters: int, what: str) -> float:
    """ms per call of `fn` from CUDA events, for a measurement that no
    padded profile saw (kept in `EVENT_TIMED`): the wall of back-to-back
    calls, launch gaps and every kernel of a call included."""
    ms = cuda_ms(fn, iters)
    EVENT_TIMED.append(what)
    print(f"  {what}: no profile saw it; {ms:.4f} ms per call from CUDA events",
          flush=True)
    return ms


def device_ms(fn, iters: int, what: str = "a call's device work") -> float:
    """Summed device ms per call of `iters` calls of `fn`, profiled again
    (`profiled_until`) while the profiler sees fewer device kernels than
    calls (every call launches one at least; a session that dropped most
    of its events once gave a bf16 SDPA yardstick of 0.1 us), or
    `event_timed` where no padded profile saw them."""
    def seen(t):
        kernels = sum(n for k, (_, n) in t.items()
                      if not k.startswith(("Memcpy", "Memset")))
        return per_call_ms(t, iters) > 0 and kernels >= iters

    times = profiled_until(fn, iters, seen, f"a device kernel of each call of {what}")
    if times is None:
        return event_timed(fn, iters, what)
    return per_call_ms(times, iters)


def others(times: dict, kernel: str) -> dict:
    """{device kernel: launches} of a profile's kernels other than `kernel`
    (memory copies and sets left out)."""
    return {k[:48]: c for k, (_, c) in times.items()
            if f"{kernel}(" not in k and f"{kernel}<" not in k
            and not k.startswith(("Memcpy", "Memset"))}


def per_call_ms(times: dict, iters: int) -> float:
    """Summed device time of a profile, per call."""
    return sum(us for us, _ in times.values()) / iters / 1e3


ATTENTION_KERNELS = (("pim_attention_kernel", "pim_attention"),
                     ("pim_decode_kernel", "pim_decode"))


class EventsDropped(Exception):
    """The profiler saw fewer of a kernel's launches than were made."""


def profile_report(prof, wall_s: float, prof_s: float, label: str,
                   launches: dict, kernel_names=ATTENTION_KERNELS,
                   last: bool = True) -> dict:
    """Print where a profiled run's device time went: busy share of the
    unprofiled wall `wall_s` of the same run, each (device kernel, wrapper)
    of `kernel_names`' device time per launch and the top device kernels.
    `launches` are the wrapper counts of the profiled run: the profiler must
    see one device kernel per wrapper call.  Where it saw fewer (it can drop
    a few events of a long run), raises EventsDropped unless `last`."""
    stamp(f"profile of the {label} taken")
    times, host_launches = raw_device_us(prof)
    stamp("profile read")
    for kernel, wrapper in kernel_names:
        n, made = kernel_us(times, kernel)[1], launches.get(wrapper, 0)
        if n < made and not last:
            raise EventsDropped(f"the profiler saw {n} of {made} {kernel} launches")
    busy_ms = sum(us for us, _ in times.values()) / 1e3
    n_dev = sum(n for _, n in times.values())
    print(f"  profiled {label}: device busy {busy_ms:.2f} ms = "
          f"{busy_ms / (wall_s * 1e3):.1%} of the unprofiled wall "
          f"{wall_s * 1e3:.1f} ms ({busy_ms / (prof_s * 1e3):.1%} of the "
          f"profiled wall {prof_s * 1e3:.1f} ms); {n_dev} device kernels and "
          f"copies, {host_launches} cudaLaunchKernel calls")
    kernels = {}
    for kernel, wrapper in kernel_names:
        us, n = kernel_us(times, kernel)
        made = launches.get(wrapper, 0)
        check(n > 0 and n == made, f"profiled {label}: one {kernel} per "
              f"{wrapper} call ({n} seen, {made} made)")
        kernels[kernel] = dict(device_us=us, count=n, us_per_launch=us / n,
                               launched=made)
        print(f"  {kernel}: {n} launches seen of {made} made, {us / 1e3:.3f} ms, "
              f"{us / n:.2f} us each")
        for key, (u, c) in times.items():
            if f"{kernel}(" in key or f"{kernel}<" in key:
                print(f"    {key[:64]}: {c} launches, {u / c:.2f} us each")
    print("  top device kernels and copies (ms, launches, us each):")
    for key, (u, c) in sorted(times.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {key[:64]}: {u / 1e3:.3f} ms, {c}, {u / c:.2f}")
    return dict(profiled_wall_ms=prof_s * 1e3, device_busy_ms=busy_ms,
                busy_share=busy_ms / (wall_s * 1e3), device_events=n_dev,
                host_launches=host_launches, kernels=kernels)


def profiled_report(prepare, run, label: str, wall_s: float,
                    kernel_names=ATTENTION_KERNELS, tries: int = 3) -> dict:
    """`profile_report` of `run(prepare())` under torch.profiler (only the
    run is timed and profiled), profiled again, up to `tries` times and
    padded as `profiled_until` pads, while the profiler drops some of its
    kernels' events."""
    for attempt, pad in enumerate(PROFILE_PADS[:tries], 1):
        state = prepare()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            run(state)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
            time.sleep(pad)
        try:
            return profile_report(prof, wall_s, prof_s, label, dict(_build.LAUNCHES),
                                  kernel_names, last=attempt == tries)
        except EventsDropped as e:
            print(f"  {e}: profiling again", flush=True)


def unprofiled_wall(prepare, run, recorder) -> tuple:
    """(what `recorder()` yields, wall s) of `run(prepare())` inside the
    context `recorder()`, unprofiled: the same work as `profiled_report`'s."""
    state = prepare()
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with recorder() as seen:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return seen, wall


def attention_bound(nbytes: int, pairs: int, Dh: int):
    """(ms, limit) of an attention call on the H100: `nbytes` over HBM,
    against 2 Dh int8 operations (scores) and 2 Dh float32 ones (PV) per
    unmasked (query, key) pair."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (2 * Dh * pairs / INT8_OPS + 2 * Dh * pairs / F32_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kv_token_bytes(cfg) -> int:
    """Bytes of one cached token and KV head as the cache stores it: K and
    V codes at `cfg.kv_bits` (two 4-bit codes a byte) and two f32 scales;
    2 Dh + 8 at int8, Dh + 8 at 4-bit."""
    return 2 * cfg.resolved_head_dim * cfg.kv_bits // 8 + 8


def decode_bound(kv_lens, q_lens, Sq: int, cfg):
    """(ms, limit) of one pim_decode call at a served shape: the K/V codes
    (at the cache's precision) and f32 scales of the rows that each slot
    with a query attends to (at most `cfg.window` of them), read once, q,
    its scales and the f32 output, against the pairs it scores."""
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    W = cfg.window or 1 << 62     # a windowed arch's layers all attend in the window
    live = [(min(kv, W), ql) for kv, ql in zip(kv_lens, q_lens) if ql > 0]
    nbytes = (sum(kv for kv, _ in live) * Hkv * kv_token_bytes(cfg)
              + len(kv_lens) * H * Sq * (Dh + 4 + 4 * Dh))
    return attention_bound(nbytes, sum(H * ql * kv for kv, ql in live), Dh)


def prefill_bound(offs, kv_lens, q_lens, Sq: int, causal: bool, cfg):
    """(ms, limit) of one pim_attention call at a served shape: bytes as
    `decode_bound`, against the causal pairs of each slot's valid query
    rows (row i at position offs + i sees min(kv_len, offs + i + 1)
    keys, of them the last `cfg.window` in a windowed arch), or, not
    causal (cross-attention), all kv_len keys for every valid row."""
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    live = [(o, kv, min(ql, Sq)) for o, kv, ql in zip(offs, kv_lens, q_lens) if ql > 0]
    nbytes = (sum(kv for _, kv, _ in live) * Hkv * kv_token_bytes(cfg)
              + len(kv_lens) * H * Sq * (Dh + 4 + 4 * Dh))
    pairs = sum(window_pairs(ql, o, kv, cfg.window) if causal else ql * kv
                for o, kv, ql in live)
    return attention_bound(nbytes, H * pairs, Dh)


@contextlib.contextmanager
def launch_shapes(cfg):
    """Within the block, both attention wrappers keep each launch's scalar
    table on the device (no host sync); after it, {wrapper: [([q_offset],
    [kv_len], [q_len], Sq, causal)]} of every launch, one slot per
    sequence."""
    mods = {"pim_attention": attn_k, "pim_decode": dec_k}
    seen = {name: [] for name in mods}
    for mod in mods.values():
        mod.SHAPES = []
    try:
        yield seen
    finally:
        kept = {name: mod.SHAPES for name, mod in mods.items()}
        for mod in mods.values():
            mod.SHAPES = None
    for name, launches in kept.items():
        for scalars, (BH, Sq, _), causal in launches:
            off, kv, ql = scalars.tolist()
            B = BH // cfg.num_heads
            if len(kv) == 1:   # int lengths: one column for the batch
                off, kv, ql = off * B, kv * B, ql * B
            seen[name].append((off[:B], kv[:B], ql[:B], Sq, causal))


def served_attention(entries, label: str, report: dict, shapes, cfg) -> dict:
    """Kernels 1 and 2's device us per launch of a profiled serving run
    beside their mean bounds over the same launches' shapes (those of the
    unprofiled run of the same work); returns {wrapper: (us, bound us)}."""
    out = {}
    for name, kernel, num in (("pim_attention", "pim_attention_kernel", 1),
                              ("pim_decode", "pim_decode_kernel", 2)):
        if not shapes[name]:
            continue
        bounds = [(prefill_bound(*s, cfg) if num == 1 else decode_bound(*s[1:4], cfg))[0]
                  * 1e3 for s in shapes[name]]
        us = report["kernels"][kernel]["us_per_launch"]
        b_us = sum(bounds) / len(bounds)
        if name in entries:
            entries[name].setdefault("served_us", {})[label] = us
            entries[name].setdefault("served_bound_us", {})[label] = b_us
        out[name] = (us, b_us)
        print(f"  kernel {num} on the {label}: {us:.2f} us per launch, bound "
              f"{b_us:.3f} us (mean over its {len(bounds)} calls' shapes), "
              f"{b_us / us:.1%} of it")
    return out


PAGE = 16     # tokens per KV page in phases 3, 5 and 7
CUT_DEPTH = 6   # layers of phases 10-13: their checks are identities
PROFILED_STEPS = 1   # scheduler steps of the paged trace under the profiler
PROFILED_TOKENS = 8  # new tokens of the classic request under the profiler


def random_table(lens, n_tables: int, seed: int, dev, holes: bool = False):
    """A (B, n_tables) int32 page table on `dev`: a random permutation of
    pages 1..P-1 (page 0 is the trash page), -1 past each row's pages and,
    with `holes`, at a random page inside each row of more than two pages.
    Returns (table, P)."""
    rng = np.random.RandomState(seed)
    P = len(lens) * n_tables + 1
    perm = rng.permutation(np.arange(1, P))
    pt = np.full((len(lens), n_tables), -1, np.int32)
    i = 0
    for b, n in enumerate(lens):
        k = -(-int(n) // PAGE)
        pt[b, :k] = perm[i:i + k]
        i += k
        if holes and k > 2:
            pt[b, rng.randint(1, k - 1)] = -1
    return torch.from_numpy(pt).to(dev), P


def run_audited(sched, trace):
    """Submit `trace` [(prompt, budget)], step the scheduler to the end with
    `audit()` after every step; returns the streams in trace order."""
    rids = [sched.submit(p, b) for p, b in trace]
    res = {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        for rid, toks in sched.step().items():
            res.setdefault(rid, []).extend(toks)
        sched.audit()
    return [res.get(r, []) for r in rids]


# ---- 3. the paged mode of both kernels --------------------------------------
def paged_kernels(dev, cfg, gen, compare, bound, entries) -> None:
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def operands(lens, Sq, S, kv_bits=8, seed=0, holes=False):
        """The same K/V in a paged pool (random table of PAGE-token pages,
        with `holes` unallocated pages inside the slots' ranges) and in a
        dense ragged cache of S tokens; returns (paged operands, table,
        dense operands, (B,) lengths)."""
        B = len(lens)
        lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        dense = A.init_kv_cache(B, S, Hkv, Dh, kv_bits=kv_bits, device=dev, ragged=True)
        A.cache_write_ragged(dense, k, v, zeros, pim_cfg, seq_lens=lens_d)
        pt, P = random_table(lens, S // PAGE, seed, dev, holes)
        pool = A.init_paged_kv_cache(P, PAGE, Hkv, Dh, kv_bits=kv_bits, device=dev)
        A.paged_cache_write(pool, k, v, zeros, pim_cfg, pt, seq_lens=lens_d)
        q_q, qs = ops._q_kernel_layout(q, pim_cfg.input_bits)
        return ((q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale), pt,
                ops.kernel_attention_layout(q, dense, pim_cfg.input_bits), lens_d)

    print("paged kernels vs plain versions and vs dense at block_k == "
          f"page size {PAGE}:", flush=True)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    for seed, lens in enumerate(([0, 15, 1000, 2048], [16, 17, 2048, 1000])):
        for what, Sq, kv_bits, kern, plain in (
                ("decode", 1, 8, pim_decode, pim_decode_plain),
                ("decode verify rows", 4, 8, pim_decode, pim_decode_plain),
                ("decode", 1, 4, pim_decode, pim_decode_plain),
                ("decode verify rows", 4, 4, pim_decode, pim_decode_plain),
                ("prefill ragged chunk", 128, 8, pim_attention, pim_attention_plain),
                ("prefill ragged chunk", 128, 4, pim_attention, pim_attention_plain)):
            paged, pt, dense, lens_d = operands(lens, Sq, 2048, kv_bits, seed)
            offs = torch.clamp(lens_d - Sq, min=0)
            ql = torch.clamp(lens_d, max=Sq)
            name = f"{what} paged Sq{Sq} kv{kv_bits} lens {lens}"
            o_k = kern(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw)
            compare(name, o_k, plain(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw))
            o_d = kern(*dense, offs, lens_d, q_len=ql, block_k=PAGE, **kw)
            check(torch.equal(o_k[0], o_d[0]) and torch.equal(o_k[1], o_d[1]),
                  f"{name}: paged == dense at block_k {PAGE}, bit for bit")
    # an unallocated page inside each slot's range (no record is written
    # for it): decode skips it as the plain version does, Sq 1 and verify
    # rows, several CTAs a head over the 128 pages of a 2048-token slot
    for Sq in (1, 4):
        lens = [40, 300, 2048, 1000]
        paged, pt, _, lens_d = operands(lens, Sq, 2048, seed=5 + Sq, holes=True)
        check(all(bool((pt[b, :-(-n // PAGE)] < 0).any()) for b, n in enumerate(lens)),
              "each slot's table has a hole inside its pages")
        offs, ql = lens_d - Sq, torch.clamp(lens_d, max=Sq)
        compare(f"decode paged Sq{Sq} holes inside the ranges, lens {lens}",
                pim_decode(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw),
                pim_decode_plain(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw))

    def paged_bytes(paged, pt):
        """Operand bytes the launch needs: q, its scales, the allocated
        pages of the four pool planes, the table and the f32 output."""
        q_q, qs = paged[:2]
        n_pages = int((pt >= 0).sum())
        pages = sum(t[0].numel() * t.element_size() for t in paged[2:]) * n_pages
        return (q_q.numel() + 4 * qs.numel() + pages + 4 * pt.numel()
                + 4 * q_q.numel())

    # the paged mode at the shapes phase 2 timed, for the same work
    B = 4
    paged, pt, _, lens_d = operands([512] * B, 512, 512, seed=2)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    compare("prefill paged timed shape Sq512",
            pim_attention(*paged, zeros, lens_d, page_table=pt, **kw),
            pim_attention_plain(*paged, zeros, lens_d, page_table=pt, **kw))
    fn = lambda: pim_attention(*paged, zeros, lens_d, pim_cfg, lut_cfg,  # noqa: E731
                               page_table=pt)
    us, n = kernel_us(profiled(fn, 20), "pim_attention_kernel")
    check(n == 20, f"profiler saw the 20 paged prefill launches ({n})")
    b_ms, _ = bound(paged_bytes(paged, pt), B * H * 512 * 513 // 2)
    entries["pim_attention"].update(paged_ms=us / 20 / 1e3, paged_bound_ms=b_ms)
    print(f"  paged prefill Sq512, device ms per call: kernel {us / 20 / 1e3:.4f} "
          f"(dense {entries['pim_attention']['ms']:.4f}), bound {b_ms:.4f}")

    kv = 4096
    paged, pt, _, lens_d = operands([kv] * B, 1, kv, seed=3)
    offs = lens_d - 1
    compare("decode paged timed shape kv_len 4096",
            pim_decode(*paged, offs, lens_d, page_table=pt, **kw),
            pim_decode_plain(*paged, offs, lens_d, page_table=pt, **kw))
    fn = lambda: pim_decode(*paged, offs, lens_d, pim_cfg, lut_cfg,  # noqa: E731
                            page_table=pt)
    times = profiled(fn, 50)
    us, n = kernel_us(times, "pim_decode_kernel")
    check(n == 50, f"profiler saw one pim_decode_kernel per paged decode call ({n} of 50)")
    print(f"  other device kernels of the 50 paged calls: {others(times, 'pim_decode_kernel')} "
          "(the wrapper stacks tensor scalars into one table)")
    b_ms, _ = bound(paged_bytes(paged, pt), B * H * kv)
    entries["pim_decode"].update(paged_ms=us / 50 / 1e3, paged_bound_ms=b_ms)
    print(f"  paged decode kv{kv}, device ms per call: kernel {us / 50 / 1e3:.4f} "
          f"(dense {entries['pim_decode']['ms']:.4f}), bound {b_ms:.4f}")

    # the same two shapes over 4-bit pages, beside the int8 times above
    for what, wrapper, kern, plain, Sq, S, iters, pairs, seed in (
            ("prefill paged timed shape Sq512 kv4", "pim_attention", pim_attention,
             pim_attention_plain, 512, 512, 20, B * H * 512 * 513 // 2, 2),
            ("decode paged timed shape kv_len 4096 kv4", "pim_decode", pim_decode,
             pim_decode_plain, 1, kv, 50, B * H * kv, 3)):
        paged, pt, _, lens_d = operands([S] * B, Sq, S, kv_bits=4, seed=seed)
        offs = lens_d - Sq
        compare(what, kern(*paged, offs, lens_d, page_table=pt, **kw),
                plain(*paged, offs, lens_d, page_table=pt, **kw))
        us, n = kernel_us(profiled(lambda: kern(*paged, offs, lens_d, pim_cfg, lut_cfg,
                                                page_table=pt), iters), wrapper + "_kernel")
        check(n == iters, f"{what}: the profiler saw its {iters} launches ({n})")
        b_ms, _ = bound(paged_bytes(paged, pt), pairs)
        entries[wrapper].update(paged_kv4_ms=us / iters / 1e3, paged_kv4_bound_ms=b_ms)
        print(f"  {what}, device ms per call: kernel {us / iters / 1e3:.4f} (int8 "
              f"{entries[wrapper]['paged_ms']:.4f}), bound {b_ms:.4f}")


# ---- 5. the Scheduler at small width on the card ----------------------------
def smoke_scheduler(dev, small, params) -> None:
    """Streams of the dense and the paged Scheduler against classic greedy
    generation, each request on its own.  The split-K partitions are one
    page wide, so that decode over dense slots and over pages does the same
    arithmetic bit for bit.  (With 8-token pages against 16-token
    partitions the LUT-domain rescales round differently, and this model's
    greedy stream flips at the fifth token of the first prompt.)  Prefill
    tiles still differ for prompts longer than a page (one 256-row block
    against 16-row pages)."""
    cfg = dataclasses.replace(small, decode_block_k=PAGE)
    model = build_model(cfg, dev)
    V = cfg.vocab_size
    print("scheduler at smoke width (float32, kernel path):", flush=True)

    def isolated(trace, max_len):
        return [serve_lib.greedy_generate(
            model, params, {"tokens": torch.tensor([p])}, b, max_len)[0].tolist()
                for p, b in trace]

    full = data.lm_batch(1, 4, 24, V)
    trace = [(full[i, :n].tolist(), b)
             for i, (n, b) in enumerate(zip([5, 17, 24, 9], [4, 7, 10, 13]))]
    ref = isolated(trace, 64)
    dense = run_audited(serve_lib.Scheduler(model, params, max_batch_slots=2,
                                            max_len=64), trace)
    check(dense == ref, "dense slots (2 slots, 4 mixed requests) == isolated greedy")
    sched = serve_lib.Scheduler(model, params, max_batch_slots=2, max_len=64,
                                page_size=PAGE, num_pages=9)
    paged = run_audited(sched, trace)
    check(paged == ref, "paged pool (9 pages) == isolated greedy; audit() after every step")
    check(len(sched.free_pages) == sched.num_pages - 1, "every page returned to the free list")

    full = data.lm_batch(4, 2, 30, V)
    trace = [(full[0].tolist(), 24), (full[1].tolist(), 8)]
    sched = serve_lib.Scheduler(model, params, max_batch_slots=2, max_len=64,
                                page_size=PAGE, num_pages=6, decode_chunk=8)
    starved = run_audited(sched, trace)
    check(sched.n_evictions >= 1, f"a starved pool (6 pages) evicted ({sched.n_evictions})")
    check(starved == isolated(trace, 64), "starved-pool streams == isolated greedy")
    check(len(sched.free_pages) == sched.num_pages - 1, "every page returned to the free list")

    toks = {"tokens": torch.from_numpy(data.lm_batch(0, 3, 8, V)).long()}
    classic = serve_lib.greedy_generate(model, params, toks, 6, 32)
    for ps in (0, PAGE):
        out = serve_lib.generate(model, params, toks, 6, 32,
                                 continuous_batching=True, page_size=ps)
        check(torch.equal(out, classic),
              f"generate(continuous_batching=True, page_size={ps}) == classic generate")


# ---- 7. the Scheduler at full width -----------------------------------------
def prefill_logits(model, params, prompts):
    """Logits of one admission wave of `prompts` (each at most 256 tokens)
    through dense slots (256-row KV tiles) and through the paged pool
    (16-row pages): returns (dense, paged), float32."""
    dev = model.device
    n = len(prompts)
    toks = np.zeros((n, 256), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks = torch.from_numpy(toks).long().to(dev)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(lens)
    pt = torch.arange(1, n * 16 + 1, dtype=torch.int32, device=dev).view(n, 16)
    with torch.inference_mode():
        ld, _ = model.forward_serve(params, {"tokens": toks},
                                    model.init_cache(n, 256, ragged=True),
                                    zeros, seq_lens=lens)
        lp, _ = model.forward_serve(params, {"tokens": toks},
                                    model.init_cache(n, 256, page_size=PAGE,
                                                     num_pages=n * 16 + 1),
                                    zeros, seq_lens=lens, pages=pt)
    return ld.float(), lp.float()


@contextlib.contextmanager
def recorded(pick, targets=None, by_sq=None):
    """Within the block, keeps copies of the operands of the serving path's
    kernel launches that `pick(name, index)` labels (name a key of
    `targets`, {name: (module, attribute)} of the wrappers the path calls,
    by default the attention wrappers of `ops`; index of the launch among
    that wrapper's in the block): yields {label: (name, args, kwargs)}.  The
    copies are taken at launch, since the scheduler writes its cache in
    place afterwards.  A dict `by_sq` counts every launch by (name, the
    query rows Sq of its first operand)."""
    def copied(x):
        """A copy of a tensor operand in its layout: a broadcast (stride 0)
        dim stays a broadcast of the copied storage."""
        if not isinstance(x, torch.Tensor):
            return x
        if 0 not in x.stride():
            return x.clone()
        one = tuple(slice(0, 1) if st == 0 else slice(None) for st in x.stride())
        return x[one].clone().expand(x.shape)

    kept, counts, wrapped = {}, {}, {}

    def wrap(name, fn):
        def launch(*args, **kw):
            i = counts[name] = counts.get(name, -1) + 1
            if by_sq is not None:
                key = (name, int(args[0].shape[-2]))
                by_sq[key] = by_sq.get(key, 0) + 1
            label = pick(name, i)
            if label:
                kept[label] = (name, tuple(copied(a) for a in args),
                               {k: copied(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return launch

    if targets is None:
        targets = {name: (ops, name) for name in ("pim_attention", "pim_decode")}
    for name, (mod, attr) in targets.items():
        wrapped[name] = getattr(mod, attr)
        setattr(mod, attr, wrap(name, wrapped[name]))
    try:
        yield kept
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, wrapped[name])


def replay_served(storage: str, kept: dict, compare,
                  need=("pim_attention", "pim_decode")) -> None:
    """Hold each recorded launch of the `storage` scheduler run against the
    kernel's plain version on the same operands (REL_TOL, iteration maps
    equal); launches of each kernel of `need` must have been recorded."""
    plain = {"pim_attention": (pim_attention, pim_attention_plain),
             "pim_decode": (pim_decode, pim_decode_plain)}
    for name in need:
        check(any(n == name for n, _, _ in kept.values()),
              f"{storage}: recorded served launches of {name}")
    for label, (name, args, kw) in kept.items():
        kern, ref = plain[name]
        ql = kw.get("q_len")
        what = (f"{'prefill' if name == 'pim_attention' else 'decode'} served "
                f"by the {storage} scheduler, {label}: Sq {args[0].shape[1]}, "
                f"kv_len {torch.as_tensor(args[7]).tolist()}, q_len "
                f"{None if ql is None else ql.tolist()}")
        compare(what, kern(*args, **kw, return_iters=True),
                ref(*args, **kw, return_iters=True))


SCHED_KW = dict(max_batch_slots=8, max_len=512, decode_chunk=8)


def sched_trace(V: int):
    """The 16-request trace of phases 7 and 9: prompts of 16-256 tokens and
    budgets of 16-64 drawn from seed 0 (one prompt a whole number of pages).
    Returns (trace [(prompt, budget)], prompt lengths, budgets)."""
    rng = np.random.RandomState(0)
    n_req = 16
    lens = rng.randint(16, 257, n_req)
    if not (lens % PAGE == 0).any():
        lens[0] = PAGE * max(1, lens[0] // PAGE)
    budgets = rng.randint(16, 65, n_req)
    toks = data.lm_batch(0, n_req, 256, V)
    trace = [(toks[i, :n].tolist(), int(b)) for i, (n, b) in enumerate(zip(lens, budgets))]
    return trace, lens, budgets


def full_scheduler(model, params, cfg, entries, compare) -> dict:
    V = cfg.vocab_size
    trace, lens, budgets = sched_trace(V)
    n_req = len(trace)
    n_tok = int(budgets.sum())
    kw = SCHED_KW
    print(f"scheduler at full width: {n_req} requests, prompts {lens.tolist()}, "
          f"budgets {budgets.tolist()} ({n_tok} tokens), {kw}", flush=True)

    L = cfg.num_layers

    def pick(name, i):
        """Every admission wave's prefill (at a layer that moves with the
        wave) and three decode forwards: early, mid-trace and late, when
        slots have retired."""
        if name == "pim_attention":
            return f"wave {i // L + 1} layer {i % L}" if i % L == (i // L * 7) % L else None
        for f in (2, 40, 80):
            if i == f * L + f % L:
                return f"decode forward {f + 1} layer {f % L}"
        return None

    def serve(record=False, **extra):
        sched = serve_lib.Scheduler(model, params, **kw, **extra)
        rids = [sched.submit(p, b) for p, b in trace]
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with recorded(pick) if record else contextlib.nullcontext({}) as kept, \
                plain_calls() as n_plain:
            t0 = time.perf_counter()
            res = sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check(not n_plain, f"{'paged' if extra else 'dense'}: no plain-version call "
              f"on the path ({n_plain})")
        check(launches.get("pim_attention", 0) % L == 0,
              f"{'paged' if extra else 'dense'}: {L} prefill launches per prefill forward")
        if record:
            replay_served("paged" if extra else "dense", kept, compare)
        streams = [res.get(r, []) for r in rids]
        check(all(len(s) == b for s, (_, b) in zip(streams, trace))
              and all(0 <= t < V for s in streams for t in s),
              f"{'paged' if extra else 'dense'}: every request got its budget "
              "of in-vocabulary tokens")
        for name in ("pim_attention", "pim_decode"):
            check(launches.get(name, 0) > 0,
                  f"{'paged' if extra else 'dense'} scheduler launched {name}")
        sched.audit()
        st = sched.stats
        info = dict(wall_s=wall, tokens_per_s=n_tok / wall,
                    ms_per_step=wall / st["steps"] * 1e3, steps=st["steps"],
                    model_steps=st["model_steps"], evictions=st["evictions"],
                    launches=launches)
        if extra:
            check(len(sched.free_pages) == sched.num_pages - 1,
                  "paged: every page returned to the free list")
            info.update(peak_pages_in_use=sched.peak_pages_in_use,
                        num_pages=sched.num_pages)
        print(f"  {'paged' if extra else 'dense'}: {wall:.2f} s, "
              f"{n_tok / wall:.1f} tokens/s, {info['ms_per_step']:.1f} ms per "
              f"scheduler step ({st['steps']} steps, {st['model_steps']} "
              f"forwards), launches {launches}"
              + (f", peak pages {sched.peak_pages_in_use} of "
                 f"{sched.num_pages - 1}" if extra else ""), flush=True)
        return streams, info

    # the dense run and the second paged run keep copies of some launches'
    # operands and replay them against the plain versions after the run;
    # the first paged run is the clean one for timing
    dense, dense_info = serve(record=True)
    paged, paged_info = serve(page_size=PAGE)
    again, _ = serve(record=True, page_size=PAGE)
    check(again == paged, "a second paged run gives identical streams")
    agree = sum(a == b for a, b in zip(dense, paged))
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
                  for a, b in zip(dense, paged)]
    print(f"  dense and paged streams agree on {agree} of {n_req} requests "
          "(256-row tiles and 16-row pages round the LUT rescales "
          f"differently); first differing token per request: {first_diff}")
    # prompts of one page run the same tiles on both storages
    ld, lp = prefill_logits(model, params, [p[:PAGE] for p, _ in trace[:8]])
    check(torch.equal(ld, lp), f"prompts of {PAGE} tokens: dense and paged "
          "prefill logits equal bit for bit")
    ld, lp = prefill_logits(model, params, [p for p, _ in trace[:8]])
    span = ld.amax(-1) - ld.amin(-1)
    top2 = torch.topk(ld, 2, dim=-1).values
    diff = ((lp - ld).abs().amax(-1) / span).tolist()
    gap = ((top2[:, 0] - top2[:, 1]) / span).tolist()
    print("  first 8 prompts, dense vs paged prefill logits: largest "
          f"difference per row {[round(x, 5) for x in diff]}, top-2 gap per "
          f"row {[round(x, 5) for x in gap]} (shares of the row's logit "
          f"range); argmax agrees on {int((ld.argmax(-1) == lp.argmax(-1)).sum())}"
          " of 8", flush=True)
    for name in ("pim_attention", "pim_decode"):
        entries[name]["dense_sched_launches"] = dense_info["launches"].get(name, 0)
        entries[name]["paged_launches"] = paged_info["launches"].get(name, 0)

    # the profiler's summary costs about 0.6 ms of host time per launch, so
    # it covers the first PROFILED_STEPS steps, an admission wave and a
    # decode chunk (both runs of them are the same work: the trace and the
    # scheduler are deterministic); three steps took 110 s of the limit
    def submitted():
        sched = serve_lib.Scheduler(model, params, page_size=PAGE, **kw)
        for p, b in trace:
            sched.submit(p, b)
        return sched

    def steps(sched):
        for _ in range(PROFILED_STEPS):
            sched.step()

    shapes, wall = unprofiled_wall(submitted, steps, lambda: launch_shapes(cfg))
    paged_info["profile"] = profiled_report(
        submitted, steps, f"first {PROFILED_STEPS} steps of the paged trace", wall)
    served_attention(entries, "trace", paged_info["profile"], shapes, cfg)
    return dict(dense=dense_info, paged=paged_info, agree=agree,
                prompts=lens.tolist(), budgets=budgets.tolist())


# ---- 10. prefix sharing and mixed steps at full width ----------------------
MIX_KW = dict(max_batch_slots=8, max_len=1536, decode_chunk=8)
MIX_BUDGET = 256     # prefill_chunk_budget of the mixed runs
SYSTEM = 256         # tokens of the shared system prompt (16 pages)
LONG = 1024          # the long prompt, submitted after LONG_AT steps
LONG_AT = 3
REC_LAYER = 5        # the layer whose launches the replays keep


def mixed_trace(V: int):
    """Phase 10's trace, from seed 10: 12 requests open with one 256-token
    system prompt and go on with distinct tails of 16-200 tokens, two
    pairs of them with equal page-aligned prompts (tails of 48 and 96
    tokens); 3 prompts of 32-256 tokens share nothing.  A 1,024-token
    prompt comes later.  Budgets 16-48.  Returns (trace [(prompt,
    budget)], the late (prompt, budget), prefix hits and hit tokens that
    sharing must give)."""
    rng = np.random.RandomState(10)
    toks = data.lm_batch(10, 16, LONG, V)
    system = toks[0, :SYSTEM].tolist()
    tails = rng.randint(16, 201, 8)
    shared = [system + toks[1 + i, :n].tolist() for i, n in enumerate(tails)]
    twins = [system + toks[9, :48].tolist(), system + toks[10, :96].tolist()]
    alone = [toks[11 + i, :n].tolist() for i, n in enumerate(rng.randint(32, 257, 3))]
    prompts = [shared[0], shared[1], twins[0], shared[2], alone[0], twins[0],
               shared[3], twins[1], shared[4], alone[1], shared[5], twins[1],
               shared[6], alone[2], shared[7]]
    budgets = rng.randint(16, 49, len(prompts) + 1)
    trace = [(p, int(b)) for p, b in zip(prompts, budgets)]
    # every system-prompt request but the first maps the 16 system pages;
    # a twin's second copy maps its whole prompt and re-runs the last token
    hits = 11
    hit_tokens = 9 * SYSTEM + sum(len(t) - 1 for t in twins)
    return trace, (toks[14, :LONG].tolist(), int(budgets[-1])), hits, hit_tokens


def serve_steps(sched, trace, late):
    """Submit `trace`, step with `audit()` after every step, submit `late`
    after LONG_AT steps.  Returns (streams in trace order + late, per-step
    (wall s, rids emitting, whether the late request was prefilling))."""
    rids = [sched.submit(p, b) for p, b in trace]
    res, steps = {}, []

    def long_filling():
        return len(rids) > len(trace) and any(
            r is not None and r.rid == rids[-1] and sched.prefilling[b]
            for b, r in enumerate(sched.slot_req))

    while sched.queue or any(r is not None for r in sched.slot_req) or len(rids) == len(trace):
        if len(steps) == LONG_AT:
            rids.append(sched.submit(*late))
        before = long_filling()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em = sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps.append((wall, set(em), before or long_filling()))
        for rid, toks in em.items():
            res.setdefault(rid, []).extend(toks)
        sched.audit()
    return [res.get(r, []) for r in rids], steps, rids[-1]


@contextlib.contextmanager
def armed_recording(ctx, label_of, names=("mixed_step", "paged_prefill")):
    """Wrap the scheduler's device steps `names` of `serve_lib`: the first
    call for which `label_of(fn name, args)` gives a label records its
    REC_LAYER launches of both attention wrappers (through `recorded`)."""
    saved = {n: getattr(serve_lib, n) for n in names}

    def wrap(name):
        def call(*a, **k):
            label = None if ctx["done"] else label_of(name, a)
            if label:
                ctx.update(label=label, first={}, done=True)
            try:
                return saved[name](*a, **k)
            finally:
                ctx["label"] = None
        return call

    for n in saved:
        setattr(serve_lib, n, wrap(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(serve_lib, n, f)


PROBE_ROWS = (3, 8, 40)   # 40 = n * P at 8 slots and P = draft_len + 1


def rows_apart(fn, ns=PROBE_ROWS) -> list:
    """How many of the first 8 rows get other bits from the row-wise op
    `fn(lo, hi)` (its output for rows lo..hi - 1) alone than among the
    first n rows, for each n of `ns`."""
    alone = torch.cat([fn(i, i + 1) for i in range(8)])
    return [int((fn(0, n)[:8] != alone[:min(n, 8)]).flatten(1).any(-1).sum())
            for n in ns]


def row_probe(model, params, cfg) -> dict:
    """Whether a row's bits depend on the rows beside it, for the ops that
    see a served row among other row counts in phases 10-11: RMSNorm
    (`layers.norm_apply`, and torch's own mean beside it) over 8 rows
    against the same rows among 1, 64 and 2048; and, alone against among
    3, 8 and 40 rows, the unembed (bf16 and float32), the top-k / top-p
    truncation, its
    softmax and the Gumbel arg-max of the sampler (with torch's own cumsum
    beside the truncation's, which the sampler does not use)."""
    from repro_torch.models import layers as Lm
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(2048, cfg.d_model, generator=gen, device=dev)
         * torch.rand(2048, 1, generator=gen, device=dev) * 8).to(torch.bfloat16)
    scale = params["final_norm"]
    alone = [Lm.norm_apply(scale, x[i:i + 1], cfg.norm) for i in range(8)]
    norm_eq = all(torch.equal(torch.cat(alone), Lm.norm_apply(scale, x[:n], cfg.norm)[:8])
                  for n in (8, 64, 2048))
    xf = x.float() ** 2
    m8 = xf[:8].mean(-1)
    mean_rows = [int((torch.cat([xf[i:i + 1].mean(-1) for i in range(8)]) != m8).sum())] + [
        int((xf[:n].mean(-1)[:8] != m8).sum()) for n in (64, 2048)]
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    normed = Lm.norm_apply(scale, x[:40], cfg.norm)
    unembed = rows_apart(lambda lo, hi: Lm.unembed_apply(head, normed[lo:hi]))
    normed32 = normed.float()
    unembed_f32 = rows_apart(lambda lo, hi: Lm.unembed_apply(head, normed32[lo:hi]))
    logits = Lm.unembed_apply(head, normed).float()
    T, k, p = SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"]
    trunc = rows_apart(lambda lo, hi: serve_lib._truncate_logits(logits[lo:hi] / T, k, p))
    lt = serve_lib._truncate_logits(logits / T, k, p)
    softmax = rows_apart(lambda lo, hi: torch.softmax(lt[lo:hi], dim=-1))
    probs = torch.softmax(lt, dim=-1)
    torch_cumsum = rows_apart(lambda lo, hi: torch.cumsum(probs[lo:hi], dim=-1))
    keys = serve_lib._row_keys(serve_lib.prng.PRNGKey(SPEC_SEED, dev),
                               torch.arange(40, device=dev),
                               torch.zeros(40, dtype=torch.long, device=dev))
    draw = rows_apart(lambda lo, hi: serve_lib.sample_logits_per_row(
        logits[lo:hi], keys[lo:hi], T, k, p)[:, None])
    out = dict(norm_rows_equal=norm_eq, torch_mean_rows_differing=mean_rows,
               unembed_rows_differing=unembed, unembed_f32_rows_differing=unembed_f32,
               truncation_rows_differing=trunc,
               softmax_rows_differing=softmax, draw_rows_differing=draw,
               torch_cumsum_rows_differing=torch_cumsum)
    print(f"  row probe: RMSNorm of 8 rows bit-equal alone and among 8 / 64 / 2048 "
          f"rows: {norm_eq} (torch's own float32 mean of those 8 rows differs from "
          f"its 8-row value in {mean_rows} rows: alone / among 64 / among 2048); "
          f"of 8 rows, the number whose bits differ alone and among {PROBE_ROWS} "
          f"rows: bf16 unembed {unembed}, float32 unembed {unembed_f32}, top-k {k} / "
          f"top-p {p} truncation {trunc}, "
          f"its softmax {softmax}, the Gumbel arg-max {draw} (torch's own cumsum of "
          f"the truncated probabilities: {torch_cumsum})", flush=True)
    return out


def check_row_probe(probe: dict) -> None:
    check(probe["norm_rows_equal"], "RMSNorm gives a row the same bits among 1, 8, 64 "
          "and 2048 rows")
    for op in ("unembed", "unembed_f32", "truncation", "softmax", "draw"):
        check(not any(probe[f"{op}_rows_differing"]), f"the {op} gives a row the same "
              f"bits alone and among {PROBE_ROWS} rows")


def first_diff(name, a, b):
    """Print where two runs' streams first part; returns the count of
    requests whose streams differ."""
    diffs = [(i, next((j for j, (x, y) in enumerate(zip(s, t)) if x != y),
                      min(len(s), len(t))), s, t)
             for i, (s, t) in enumerate(zip(a, b)) if s != t]
    if diffs:
        i, j, s, t = diffs[0]
        print(f"  {name}: {len(diffs)} requests part; first request {i} at "
              f"token {j}: {s[j:j + 4]} against {t[j:j + 4]}", flush=True)
    return len(diffs)


def mixed_scheduler(model, params, cfg, entries, compare, smi) -> dict:
    """Phase 10: the trace served six ways, checked and timed."""
    cfg = dataclasses.replace(cfg, decode_block_k=PAGE)
    model = build_model(cfg, model.device)
    V, L = cfg.vocab_size, cfg.num_layers
    trace, late, hits, hit_tokens = mixed_trace(V)
    n_tok = sum(b for _, b in trace) + late[1]
    print(f"mixed scheduler: {len(trace) + 1} requests, prompts "
          f"{[len(p) for p, _ in trace] + [len(late[0])]} (the last after "
          f"{LONG_AT} steps), budgets {[b for _, b in trace] + [late[1]]} "
          f"({n_tok} tokens), {MIX_KW}, pages of {PAGE}, decode_block_k "
          f"{PAGE}, prefill_chunk_budget {MIX_BUDGET}", flush=True)
    mixed = dict(mixed_steps=True, prefill_chunk_budget=MIX_BUDGET)
    share = dict(page_size=PAGE, prefix_sharing=True)
    runs = {"A": dict(page_size=PAGE), "B": share,
            "C": dict(share, **mixed), "D": dict(share, mixed_dispatch="paired", **mixed),
            "E": {}, "F": mixed}
    what = {"A": "paged", "B": "paged, sharing", "C": "paged, sharing, mixed fused",
            "D": "paged, sharing, mixed paired", "E": "dense", "F": "dense, mixed fused"}

    def tail_prefill(name, a):
        offs = a[6] if len(a) > 6 else None
        return ("tail prefill at offset "
                f"{int(np.max(offs))} over shared pages (B)"
                if name == "paged_prefill" and offs is not None
                and (np.asarray(offs) > 0).any() else None)

    def fused_step(name, a):
        if name != "mixed_step":
            return None
        seq, dec = np.asarray(a[5]), np.asarray(a[6])
        return ("fused mixed step (C)" if dec.any() and (seq[~dec] > 0).any()
                else None)

    def chunk_wave(name, a):
        offs = a[6] if len(a) > 6 else None
        return ("paired chunk wave (D)" if name == "paged_prefill" and offs is not None
                and (np.asarray(offs) > 0).any() else None)

    labels = {"B": tail_prefill, "C": fused_step, "D": chunk_wave}
    forward_launches = []

    def count_forward(fn):
        def call(*a, **k):
            before = dict(_build.LAUNCHES)
            out = fn(*a, **k)
            forward_launches.append({n: _build.LAUNCHES[n] - before.get(n, 0)
                                     for n in ("pim_attention", "pim_decode")})
            return out
        return call

    out, streams, kept = {}, {}, {}
    for key, extra in runs.items():
        sched = serve_lib.Scheduler(model, params, **MIX_KW, **extra)
        ctx = {"label": None, "first": {}, "done": False}

        def pick(name, i, ctx=ctx):
            if ctx["label"] is None:
                return None
            first = ctx["first"].setdefault(name, i)
            return (f"{ctx['label']}, layer {REC_LAYER} ({name})"
                    if i - first == REC_LAYER else None)

        saved_step = serve_lib.mixed_step
        if key == "C":
            serve_lib.mixed_step = count_forward(saved_step)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        try:
            with recorded(pick) as rec, plain_calls() as n_plain, \
                    armed_recording(ctx, labels.get(key, lambda n, a: None)):
                t0 = time.perf_counter()
                got, steps, long_rid = serve_steps(sched, trace, late)
                wall = time.perf_counter() - t0
        finally:
            serve_lib.mixed_step = saved_step
        launches = dict(_build.LAUNCHES)
        kept.update(rec)
        streams[key] = got
        st = sched.stats
        info = dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                    model_steps=st["model_steps"], launches=launches,
                    plain_calls=dict(n_plain),
                    prefill_tokens_computed=sched.prefill_tokens_computed,
                    prefix_hits=sched.prefix_hits,
                    prefix_hit_tokens=sched.prefix_hit_tokens,
                    cow_copies=sched.n_cow_copies,
                    step_walls_ms=[round(w * 1e3, 3) for w, _, _ in steps])
        first = next(i for i, (_, em, _) in enumerate(steps) if long_rid in em)
        info["long_first_token_step_ms"] = steps[first][0] * 1e3
        filling = [w for w, _, f in steps if f]
        info["long_chunked_max_step_ms"] = max(filling) * 1e3 if filling else None
        if sched.paged:
            info.update(peak_pages_in_use=sched.peak_pages_in_use)
            if sched.prefix_sharing:
                info["directory_pages"] = sched.directory_pages()
                sched.clear_prefix_cache()
            info["pages_back"] = (len(sched.free_pages) == sched.num_pages - 1
                                  and int(sched.page_ref.sum()) == 0)
        out[key] = info
        print(f"  {key} ({what[key]}): {wall:.2f} s, {n_tok / wall:.1f} tokens/s, "
              f"{st['steps']} steps, {st['model_steps']} forwards, prefill tokens "
              f"{sched.prefill_tokens_computed}, hits {sched.prefix_hits} "
              f"({sched.prefix_hit_tokens} tokens), copies {sched.n_cow_copies}"
              + (f", peak pages {sched.peak_pages_in_use}" if sched.paged else "")
              + f", launches {launches} [{smi}]", flush=True)
    print(f"  the step giving the {LONG}-token prompt its first token: B "
          f"{out['B']['long_first_token_step_ms']:.1f} ms (its admission "
          f"prefill); longest step while it is chunked in C: "
          f"{out['C']['long_chunked_max_step_ms']:.1f} ms [{smi}]", flush=True)

    parted = {f"{a}-{b}": first_diff(f"{a} vs {b}", streams[a], streams[b])
              for a, b in (("A", "B"), ("A", "C"), ("A", "D"), ("E", "F"))}
    replay_served("mixed-step", kept, compare)
    for label in ("tail prefill", "fused mixed step", "paired chunk wave"):
        check(any(k.startswith(label) for k in kept), f"replayed a served {label}")

    for key in runs:
        check(not out[key]["plain_calls"], f"{key}: no plain-version call "
              f"({out[key]['plain_calls']})")
    check(not any(parted.values()), f"streams equal: A == B == C == D and E == F "
          f"(requests parting: {parted})")
    st = [len(s) == b for s, b in zip(streams["A"], [b for _, b in trace] + [late[1]])]
    check(all(st) and all(0 <= t < V for s in streams["A"] for t in s),
          "every request got its budget of in-vocabulary tokens")
    for key in "BCD":
        check(out[key]["prefix_hits"] == hits
              and out[key]["prefix_hit_tokens"] == hit_tokens,
              f"{key}: prefix hits {out[key]['prefix_hits']} == {hits}, hit "
              f"tokens {out[key]['prefix_hit_tokens']} == {hit_tokens}")
        check(out[key]["prefill_tokens_computed"]
              == out["A"]["prefill_tokens_computed"] - hit_tokens,
              f"{key}: prefill tokens computed "
              f"{out[key]['prefill_tokens_computed']} == A's "
              f"{out['A']['prefill_tokens_computed']} - {hit_tokens}")
        check(out[key]["cow_copies"] >= 2, f"{key}: {out[key]['cow_copies']} "
              "copy-on-write copies >= 2")
    check(out["B"]["peak_pages_in_use"] < out["A"]["peak_pages_in_use"],
          f"peak pages with sharing {out['B']['peak_pages_in_use']} < without "
          f"{out['A']['peak_pages_in_use']}")
    for key in "ABCD":
        check(out[key]["pages_back"], f"{key}: every page back on the free list"
              + (" after clear_prefix_cache()" if key != "A" else ""))
    check(bool(forward_launches) and all(
        f == {"pim_attention": L, "pim_decode": L} for f in forward_launches),
        f"C: each of its {len(forward_launches)} fused mixed forwards launched "
        f"{L} kernel-1 and {L} kernel-2 kernels")
    for name in ("pim_attention", "pim_decode"):
        if name in entries:
            entries[name]["mixed_launches"] = out["C"]["launches"].get(name, 0)

    # one fused mixed step of C (the third: decode rows beside a prefill
    # chunk) under the profiler
    def prepared():
        sched = serve_lib.Scheduler(model, params, **MIX_KW, **runs["C"])
        for p, b in trace:
            sched.submit(p, b)
        for _ in range(2):
            sched.step()
        return sched

    def one_step(sched):
        sched.step()

    shapes, wall = unprofiled_wall(prepared, one_step, lambda: launch_shapes(cfg))
    out["profile"] = profiled_report(prepared, one_step, "third step of C (one "
                                     "fused mixed forward)", wall)
    k = out["profile"]["kernels"]
    print(f"  fused mixed step: kernel 1 {k['pim_attention_kernel']['us_per_launch']:.2f} "
          f"us, kernel 2 {k['pim_decode_kernel']['us_per_launch']:.2f} us per launch "
          f"[{smi}]", flush=True)
    check(k["pim_attention_kernel"]["count"] == L and k["pim_decode_kernel"]["count"] == L,
          "the profiled step was one fused mixed forward")
    served_attention(entries, "mixed step", out["profile"], shapes, cfg)
    out["parted"] = parted
    out["paper_fidelity"] = paper_mixed(cfg, params, trace, late, smi, model.device)
    return out


def paper_mixed(cfg, params, trace, late, smi, dev) -> dict:
    """Phase 10's runs A (paged) and C (sharing and fused mixed steps) at
    the paper's fidelity (behavioral attention, 6-bit quantized ADC): its
    float32 ADC sums over more than 512 keys (the 1,024-token prompt) meet
    other row counts in C's fused steps than in A's decode chunks, so the
    two streams hold only if those sums are row-local."""
    pcfg = dataclasses.replace(cfg, attn_impl="behavioral",
                               pim=dataclasses.replace(cfg.pim, adc_mode="quantized"))
    model = build_model(pcfg, dev)
    n_tok = sum(b for _, b in trace) + late[1]
    runs = {"A": dict(page_size=PAGE),
            "C": dict(page_size=PAGE, prefix_sharing=True, mixed_steps=True,
                      prefill_chunk_budget=MIX_BUDGET)}
    out, streams = {}, {}
    for key, extra in runs.items():
        sched = serve_lib.Scheduler(model, params, **MIX_KW, **extra)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with plain_calls() as n_plain:
            t0 = time.perf_counter()
            streams[key], _, _ = serve_steps(sched, trace, late)
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check(not n_plain, f"paper fidelity {key}: no plain-version call ({n_plain})")
        check(launches.get("pim_matmul", 0) > 0 and launches.get("lut_softmax", 0) > 0
              and not launches.get("pim_attention") and not launches.get("pim_decode"),
              f"paper fidelity {key}: kernels 3 and 4 served it, no attention kernel "
              f"({launches})")
        st = sched.stats
        out[key] = dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                        model_steps=st["model_steps"], launches=launches)
        print(f"  paper fidelity {key}: {wall:.2f} s, {n_tok / wall:.1f} tokens/s, "
              f"{st['model_steps']} forwards, launches {launches} [{smi}]", flush=True)
    out["parted"] = first_diff("paper fidelity A vs C", streams["A"], streams["C"])
    check(out["parted"] == 0, "paper fidelity: A == C token for token (the ADC sums "
          "of a row do not depend on the rows beside it)")
    return out


# ---- 11. sampled and speculative serving at full width ---------------------
SPEC_KW = dict(max_batch_slots=8, max_len=1024, decode_chunk=8, page_size=PAGE)
DRAFT = 4            # draft_len of the speculative runs
SPEC_BUDGET = 256    # prefill_chunk_budget of the mixed runs
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SPEC_SEED = 7        # the sampled runs draw under PRNGKey(7)


def spec_trace(V: int):
    """Phase 11's trace, from seed 11: 16 prompts of 48-400 tokens; in 12
    of them a motif of 8-32 tokens repeats through about two thirds of
    the prompt before a random tail, so the n-gram proposer has matches
    from the first step; 4 are random tokens.  Budgets 32-96."""
    rng = np.random.RandomState(11)
    toks = data.lm_batch(11, 16, 400, V)
    lens, budgets = rng.randint(48, 401, 16), rng.randint(32, 97, 16)
    trace = []
    for i, (n, b) in enumerate(zip(lens, budgets)):
        if i % 4 == 3:
            prompt = toks[i, :n].tolist()
        else:
            m, rep = int(rng.randint(8, 33)), 2 * int(n) // 3
            prompt = ((toks[i, :m].tolist() * (rep // m + 1))[:rep]
                      + toks[i, m:m + n - rep].tolist())
        trace.append((prompt, int(b)))
    return trace


def spec_scheduler(model, params, cfg, entries, compare, smi) -> dict:
    """Phase 11: the trace served greedy (G), with speculation (H), with
    speculation and fused mixed steps (I), sampled (J), sampled with fused
    mixed steps (K) and sampled with speculation, twice (L, L2)."""
    cfg = dataclasses.replace(cfg, decode_block_k=PAGE)
    model = build_model(cfg, model.device)
    V, L = cfg.vocab_size, cfg.num_layers
    trace = spec_trace(V)
    n_tok = sum(b for _, b in trace)
    print(f"spec scheduler: {len(trace)} requests, prompts "
          f"{[len(p) for p, _ in trace]}, budgets {[b for _, b in trace]} ({n_tok} "
          f"tokens), {SPEC_KW}, decode_block_k {PAGE}, draft_len {DRAFT}, sampled "
          f"runs {SAMPLED} under PRNGKey({SPEC_SEED}), chunk budget {SPEC_BUDGET}",
          flush=True)
    spec = dict(speculate=True, draft_len=DRAFT)
    mixed = dict(mixed_steps=True, prefill_chunk_budget=SPEC_BUDGET)
    sampled = dict(SAMPLED, rng=serve_lib.prng.PRNGKey(SPEC_SEED))
    runs = {"G": {}, "H": spec, "I": dict(spec, **mixed), "J": sampled,
            "K": dict(sampled, **mixed), "L": dict(sampled, **spec),
            "L2": dict(sampled, **spec)}

    def verify_step(name, a):
        seq, dec = np.asarray(a[5]), np.asarray(a[6])
        if name != "spec_step" or not (seq[dec] > 1).any():
            return None
        return ("speculative step with verify rows"
                + (" and chunk rows" if (seq[~dec] > 0).any() else "") + " (I)")

    out, streams, kept = {}, {}, {}
    for key, extra in runs.items():
        sched = serve_lib.Scheduler(model, params, **SPEC_KW, **extra)
        ctx = {"label": None, "first": {}, "done": False}

        def pick(name, i, ctx=ctx):
            if ctx["label"] is None:
                return None
            first = ctx["first"].setdefault(name, i)
            return (f"{ctx['label']}, layer {REC_LAYER} ({name})"
                    if i - first == REC_LAYER else None)

        by_sq = {}
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with recorded(pick, by_sq=by_sq) as rec, plain_calls() as n_plain, \
                armed_recording(ctx, verify_step if key == "I" else lambda n, a: None,
                                ("spec_step",)):
            t0 = time.perf_counter()
            got = run_audited(sched, trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kept.update(rec)
        streams[key] = got
        st = sched.stats
        check(not n_plain, f"{key}: no plain-version call ({n_plain})")
        check(all(len(s) == b for s, (_, b) in zip(got, trace))
              and all(0 <= t < V for s in got for t in s),
              f"{key}: every request got its budget of in-vocabulary tokens")
        check(len(sched.free_pages) == sched.num_pages - 1,
              f"{key}: every page back on the free list")
        info = dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                    model_steps=st["model_steps"], tokens_per_model_step=n_tok / st["model_steps"],
                    launches=dict(_build.LAUNCHES),
                    decode_launches_by_sq={sq: n for (name, sq), n in sorted(by_sq.items())
                                           if name == "pim_decode"},
                    **{k: st[k] for k in ("spec_steps", "spec_proposed", "spec_accepted",
                                          "spec_rejected", "spec_accept_rate")})
        out[key] = info
        print(f"  {key}: {wall:.2f} s, {n_tok / wall:.1f} tokens/s, {st['steps']} steps, "
              f"{st['model_steps']} forwards ({info['tokens_per_model_step']:.2f} tokens "
              f"a forward), kernel 2 launches by Sq {info['decode_launches_by_sq']}"
              + (f", drafts {st['spec_proposed']} proposed, {st['spec_accepted']} "
                 f"accepted ({st['spec_accept_rate']:.1%})" if st["spec_steps"] else "")
              + f" [{smi}]", flush=True)

    parted = {f"{a}-{b}": first_diff(f"{a} vs {b}", streams[a], streams[b])
              for a, b in (("G", "H"), ("G", "I"), ("J", "K"), ("L", "L2"))}
    out["parted"] = parted
    check(not any(parted.values()), f"streams equal: G == H == I, J == K, L == L2 "
          f"(requests parting: {parted})")
    print(f"  sampled streams J against greedy G: {first_diff('J vs G', streams['J'], streams['G'])} "
          "of 16 requests differ", flush=True)
    for spec_key, base in (("H", "G"), ("L", "J")):
        o = out[spec_key]
        check(o["model_steps"] < out[base]["model_steps"] and o["spec_proposed"] > 0
              and o["spec_accepted"] > 0,
              f"{spec_key}: {o['model_steps']} forwards < {base}'s "
              f"{out[base]['model_steps']}, {o['spec_proposed']} drafts proposed, "
              f"{o['spec_accepted']} accepted")
    check(any(sq > 1 for sq in out["H"]["decode_launches_by_sq"]),
          f"kernel 2 ran verify rows (Sq > 1) on the served path: launches by Sq "
          f"{out['H']['decode_launches_by_sq']}")
    replay_served("speculative", kept, compare)
    check(any(k.startswith("speculative step") and "pim_decode" in k for k in kept),
          "replayed a served speculative step's verify rows")
    if "pim_decode" in entries:
        entries["pim_decode"]["verify_launches"] = sum(
            n for sq, n in out["H"]["decode_launches_by_sq"].items() if sq > 1)

    # one speculative step of L (its second: 8 decode rows verifying their
    # drafts) under the profiler, and its sampler alone on the step's inputs
    inputs = {}

    def prepared():
        sched = serve_lib.Scheduler(model, params, **SPEC_KW, **runs["L"])
        for p, b in trace:
            sched.submit(p, b)
        sched.step()
        return sched

    def one_step(sched):
        sched.step()

    @contextlib.contextmanager
    def sampler_inputs():
        with launch_shapes(cfg) as shapes:
            fn = serve_lib.spec_accept

            def keep(*a):
                inputs["spec_accept"] = tuple(x.clone() if isinstance(x, torch.Tensor)
                                              else x for x in a)
                return fn(*a)
            serve_lib.spec_accept = keep
            try:
                yield shapes
            finally:
                serve_lib.spec_accept = fn

    shapes, wall = unprofiled_wall(prepared, one_step, sampler_inputs)
    out["profile"] = profiled_report(prepared, one_step, "second step of L (one "
                                     "sampled speculative forward)", wall)
    k = out["profile"]["kernels"]
    check(k["pim_attention_kernel"]["count"] == L and k["pim_decode_kernel"]["count"] == L,
          "the profiled step was one speculative forward")
    check(all(sq == DRAFT + 1 for *_, sq, _ in shapes["pim_decode"]),
          f"the profiled step's kernel 2 launches carry verify rows of Sq {DRAFT + 1}")
    out["served"] = served_attention(entries, f"speculative step (Sq {DRAFT + 1})",
                                     out["profile"], shapes, cfg)
    logits = inputs["spec_accept"][0]
    rows = logits.flatten(0, 1)[:8]
    keys = serve_lib._row_keys(serve_lib.prng.PRNGKey(SPEC_SEED, model.device),
                               torch.arange(8, device=model.device),
                               torch.zeros(8, dtype=torch.long, device=model.device))
    sampler = {}
    for name, fn in (("speculative accept", lambda: serve_lib.spec_accept(*inputs["spec_accept"])),
                     ("per-row draw", lambda: serve_lib.sample_logits_per_row(
                         rows, keys, SAMPLED["temperature"], SAMPLED["top_k"],
                         SAMPLED["top_p"]))):
        times = profiled(fn, 3)
        sampler[name] = dict(device_us=sum(us for us, _ in times.values()) / 3,
                             launches=sum(n for _, n in times.values()) / 3)
        print(f"  sampler, {name} ({tuple(logits.shape) if 'accept' in name else tuple(rows.shape)} "
              f"logits): {sampler[name]['launches']:.0f} device kernels and copies, "
              f"{sampler[name]['device_us']:.1f} us of device time a step [{smi}]", flush=True)
    out["sampler"] = sampler
    print(f"  speculative step: kernel 1 {k['pim_attention_kernel']['us_per_launch']:.2f} "
          f"us, kernel 2 {k['pim_decode_kernel']['us_per_launch']:.2f} us per launch "
          f"[{smi}]", flush=True)
    return out


# ---- 12. overload control at full width: the starved trace -----------------
STARVE_KW = dict(max_batch_slots=8, max_len=1024, decode_chunk=8, page_size=PAGE,
                 audit_every_step=True)
STARVED_POOL = 113   # 112 pages + the trash page (the unstarved pool: 513)
VICTIM = 256         # host pages of the victim pool of S and F
VICTIM_CAP = 16      # C's cap: the first spill fits, a later one falls back
LATE_AT, LATE_TTL = 3, 2   # F: a request submitted after 3 steps, ttl 2 steps
FAULTS = dict(evict_steps=(6, 21), alloc_fail_steps=(8, 16),
              restore_delay_steps=(9, 12, 24), corrupt_refcount_steps=(4, 15, 30),
              nan_logit_steps=(11,))


def starved_trace(V: int):
    """Phase 12's trace, from seed 12: 16 prompts of 64-384 tokens, budgets
    of 48-128; and F's late request (a 200-token prompt, budget 64)."""
    rng = np.random.RandomState(12)
    toks = data.lm_batch(12, 17, 384, V)
    lens, budgets = rng.randint(64, 385, 16), rng.randint(48, 129, 16)
    trace = [(toks[i, :n].tolist(), int(b)) for i, (n, b) in enumerate(zip(lens, budgets))]
    return trace, (toks[16, :200].tolist(), 64)


@contextlib.contextmanager
def overload_watch(ctx):
    """Wrap the scheduler's spill, restore, admission-prefill and decode
    steps of `serve_lib` for phase 12: time each spill (`page_fetch`: gather
    and copy to the host) and restore (`page_restore`: copy to the card and
    scatter) with CUDA events, count re-prefilled continuation rows, and arm
    `recorded` (through ctx["label"]) for the first decode after a restore
    and the first re-prefill of a recompute continuation."""
    saved = {n: getattr(serve_lib, n) for n in
             ("page_fetch", "page_restore", "paged_prefill", "ragged_decode")}

    def timed(name):
        def call(model, cache, pages, *a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = saved[name](model, cache, pages, *a)
            end.record()
            end.synchronize()
            real = [int(p) for p in pages if int(p) != A.TRASH_PAGE]
            ctx[name].append(dict(pages=len(real), width=len(pages),
                                  device_ms=start.elapsed_time(end),
                                  host_ms=(time.perf_counter() - t0) * 1e3))
            if name == "page_restore":
                ctx["restored_pages"] = real
            return out
        return call

    def prefill(*a, **k):
        cont = int((np.asarray(k["gens"]) > 0).sum())
        ctx["reprefilled"] += cont
        for rid, g in zip(np.asarray(k["rids"]).tolist(), np.asarray(k["gens"]).tolist()):
            if g > 0:
                ctx["recomputed"].setdefault(rid, g)
        arm = cont and ctx["arm_prefill"]
        if arm:
            ctx.update(label="re-prefill of a recompute continuation (R)", first={},
                       arm_prefill=False)
        try:
            return saved["paged_prefill"](*a, **k)
        finally:
            if arm:
                ctx["label"] = None

    def decode(*a, **k):
        arm = ctx["arm_decode"] and ctx["restored_pages"]
        if arm:
            ctx.update(label="first decode after a restore (S)", first={},
                       arm_decode=False)
            ctx["fresh_in_table"] = set(ctx["restored_pages"]) <= set(
                np.asarray(a[10]).ravel().tolist())
        try:
            return saved["ragged_decode"](*a, **k)
        finally:
            if arm:
                ctx["label"] = None

    serve_lib.page_fetch, serve_lib.page_restore = timed("page_fetch"), timed("page_restore")
    serve_lib.paged_prefill, serve_lib.ragged_decode = prefill, decode
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(serve_lib, n, f)


def overload_ctx(**extra):
    """(ctx, pick): a fresh ctx for `overload_watch` and `starved_steps`
    updated with `extra`, and the `recorded` pick that keeps layer
    REC_LAYER of the launches after each arming (ctx["label"])."""
    ctx = dict(label=None, first={}, page_fetch=[], page_restore=[],
               restored_pages=None, reprefilled=0, recomputed={},
               arm_decode=False, arm_prefill=False, fresh_in_table=None)
    ctx.update(extra)

    def pick(name, i):
        if ctx["label"] is None:
            return None
        first = ctx["first"].setdefault(name, i)
        return (f"{ctx['label']}, layer {REC_LAYER} ({name})"
                if i - first == REC_LAYER else None)
    return ctx, pick


def starved_steps(sched, trace, ctx=None, late=None, profile_step=None, cfg=None):
    """Submit `trace` (and `late` (prompt, budget) with ttl LATE_TTL after
    LATE_AT steps), step to the end, synchronized.  Each scheduler step
    audits itself.  Returns (streams in trace order, late rid or None, per
    step dicts: wall, restores, spills, re-prefilled rows, victim records
    held at its end, launches); step `profile_step` runs under
    torch.profiler and launch_shapes, kept in ctx["profile"]; a
    `CrashInjected` ends the run and is kept in ctx["crash"]."""
    ctx = overload_ctx()[0] if ctx is None else ctx
    rids = [sched.submit(p, b) for p, b in trace]
    late_rid, steps, res = None, [], {}
    while sched.queue or any(r is not None for r in sched.slot_req):
        if late is not None and len(steps) == LATE_AT:
            late_rid = sched.submit(*late, ttl_steps=LATE_TTL)
        before = (sched.n_restores, sched.n_spills, ctx["reprefilled"])
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        prof = len(steps) + 1 == profile_step
        try:
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                  if prof else contextlib.nullcontext()) as p, \
                    (launch_shapes(cfg) if prof else contextlib.nullcontext()) as shapes:
                t0 = time.perf_counter()
                em = sched.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        except serve_lib.CrashInjected as e:
            ctx["crash"] = (sched._step_idx, str(e))
            break
        if prof:
            ctx["profile"] = (p, wall, dict(_build.LAUNCHES), shapes)
        steps.append(dict(wall=wall, restores=sched.n_restores - before[0],
                          spills=sched.n_spills - before[1],
                          reprefilled=ctx["reprefilled"] - before[2],
                          records=len(sched._victim), launches=dict(_build.LAUNCHES)))
        for rid, toks in em.items():
            res.setdefault(rid, []).extend(toks)
    return [res.get(r, []) for r in rids], late_rid, steps


def run_launches(steps) -> dict:
    """{wrapper: launches} of a run, summed over `starved_steps`' steps."""
    total = {}
    for x in steps:
        for name, n in x["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def starved_scheduler(model, params, cfg, entries, compare, smi) -> dict:
    """Phase 12: the starved trace served five ways, checked and timed."""
    cfg = dataclasses.replace(cfg, decode_block_k=PAGE)
    model = build_model(cfg, model.device)
    V = cfg.vocab_size
    trace, late = starved_trace(V)
    n_tok = sum(b for _, b in trace)
    page_bytes = PAGE * serve_lib.kv_bytes_per_token(cfg)
    print(f"starved scheduler: {len(trace)} requests, prompts {[len(p) for p, _ in trace]}, "
          f"budgets {[b for _, b in trace]} ({n_tok} tokens), {STARVE_KW}, "
          f"decode_block_k {PAGE}; pool {STARVED_POOL} pages of {page_bytes} bytes "
          f"({(STARVED_POOL - 1) * page_bytes / 2**20:.1f} MiB) against 513 unstarved; "
          f"victim pool {VICTIM} pages ({VICTIM * page_bytes / 2**20:.1f} MiB of host "
          f"memory), C's cap {VICTIM_CAP}; F: {FAULTS}, a late request after "
          f"{LATE_AT} steps with ttl_steps {LATE_TTL}", flush=True)
    starved = dict(num_pages=STARVED_POOL)
    runs = {"U": {}, "R": starved, "S": dict(starved, victim_pool_pages=VICTIM),
            "C": dict(starved, victim_pool_pages=VICTIM_CAP),
            "F": dict(starved, victim_pool_pages=VICTIM,
                      fault_plan=serve_lib.FaultPlan(**FAULTS))}
    what = {"U": "unstarved", "R": "starved, recompute", "S": "starved, spill",
            "C": f"starved, spill capped at {VICTIM_CAP} pages", "F": "S under faults"}
    out, streams, kept, ctxs = {}, {}, {}, {}
    profile_step = None
    for key, extra in runs.items():
        sched = serve_lib.Scheduler(model, params, **STARVE_KW, **extra)
        ctx, pick = overload_ctx(arm_decode=key == "S", arm_prefill=key == "R")
        ctxs[key] = ctx
        dropped = []
        if key == "F":
            drop = sched._drop_victim

            def dropping(rid, drop=drop, sched=sched):
                if rid in sched._victim:
                    dropped.append(rid)
                drop(rid)
            sched._drop_victim = dropping

        torch.cuda.synchronize()
        with recorded(pick) as rec, plain_calls() as n_plain, overload_watch(ctx):
            t0 = time.perf_counter()
            got, late_rid, steps = starved_steps(
                sched, trace, ctx, late if key == "F" else None,
                profile_step if key == "C" else None, cfg)
            wall = time.perf_counter() - t0
        kept.update(rec)
        streams[key] = got
        st = sched.stats
        check(not n_plain, f"{key}: no plain-version call ({n_plain})")
        sched.clear_prefix_cache()
        check(len(sched.free_pages) == sched.num_pages - 1 and int(sched.page_ref.sum()) == 0
              and not sched._victim and sched._victim_used == 0,
              f"{key}: every page back after clear_prefix_cache(), the victim pool empty")
        info = dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                    model_steps=st["model_steps"], peak_pages_in_use=sched.peak_pages_in_use,
                    **{k: st[k] for k in ("evictions", "spills", "restores", "spilled_pages",
                                          "spill_bytes", "recompute_fallbacks",
                                          "deadline_misses", "poisoned",
                                          "refcount_corruptions_detected")},
                    reprefilled_rows=ctx["reprefilled"],
                    spill_calls=ctx["page_fetch"], restore_calls=ctx["page_restore"],
                    step_walls_ms=[round(x["wall"] * 1e3, 3) for x in steps],
                    status=[sched.requests[r].status for r in sorted(sched.requests)],
                    records_dropped=len(dropped))
        if sched._faults is not None:
            info["fired"] = dict(sched._faults.fired)
        if late_rid is not None:
            info["late"] = dict(status=sched.requests[late_rid].status,
                                tokens=len(sched.requests[late_rid].tokens))
        restore_steps = [x for x in steps if x["restores"]]
        reprefill_steps = [x for x in steps if x["reprefilled"]]
        info["longest_step_ms"] = max(x["wall"] for x in steps) * 1e3
        info["longest_restore_step_ms"] = (max(x["wall"] for x in restore_steps) * 1e3
                                           if restore_steps else None)
        info["longest_reprefill_step_ms"] = (max(x["wall"] for x in reprefill_steps) * 1e3
                                             if reprefill_steps else None)
        if key == "S":
            # C's profiled step: S's first step that restores, one with an
            # admission prefill beside it if there is one (C runs S's
            # schedule until its first refused spill)
            both = [i for i, x in enumerate(steps) if x["restores"]
                    and x["launches"].get("pim_attention")]
            first = [i for i, x in enumerate(steps) if x["restores"]]
            profile_step = (both or first or [None])[0]
            profile_step = None if profile_step is None else profile_step + 1
            info["profile_step"] = profile_step
            info["profile_step_wall_ms"] = (steps[profile_step - 1]["wall"] * 1e3
                                            if profile_step else None)
        out[key] = info
        print(f"  {key} ({what[key]}): {wall:.2f} s, {n_tok / wall:.1f} tokens/s, "
              f"{st['steps']} steps, {st['model_steps']} forwards, evictions "
              f"{st['evictions']}, spills {st['spills']} ({st['spilled_pages']} pages), "
              f"restores {st['restores']}, recompute fallbacks {st['recompute_fallbacks']}, "
              f"re-prefilled rows {ctx['reprefilled']}, peak pages {sched.peak_pages_in_use}, "
              f"longest step {info['longest_step_ms']:.1f} ms [{smi}]", flush=True)

    u = streams["U"]
    check(all(len(x) == b for x, (_, b) in zip(u, trace)) and all(0 <= t < V for x in u for t in x),
          "U: every request got its budget of in-vocabulary tokens")
    parted = {k: first_diff(f"{k} vs U", streams[k], u) for k in ("S", "C", "R")}
    out["parted"] = parted
    check(parted["S"] == 0 and not ctxs["S"]["recomputed"],
          f"S == U token for token ({parted['S']} requests part), no re-prefill")
    # a recompute continuation re-prefills its generated tokens through
    # kernel 1, which the decode steps had run through kernel 2: the online
    # LUT steps round otherwise, so it may part from U after its re-prefill,
    # as the reference's own continuations do (ROADMAP.md §3).  Every other
    # request of R and C (C's spilled continuations included) equals U.
    for key in ("R", "C"):
        rc = ctxs[key]["recomputed"]     # rid (= trace index) -> tokens then
        ok = all(x == y if i not in rc else x[:rc[i]] == y[:rc[i]]
                 for i, (x, y) in enumerate(zip(streams[key], u)))
        where = [(i, next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), None),
                  rc.get(i)) for i, (x, y) in enumerate(zip(streams[key], u)) if x != y]
        out[f"{key}_parts"] = where
        print(f"  {key} against U: {len(rc)} recompute continuations (request: tokens "
              f"at its re-prefill) {rc}; requests parting (index, first differing "
              f"token, tokens at its re-prefill) {where}", flush=True)
        check(bool(rc) and ok, f"{key} == U but where a recompute continuation parts "
              f"after its re-prefill ({len(where)} of {len(rc)} part)")
    s, c = out["S"], out["C"]
    check(s["evictions"] >= 3 and s["spills"] == s["evictions"] and s["restores"] == s["spills"]
          and s["recompute_fallbacks"] == 0,
          f"S: {s['spills']} spills of {s['evictions']} evictions >= 3, every one restored")
    check(s["spill_bytes"] == s["spilled_pages"] * page_bytes,
          f"S: spill bytes {s['spill_bytes']} == {s['spilled_pages']} pages x {page_bytes}")
    check(c["recompute_fallbacks"] >= 1 and c["spills"] >= 1,
          f"C: {c['spills']} spills and {c['recompute_fallbacks']} recompute fallbacks mix")
    check(out["R"]["reprefilled_rows"] >= out["R"]["evictions"] >= 3
          and out["S"]["reprefilled_rows"] == 0,
          f"R re-prefilled {out['R']['reprefilled_rows']} continuations, S none")

    f = out["F"]
    plan = serve_lib.FaultPlan(**FAULTS)
    fs = streams["F"]
    poisoned = [i for i, st in enumerate(f["status"][:16]) if st == "poisoned"]
    check(len(poisoned) == 1 and f["poisoned"] == 1, f"F: one request poisoned ({poisoned})")
    p_i = poisoned[0]
    check(all(fs[i] == u[i] for i in range(16) if i != p_i)
          and fs[p_i] == u[p_i][:len(fs[p_i])] and f["status"].count("done") == 15,
          "F: every other request equals U, the poisoned one's tokens are a prefix of U's")
    check(f["late"]["status"] == "deadline_missed" and f["deadline_misses"] == 1,
          f"F: the late request shed ({f['late']})")
    fired = f["fired"]
    check(fired["evict"] == len(plan.evict_steps) and fired["nan"] == 1
          and fired["corrupt"] == len(plan.corrupt_refcount_steps)
          and f["refcount_corruptions_detected"] == len(plan.corrupt_refcount_steps)
          and fired["alloc_fail"] >= 1 and fired["restore_delay"] >= 1,
          f"F: faults fired as planned ({fired}), every corruption detected "
          f"({f['refcount_corruptions_detected']})")
    check(f["restores"] + f["records_dropped"] == f["spills"] >= len(plan.evict_steps),
          f"F: restores {f['restores']} + shed records {f['records_dropped']} == spills "
          f"{f['spills']}")
    out["spills_total"] = sum(out[k]["spills"] for k in runs)

    # kernels 1 and 2 replayed on the launches of a re-prefill and a restore
    replay_served("starved", kept, compare)
    check(ctxs["S"]["fresh_in_table"] is True,
          "the replayed decode after a restore reads the restored slot's fresh pages")

    # a spill and a restore on the device
    for key in ("spill", "restore"):
        calls = out["S"][f"{key}_calls"]
        pages = sum(x["pages"] for x in calls)
        ms = sum(x["device_ms"] for x in calls)
        out[key] = dict(calls=len(calls), pages=pages, device_ms=ms,
                        ms_per_page=ms / max(pages, 1),
                        gb_per_s=pages * page_bytes / max(ms, 1e-9) / 1e6)
        print(f"  {key}: {len(calls)} calls of {[x['pages'] for x in calls]} pages "
              f"(widths {[x['width'] for x in calls]}), device "
              f"{[round(x['device_ms'], 3) for x in calls]} ms, host "
              f"{[round(x['host_ms'], 3) for x in calls]} ms: {ms / max(pages, 1):.4f} ms "
              f"a page, {out[key]['gb_per_s']:.2f} GB/s of real pages [{smi}]", flush=True)
    # warm: a spill and a restore of 16 and 32 pages on a pool of the
    # starved size, 5 each timed by CUDA events
    cache = model.init_cache(STARVE_KW["max_batch_slots"], STARVE_KW["max_len"],
                             page_size=PAGE, num_pages=STARVED_POOL)
    out["warm"] = {}
    for n in (16, 32):
        pages = list(range(1, n + 1))
        held = serve_lib.page_fetch(model, cache, pages)
        fetch = cuda_ms(lambda: serve_lib.page_fetch(model, cache, pages), 5)
        restore = cuda_ms(lambda: serve_lib.page_restore(model, cache, pages, held), 5)
        out["warm"][n] = dict(spill_ms=fetch, restore_ms=restore,
                              spill_gb_per_s=n * page_bytes / fetch / 1e6,
                              restore_gb_per_s=n * page_bytes / restore / 1e6)
        print(f"  warm, {n} pages ({n * page_bytes / 2**20:.1f} MiB): spill {fetch:.3f} ms "
              f"({fetch / n:.4f} a page, {n * page_bytes / fetch / 1e6:.2f} GB/s), restore "
              f"{restore:.3f} ms ({restore / n:.4f} a page, "
              f"{n * page_bytes / restore / 1e6:.2f} GB/s) [{smi}]", flush=True)
    del cache, held
    print(f"  longest step: R {out['R']['longest_step_ms']:.1f} ms (longest with a "
          f"re-prefill {out['R']['longest_reprefill_step_ms']}), S "
          f"{out['S']['longest_step_ms']:.1f} ms (longest with a restore "
          f"{out['S']['longest_restore_step_ms']}) [{smi}]", flush=True)

    # the profiled step of C: S's profile_step, under the same schedule
    check(ctxs["C"].get("profile") is not None, f"C profiled its step {profile_step}")
    prof, prof_s, launches, shapes = ctxs["C"]["profile"]
    names = tuple(k for k in ATTENTION_KERNELS if launches.get(k[1]))
    out["profile"] = profile_report(prof, out["S"]["profile_step_wall_ms"] / 1e3, prof_s,
                                    f"step {profile_step} of C (restores a spilled "
                                    f"slot; S's wall of that step as the unprofiled one)",
                                    launches, names)
    out["served"] = served_attention(entries, "starved step with a restore",
                                     out["profile"], shapes, cfg)
    return out


# ---- 13. 4-bit KV pools, page integrity, the SLA ladder, crash restore -----
KV4_REQUESTS = 8     # the first requests of phase 12's trace
KV4_CHUNK = 256      # L4's prefill chunk budget
# L4's time-between-tokens target, below every step of the CUT_DEPTH-layer
# model: 50 ms at 24 layers, scaled by the step time's CUT_DEPTH / 24
KV4_TBT_MS = 50.0 * CUT_DEPTH / 24
SNAP_EVERY = 2       # C4's snapshot period (steps)
IDLE_STEPS = 64      # most idle steps L4 takes to release its ladder


def recovery_scheduler(model, params, cfg, entries, compare, smi) -> dict:
    """Phase 13: 4-bit KV pools through kernels 1 and 2 on the served path,
    with page checksums, a bit flip, a crash and restore, and the ladder."""
    cfg = dataclasses.replace(cfg, decode_block_k=PAGE)
    model = build_model(cfg, model.device)
    cfg4 = dataclasses.replace(cfg, kv_bits=4)
    V, L = cfg.vocab_size, cfg.num_layers
    trace = starved_trace(V)[0][:KV4_REQUESTS]
    n_tok = sum(b for _, b in trace)
    page4 = PAGE * serve_lib.kv_bytes_per_token(cfg4)
    page8 = PAGE * serve_lib.kv_bytes_per_token(dataclasses.replace(cfg, kv_bits=8))
    print(f"4-bit scheduler: {len(trace)} requests, prompts {[len(p) for p, _ in trace]}, "
          f"budgets {[b for _, b in trace]} ({n_tok} tokens), {STARVE_KW}, kv_bits 4, "
          f"decode_block_k {PAGE}; a page holds {page4} bytes at 4-bit against "
          f"{page8} at int8 (kv_bytes_per_token x {PAGE})", flush=True)
    check(page4 == PAGE * L * cfg.num_kv_heads * kv_token_bytes(cfg4) < page8,
          f"page bytes follow the stored precision: {page4} at 4-bit, {page8} at int8 "
          "(the bounds' bytes a token and head, x heads x layers x page)")
    out = dict(page_bytes_kv4=page4, page_bytes_kv8=page8)

    def pool_kw(**extra):
        return dict(STARVE_KW, kv_bits=4, **extra)

    def info_of(sched, wall, steps):
        st = sched.stats
        return dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                    model_steps=st["model_steps"],
                    **{k: st[k] for k in ("evictions", "spills", "restores", "spilled_pages",
                                          "spill_bytes", "recompute_fallbacks",
                                          "corruptions_detected", "bitflips_injected",
                                          "snapshots", "ladder_escalations",
                                          "ladder_deescalations", "ladder_paused_steps",
                                          "ladder_transitions", "tbt_p95_ms")},
                    longest_step_ms=max([x["wall"] for x in steps] or [0.0]) * 1e3)

    def report(key, what, info):
        print(f"  {key} ({what}): {info['wall_s']:.2f} s, {info['tokens_per_s']:.1f} "
              f"tokens/s, {info['steps']} steps, {info['model_steps']} forwards, evictions "
              f"{info['evictions']}, spills {info['spills']} ({info['spilled_pages']} pages, "
              f"{info['spill_bytes']} bytes), restores {info['restores']}, recompute "
              f"fallbacks {info['recompute_fallbacks']}, corruptions detected "
              f"{info['corruptions_detected']}, longest step {info['longest_step_ms']:.1f} ms "
              f"[{smi}]", flush=True)

    layer = REC_LAYER % L

    def pick(name, i):
        if name == "pim_attention" and i == layer:
            return f"4-bit admission wave, layer {layer}"
        if name == "pim_decode" and i == 2 * L + layer:
            return f"4-bit decode forward 3, layer {layer}"
        return None

    # P4: the default pool, kernels counted and served launches replayed
    sched = serve_lib.Scheduler(model, params, **pool_kw())
    check(sched.model.cfg.kv_bits == 4 and sched.model.device == model.device
          and sched.cache["blocks"][0].k_q.shape[-1] == cfg.resolved_head_dim // 2,
          "kv_bits=4 rebuilds the model at 4-bit on the caller's card: pool codes Dh/2 wide")
    torch.cuda.synchronize()
    with recorded(pick) as kept, plain_calls() as n_plain:
        t0 = time.perf_counter()
        p4, _, steps = starved_steps(sched, trace)
        wall = time.perf_counter() - t0
    launches = run_launches(steps)
    check(not n_plain, f"P4: no plain-version call on the path ({n_plain})")
    for name in ("pim_attention", "pim_decode"):
        check(launches.get(name, 0) > 0, f"P4 launched {name} over 4-bit pages")
        if name in entries:
            entries[name]["kv4_launches"] = launches[name]
    check(all(len(x) == b for x, (_, b) in zip(p4, trace))
          and all(0 <= t < V for x in p4 for t in x),
          "P4: every request got its budget of in-vocabulary tokens")
    check(all(args[2].shape[-1] == cfg.resolved_head_dim // 2 for _, args, _ in kept.values()),
          "P4: the recorded launches read 4-bit codes (Dh/2 wide) in place in the pool")
    replay_served("4-bit paged", kept, compare)
    out["P4"] = dict(info_of(sched, wall, steps), launches=launches)
    report("P4", "4-bit pool", out["P4"])

    # one profiled step: the admission wave and a decode chunk
    def submitted():
        s = serve_lib.Scheduler(model, params, **pool_kw())
        for p, b in trace:
            s.submit(p, b)
        return s

    shapes, wall = unprofiled_wall(submitted, lambda s: s.step(), lambda: launch_shapes(cfg4))
    out["profile"] = profiled_report(submitted, lambda s: s.step(),
                                     "first step of P4 (4-bit pool)", wall)
    out["served"] = served_attention(entries, "4-bit pool, first step", out["profile"],
                                     shapes, cfg4)

    # D4 against P4 where the tiles match: prompts of one page (a dense
    # prefill runs 256-row KV tiles, a paged one 16-row pages), budgets cut
    # to four decode chunks
    short = [(p[:PAGE], min(b, 4 * STARVE_KW["decode_chunk"])) for p, b in trace]
    got = {}
    for key, kw in (("P4 one-page prompts", pool_kw()),
                    ("D4", dict(max_batch_slots=8, max_len=1024, decode_chunk=8,
                                audit_every_step=True, kv_bits=4))):
        s = serve_lib.Scheduler(model, params, **kw)
        with plain_calls() as n_plain:
            t0 = time.perf_counter()
            got[key], _, steps = starved_steps(s, short)
            wall = time.perf_counter() - t0
        check(not n_plain and all(run_launches(steps).get(n, 0) > 0
                                  for n in ("pim_attention", "pim_decode")),
              f"{key}: kernels 1 and 2 launched, no plain-version call")
        out[key] = dict(info_of(s, wall, steps),
                        tokens_per_s=sum(b for _, b in short) / wall)
        report(key, "prompts cut to one page, budgets to 32", out[key])
    check(first_diff("D4 vs P4 (one-page prompts)", got["D4"], got["P4 one-page prompts"]) == 0,
          "D4 == P4 token for token on one-page prompts (block_k == page size)")

    # S4: the starved pool spilling to the host, page checksums on
    starved = dict(num_pages=STARVED_POOL, victim_pool_pages=VICTIM, integrity="checksum")
    ctxs = {}

    def overload_run(key, extra, **ctx_extra):
        s = serve_lib.Scheduler(model, params, **pool_kw(**starved, **extra))
        ctx, pick_ctx = overload_ctx(**ctx_extra)
        ctxs[key] = ctx
        torch.cuda.synchronize()
        with recorded(pick_ctx) as rec, plain_calls() as n_plain, overload_watch(ctx):
            t0 = time.perf_counter()
            streams, _, steps = starved_steps(s, trace, ctx)
            wall = time.perf_counter() - t0
        check(not n_plain, f"{key}: no plain-version call ({n_plain})")
        return s, streams, steps, rec, wall

    s4, s4_streams, s4_steps, rec, wall = overload_run("S4", {}, arm_decode=True)
    out["S4"] = info_of(s4, wall, s4_steps)
    report("S4", f"starved pool of {STARVED_POOL} pages, spill, checksums", out["S4"])
    s = out["S4"]
    check(first_diff("S4 vs P4", s4_streams, p4) == 0, "S4 == P4 token for token")
    check(s["spills"] >= 1 and s["restores"] == s["spills"] and s["recompute_fallbacks"] == 0
          and s["corruptions_detected"] == 0,
          f"S4: {s['spills']} spills, each restored from its checksummed host copy")
    check(s["spill_bytes"] == s["spilled_pages"] * page4,
          f"S4: spilled bytes {s['spill_bytes']} == {s['spilled_pages']} pages x {page4}")
    replay_served("4-bit starved", rec, compare, need=("pim_decode",))
    check(ctxs["S4"]["fresh_in_table"] is True,
          "the replayed decode after a 4-bit restore reads the restored slot's fresh pages")
    for kind in ("spill", "restore"):
        calls = ctxs["S4"][f"page_{'fetch' if kind == 'spill' else 'restore'}"]
        pages = sum(x["pages"] for x in calls)
        ms = sum(x["device_ms"] for x in calls)
        out[f"S4_{kind}"] = dict(calls=calls, pages=pages, device_ms=ms,
                                 ms_per_page=ms / max(pages, 1),
                                 gb_per_s=pages * page4 / max(ms, 1e-9) / 1e6)
        print(f"  S4 {kind}: {len(calls)} calls of {[x['pages'] for x in calls]} 4-bit pages, "
              f"device {[round(x['device_ms'], 3) for x in calls]} ms, host "
              f"{[round(x['host_ms'], 3) for x in calls]} ms: {ms / max(pages, 1):.4f} ms a "
              f"page, {out[f'S4_{kind}']['gb_per_s']:.2f} GB/s [{smi}]", flush=True)

    # B4: S4 with one byte of a spilled page flipped in host memory
    flip = serve_lib.FaultPlan(bitflip_spilled_page_steps=tuple(range(1, 4097)), max_faults=1)
    b4, b4_streams, b4_steps, _, wall = overload_run("B4", dict(fault_plan=flip))
    out["B4"] = dict(info_of(b4, wall, b4_steps), fired=dict(b4._faults.fired),
                     recomputed=dict(ctxs["B4"]["recomputed"]))
    report("B4", "S4 + a bit flip of a spilled page", out["B4"])
    b = out["B4"]
    rc = ctxs["B4"]["recomputed"]         # rid (= trace index) -> tokens then
    check(b["bitflips_injected"] == 1 and b["corruptions_detected"] >= 1
          and b["recompute_fallbacks"] == 1 and len(rc) == 1,
          f"B4: the flip detected ({b['corruptions_detected']} pages) and its request "
          f"recomputed from its prompt ({rc})")
    parts = [(i, next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None))
             for i, (g, w) in enumerate(zip(b4_streams, p4)) if g != w]
    out["B4"]["parts"] = parts
    print(f"  B4 against P4: requests parting (index, first differing token) {parts}; "
          f"the recomputed one re-prefilled at {rc}", flush=True)
    check(all(g == w if i not in rc else g[:rc[i]] == w[:rc[i]]
              for i, (g, w) in enumerate(zip(b4_streams, p4))),
          "B4: every other request == P4, the recomputed one up to its re-prefill")

    # C4: S4 with snapshots, crashed after a spill, restored by a fresh scheduler
    held = [i + 1 for i, x in enumerate(s4_steps) if x["records"] and (i + 1) % SNAP_EVERY == 0]
    check(bool(held), f"S4 holds a victim record at the end of a step of {SNAP_EVERY}k")
    crash_at = held[0] + 1
    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        plan = serve_lib.FaultPlan(crash_at_step=crash_at)
        snap = dict(fault_plan=plan, snapshot_dir=snap_dir, snapshot_every=SNAP_EVERY)
        writes = []
        crash_sched = serve_lib.Scheduler(model, params, **pool_kw(**starved, **snap))
        save = crash_sched.snapshot

        def timed_snapshot(*a, **k):
            t0 = time.perf_counter()
            path = save(*a, **k)
            writes.append(dict(step=crash_sched._step_idx, s=time.perf_counter() - t0,
                               bytes=sum(os.path.getsize(os.path.join(path, f))
                                         for f in os.listdir(path))))
            return path
        crash_sched.snapshot = timed_snapshot
        ctx = overload_ctx()[0]
        t0 = time.perf_counter()
        starved_steps(crash_sched, trace, ctx)
        crash_wall = time.perf_counter() - t0
        check(ctx.get("crash", (None,))[0] == crash_at,
              f"C4: CrashInjected at step {crash_at} ({ctx.get('crash')})")
        restored = serve_lib.Scheduler(model, params, **pool_kw(**starved, **snap))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = restored.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(step == crash_at - 1 and bool(restored._victim),
              f"C4: restored the snapshot of step {step}, a victim record inside it "
              f"({len(restored._victim)})")
        t0 = time.perf_counter()
        with plain_calls() as n_plain:
            while restored.queue or any(r is not None for r in restored.slot_req):
                restored.step()
            torch.cuda.synchronize()
        rest_wall = time.perf_counter() - t0
        check(not n_plain, f"C4: no plain-version call ({n_plain})")
        restored.audit()
        res = restored.results()
        c4 = [res[i] for i in range(len(trace))]
        check(first_diff("C4 vs S4", c4, s4_streams) == 0 and restored._faults.fired["crash"] == 1,
              "C4: the restored run == S4 token for token, the crash never fired again")
        out["C4"] = dict(crash_at=crash_at, restored_step=step, snapshots=writes,
                         snapshot_bytes=writes[-1]["bytes"] if writes else None,
                         snapshot_write_s=[w["s"] for w in writes], restore_s=restore_s,
                         crash_run_s=crash_wall, restored_run_s=rest_wall,
                         restores=restored.n_restores, spills=restored.n_spills)
        print(f"  C4: crashed at step {crash_at} after {len(writes)} snapshots of "
              f"{[w['bytes'] for w in writes]} bytes on disk, written (fsync'd) in "
              f"{[round(w['s'], 3) for w in writes]} s; restore {restore_s:.3f} s; the "
              f"restored run {rest_wall:.2f} s to its end [{smi}]", flush=True)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)

    # L4: P4 with mixed steps under the SLA ladder on the real clock
    lad = serve_lib.Scheduler(model, params, **pool_kw(
        mixed_steps=True, prefill_chunk_budget=KV4_CHUNK, tbt_target_ms=KV4_TBT_MS,
        ladder_cooldown_steps=1))
    levels = []
    budgets = set()
    step = lad.step

    def watched():
        em = step()
        levels.append(lad.ladder_level)
        budgets.add(lad._effective_chunk_budget())
        return em
    lad.step = watched
    t0 = time.perf_counter()
    with plain_calls() as n_plain:
        l4, _, l4_steps = starved_steps(lad, trace)
        wall = time.perf_counter() - t0
        served_levels = list(levels)
        served_info = info_of(lad, wall, l4_steps)
        tbt_served = lad.stats["tbt_p95_ms"]
        # the load is gone: idle steps sample short times between steps
        for _ in range(IDLE_STEPS):
            if lad.ladder_level == 0:
                break
            lad.step()
    check(not n_plain, f"L4: no plain-version call ({n_plain})")
    out["L4"] = dict(served_info, levels=served_levels, released=lad.ladder_deescalations,
                     chunk_budgets=sorted(budgets), idle_steps=len(levels) - len(served_levels),
                     tbt_p95_ms_served=tbt_served)
    report("L4", f"mixed steps, tbt target {KV4_TBT_MS} ms", out["L4"])
    print(f"  L4 ladder: levels per served step {served_levels}, chunk budgets "
          f"{sorted(budgets)}, transitions {lad.stats['ladder_transitions']}, escalations "
          f"{lad.ladder_escalations}, releases {lad.ladder_deescalations} (after "
          f"{out['L4']['idle_steps']} idle steps), paused steps {lad.ladder_paused_steps}, "
          f"p95 time between steps {tbt_served:.1f} ms at the trace's end, "
          f"{lad.stats['tbt_p95_ms']:.1f} ms after the idle steps [{smi}]", flush=True)
    check(max(served_levels) == len(serve_lib.LADDER_RUNGS) and lad.ladder_level == 0
          and lad.ladder_deescalations == lad.ladder_escalations >= 3,
          "L4: the ladder climbed every rung under load and released every one after it")
    check(first_diff("L4 vs P4", l4, p4) == 0, "L4 == P4 token for token")
    return out


# ---- 8. kernels 3 and 4 against their plain versions ------------------------
# (K, N) of the PIM linears of internlm2-1.8b: wk/wv, wq/wo, w_gate/w_in, w_out
LINEARS = ((2048, 1024), (2048, 2048), (2048, 8192), (8192, 2048))
LINEARS_PER_LAYER = 7
HEAD_MM = (4, 2048, 8192)   # (M, K, N) of kernel 3's line in the JSON: decode w_gate / w_in


def int8_codes(shape, gen, dev, scale: float = 40.0) -> torch.Tensor:
    """Random int8 codes, roughly as a per-token quantize spreads them."""
    x = torch.randn(shape, generator=gen, device=dev) * scale
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def matmul_bound(M: int, K: int, N: int, quantized: bool):
    """Least time of an (M, K) x (K, N) PIM matmul on the H100: x, w and the
    f32 output moved once over HBM, against 2 int8 operations per
    multiply-add at the int8 tensor-core rate plus, under the ADC, 5 float32
    operations per 16-row group and output (divide, round, two clamps, add)
    at the float32 rate."""
    t_bytes = (M * K + K * N + 4 * M * N) / HBM_BPS * 1e3
    t_ops = (2 * M * N * K / INT8_OPS
             + (5 * M * N * -(-K // 16) / F32_OPS if quantized else 0.0)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def softmax_bound(scores: torch.Tensor, mask: torch.Tensor):
    """Least time of the LUT softmax on the H100: each input byte read once
    (the scores at their own dtype, the mask at its un-broadcast size) and
    the int32 codes written once; a few operations per element are far
    below.  A full mask over int32 scores: 9 bytes per position."""
    mask_bytes = math.prod(n for n, st in zip(mask.shape, mask.stride()) if st != 0)
    nbytes = scores.numel() * (scores.element_size() + 4) + mask_bytes
    return nbytes / HBM_BPS * 1e3, "bytes"


def kernel_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device ms per launch of the device kernel `kernel` over `iters` calls
    of `fn` (torch.profiler; other kernels of the calls left out), or
    `event_timed` where no padded profile saw every launch."""
    times = profiled_until(fn, iters, lambda t: kernel_us(t, kernel)[1] == iters,
                           f"some of the {iters} {kernel} launches")
    if times is None:
        return event_timed(fn, iters, f"{kernel} launches")
    return kernel_us(times, kernel)[0] / iters / 1e3


L2_FLUSH_BYTES = 64 << 20   # a write of more than the H100's 50 MB L2


def flushed(fn, dev):
    """`fn` after a write of L2_FLUSH_BYTES: it finds its operands in HBM."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def call():
        buf.fill_(1)
        return fn()
    return call


def staged_max_s(score_bytes: int) -> int:
    """The longest row that kernel 4 stages in shared memory."""
    lo, hi = sm_k.ROWS_MAX_S, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        staged = sm_k._plan(1, mid, score_bytes).regime == "staged"
        lo, hi = (mid, hi) if staged else (lo, mid)
    return lo


def softmax_kernel(dev, lut, gen, same, entries) -> None:
    """Kernel 4 against its plain version bit for bit at every regime's
    boundaries and the served shapes, then timed warm and with L2 flushed."""
    print("kernel 4 (lut_softmax) vs its plain version, bit for bit:", flush=True)

    def scores(shape, dtype=torch.int32):
        return torch.clamp(torch.round(torch.randn(shape, generator=gen, device=dev)
                                       * 24), -128, 127).to(dtype)

    def held(s, mk):
        return bool(torch.equal(sm_k.lut_softmax(s, mk, lut),
                                sm_k.lut_softmax_plain(s, mk, lut)))

    # warp rows (S <= 1024, more than 8 rows an SM: 1,100 rows, not a
    # multiple of a CTA's 8), CTA rows held in registers (S <= 4096),
    # staged in shared memory up to its limit and streamed past it; 1 and 9
    # rows, aligned and one element into the storage, an all-masked row
    # among several
    for dtype in (torch.int32, torch.int8):
        top = staged_max_s(dtype.itemsize)
        for rows in (1, 9, 1100):
            lengths = ((1, 31, 32, 33, 127, 128, 129, 160, 512, 1023, 1024, 1025, 2048,
                        4096, 4097, top, top + 1) if rows < 1100 else (160, 1023, 1024))
            for S in lengths:
                ok = []
                flat = scores((rows * S + 1,), dtype)
                for off in (0, 1):
                    mk = torch.rand((rows, S), generator=gen, device=dev) < 0.9
                    if rows > 1:
                        mk[-1] = False
                    ok.append(held(flat[off:off + rows * S].view(rows, S), mk))
                regime = sm_k._plan(rows, S, dtype.itemsize).regime
                check(all(ok), f"{str(dtype)[6:]} {rows} x {S} ({regime}), aligned and "
                      "one element in: kernel == plain bit for bit")

    # behavioral prefill rows of the classic request: 4 x 16 heads x 128
    # queries over its 160-row cache, causal, as a full mask and as the
    # attention hands it over (broadcast over the heads); decode rows: 4 x 16
    # heads over 4096 positions, 4000 valid
    k_pos = torch.arange(160, device=dev)
    causal = (k_pos[None, :] <= torch.arange(128, device=dev)[:, None]) & (k_pos < 128)
    pre_mask = causal.expand(4, 16, 128, 160).reshape(8192, 160)
    pre = scores((8192, 160))
    same("prefill rows 8192 x 160, causal", "lut_softmax",
         sm_k.lut_softmax(pre, pre_mask, lut), sm_k.lut_softmax_plain(pre, pre_mask, lut))
    att = pre.view(4, 16, 1, 128, 160)
    att_mask = causal.expand(4, 128, 160)[:, None, None].expand(att.shape)
    for what, s in (("int32", att), ("int8", att.to(torch.int8))):
        same(f"the attention's (4, 16, 1, 128, 160) {what} scores, its broadcast mask",
             "lut_softmax", sm_k.lut_softmax(s, att_mask, lut),
             sm_k.lut_softmax_plain(s, att_mask, lut))
    dec_mask = (torch.arange(4096, device=dev) < 4000).expand(64, 4096).clone()
    dec_mask[5] = False                                 # an all-masked row
    dec = scores((64, 4096))
    out = sm_k.lut_softmax(dec, dec_mask, lut)
    same("decode rows 64 x 4096 with an all-masked row", "lut_softmax", out,
         sm_k.lut_softmax_plain(dec, dec_mask, lut))
    check(int(out[5].abs().max()) == 0, "the all-masked row's codes are all 0")
    s8 = dec.to(torch.int8)
    same("int8 score codes", "lut_softmax", sm_k.lut_softmax(s8, dec_mask, lut),
         sm_k.lut_softmax_plain(s8, dec_mask, lut))
    for R, S in ((3, 1024), (2, 4096)):     # a warp row and a staged row
        flat = torch.zeros((R, S), dtype=torch.int32, device=dev)
        flat_mask = torch.ones_like(flat, dtype=torch.bool)
        out = sm_k.lut_softmax(flat, flat_mask, lut)
        same(f"flat rows of {S} table maxima (sum of exps 2^15 * {S} > 2^24)",
             "lut_softmax", out, sm_k.lut_softmax_plain(flat, flat_mask, lut))
        check(bool((out == 65536 // S).all()),
              f"flat rows: every code is 2^16 / {S} = {65536 // S}")

    # ---- timing: served shapes, warm and with L2 flushed ----------------
    print("kernel 4 times, device ms per launch (torch.profiler):", flush=True)
    lens = torch.randint(1, 513, (128, 1), generator=gen, device=dev)
    timed = (("classic decode rows 64 x 160", scores((64, 160)),
              (k_pos < 129).expand(64, 160).clone()),
             ("trace decode rows 128 x 512", scores((128, 512)),
              torch.arange(512, device=dev) < lens),
             ("prefill rows 8192 x 160", pre, pre_mask),
             ("prefill 8192 x 160 as served (broadcast mask)", att, att_mask),
             ("decode rows 64 x 4096", dec, dec_mask))
    srows = []
    for what, sc, mk in timed:
        def call():
            return sm_k.lut_softmax(sc, mk, lut)
        ms = kernel_ms(call, "lut_softmax_kernel")
        cold = kernel_ms(flushed(call, dev), "lut_softmax_kernel")
        plain_ms = per_call_ms(profiled(lambda: sm_k.lut_softmax_plain(sc, mk, lut), 3), 3)
        b_ms, b_by = softmax_bound(sc, mk)
        R, S = sc.numel() // sc.shape[-1], sc.shape[-1]
        regime = sm_k._plan(R, S, sc.element_size()).regime
        srows.append(dict(what=what, rows=R, S=S, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, regime=regime))
        print(f"  lut_softmax {what} ({regime}): warm {ms:.5f} "
              f"({b_ms / ms:.1%} of the bound), L2 flushed {cold:.5f} ({b_ms / cold:.1%}), "
              f"bound {b_ms:.5f} ({b_by}), plain {plain_ms:.4f}", flush=True)
    head = srows[2]
    entries["lut_softmax"] = dict(
        name="lut_softmax", route="cuda",
        source="src/repro_torch/kernels/csrc/lut_softmax.cu",
        replaces="src/repro/kernels/lut_softmax.py:73",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, cold_ms=head["cold_ms"], timed=srows,
        shape="8192 x 160 prefill rows of the classic request, full mask; library: "
              "no one PyTorch call computes the LUT softmax")


def timed_matmul(x, w, pim_q, pim_i) -> dict:
    """Kernel 3 on (M, K) int8 x against the (K, N) int8 view w, timed in
    both ADC modes (device ms per call, torch.profiler), beside its plain
    version, `torch._int_mm` (the ideal mode's product; cuBLAS takes more
    than 16 rows, so x is padded to 32) and its bounds; printed."""
    (M, K), N = x.shape, w.shape[1]
    xp = F.pad(x, (0, 0, 0, max(0, 32 - M)))
    t = {}
    for mode, pc in (("quantized", pim_q), ("ideal", pim_i)):
        def call(pc=pc):
            return mm_k.pim_matmul_int(x, w, pc)
        times = profiled_until(
            call, 20, lambda t: kernel_us(t, "pim_matmul_kernel")[1] == 20,
            f"some of the 20 {mode} pim_matmul launches")
        t[mode] = (event_timed(call, 20, f"M{M} K{K} N{N} {mode} pim_matmul")
                   if times is None else per_call_ms(times, 20))
    t["plain"] = device_ms(lambda: mm_k.pim_matmul_int_plain(x, w, pim_q), 2)
    t["int_mm"] = device_ms(lambda: torch._int_mm(xp, w), 20)
    b_ms, b_by = matmul_bound(M, K, N, True)
    bi_ms, _ = matmul_bound(M, K, N, False)
    tops = {m: 2 * M * N * K / (t[m] * 1e-3) / 1e12 for m in ("quantized", "ideal")}
    print(f"  pim_matmul M{M} K{K} N{N}: quantized {t['quantized']:.4f} "
          f"({tops['quantized']:.1f} TOP/s, {b_ms / t['quantized']:.1%} of the bound "
          f"{b_ms:.4f}, {b_by}), ideal {t['ideal']:.4f} ({tops['ideal']:.1f} TOP/s, "
          f"{bi_ms / t['ideal']:.1%} of {bi_ms:.4f}; {t['ideal'] / t['int_mm']:.2f}x "
          f"torch._int_mm {t['int_mm']:.4f}), plain (quantized) {t['plain']:.4f}",
          flush=True)
    return dict(M=M, K=K, N=N, ms=t["quantized"], ideal_ms=t["ideal"],
                plain_ms=t["plain"], int_mm_ms=t["int_mm"], bound_ms=b_ms,
                bound_by=b_by, ideal_bound_ms=bi_ms, tops=tops["quantized"],
                ideal_tops=tops["ideal"])


def adc_kernels(dev, cfg, gen, entries) -> None:
    """Kernel 3 in both ADC modes and kernel 4, each against its plain
    version bit for bit at the served shapes, then timed (device time from
    torch.profiler)."""
    pim_q = dataclasses.replace(cfg.pim, adc_mode="quantized")
    pim_i = dataclasses.replace(cfg.pim, adc_mode="ideal")
    err = {"pim_matmul": 0.0, "lut_softmax": 0.0}

    def same(what, name, kern, plain):
        torch.cuda.synchronize()
        e = (kern.double() - plain.double()).abs().max().item() if kern.numel() else 0.0
        check(kern.shape == plain.shape and torch.equal(kern, plain),
              f"{what}: kernel == plain bit for bit (max|diff| {e:.3g})")
        err[name] = max(err[name], e)

    def deployed(K, N, layers=3, r=1):
        """Layer r of a stack in the deployed layout: a (K, N) view of an
        (N, K) store, at an offset into the stack."""
        return int8_codes((layers, N, K), gen, dev).transpose(1, 2)[r]

    print("kernel 3 (pim_matmul) vs its plain version, bit for bit:", flush=True)
    for K, N in LINEARS:
        w = deployed(K, N)
        for M in (4, 512, 2048):
            x = int8_codes((M, K), gen, dev)
            for pc in (pim_q, pim_i):
                same(f"M{M} K{K} N{N} {pc.adc_mode}", "pim_matmul",
                     mm_k.pim_matmul_int(x, w, pc), mm_k.pim_matmul_int_plain(x, w, pc))
    stack = int8_codes((3, 2000, 1024), gen, dev)
    w = stack[1]
    check(w.storage_offset() == 2000 * 1024 and w.stride() == (1024, 1),
          "a row-major layer view of a stacked (3, 2000, 1024) block")
    for M in (4, 512):
        x = int8_codes((M, 2000), gen, dev)
        for pc in (pim_q, pim_i):
            same(f"M{M} K2000 (not a multiple of 16) N1024 row-major layer view "
                 f"{pc.adc_mode}", "pim_matmul", mm_k.pim_matmul_int(x, w, pc),
                 mm_k.pim_matmul_int_plain(x, w, pc))
            same(f"M{M} K2000 deployed view {pc.adc_mode}", "pim_matmul",
                 mm_k.pim_matmul_int(x, w.t().contiguous().t(), pc),
                 mm_k.pim_matmul_int_plain(x, w, pc))
    x, w = int8_codes((3, 200), gen, dev), deployed(200, 24)
    same("M3 K200 N24 quantized", "pim_matmul", mm_k.pim_matmul_int(x, w, pim_q),
         mm_k.pim_matmul_int_plain(x, w, pim_q))
    w = deployed(2048, 1024)
    for M in (4, 12, 512):
        # a contiguous x one byte into its storage: rows not 16-byte aligned
        x = int8_codes((M * 2048 + 1,), gen, dev)[1:].view(M, 2048)
        check(x.data_ptr() % 16 != 0, f"M{M} x view is misaligned")
        for pc in (pim_q, pim_i):
            same(f"M{M} K2048 N1024 misaligned x {pc.adc_mode}", "pim_matmul",
                 mm_k.pim_matmul_int(x, w, pc), mm_k.pim_matmul_int_plain(x, w, pc))

    # ---- timing at the served shapes -----------------------------------
    print("kernel 3 times, device ms per call (torch.profiler):", flush=True)
    rows = [timed_matmul(int8_codes((M, K), gen, dev), deployed(K, N), pim_q, pim_i)
            for M in (4, 512, 2048) for K, N in LINEARS]
    head = next(r for r in rows if (r["M"], r["K"], r["N"]) == HEAD_MM)
    entries["pim_matmul"] = dict(
        name="pim_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_matmul.cu",
        replaces="src/repro/kernels/pim_matmul.py:69",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, ideal_ms=head["ideal_ms"],
        int_mm_ms=head["int_mm_ms"], timed=rows,
        shape="M4 K2048 N8192 quantized ADC (decode w_gate / w_in); library: "
              "no one PyTorch call computes the ADC; int_mm_ms is torch._int_mm "
              "of the ideal mode")
    softmax_kernel(dev, cfg.lut, gen, same, entries)
    for name in err:
        entries[name]["max_abs_err"] = err[name]


# ---- 9. paper-fidelity serving: 6-bit ADC linears, behavioral attention ----
ADC_KERNELS = (("pim_matmul_kernel", "pim_matmul"), ("lut_softmax_kernel", "lut_softmax"))
ADC_TARGETS = {"pim_matmul": (core_pim, "_adc_matmul"),
               "lut_softmax": (A, "_lut_softmax_kernel")}


@contextlib.contextmanager
def plain_calls():
    """Counts calls of the plain versions of the four kernels in the block
    (the served path on the card must make none): yields the counter."""
    counts = {}
    saved = {"pim_attention": (attn_k, "pim_attention_plain"),
             "pim_decode": (dec_k, "pim_decode_plain"),
             "pim_matmul": (mm_k, "pim_matmul_int_plain"),
             "lut_softmax": (sm_k, "lut_softmax_plain")}
    fns = {name: getattr(mod, attr) for name, (mod, attr) in saved.items()}

    def counting(name):
        def call(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fns[name](*a, **k)
        return call

    for name, (mod, attr) in saved.items():
        setattr(mod, attr, counting(name))
    try:
        yield counts
    finally:
        for name, (mod, attr) in saved.items():
            setattr(mod, attr, fns[name])


def replay_adc(label: str, kept: dict, rows: dict) -> None:
    """Hold recorded served launches of kernels 3 and 4 against their plain
    versions on the same operands, bit for bit.  `rows` {what: tokens} names
    every launch that must have been recorded (a prefill and a decode
    forward of each kernel) and the tokens its operands hold: kernel 3's M,
    kernel 4's batch x query rows."""
    plain = {"pim_matmul": (mm_k.pim_matmul_int, mm_k.pim_matmul_int_plain),
             "lut_softmax": (sm_k.lut_softmax, sm_k.lut_softmax_plain)}
    check(sorted(kept) == sorted(rows),
          f"{label}: recorded served launches {sorted(kept)}, expected {sorted(rows)}")
    for what, (name, args, kw) in kept.items():
        s = args[0].shape
        # kernel 3: rows of every expert of a stack; kernel 4: batch x rows
        tokens = math.prod(s[:-1]) if name == "pim_matmul" else s[0] * s[-2]
        check(tokens == rows[what], f"{label}, {what}: {name} operands hold "
              f"{tokens} tokens, expected {rows[what]}")
        kern, ref = plain[name]
        o_k, o_p = kern(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(o_k, o_p), f"{label}, {what}: {name} operands "
              f"{tuple(args[0].shape)} x {tuple(args[1].shape)}, kernel == plain "
              "bit for bit")
        if name == "lut_softmax":
            mask = args[1]
            check(0 in mask.stride(), f"{label}, {what}: the served mask is a "
                  f"broadcast (strides {mask.stride()})")
            extra = others(profiled(lambda: kern(*args, **kw), 3), "lut_softmax_kernel")
            check(not extra, f"{label}, {what}: the served call runs kernel 4 and no "
                  f"other device kernel (no mask copy, no int32 conversion) {extra}")


@contextlib.contextmanager
def adc_bounds():
    """Within the block, each kernel 4 call of the behavioral attention and
    each kernel 3 call of a PIM linear records its bound in us
    (`softmax_bound` of its operands, `matmul_bound` of its M, K, N under
    the ADC): yields {"lut_softmax": [...], "pim_matmul": [...]}."""
    seen = {"lut_softmax": [], "pim_matmul": []}
    sm, mm = A._lut_softmax_kernel, core_pim._adc_matmul

    def softmax_call(scores, mask, cfg):
        seen["lut_softmax"].append(softmax_bound(scores, mask)[0] * 1e3)
        return sm(scores, mask, cfg)

    def matmul_call(x, w, cfg):
        seen["pim_matmul"].append(
            matmul_bound(x.shape[0], x.shape[1], w.shape[1], True)[0] * 1e3)
        return mm(x, w, cfg)

    A._lut_softmax_kernel, core_pim._adc_matmul = softmax_call, matmul_call
    try:
        yield seen
    finally:
        A._lut_softmax_kernel, core_pim._adc_matmul = sm, mm


def served_adc(entries, label: str, report: dict, bounds, L: int) -> None:
    """Kernels 4 and 3's device us per launch of a profiled serving run
    beside their mean bounds over the launches of the unprofiled run of the
    same work, and the run's device kernels and copies per forward (one
    kernel 4 launch per layer and forward)."""
    forwards = report["kernels"]["lut_softmax_kernel"]["launched"] // L
    report["device_events_per_forward"] = report["device_events"] / forwards
    for name, kernel, num in (("lut_softmax", "lut_softmax_kernel", 4),
                              ("pim_matmul", "pim_matmul_kernel", 3)):
        us = report["kernels"][kernel]["us_per_launch"]
        b_us = sum(bounds[name]) / len(bounds[name])
        entries[name].setdefault("served_us", {})[label] = us
        entries[name].setdefault("served_bound_us", {})[label] = b_us
        print(f"  kernel {num} on the {label}: {us:.2f} us per launch, bound "
              f"{b_us:.3f} us (mean over its {len(bounds[name])} calls' operands), "
              f"{b_us / us:.1%} of it", flush=True)
    print(f"  {report['device_events_per_forward']:.1f} device kernels and copies "
          f"per forward ({forwards} forwards)", flush=True)


def expect_launches(label: str, launches: dict, forwards: int, L: int) -> None:
    """Kernel 3 once per PIM linear and kernel 4 once per layer (every query
    block here is one chunk) in every forward; no attention kernel."""
    want = {"pim_matmul": LINEARS_PER_LAYER * L * forwards, "lut_softmax": L * forwards}
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{label}: {name} launched {launches.get(name, 0)} times, expected {n}")
    check(not launches.get("pim_attention") and not launches.get("pim_decode"),
          f"{label}: no attention kernel on the behavioral path")


def paper_fidelity(cfg, params, entries) -> dict:
    """internlm2-1.8b at full width and depth under the paper's numerics:
    every PIM linear through the 6-bit ADC (kernel 3) and the behavioral
    Score -> LUT softmax (kernel 4) -> AV attention, with the phase 6
    weights.  The classic request and the phase 7 trace on the paged
    pool."""
    pcfg = dataclasses.replace(cfg, attn_impl="behavioral",
                               pim=dataclasses.replace(cfg.pim, adc_mode="quantized"))
    model = build_model(pcfg)
    dev, L, V = model.device, pcfg.num_layers, pcfg.vocab_size
    print(f"paper fidelity: {pcfg.pim}, attn_impl {pcfg.attn_impl}", flush=True)
    out = {}

    Bs, P, T = 4, 128, 32
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, V)).long()}
    logits, _ = model.forward_serve(params, {"tokens": batch["tokens"].to(dev)},
                                    model.init_cache(Bs, P + T), 0)
    check(tuple(logits.shape) == (Bs, V) and bool(torch.isfinite(logits).all()),
          "paper fidelity: prefill logits finite, (4, 92544)")
    serve_lib.generate(model, params, batch, 2, P + T)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)          # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pick(name, i):
        """Layer 0 of the prefill (w_gate for kernel 3), layer 3 of the
        sixth forward, a decode step (w_out)."""
        mm = name == "pim_matmul"
        per = LINEARS_PER_LAYER if mm else 1
        if i == (4 if mm else 0):
            return "prefill layer 0" + (" w_gate" if mm else "")
        if i == 5 * per * L + 3 * per + (6 if mm else 0):
            return "decode forward 6 layer 3" + (" w_out" if mm else "")
        return None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(pick, ADC_TARGETS) as kept:
        t0 = time.perf_counter()
        toks = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not n_plain, f"classic request: no plain-version call on the path ({n_plain})")
    check(tuple(toks.shape) == (Bs, T) and int(toks.min()) >= 0 and int(toks.max()) < V,
          "paper fidelity: served (4, 32) token ids in the vocabulary")
    expect_launches("classic request", launches, T, L)
    replay_adc("classic request", kept, {
        "prefill layer 0 w_gate": Bs * P, "prefill layer 0": Bs * P,
        "decode forward 6 layer 3 w_out": Bs, "decode forward 6 layer 3": Bs})
    decode_ms = (total_s - prefill_s) / (T - 1) * 1e3
    print(f"  classic request: prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} "
          f"ms/token, {Bs * T / total_s:.1f} tokens/s, peak {peak:.2f} GiB; launches "
          f"{launches}; first sequence {toks[0, :12].tolist()}", flush=True)
    for name in ("pim_matmul", "lut_softmax"):
        entries[name]["launches"] = launches.get(name, 0)
    def cut(_):
        serve_lib.generate(model, params, batch, PROFILED_TOKENS, P + T)

    bounds, wall = unprofiled_wall(lambda: None, cut, adc_bounds)
    out["classic"] = dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
        tokens_per_s=Bs * T / total_s, total_s=total_s, launches=launches,
        peak_gib=peak, **profiled_report(
            lambda: None, cut, f"paper-fidelity request cut to {PROFILED_TOKENS} new "
            "tokens", wall, ADC_KERNELS))
    served_adc(entries, "classic request", out["classic"], bounds, L)

    trace, lens, budgets = sched_trace(V)
    n_tok = int(budgets.sum())

    def pick_sched(name, i):
        """Layer 0 of the first admission wave (8 prompts bucketed to 256
        rows) and of the fourth forward, a decode step."""
        mm = name == "pim_matmul"
        if i == (4 if mm else 0):
            return "wave 1 prefill layer 0" + (" w_gate" if mm else "")
        if i == 3 * (LINEARS_PER_LAYER if mm else 1) * L + (6 if mm else 0):
            return "decode forward 4 layer 0" + (" w_out" if mm else "")
        return None

    sched = serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
    rids = [sched.submit(p, b) for p, b in trace]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(pick_sched, ADC_TARGETS) as kept:
        t0 = time.perf_counter()
        res = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = sched.stats
    check(not n_plain, f"paged trace: no plain-version call on the path ({n_plain})")
    streams = [res.get(r, []) for r in rids]
    check(all(len(s) == b for s, (_, b) in zip(streams, trace))
          and all(0 <= t < V for s in streams for t in s),
          "paper fidelity, paged trace: every request got its budget of "
          "in-vocabulary tokens")
    expect_launches("paged trace", launches, st["model_steps"], L)
    slots = SCHED_KW["max_batch_slots"]
    wave = slots * sched._bucket(int(lens[:slots].max()))
    replay_adc("paged trace", kept, {
        "wave 1 prefill layer 0 w_gate": wave, "wave 1 prefill layer 0": wave,
        "decode forward 4 layer 0 w_out": slots, "decode forward 4 layer 0": slots})
    sched.audit()
    check(len(sched.free_pages) == sched.num_pages - 1,
          "paper fidelity, paged trace: every page returned to the free list")
    print(f"  paged trace: {wall:.2f} s, {n_tok / wall:.1f} tokens/s, "
          f"{wall / st['steps'] * 1e3:.1f} ms per scheduler step ({st['steps']} steps, "
          f"{st['model_steps']} forwards), peak {peak:.2f} GiB, peak pages "
          f"{sched.peak_pages_in_use}, launches {launches}", flush=True)
    entries["pim_matmul"]["paged_launches"] = launches.get("pim_matmul", 0)
    entries["lut_softmax"]["paged_launches"] = launches.get("lut_softmax", 0)
    peak_pages = sched.peak_pages_in_use

    def submitted():
        sched = serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
        for p, b in trace:
            sched.submit(p, b)
        return sched

    def steps(sched):
        for _ in range(PROFILED_STEPS):
            sched.step()

    bounds, cut_wall = unprofiled_wall(submitted, steps, adc_bounds)
    out["paged"] = dict(
        wall_s=wall, tokens_per_s=n_tok / wall, ms_per_step=wall / st["steps"] * 1e3,
        steps=st["steps"], model_steps=st["model_steps"], launches=launches,
        peak_gib=peak, peak_pages_in_use=peak_pages,
        profile=profiled_report(
            submitted, steps, f"first {PROFILED_STEPS} steps of the paper-fidelity "
            "paged trace", cut_wall, ADC_KERNELS))
    served_adc(entries, "paged trace", out["paged"]["profile"], bounds, L)
    return out


def dense_kernels(dev, cfg, gen, operands, compare, bound, entries) -> None:
    """Phase 2: both attention kernels against their plain versions at the
    widths of `cfg`, dense, with their times."""
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh, B = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    print("kernels vs plain versions:", flush=True)
    # prefill: causal Sq 512 (timed), windowed, 4-bit, and the serve shape
    Sq = 512
    q, cache, opnd = operands(Sq, Sq, Sq)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    compare("prefill causal Sq512",
                  pim_attention(*opnd, 0, Sq, **kw),
                  pim_attention_plain(*opnd, 0, Sq, **kw))
    _, iters = pim_attention(*opnd, 0, Sq, **kw)
    exp = expected_kv_block_iters(Sq, Sq, 0, 32, 256)
    check(bool((iters.sum(dim=1) == exp).all()),
          f"prefill iterations per head == expected_kv_block_iters ({exp})")
    kern = lambda: pim_attention(*opnd, 0, Sq, pim_cfg, lut_cfg)  # noqa: E731
    plain = lambda: pim_attention_plain(*opnd, 0, Sq, pim_cfg, lut_cfg)  # noqa: E731
    qb = q.transpose(1, 2)
    kf = torch.randn(B, Hkv, Sq, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qb, kf, kf, is_causal=True, enable_gqa=True)
    us, n = kernel_us(profiled(kern, 20), "pim_attention_kernel")
    check(n == 20, f"profiler saw the 20 prefill launches ({n})")
    ms = us / 20 / 1e3
    plain_ms = per_call_ms(profiled(plain, 3, check_reader=True), 3)
    lib_ms = per_call_ms(profiled(lib, 20), 20)
    walls = dict(wrapper_ms=cuda_ms(kern, 20), plain_wall_ms=cuda_ms(plain, 3),
                 library_wall_ms=cuda_ms(lib, 20))
    nbytes = sum(t.numel() * t.element_size() for t in opnd) + B * H * Sq * Dh * 4
    pairs = B * H * Sq * (Sq + 1) // 2
    b_ms, b_by = bound(nbytes, pairs)
    entries["pim_attention"] = dict(
        name="pim_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_attention.cu",
        replaces="src/repro/kernels/pim_attention.py:224",
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, **walls,
        shape=f"B{B} H{H}/{Hkv} Dh{Dh} Sq{Sq} Sk{Sq} causal int8")
    print(f"  prefill Sq{Sq}, device ms per call: kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}, sdpa bf16 {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); "
          f"wall of back-to-back calls: wrapper {walls['wrapper_ms']:.4f}, plain "
          f"{walls['plain_wall_ms']:.4f}, sdpa {walls['library_wall_ms']:.4f}")
    compare("prefill window 128",
            pim_attention(*opnd, 0, Sq, window=128, **kw),
            pim_attention_plain(*opnd, 0, Sq, window=128, **kw))
    _, _, opnd4 = operands(Sq, Sq, Sq, kv_bits=4)
    compare("prefill kv4", pim_attention(*opnd4, 0, Sq, **kw),
            pim_attention_plain(*opnd4, 0, Sq, **kw))
    _, _, opnd_s = operands(128, 160, 128)
    compare("prefill serve shape Sq128 Sk160",
            pim_attention(*opnd_s, 0, 128, **kw),
            pim_attention_plain(*opnd_s, 0, 128, **kw))
    # a group of 4 q heads (two CTAs of 64 rows at head_dim 128) and head_dim 64
    for what, heads in (("q_per_kv 4 (16 over 4 heads)", (16, 4, Dh)),
                        ("head_dim 64", (H, Hkv, 64))):
        _, _, opnd_h = operands(Sq, Sq, Sq, heads=heads)
        compare(f"prefill {what} Sq{Sq}",
                pim_attention(*opnd_h, 0, Sq, **kw),
                pim_attention_plain(*opnd_h, 0, Sq, **kw))

    # decode: kv_len 4096, block_k 256
    kv = 4096
    q, cache, opnd = operands(1, kv, kv)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, block_k=256, return_iters=True)
    compare("decode kv_len 4096", pim_decode(*opnd, kv - 1, kv, **kw),
                  pim_decode_plain(*opnd, kv - 1, kv, **kw))
    _, iters = pim_decode(*opnd, kv - 1, kv, **kw)
    exp = expected_kv_block_iters(1, kv, kv - 1, 1, 256, kv_valid_len=kv)
    check(bool((iters.sum(dim=1) == exp).all()),
          f"decode partitions per KV head == expected_kv_block_iters ({exp})")
    kern = lambda: pim_decode(*opnd, kv - 1, kv, pim_cfg, lut_cfg)  # noqa: E731
    plain = lambda: pim_decode_plain(*opnd, kv - 1, kv, pim_cfg, lut_cfg)  # noqa: E731
    qb = q.transpose(1, 2)
    kf = torch.randn(B, Hkv, kv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(qb, kf, kf, enable_gqa=True)  # noqa: E731
    times = profiled(kern, 50)
    us, n = kernel_us(times, "pim_decode_kernel")
    check(n == 50, f"profiler saw one pim_decode_kernel per decode call ({n} of 50)")
    rest = others(times, "pim_decode_kernel")
    check(not rest, f"a decode call runs one device kernel, no copy kernel ({rest})")
    ms = us / 50 / 1e3
    plain_ms, lib_ms = per_call_ms(profiled(plain, 3), 3), per_call_ms(profiled(lib, 50), 50)
    walls = dict(wrapper_ms=cuda_ms(kern, 50), plain_wall_ms=cuda_ms(plain, 3),
                 library_wall_ms=cuda_ms(lib, 50))
    nbytes = sum(t.numel() * t.element_size() for t in opnd) + B * H * Dh * 4
    b_ms, b_by = bound(nbytes, B * H * kv)
    entries["pim_decode"] = dict(
        name="pim_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_decode.cu",
        replaces="src/repro/kernels/pim_decode.py:160",
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, **walls,
        shape=f"B{B} H{H}/{Hkv} Dh{Dh} Sq1 kv_len{kv} block_k256 int8")
    print(f"  decode kv{kv}, device ms per call: kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}, sdpa bf16 {lib_ms:.4f}, "
          f"bound {b_ms:.4f} ({b_by}); wall of back-to-back calls: wrapper "
          f"{walls['wrapper_ms']:.4f}, plain {walls['plain_wall_ms']:.4f}, "
          f"sdpa {walls['library_wall_ms']:.4f}")
    # verify rows, bit-identical to single-step launches: Sq 4 (8 packed
    # rows, one row tile) and Sq 5 (10, two tiles: draft_len 4's rows)
    for sq in (4, 5):
        qv, cache_v, opnd_v = operands(sq, kv, kv)
        o_v, it_v = pim_decode(*opnd_v, kv - sq, kv, **kw)
        compare(f"decode verify rows Sq{sq}", (o_v, it_v),
                pim_decode_plain(*opnd_v, kv - sq, kv, **kw))
        same = True
        for l in range(sq):
            o_1 = ops.pim_flash_attention(qv[:, l:l + 1], cache_v, kv - sq + l,
                                          pim_cfg, lut_cfg, out_dtype=torch.float32)
            same &= torch.equal(o_v.reshape(B, H, sq, Dh)[:, :, l], o_1[:, 0])
        check(bool(same), f"verify rows Sq{sq} bit-identical to single-step decodes")
    ql = torch.tensor([1, 0, 1, 1], device=dev)
    compare("decode ragged q_len with a 0 row",
            pim_decode(*opnd, kv - 1, kv, q_len=ql, **kw),
            pim_decode_plain(*opnd, kv - 1, kv, q_len=ql, **kw))
    _, _, opnd4 = operands(1, kv, kv, kv_bits=4)
    compare("decode kv4", pim_decode(*opnd4, kv - 1, kv, **kw),
            pim_decode_plain(*opnd4, kv - 1, kv, **kw))
    # the served request's own shape: a cache of prompt + new tokens = 160
    # rows, holding 129..159 of them, so one partial partition whose rows
    # past Sk are zero-filled and whose rows past kv_len are masked
    Sk = 160
    for kvs in (129, 144, 159):
        _, _, opnd_s = operands(1, Sk, kvs)
        compare(f"decode serve shape Sk{Sk} kv_len {kvs}",
                pim_decode(*opnd_s, kvs - 1, kvs, **kw),
                pim_decode_plain(*opnd_s, kvs - 1, kvs, **kw))
    _, _, opnd_s = operands(4, Sk, 150)
    compare(f"decode serve shape Sk{Sk} verify rows Sq4",
            pim_decode(*opnd_s, 146, 150, **kw),
            pim_decode_plain(*opnd_s, 146, 150, **kw))
    _, _, opnd_s = operands(1, Sk, 137, kv_bits=4)
    compare(f"decode serve shape Sk{Sk} kv4",
            pim_decode(*opnd_s, 136, 137, **kw),
            pim_decode_plain(*opnd_s, 136, 137, **kw))
    # block sizes other than 16, 32, 64 and multiples of 128: each partition
    # a unit of its own, its rows past block_k zero-filled and masked
    _, _, opnd_o = operands(4, 1000, 1000)
    for bk in (8, 48, 96, 192):
        for what, o, L in (("Sq1", opnd, kv), ("verify rows Sq4", opnd_o, 1000)):
            n, kwb = o[0].shape[1], dict(kw, block_k=bk)
            compare(f"decode block_k {bk} {what} kv_len {L}",
                    pim_decode(*o, L - n, L, **kwb), pim_decode_plain(*o, L - n, L, **kwb))


# ---- 2 and 3 at head_dims 256 and 96: the Griffin family's and phi-3's heads ---
# head_dim: (head cases, prefill cases (Sq, window, timed) of a head case,
# decode cases (block_k, window) of a head case, verify rows' windows)
WIDE_HEADS = {
    256: ((("16/16 heads (gemma-7b)", (16, 16, 256)),
           ("16/1 heads (recurrentgemma-9b)", (16, 1, 256))),
          lambda Hkv: ((512, 0, True), (512, 128, False))
          + (((2304, 2048, True),) if Hkv == 1 else ()),   # recurrentgemma-9b's window
          lambda Hkv: ((256, 0), (256, 2048)),
          (0, 2048)),
    # phi-3's 32/32 heads, and 32/8 for the prefill's 64-row CTAs (q_per_kv
    # 4) and kernel 2's 32-dim slices (dsplit 3: 32 tiles at block_k 2048)
    96: ((("32/32 heads (phi-3-vision-4.2b)", (32, 32, 96)),
          ("32/8 heads", (32, 8, 96))),
         lambda Hkv: ((512, 0, True), (512, 128, True)),
         lambda Hkv: ((256, 0),) + (((2048, 0),) if Hkv == 8 else ()),
         (0,)),
}


def window_pairs(Sq: int, offset: int, kv_len: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the query at offset + i sees
    the keys (q - window, q] below kv_len (window 0: every key up to q)."""
    q = offset + np.arange(Sq)
    hi = np.minimum(q + 1, kv_len)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo, 0).sum())


def timed_call(kern, plain, lib, kernel: str, iters: int) -> dict:
    """Device ms per call of a kernel (its launches all seen), its plain
    version and a bf16 SDPA yardstick, from torch.profiler (`kernel_ms`,
    `device_ms`)."""
    return dict(ms=kernel_ms(kern, kernel, iters), plain_ms=device_ms(plain, 2),
                library_ms=device_ms(lib, iters))


def dense_kernels_wide(Dh, dev, cfg, gen, operands, compare, entries) -> None:
    """Phase 2 at head_dim `Dh` (WIDE_HEADS): both kernels against their
    plain versions (iteration maps against the analytic count), verify rows
    bit-identical to single steps, 4-bit KV, and times beside bounds and
    bf16 SDPA; kernel 2's grid (rows, head-dim slices, chunks) printed."""
    head_cases, prefill_cases, decode_cases, verify_windows = WIDE_HEADS[Dh]
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    B = 4
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    timed, dsplits = {}, set()
    print(f"kernels vs plain versions at head_dim {Dh}:", flush=True)
    for what, heads in head_cases:
        H, Hkv, _ = heads
        for Sq, window, time_it in prefill_cases(Hkv):
            q, _, opnd = operands(Sq, Sq, Sq, heads=heads)
            name = f"prefill Dh{Dh} {what} Sq{Sq} window {window}"
            got = pim_attention(*opnd, 0, Sq, window=window, **kw)
            compare(name, got, pim_attention_plain(*opnd, 0, Sq, window=window, **kw))
            exp = expected_kv_block_iters(Sq, Sq, 0, 32, 256, window=window)
            check(bool((got[1].sum(dim=1) == exp).all()),
                  f"{name}: iterations per head == expected_kv_block_iters ({exp})")
            if not time_it:
                continue
            qb = q.transpose(1, 2)
            kf = torch.randn(B, Hkv, Sq, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
            mask = None
            if window:
                pos = torch.arange(Sq, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            t = timed_call(
                lambda: pim_attention(*opnd, 0, Sq, pim_cfg, lut_cfg, window=window),
                lambda: pim_attention_plain(*opnd, 0, Sq, pim_cfg, lut_cfg, window=window),
                lambda: F.scaled_dot_product_attention(
                    qb, kf, kf, attn_mask=mask, is_causal=mask is None, enable_gqa=True),
                "pim_attention_kernel", 20)
            nbytes = sum(x.numel() * x.element_size() for x in opnd) + B * H * Sq * Dh * 4
            pairs = B * H * window_pairs(Sq, 0, Sq, window)
            t["bound_ms"], t["bound_by"] = attention_bound(nbytes, pairs, Dh)
            t["rows"] = attn_k.launch_plan(Dh, Dh, 32, H // Hkv, 256).rows
            key = f"prefill {heads[0]}/{heads[1]} Sq{Sq} window {window}"
            timed[key] = t
            print(f"  {key} ({t['rows']}-row CTAs): kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f}, sdpa bf16 {t['library_ms']:.4f}, bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} "
                  "of it", flush=True)
        _, _, opnd4 = operands(512, 512, 512, kv_bits=4, heads=heads)
        compare(f"prefill Dh{Dh} {what} kv4 Sq512", pim_attention(*opnd4, 0, 512, **kw),
                pim_attention_plain(*opnd4, 0, 512, **kw))
        # decode at kv_len 4096, with and without the window
        kv = 4096
        q, cache, opnd = operands(1, kv, kv, heads=heads)
        for bk, window in decode_cases(Hkv):
            kwd = dict(kw, block_k=bk)
            plan = dec_k._checked_plan(H // Hkv, Dh, Dh, bk, kv // bk, B * Hkv, False,
                                       dev.index or 0)
            dsplits.add(plan.dsplit)
            name = f"decode Dh{Dh} {what} kv_len {kv} block_k {bk} window {window}"
            got = pim_decode(*opnd, kv - 1, kv, window=window, **kwd)
            compare(name, got, pim_decode_plain(*opnd, kv - 1, kv, window=window, **kwd))
            exp = expected_kv_block_iters(1, kv, kv - 1, 1, bk, window=window,
                                          kv_valid_len=kv)
            check(bool((got[1].sum(dim=1) == exp).all()),
                  f"{name}: partitions per KV head == expected_kv_block_iters ({exp})")
            qb = q.transpose(1, 2)
            kf = torch.randn(B, Hkv, kv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
            lo = kv - window if window else 0
            t = timed_call(
                lambda: pim_decode(*opnd, kv - 1, kv, pim_cfg, lut_cfg, window=window,
                                   block_k=bk),
                lambda: pim_decode_plain(*opnd, kv - 1, kv, pim_cfg, lut_cfg, window=window,
                                         block_k=bk),
                lambda: F.scaled_dot_product_attention(qb, kf[:, :, lo:], kf[:, :, lo:],
                                                       enable_gqa=True),
                "pim_decode_kernel", 50)
            keys = kv - lo
            nbytes = (B * Hkv * keys * (2 * Dh + 8) + B * H * (Dh + 4 + 4 * Dh))
            t["bound_ms"], t["bound_by"] = attention_bound(nbytes, B * H * keys, Dh)
            t["grid"] = dict(rows=plan.rows, dsplit=plan.dsplit, chunks=plan.chunks)
            key = (f"decode {heads[0]}/{heads[1]} kv_len {kv} window {window}"
                   + (f" block_k {bk}" if bk != 256 else ""))
            timed[key] = t
            print(f"  {key} (tiles of {plan.rows} rows, dsplit {plan.dsplit}, "
                  f"{plan.chunks} chunks): kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f}, sdpa bf16 {t['library_ms']:.4f}, bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} "
                  "of it", flush=True)
        kwd = dict(kw, block_k=256)
        for sq in (4, 5):
            qv, cache_v, opnd_v = operands(sq, kv, kv, heads=heads)
            for window in verify_windows:
                o_v, it_v = pim_decode(*opnd_v, kv - sq, kv, window=window, **kwd)
                compare(f"decode Dh{Dh} {what} verify rows Sq{sq} window {window}",
                        (o_v, it_v),
                        pim_decode_plain(*opnd_v, kv - sq, kv, window=window, **kwd))
                same = True
                for l in range(sq):
                    o_1 = ops.pim_flash_attention(qv[:, l:l + 1], cache_v, kv - sq + l,
                                                  pim_cfg, lut_cfg, window=window,
                                                  out_dtype=torch.float32)
                    same &= torch.equal(o_v.reshape(B, H, sq, Dh)[:, :, l], o_1[:, 0])
                check(bool(same), f"Dh{Dh} {what} verify rows Sq{sq} window {window} "
                      "bit-identical to single-step decodes")
        _, _, opnd4 = operands(1, kv, kv, kv_bits=4, heads=heads)
        compare(f"decode Dh{Dh} {what} kv4", pim_decode(*opnd4, kv - 1, kv, **kwd),
                pim_decode_plain(*opnd4, kv - 1, kv, **kwd))
    if Dh == 96:
        check(dsplits == {1, 3}, f"Dh96 decode: 32-dim slices and whole head dims both "
              f"launched (dsplit {sorted(dsplits)})")
    for name, prefix in (("pim_attention", "prefill"), ("pim_decode", "decode")):
        entries[name][f"dh{Dh}"] = {k: v for k, v in timed.items() if k.startswith(prefix)}


def paged_kernels_wide(Dh, dev, cfg, gen, compare) -> None:
    """Phase 3 at head_dim `Dh` (WIDE_HEADS): both kernels over 16-token
    pages against their plain versions, int8 and 4-bit, and paged == dense
    at block_k == page size bit for bit."""
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    S = 2048
    for what, (H, Hkv, _) in WIDE_HEADS[Dh][0]:
        for seed, (Sq, kv_bits, window, kern, plain) in enumerate((
                (1, 8, 0, pim_decode, pim_decode_plain),
                (4, 8, 0, pim_decode, pim_decode_plain),
                (1, 4, 0, pim_decode, pim_decode_plain),
                (128, 8, 0, pim_attention, pim_attention_plain),
                (128, 4, 0, pim_attention, pim_attention_plain))):
            lens = [16, 17, 2048, 1000]
            B = len(lens)
            lens_d = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
            k = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
            v = torch.randn(B, S, Hkv, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
            zeros = torch.zeros(B, dtype=torch.int32, device=dev)
            dense = A.init_kv_cache(B, S, Hkv, Dh, kv_bits=kv_bits, device=dev, ragged=True)
            A.cache_write_ragged(dense, k, v, zeros, pim_cfg, seq_lens=lens_d)
            pt, P = random_table(lens, S // PAGE, 30 + seed, dev)
            pool = A.init_paged_kv_cache(P, PAGE, Hkv, Dh, kv_bits=kv_bits, device=dev)
            A.paged_cache_write(pool, k, v, zeros, pim_cfg, pt, seq_lens=lens_d)
            q_q, qs = ops._q_kernel_layout(q, pim_cfg.input_bits)
            paged = (q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale)
            offs, ql = torch.clamp(lens_d - Sq, min=0), torch.clamp(lens_d, max=Sq)
            name = (f"{'decode' if Sq < 128 else 'prefill'} Dh{Dh} {what} paged Sq{Sq} "
                    f"kv{kv_bits} lens {lens}")
            o_k = kern(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw)
            compare(name, o_k, plain(*paged, offs, lens_d, q_len=ql, page_table=pt, **kw))
            o_d = kern(*ops.kernel_attention_layout(q, dense, pim_cfg.input_bits), offs,
                       lens_d, q_len=ql, block_k=PAGE, **kw)
            check(torch.equal(o_k[0], o_d[0]) and torch.equal(o_k[1], o_d[1]),
                  f"{name}: paged == dense at block_k {PAGE}, bit for bit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the results here")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phases to run (default: all); phase 1 "
                         "always runs, and a phase brings the ones it needs")
    args = ap.parse_args(argv)
    phases = {1} | {int(p) for p in args.phases.split(",") if p.strip()}
    if not phases <= set(PHASES):
        ap.error(f"--phases takes phases of {PHASES}")
    for p in sorted(phases, reverse=True):
        phases |= NEEDS.get(p, set())

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {}

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    results["card"] = smi
    _build.build_all()
    info = _build.build_info
    print(f"build: {info['seconds']:.1f}s for {info['built'] or 'nothing (cached)'}")
    for name in _build.SOURCES:
        for line in str(info.get(f"nvcc_{name}", "")).splitlines():
            if "Function properties for" in line:   # the kernel (template) named
                print(f"  ptxas {name}: {line.split('for')[-1].strip()[-48:]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    results["build_s"] = info["seconds"]
    results["pim_matmul_imma"] = sass_imma("pim_matmul")
    results["pim_attention_imma"] = sass_imma("pim_attention")
    results["pim_decode_imma"] = sass_imma("pim_decode")

    # ---- 2. kernels against their plain versions --------------------------
    cfg = get_config("internlm2-1.8b")
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Hkv, Dh, B = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, 4
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(Sq, Sk, kv_len, kv_bits=8, heads=(H, Hkv, Dh)):
        """Random q and a dense cache of kv_len tokens at (q heads, KV
        heads, head_dim) `heads`: (q, cache, kernel operands)."""
        Hq, Hk, D = heads
        q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, kv_len, Hk, D, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, kv_len, Hk, D, generator=gen, device=dev, dtype=torch.bfloat16)
        cache = A.init_kv_cache(B, Sk, Hk, D, kv_bits=kv_bits, device=dev)
        A.cache_write(cache, k, v, 0, pim_cfg)
        return q, cache, ops.kernel_attention_layout(q, cache, pim_cfg.input_bits)

    max_err = {"pim_attention": 0.0, "pim_decode": 0.0}

    def compare(name, kern, plain):
        """Hold a kernel's (out, iters) to its plain version's; the error
        counts toward pim_attention in "prefill ..." cases, else pim_decode."""
        (o_k, it_k), (o_p, it_p) = kern, plain
        torch.cuda.synchronize()
        err = (o_k - o_p).abs().max().item()
        scale = o_p.abs().max().item()
        check(bool(torch.isfinite(o_k).all()) and err <= REL_TOL * scale,
              f"{name}: max|kernel-plain| {err:.3g} <= {REL_TOL} * {scale:.3g}")
        check(torch.equal(it_k, it_p), f"{name}: iteration maps equal")
        kernel = "pim_attention" if name.startswith("prefill") else "pim_decode"
        max_err[kernel] = max(max_err[kernel], err)

    def bound(nbytes, pairs):
        return attention_bound(nbytes, pairs, Dh)

    entries = {}
    if 2 in phases:
        stamp("phase 2")
        dense_kernels(dev, cfg, gen, operands, compare, bound, entries)
        for wide in (256, 96):
            dense_kernels_wide(wide, dev, cfg, gen, operands, compare, entries)
    if 3 in phases:
        stamp("phase 3")
        paged_kernels(dev, cfg, gen, compare, bound, entries)
        for wide in (256, 96):
            paged_kernels_wide(wide, dev, cfg, gen, compare)
    if 8 in phases:
        stamp("phase 8")
        adc_kernels(dev, cfg, gen, entries)
    if 4 in phases:
        small_model(dev, 5 in phases)
    if phases & {6, 7, 9, 10, 11, 12, 13}:
        serve_phases(dev, cfg, phases, entries, compare, results)
    if 14 in phases:
        moe_phase(dev, entries, compare, results)
    if 15 in phases:
        griffin_phase(entries, compare, results)
    if 16 in phases:
        phi3_phase(entries, compare, results)
    if 17 in phases:
        whisper_phase(dev, entries, compare, results)
    if 18 in phases:
        xlstm_phase(dev, entries, compare, results)
    if 19 in phases:
        train_phase(dev, entries, results)
    if 20 in phases:
        zoo_train_phase(dev, entries, results)
    stamp(f"phases {sorted(phases)} done: every check passed")
    for name in max_err:
        if name in entries:
            entries[name]["max_abs_err"] = max_err[name]
    results["kernels"] = list(entries.values())
    results["event_timed"] = EVENT_TIMED
    print(f"measurements timed with CUDA events, no profile having seen them: "
          f"{EVENT_TIMED or 'none'}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("wrapper_ms", "cold_ms", "served_us", "served_bound_us", "paged_ms", "paged_bound_ms",
             "paged_launches", "dense_sched_launches", "mixed_launches", "verify_launches",
             "kv4_launches", "paged_kv4_ms", "paged_kv4_bound_ms",
             "ideal_ms", "int_mm_ms", "quantized_ms", "quantized_bound_ms",
             "int_mm_loop_ms", "dh256", "dh96", "dh64", "griffin_launches", "xlstm",
             "train", "train_zoo")
    print(json.dumps({"kernels": [{**{k: e.get(k) for k in keys},
                                   **{k: e[k] for k in extra if k in e}}
                                  for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---- 14. Mixture-of-Experts serving: deepseek-moe-16b and dbrx-132b --------
# M of deepseek's routed expert launch: C of a 4-row decode step (1), of 40
# verify rows (5), of the classic 512-row prefill (60) and of an admission
# wave of 8 x 256 rows (240); (K, N) of its w_gate / w_in and its w_out
MOE_ROUTED_M = (1, 5, 60, 240)
MOE_KN = ((2048, 1408), (1408, 2048))
MOE_HEAD = (64, 1, 2048, 1408)   # (E, M, K, N) of the JSON line: decode w_gate / w_in
DBRX_LAYERS = 4                  # dbrx-132b's first layers served (40 do not fit one card)
MOE_TRACE = 8                    # requests of phase 7's trace through the Scheduler


def expert_bound(E: int, M: int, K: int, N: int, quantized: bool):
    """`matmul_bound` of E expert products: E times each's bytes and
    operations (every expert's weights read once)."""
    ms, by = matmul_bound(M, K, N, quantized)
    return E * ms, by


def int_mm_rows(x: torch.Tensor) -> torch.Tensor:
    """x padded with zero rows to what cuBLAS's int8 GEMM takes: more than
    16 rows, a multiple of 8."""
    M = x.shape[-2]
    return F.pad(x, (0, 0, 0, max(32, -(-M // 8) * 8) - M))


def expert_kernels(dev, gen, entries) -> dict:
    """Phase 14 (a): kernel 3's expert launch against its plain version and
    against E single launches, bit for bit, in both ADC modes, at the
    shapes deepseek-moe-16b's and dbrx-132b's experts serve; then timed
    beside its bound and, as a yardstick the port never calls, a loop of E
    `torch._int_mm` calls of the ideal mode."""
    pim_q = dataclasses.replace(PIMConfig(), adc_mode="quantized")
    pim_i = dataclasses.replace(PIMConfig(), adc_mode="ideal")
    shapes = [(64, M, K, N, "deepseek routed") for M in MOE_ROUTED_M for K, N in MOE_KN]
    shapes += [(2, M, K, N, "deepseek shared") for M in (4, 512) for K, N in MOE_KN]
    shapes += [(16, 160, 6144, 10752, "dbrx routed")]
    print("kernel 3's expert launch vs its plain version and E single launches, "
          "bit for bit; device ms per launch (torch.profiler):", flush=True)
    rows, err = [], 0.0
    for E, M, K, N, what in shapes:
        x = int8_codes((E, M, K), gen, dev)
        w = int8_codes((E, N, K), gen, dev).transpose(1, 2)     # the deployed layout
        row = dict(what=what, E=E, M=M, K=K, N=N)
        for mode, pc in (("ideal", pim_i), ("quantized", pim_q)):
            got = mm_k.pim_matmul_int(x, w, pc)
            plain = mm_k.pim_matmul_int_plain(x, w, pc)
            singles = torch.stack([mm_k.pim_matmul_int(x[e], w[e], pc) for e in range(E)])
            torch.cuda.synchronize()
            e_max = (got.double() - plain.double()).abs().max().item()
            err = max(err, e_max)
            check(got.shape == (E, M, N) and torch.equal(got, plain)
                  and torch.equal(got, singles),
                  f"{what} E{E} M{M} K{K} N{N} {mode}: one launch == plain == "
                  f"{E} single launches (max|diff| {e_max:.3g})")
            row[mode] = kernel_ms(lambda: mm_k.pim_matmul_int(x, w, pc), "pim_matmul_kernel")
            row[f"{mode}_bound"], row[f"{mode}_bound_by"] = expert_bound(
                E, M, K, N, mode == "quantized")
            del got, plain, singles
        xp = int_mm_rows(x)
        row["int_mm_loop"] = device_ms(
            lambda: [torch._int_mm(xp[e], w[e]) for e in range(E)], 5,
            f"{E} torch._int_mm at M{M} K{K} N{N}")
        if (E, M, K, N) == MOE_HEAD:
            for mode, pc in (("ideal", pim_i), ("quantized", pim_q)):
                row[f"{mode}_plain"] = device_ms(
                    lambda: mm_k.pim_matmul_int_plain(x, w, pc), 2,
                    f"the {mode} expert plain version")
        rows.append(row)
        print(f"  {what} E{E} M{M} K{K} N{N}: ideal {row['ideal']:.4f} (bound "
              f"{row['ideal_bound']:.4f}, {row['ideal_bound_by']}, "
              f"{row['ideal_bound'] / row['ideal']:.1%}), quantized {row['quantized']:.4f} "
              f"(bound {row['quantized_bound']:.4f}, {row['quantized_bound_by']}, "
              f"{row['quantized_bound'] / row['quantized']:.1%}); loop of {E} "
              f"torch._int_mm {row['int_mm_loop']:.4f}", flush=True)
        del x, w, xp
        torch.cuda.empty_cache()
    head = next(r for r in rows if (r["E"], r["M"], r["K"], r["N"]) == MOE_HEAD)
    entries["pim_matmul_experts"] = dict(
        name="pim_matmul_experts", route="cuda",
        source="src/repro_torch/kernels/csrc/pim_matmul.cu",
        replaces="src/repro/kernels/pim_matmul.py:69",
        ms=head["ideal"], plain_ms=head["ideal_plain"], bound_ms=head["ideal_bound"],
        bound_by=head["ideal_bound_by"], library_ms=None, max_abs_err=err,
        quantized_ms=head["quantized"], quantized_plain_ms=head["quantized_plain"],
        quantized_bound_ms=head["quantized_bound"], int_mm_loop_ms=head["int_mm_loop"],
        timed=rows,
        shape="E64 M1 K2048 N1408 ideal ADC (deepseek-moe-16b's routed w_gate / w_in "
              "at decode); library: no one PyTorch call computes a batched int8 "
              "product; int_mm_loop_ms is a loop of 64 torch._int_mm calls")
    return dict(timed=rows, max_abs_err=err)


@contextlib.contextmanager
def expert_launches(pick=lambda i: None):
    """Within the block, records (E, M, K, N, ADC mode) of every expert launch
    of kernel 3 (the stacked calls of `core/pim.py`) and keeps the operands
    of those `pick(index)` labels: the activations copied at launch, the
    weights as the layer holds them (serving never writes them).  Yields
    (shapes, {label: (x, w, cfg)})."""
    seen, kept = [], {}
    fn = core_pim._adc_matmul

    def call(x, w, cfg):
        if w.dim() == 3:
            label = pick(len(seen))
            seen.append((x.shape[0], x.shape[1], x.shape[2], w.shape[2], cfg.adc_mode))
            if label:
                kept[label] = (x.clone(), w, cfg)
        return fn(x, w, cfg)

    core_pim._adc_matmul = call
    try:
        yield seen, kept
    finally:
        core_pim._adc_matmul = fn


def replay_experts(label: str, kept: dict, want: dict) -> None:
    """Served expert launches against the plain version, bit for bit; `want`
    {label: M} names every launch that must have been kept."""
    check(sorted(kept) == sorted(want),
          f"{label}: kept expert launches {sorted(kept)}, expected {sorted(want)}")
    for what, (x, w, cfg) in kept.items():
        check(x.shape[1] == want[what], f"{label}, {what}: {x.shape[1]} rows an "
              f"expert, expected {want[what]}")
        got, plain = mm_k.pim_matmul_int(x, w, cfg), mm_k.pim_matmul_int_plain(x, w, cfg)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{label}, {what}: served expert launch "
              f"{tuple(x.shape)} x {tuple(w.shape)} {cfg.adc_mode}, kernel == plain "
              "bit for bit")


def moe_launches(cfg, forwards: int) -> dict:
    """Launches of each kernel wrapper in `forwards` forwards of the classic
    request on the kernel path at the ideal ADC: kernel 1 once a layer in
    the prefill, kernel 2 once a layer in each decode, kernel 3's expert
    launch once per expert matrix of a MoE layer (w_gate, w_in, w_out of the
    routed experts, and of the shared ones)."""
    L = cfg.num_layers
    moe_layers = L - cfg.num_dense_layers
    mats = 3 * (1 + (cfg.moe.num_shared > 0))
    return {"pim_attention": L, "pim_decode": (forwards - 1) * L,
            "pim_matmul_experts": mats * moe_layers * forwards}


def moe_split(params, cfg, xf) -> dict:
    """Device ms of one MoE layer on its served input `xf`, by part: the
    router (float32 product, softmax, top-k, normalisation), the dispatch
    (stable sort, ranks, the (E, C, D) buffer), the experts (routed and
    shared stacks through kernel 3's expert launch) and the combine
    (gates, the ordered adds, the shared sum)."""
    p = TT._index(params["blocks"][0], 0)["moe"]
    T, E = xf.shape[0], cfg.moe.num_experts
    C = moe_mod.capacity(T, cfg)
    gate, idx = moe_mod.route(p, xf, cfg)
    xe, slot, keep = moe_mod.dispatch(xf, idx, C, E)
    rows = xf.expand((cfg.moe.num_shared,) + xf.shape)

    def experts():
        return (mlp_apply(p["experts"], xe, cfg),
                mlp_apply(p["shared"], rows, cfg) if "shared" in p else None)

    ye, sh = experts()

    def combine():
        y = moe_mod.combine(ye, gate, idx, slot, keep)
        return y if sh is None else y + sh.sum(0)

    parts = {"router": lambda: moe_mod.route(p, xf, cfg),
             "dispatch": lambda: moe_mod.dispatch(xf, idx, C, E),
             "experts": experts, "combine": combine,
             "layer": lambda: moe_mod.moe_ffn_local(p, xf, cfg)}
    out = {name: device_ms(fn, 10, f"the MoE {name}") for name, fn in parts.items()}
    out.update(T=T, C=C)
    return out


def moe_model(cfg, entries, compare, full: bool) -> dict:
    """Phase 14 (b)-(e) for one MoE model at its published widths on the
    kernel path at the ideal ADC, random weights from seed 0: the classic
    request (batch 4, prompt 128; `full`: 32 new tokens, else the prefill
    and 8 decode tokens), its launches and served kernel launches replayed,
    profiled (busy share, kernels 1-3's us per launch beside their bounds)
    and its MoE layer's device time split by part; with `full` also dense
    == paged streams on one-page prompts, the Scheduler over 8 requests of
    phase 7's trace and a forward at the paper's fidelity."""
    name = cfg.name
    stamp(f"phase 14: {name}, {cfg.num_layers} layers")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    dev, L, V = model.device, cfg.num_layers, cfg.vocab_size
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for t in ckpt_flatten(params) if isinstance(t, torch.Tensor)]
    weight_gb = sum(t.untyped_storage().nbytes() for t in leaves) / 1e9
    peak_init = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serve {name}: {L} layers ({cfg.num_dense_layers} dense), d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads (q_per_kv "
          f"{cfg.num_heads // cfg.num_kv_heads}), head_dim {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, {cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
          f"{cfg.moe.num_shared} shared, vocab {V}, {cfg.param_count() / 1e9:.3f} B "
          f"params, {weight_gb:.2f} GB deployed; init+deploy {init_s:.1f} s, peak "
          f"{peak_init:.2f} GiB", flush=True)
    out = dict(layers=L, init_s=init_s, weight_gb=weight_gb, peak_init_gib=peak_init)

    Bs, P = 4, 128
    T = 32 if full else 9
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, V)).long()}
    serve_lib.generate(model, params, batch, 2, P + T)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)           # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    moe_layers = L - cfg.num_dense_layers
    mats = 3 * (1 + (cfg.moe.num_shared > 0))
    last = mats * moe_layers
    # a forward's expert launch of the last MoE layer's routed w_out (each
    # layer launches the routed w_gate, w_in, w_out, then the shared ones)
    w_out = (moe_layers - 1) * mats + 2

    def pick_expert(i):
        """The prefill's first expert launch (the first MoE layer's routed
        w_gate) and the last forward's routed w_out of the last MoE layer."""
        if i == 0:
            return "prefill w_gate"
        if i == (T - 1) * last + w_out:
            return f"decode forward {T} w_out"
        return None

    def pick_attention(kind, i):
        """The prefill's first layer and a decode forward's last layer."""
        if kind == "pim_attention" and i == 0:
            return "prefill layer 0"
        if kind == "pim_decode" and i == 3 * L - 1:
            return f"decode forward 4 layer {L - 1}"
        return None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, expert_launches(pick_expert) as (seen, kept), \
            recorded(pick_attention) as kept_attn:
        t0 = time.perf_counter()
        toks = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not n_plain, f"{name}: no plain-version call on the path ({n_plain})")
    want = moe_launches(cfg, T)
    check(all(launches.get(k, 0) == n for k, n in want.items())
          and not launches.get("pim_matmul"),
          f"{name}: launches {launches} == {want}, no single-product kernel 3 "
          "(the dense linears' ideal ADC is cuBLAS's int8 GEMM)")
    check(tuple(toks.shape) == (Bs, T) and int(toks.min()) >= 0
          and int(toks.max()) < V, f"{name}: served ({Bs}, {T}) token ids in the vocabulary")
    C_pre, C_dec = moe_mod.capacity(Bs * P, cfg), moe_mod.capacity(Bs, cfg)
    replay_experts(name, kept, {"prefill w_gate": C_pre, f"decode forward {T} w_out": C_dec})
    replay_served(name, kept_attn, compare)
    decode_ms = (total_s - prefill_s) / (T - 1) * 1e3
    print(f"  classic request: prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} "
          f"ms/token, {Bs * T / total_s:.1f} tokens/s, peak {peak:.2f} GiB; launches "
          f"{launches} ({sum(launches.values()) / T:.1f} kernel launches per forward); "
          f"C {C_pre} at prefill, {C_dec} at decode; first sequence "
          f"{toks[0, :12].tolist()}", flush=True)
    out["classic"] = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                          tokens_per_s=Bs * T / total_s, total_s=total_s,
                          launches=launches, forwards=T, peak_gib=peak)
    if full:
        entries["pim_matmul_experts"]["launches"] = launches["pim_matmul_experts"]

    # the request cut to PROFILED_TOKENS new tokens, unprofiled, then profiled
    cut_tokens = min(PROFILED_TOKENS, T)

    def cut(_):
        serve_lib.generate(model, params, batch, cut_tokens, P + T)

    @contextlib.contextmanager
    def shapes_of_launches():
        with launch_shapes(cfg) as attn, expert_launches() as (experts, _):
            yield attn, experts

    (attn_shapes, exp_shapes), wall = unprofiled_wall(lambda: None, cut, shapes_of_launches)
    label = f"{name} request cut to {cut_tokens} new tokens"
    report = profiled_report(lambda: None, cut, label, wall, ATTENTION_KERNELS
                             + (("pim_matmul_kernel", "pim_matmul_experts"),))
    served = {}
    for kind, kernel, num in (("pim_attention", "pim_attention_kernel", 1),
                              ("pim_decode", "pim_decode_kernel", 2)):
        bounds = [(prefill_bound(*s, cfg) if num == 1 else decode_bound(*s[1:4], cfg))[0]
                  * 1e3 for s in attn_shapes[kind]]
        served[kind] = (report["kernels"][kernel]["us_per_launch"],
                        sum(bounds) / len(bounds))
    bounds = [expert_bound(E, M, K, N, False)[0] * 1e3 for E, M, K, N, _ in exp_shapes]
    served["pim_matmul_experts"] = (report["kernels"]["pim_matmul_kernel"]["us_per_launch"],
                                    sum(bounds) / len(bounds))
    for kind, (us, b_us) in served.items():
        print(f"  {kind} served on the {label}: {us:.2f} us per launch, bound "
              f"{b_us:.3f} us (mean over the launches' shapes), {b_us / us:.1%} of it",
              flush=True)
        if kind in entries:
            entries[kind].setdefault("served_us", {})[name] = us
            entries[kind].setdefault("served_bound_us", {})[name] = b_us
    report["served_us"] = served
    report["device_events_per_forward"] = report["device_events"] / cut_tokens
    print(f"  {report['device_events_per_forward']:.1f} device kernels and copies per "
          f"forward, {report['host_launches'] / cut_tokens:.1f} cudaLaunchKernel calls",
          flush=True)
    out["profile"] = report

    # one MoE layer's device time by part, on its served prefill and decode input
    xs = []
    fn = moe_mod.moe_ffn_local

    def keep_input(p, xf, c, *rest):
        if len(xs) < 1 or (len(xs) < 2 and xf.shape[0] != xs[0].shape[0]):
            xs.append(xf.clone())
        return fn(p, xf, c, *rest)

    moe_mod.moe_ffn_local = keep_input
    try:
        serve_lib.generate(model, params, batch, 2, P + T)
    finally:
        moe_mod.moe_ffn_local = fn
    out["split"] = {}
    for xf in xs:
        s = moe_split(params, cfg, xf)
        out["split"][f"T{s['T']}"] = s
        print(f"  MoE layer at T {s['T']} (C {s['C']}), device ms: router "
              f"{s['router']:.4f}, dispatch {s['dispatch']:.4f}, experts "
              f"{s['experts']:.4f}, combine {s['combine']:.4f}; the layer "
              f"{s['layer']:.4f}", flush=True)
    if not full:
        return out

    # dense == paged where the reference promises it: prompts of one page
    # (a dense prefill runs 256-row KV tiles, a paged one 16-row pages), the
    # same batch on both, so the same routing
    one_page = {"tokens": batch["tokens"][:, :PAGE]}
    dense = serve_lib.generate(model, params, one_page, 32, PAGE + 32)
    with plain_calls() as n_plain:
        paged = serve_lib.generate(model, params, one_page, 32, PAGE + 32,
                                   continuous_batching=True, page_size=PAGE)
    check(not n_plain, f"{name} paged: no plain-version call ({n_plain})")
    check(torch.equal(dense, paged), f"{name}: the classic request on prompts of one "
          f"page ({PAGE} tokens), 32 new tokens: dense == paged token for token")
    # on the request's own prompts the two prefills take other LUT steps
    # (ROADMAP §3): printed, not checked
    paged = serve_lib.generate(model, params, batch, T, P + T, continuous_batching=True,
                               page_size=PAGE)
    same = [int((toks[b] != paged[b]).nonzero()[0]) if not torch.equal(toks[b], paged[b])
            else T for b in range(Bs)]
    print(f"  the classic request's own {P}-token prompts, dense vs paged: first "
          f"differing token per row {same} (of {T})", flush=True)
    out["dense_vs_paged_first_diff"] = same

    # the Scheduler over the first requests of phase 7's trace
    trace = sched_trace(V)[0][:MOE_TRACE]
    n_tok = sum(b for _, b in trace)
    sched = serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain:
        t0 = time.perf_counter()
        streams = run_audited(sched, trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    st = sched.stats
    check(not n_plain, f"{name} Scheduler: no plain-version call ({n_plain})")
    check(all(len(s) == b for s, (_, b) in zip(streams, trace))
          and all(0 <= t < V for s in streams for t in s),
          f"{name} Scheduler: every request got its budget of in-vocabulary tokens")
    check(len(sched.free_pages) == sched.num_pages - 1,
          f"{name} Scheduler: every page returned to the free list (audit() clean "
          "after every step)")
    check(launches.get("pim_matmul_experts", 0) == last * st["model_steps"],
          f"{name} Scheduler: {last} expert launches per forward")
    print(f"  Scheduler, {MOE_TRACE} requests of phase 7's trace (prompts "
          f"{[len(p) for p, _ in trace]}, {n_tok} tokens): {wall:.2f} s, "
          f"{n_tok / wall:.1f} tokens/s, {wall / st['steps'] * 1e3:.1f} ms per step "
          f"({st['steps']} steps, {st['model_steps']} forwards), peak pages "
          f"{sched.peak_pages_in_use}, launches {launches}", flush=True)
    out["scheduler"] = dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                            model_steps=st["model_steps"], launches=launches,
                            peak_pages_in_use=sched.peak_pages_in_use)
    del sched

    # one prefill forward at the paper's fidelity: every linear through the
    # 6-bit ADC (kernel 3, the experts in its expert launch), behavioral
    # attention (kernel 4)
    pcfg = dataclasses.replace(cfg, attn_impl="behavioral",
                               pim=dataclasses.replace(cfg.pim, adc_mode="quantized"))
    pmodel = build_model(pcfg, dev)
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, expert_launches(
            lambda i: "prefill w_out of the last MoE layer" if i == w_out else None
    ) as (_, kept):
        t0 = time.perf_counter()
        logits, _ = pmodel.forward_serve(params, {"tokens": batch["tokens"].to(dev)},
                                         pmodel.init_cache(Bs, P + T), 0)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    dense_linears = 4 * L + 3 * cfg.num_dense_layers
    check(not n_plain, f"{name} paper fidelity: no plain-version call ({n_plain})")
    check(tuple(logits.shape) == (Bs, V) and bool(torch.isfinite(logits).all()),
          f"{name} paper fidelity: prefill logits finite, ({Bs}, {V})")
    check(launches.get("pim_matmul_experts") == last
          and launches.get("pim_matmul") == dense_linears
          and launches.get("lut_softmax") == L,
          f"{name} paper fidelity: launches {launches}: {last} expert launches, "
          f"{dense_linears} single products, {L} LUT softmaxes")
    replay_experts(f"{name} paper fidelity", kept,
                   {"prefill w_out of the last MoE layer": C_pre})
    print(f"  paper fidelity: one prefill forward {fwd_s * 1e3:.1f} ms, launches "
          f"{launches}", flush=True)
    out["paper_fidelity"] = dict(forward_ms=fwd_s * 1e3, launches=launches)
    return out


def moe_phase(dev, entries, compare, results) -> None:
    """Phase 14: kernel 3's expert launch, deepseek-moe-16b at full width
    and depth, dbrx-132b's first DBRX_LAYERS layers at full width."""
    stamp("phase 14 (a): kernel 3's expert launch")
    gen = torch.Generator(device=dev).manual_seed(14)
    results["moe_kernels"] = expert_kernels(dev, gen, entries)
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = {}
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), attn_impl="kernel",
                              decode_block_k=PAGE)
    moe["deepseek"] = moe_model(cfg, entries, compare, full=True)
    dcfg = dataclasses.replace(get_config("dbrx-132b"), num_layers=DBRX_LAYERS,
                               attn_impl="kernel", decode_block_k=PAGE)
    moe["dbrx"] = moe_model(dcfg, entries, compare, full=False)
    results["moe"] = moe


def small_model(dev, scheduler: bool) -> None:
    """Phase 4, the kernel path of a small model on the GPU against the
    plain path on the CPU, and phase 5 on it when `scheduler`."""
    stamp("phase 4")
    small = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                                attn_impl="kernel", compute_dtype="float32")
    m_cpu, m_gpu = build_model(small, "cpu"), build_model(small, dev)
    p_cpu = m_cpu.init(seed=0)

    def to_gpu(t):
        if isinstance(t, dict):
            return {k: to_gpu(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(to_gpu(v) for v in t)
        return t.to(dev)

    p_gpu = to_gpu(p_cpu)
    toks = torch.from_numpy(data.lm_batch(0, 2, 16, small.vocab_size)).long()
    l_cpu, _ = m_cpu.forward_serve(p_cpu, {"tokens": toks}, m_cpu.init_cache(2, 24), 0)
    l_gpu, _ = m_gpu.forward_serve(p_gpu, {"tokens": toks.to(dev)}, m_gpu.init_cache(2, 24), 0)
    rel = ((l_gpu.cpu() - l_cpu).abs().max() / l_cpu.abs().max()).item()
    check(rel <= 1e-4, f"smoke model f32 logits, GPU kernels vs CPU plain: rel {rel:.3g} <= 1e-4")
    s_cpu = serve_lib.generate(m_cpu, p_cpu, {"tokens": toks}, 8, 24)
    s_gpu = serve_lib.generate(m_gpu, p_gpu, {"tokens": toks}, 8, 24)
    check(torch.equal(s_cpu, s_gpu.cpu()), "smoke model 8-token greedy streams equal")

    if scheduler:
        stamp("phase 5")
        smoke_scheduler(dev, small, p_gpu)


def cut_depth(cfg, params, layers: int):
    """(config, parameters) of the model's first `layers` layers: the
    phase 6 weights, each stacked leaf cut on its layer axis."""
    def first(node):
        if isinstance(node, dict):
            return {k: first(v) for k, v in node.items()}
        return node[:layers]

    return (dataclasses.replace(cfg, num_layers=layers),
            dict(params, blocks=tuple(first(b) for b in params["blocks"])))


def serve_phases(dev, cfg, phases, entries, compare, results) -> None:
    """Phases 6, 7, 9, 10, 11, 12 and 13 at full width, on the phase 6
    weights: at full depth but for phases 10-13, which run the first
    CUT_DEPTH layers to leave the time limit room for phases 14-20."""
    stamp("phase 6: model and weights")
    Dh = cfg.resolved_head_dim
    cfg = dataclasses.replace(cfg, attn_impl="kernel")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {Dh}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params "
          f"(init+deploy {time.perf_counter() - t0:.1f}s)", flush=True)
    if 6 in phases:
        serve_classic(model, params, cfg, entries, results)
    if 7 in phases:
        stamp("phase 7")
        results["scheduler"] = full_scheduler(model, params, cfg, entries, compare)
    if 9 in phases:
        stamp("phase 9")
        results["paper_fidelity"] = paper_fidelity(cfg, params, entries)
    if phases & {10, 11, 12}:
        results["row_probe"] = row_probe(model, params, cfg)
        check_row_probe(results["row_probe"])
    cut_cfg, cut_params = cut_depth(cfg, params, CUT_DEPTH)
    cut_model = build_model(cut_cfg, model.device)
    if 10 in phases:
        stamp("phase 10")
        results["mixed"] = mixed_scheduler(cut_model, cut_params, cut_cfg, entries,
                                           compare, results["card"])
    if 11 in phases:
        stamp("phase 11")
        results["spec"] = spec_scheduler(cut_model, cut_params, cut_cfg, entries,
                                         compare, results["card"])
    if 12 in phases:
        stamp("phase 12")
        results["starved"] = starved_scheduler(cut_model, cut_params, cut_cfg, entries,
                                               compare, results["card"])
    if 13 in phases:
        stamp("phase 13")
        results["kv4_recovery"] = recovery_scheduler(cut_model, cut_params, cut_cfg,
                                                     entries, compare, results["card"])


def serve_classic(model, params, cfg, entries, results) -> None:
    """Phase 6: the classic request on the kernel path, then profiled."""
    stamp("phase 6: the classic request")
    dev = model.device
    Bs, P, T = 4, 128, 32
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, cfg.vocab_size)).long()}
    logits, _ = model.forward_serve(params, {"tokens": batch["tokens"].to(dev)},
                                    model.init_cache(Bs, P + T), 0)
    check(tuple(logits.shape) == (Bs, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "full model prefill logits finite, (4, 92544)")
    serve_lib.generate(model, params, batch, 2, P + T)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)          # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    _build.LAUNCHES.clear()
    with plain_calls() as n_plain:
        t0 = time.perf_counter()
        out = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L = cfg.num_layers
    check(not n_plain, f"classic request: no plain-version call on the path ({n_plain})")
    check(launches.get("pim_attention") == L and launches.get("pim_decode") == (T - 1) * L,
          f"classic request: {L} prefill launches (one prefill forward) and "
          f"{(T - 1) * L} decode launches")
    check(tuple(out.shape) == (Bs, T) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, "served (4, 32) token ids in the vocabulary")
    decode_ms = (total_s - prefill_s) / (T - 1) * 1e3
    print(f"  prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / total_s:.1f} tokens/s over the request "
          f"(batch {Bs}, prompt {P}, {T} new tokens)")
    print(f"  first sequence: {out[0, :12].tolist()}")
    print(f"  launches: {launches}")
    for name in ("pim_attention", "pim_decode"):
        check(launches.get(name, 0) > 0, f"main path launched {name}")
        entries[name]["launches"] = launches.get(name, 0)

    # the request cut to PROFILED_TOKENS new tokens, unprofiled and then
    # under the profiler: where the device time goes
    def cut(_):
        serve_lib.generate(model, params, batch, PROFILED_TOKENS, P + T)

    shapes, wall = unprofiled_wall(lambda: None, cut, lambda: launch_shapes(cfg))
    results["serve"] = dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
        tokens_per_s=Bs * T / total_s, total_s=total_s, launches=launches,
        **profiled_report(lambda: None, cut,
                          f"request cut to {PROFILED_TOKENS} new tokens", wall))
    served_attention(entries, "classic request", results["serve"], shapes, cfg)


# ---- 15. the Griffin family: gemma-7b and recurrentgemma-9b ------------------
LONG_PROMPT = 2304   # recurrentgemma-9b's long request: past its 2,048-token window
GRIFFIN_TRACE = 8    # requests of phase 7's trace through gemma-7b's Scheduler


def load_model(cfg, label: str) -> tuple:
    """(model, params, facts) of `cfg` on the card: random weights from
    seed 0, deployed; prints the weights' size, the load time and the peak
    device memory of the load."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for t in ckpt_flatten(params) if isinstance(t, torch.Tensor)]
    weight_gb = sum(t.untyped_storage().nbytes() for t in leaves) / 1e9
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serve {label}: {cfg.num_layers} layers {cfg.block_pattern}, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.activation}, window "
          f"{cfg.window}, lru_width {cfg.lru_width}, vocab {cfg.vocab_size} (tied "
          f"{cfg.tie_embeddings}), {cfg.param_count() / 1e9:.3f} B params, "
          f"{weight_gb:.2f} GB deployed; init+deploy {init_s:.1f} s, peak "
          f"{peak:.2f} GiB", flush=True)
    return model, params, dict(init_s=init_s, weight_gb=weight_gb, peak_init_gib=peak)


def classic_run(model, params, batch, T: int, max_len: int, label: str, want: dict,
                pick=None, compare=None) -> tuple:
    """One classic request with every kernel count set to 0 just before it
    and read just after: no plain-version call, the counts `want` exactly
    ({wrapper: launches}, the others 0), in-vocabulary tokens; served
    launches `pick` labels are replayed against the plain versions.
    Returns (tokens, launches, wall s)."""
    V = model.cfg.vocab_size
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(pick or (lambda n, i: None)) as kept:
        t0 = time.perf_counter()
        toks = serve_lib.generate(model, params, batch, T, max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    check(not n_plain, f"{label}: no plain-version call on the path ({n_plain})")
    check(launches == {k: n for k, n in want.items() if n},
          f"{label}: launches {launches} == {want}")
    B = batch["tokens"].shape[0]
    check(tuple(toks.shape) == (B, T) and int(toks.min()) >= 0 and int(toks.max()) < V,
          f"{label}: served ({B}, {T}) token ids in the vocabulary")
    if pick is not None:
        replay_served(label, kept, compare,
                      need=sorted({n for n, _, _ in kept.values()}))
    return toks, launches, wall


def profile_cut(model, params, batch, T: int, max_len: int, label: str, entries,
                kernel_names) -> dict:
    """The request cut to T new tokens, unprofiled then profiled: busy
    share, per-launch device time of the kernels beside their bounds and
    the top device operators."""
    cfg = model.cfg

    def cut(_):
        serve_lib.generate(model, params, batch, T, max_len)

    @contextlib.contextmanager
    def recorder():
        with launch_shapes(cfg) as shapes, adc_bounds() as bounds:
            yield shapes, bounds

    (shapes, bounds), wall = unprofiled_wall(lambda: None, cut, recorder)
    report = profiled_report(lambda: None, cut, label, wall, kernel_names)
    report["served"] = served_attention(entries, label, report, shapes, cfg)
    if bounds["lut_softmax"]:     # kernel 4 in ring decode
        us = report["kernels"]["lut_softmax_kernel"]["us_per_launch"]
        b_us = sum(bounds["lut_softmax"]) / len(bounds["lut_softmax"])
        report["served"]["lut_softmax"] = (us, b_us)
        if "lut_softmax" in entries:
            entries["lut_softmax"].setdefault("served_us", {})[label] = us
            entries["lut_softmax"].setdefault("served_bound_us", {})[label] = b_us
        print(f"  kernel 4 on the {label}: {us:.2f} us per launch, bound {b_us:.3f} us "
              f"(mean over its {len(bounds['lut_softmax'])} calls' operands), "
              f"{b_us / us:.1%} of it", flush=True)
    return report


def griffin_launches(entries, name: str, what: str, n: int) -> None:
    """A served path's launches of a kernel beside its entry (where the
    kernel's entry exists: `--phases 15` alone runs no kernel phase)."""
    if name in entries:
        entries[name].setdefault("griffin_launches", {})[what] = n


def fidelity_run(cfg, params, batch, label: str, linears: int,
                 prefill_rows: tuple = (), first: int = LINEARS_PER_LAYER) -> dict:
    """One paper-fidelity request (the batch's prompt, 4 new tokens): every
    PIM linear through the 6-bit ADC (kernel 3) and behavioral attention,
    whose LUT softmax is kernel 4 at the model's head_dim; `linears` PIM
    linears a forward, and in the prefill alone one more of each of
    `prefill_rows`' M rows first (a VLM's image projection); one kernel 4
    launch per attention layer and forward (none in a stack without
    attention).  Kernel 3's first `first` launches of the prefill (an
    attention layer's 7 linears; after its prefill-only linears) and of
    the first decode forward are held against the plain version bit for
    bit."""
    pcfg = dataclasses.replace(cfg, attn_impl="behavioral",
                               pim=dataclasses.replace(cfg.pim, adc_mode="quantized"))
    model = build_model(pcfg)
    n_attn = sum(k.startswith("attn") for k in
                 (cfg.block_pattern * cfg.num_layers)[:cfg.num_layers])
    B, P = batch["tokens"].shape
    T, pre = 4, len(prefill_rows)

    def pick(name, i):
        if i < pre:
            return f"prefill-only linear {i}"
        if i < pre + first:
            return f"prefill linear {i - pre}"
        if 0 <= i - pre - linears < first:
            return f"decode forward 2 linear {i - pre - linears}"
        return None

    rows = {**{f"prefill-only linear {i}": m for i, m in enumerate(prefill_rows)},
            **{f"prefill linear {i}": B * P for i in range(first)},
            **{f"decode forward 2 linear {i}": B for i in range(first)}}
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(
            pick, {"pim_matmul": ADC_TARGETS["pim_matmul"]}) as kept:
        t0 = time.perf_counter()
        toks = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    want = {k: n for k, n in (("pim_matmul", linears * T + pre),
                              ("lut_softmax", n_attn * T)) if n}
    check(not n_plain, f"{label} paper fidelity: no plain-version call ({n_plain})")
    check(launches == want, f"{label} paper fidelity: launches {launches} == {want}")
    replay_adc(f"{label} paper fidelity", kept, rows)
    print(f"  {label} paper fidelity: kernel 3 == plain bit for bit at "
          f"{sorted({(tuple(a[0].shape), tuple(a[1].shape)) for _, a, _ in kept.values()})}",
          flush=True)
    del kept
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{label} paper fidelity: tokens in the vocabulary")
    print(f"  paper fidelity ({label}): prompt {P}, {T} new tokens in {wall:.2f} s, "
          f"launches {launches}; first sequence {toks[0].tolist()}", flush=True)
    return dict(wall_s=wall, launches=launches)


def gemma_serve(entries, compare) -> dict:
    """Phase 15, gemma-7b at full width and depth (28 layers, d_model 3,072,
    16/16 heads of 256, GeGLU d_ff 24,576, vocab 256,000, tied)."""
    stamp("phase 15: gemma-7b")
    cfg = dataclasses.replace(get_config("gemma-7b"), attn_impl="kernel",
                              decode_block_k=PAGE)
    model, params, out = load_model(cfg, "gemma-7b")
    L, V = cfg.num_layers, cfg.vocab_size
    Bs, P, T = 4, 128, 32
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, V)).long()}
    serve_lib.generate(model, params, batch, 2, P + T)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)           # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pick(name, i):
        if name == "pim_attention" and i == 0:
            return "prefill layer 0"
        if name == "pim_decode" and i == 3 * L - 1:
            return f"decode forward 4 layer {L - 1}"
        return None

    toks, launches, wall = classic_run(
        model, params, batch, T, P + T, "gemma-7b classic request",
        {"pim_attention": L, "pim_decode": (T - 1) * L}, pick, compare)
    decode_ms = (wall - prefill_s) / (T - 1) * 1e3
    print(f"  classic request: prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} "
          f"ms/token, {Bs * T / wall:.1f} tokens/s; launches {launches}; first "
          f"sequence {toks[0, :12].tolist()}", flush=True)
    out["classic"] = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                          tokens_per_s=Bs * T / wall, launches=launches)
    for name in ("pim_attention", "pim_decode"):
        griffin_launches(entries, name, "gemma-7b classic", launches[name])
    out["profile"] = profile_cut(model, params, batch, PROFILED_TOKENS, P + T,
                                 f"gemma-7b request cut to {PROFILED_TOKENS} new tokens",
                                 entries, ATTENTION_KERNELS)

    # dense == paged on prompts of one page, where both run the same tiles
    one_page = {"tokens": batch["tokens"][:, :PAGE]}
    dense = serve_lib.generate(model, params, one_page, 32, PAGE + 32)
    with plain_calls() as n_plain:
        paged = serve_lib.generate(model, params, one_page, 32, PAGE + 32,
                                   continuous_batching=True, page_size=PAGE)
    check(not n_plain, f"gemma-7b paged: no plain-version call ({n_plain})")
    check(torch.equal(dense, paged), f"gemma-7b: prompts of one page ({PAGE} tokens), "
          "32 new tokens: dense == paged token for token")

    trace = sched_trace(V)[0][:GRIFFIN_TRACE]
    n_tok = sum(b for _, b in trace)
    sched = serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain:
        t0 = time.perf_counter()
        streams = run_audited(sched, trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    check(not n_plain, f"gemma-7b Scheduler: no plain-version call ({n_plain})")
    check(all(len(s) == b for s, (_, b) in zip(streams, trace))
          and all(0 <= t < V for s in streams for t in s),
          "gemma-7b Scheduler: every request got its budget of in-vocabulary tokens")
    check(len(sched.free_pages) == sched.num_pages - 1,
          "gemma-7b Scheduler: every page returned to the free list (audit() clean "
          "after every step)")
    check(launches.get("pim_attention", 0) > 0 and launches.get("pim_decode", 0) > 0,
          f"gemma-7b Scheduler: kernels 1 and 2 launched ({launches})")
    st = sched.stats
    print(f"  Scheduler, {GRIFFIN_TRACE} requests of phase 7's trace ({n_tok} tokens): "
          f"{wall:.2f} s, {n_tok / wall:.1f} tokens/s, {st['steps']} steps, "
          f"{st['model_steps']} forwards, peak pages {sched.peak_pages_in_use}, "
          f"launches {launches}", flush=True)
    out["scheduler"] = dict(wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
                            model_steps=st["model_steps"], launches=launches)
    del sched
    out["paper_fidelity"] = fidelity_run(cfg, params, batch, "gemma-7b",
                                         LINEARS_PER_LAYER * L)
    return out


def layer_ms(fn, what: str, iters: int = 5) -> tuple:
    """(device ms, wall ms) of one call of `fn`: its kernels' summed device
    time (torch.profiler) and CUDA events around `iters` back-to-back calls,
    which a host-bound call stretches past its device time."""
    return device_ms(fn, iters, what), cuda_ms(fn, iters)


def griffin_split(model, params, cfg, batch) -> dict:
    """Device ms (and the wall of back-to-back calls) of one RG-LRU layer
    and one ring-attention layer of recurrentgemma-9b, at the long
    request's prefill (its inputs captured from a served prefill) and at a
    decode step over a full ring."""
    from repro_torch.models import blocks as TB
    xs = {}
    rg, at = TB.rglru_block_fwd_serve, TB.attn_block_fwd_serve

    def keep_rg(p, x, state, c):
        xs.setdefault(("rglru", x.shape[1]), (p, x.clone(),
                                              {k: v.clone() for k, v in state.items()}))
        return rg(p, x, state, c)

    def keep_at(p, x, cache, offset, c, **kw):
        xs.setdefault(("attn", x.shape[1]), (p, x.clone(), offset, kw))
        return at(p, x, cache, offset, c, **kw)

    TB.rglru_block_fwd_serve, TB.attn_block_fwd_serve = keep_rg, keep_at
    try:
        serve_lib.generate(model, params, batch, 2, LONG_PROMPT + 32)
    finally:
        TB.rglru_block_fwd_serve, TB.attn_block_fwd_serve = rg, at
    out = {}
    dev = model.device
    B = batch["tokens"].shape[0]
    for (kind, S), item in sorted(xs.items()):
        what = "prefill" if S > 1 else "decode"
        if kind == "rglru":
            p, x, state = item
            ms, wall = layer_ms(lambda: rg(p, x, {k: v.clone() for k, v in state.items()},
                                           cfg), f"an RG-LRU layer at {what}")
        else:
            p, x, offset, kw = item
            cache = TT._state_init("attn_local", cfg, B, LONG_PROMPT + 32, dev)
            W = cfg.window         # the ring after the long prompt: slot s holds p = s (mod W)
            pos = torch.arange(W, device=dev)
            cache.positions.copy_(torch.where(pos < LONG_PROMPT - W, pos + W, pos))
            ms, wall = layer_ms(lambda: at(p, x, cache, offset, cfg, **kw),
                                f"a ring-attention layer at {what}")
        out[f"{kind} {what}"] = dict(device_ms=ms, wall_ms=wall)
        print(f"  recurrentgemma-9b {kind} layer at {what} (S {S}, batch {B}): "
              f"{ms:.3f} ms of device time a layer, {wall:.3f} ms wall back to back",
              flush=True)
    return out


def recurrentgemma_serve(entries, compare) -> dict:
    """Phase 15, recurrentgemma-9b at full width and depth (26 RG-LRU and 12
    local-attention layers, lru_width 4,096, MQA 16 q heads over 1 KV head
    of 256, window 2,048)."""
    stamp("phase 15: recurrentgemma-9b")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), attn_impl="kernel",
                              decode_block_k=PAGE)
    model, params, out = load_model(cfg, "recurrentgemma-9b")
    V, W = cfg.vocab_size, cfg.window
    n_attn = sum(k == "attn_local" for k in TT.pattern_layout(cfg)[0]) \
        * TT.pattern_layout(cfg)[1]
    n_rg = cfg.num_layers - n_attn
    check((n_attn, n_rg) == (12, 26), f"12 local-attention and 26 RG-LRU layers "
          f"({n_attn}, {n_rg})")
    T = 32

    # (a) the long request: prompts past the window, rings of 2,048 slots
    Bs, P = 2, LONG_PROMPT
    long_batch = {"tokens": torch.from_numpy(data.lm_batch(1, Bs, P, V)).long()}
    serve_lib.generate(model, params, long_batch, 2, P + T)       # warm-up
    cache = model.init_cache(Bs, P + T)
    ring = cache["blocks"][2]
    check(ring.positions is not None and ring.k_q.shape[-2] == W,
          f"recurrentgemma-9b at max_len {P + T}: rings of {W} slots")
    del cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, long_batch, 1, P + T)       # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pick_long(name, i):
        return "windowed prefill, first attention layer" if i == 0 else None

    toks, launches, wall = classic_run(
        model, params, long_batch, T, P + T, "recurrentgemma-9b long request",
        {"pim_attention": n_attn, "lut_softmax": (T - 1) * n_attn}, pick_long, compare)
    # the windowed prefill's iteration map: the analytic count with the
    # window (at 2,304 tokens no 256-row block lies wholly before a 32-row
    # q block's window, so it equals the causal count; phase 2's window
    # 128 at Sq 512 skips blocks)
    torch.cuda.synchronize()
    with recorded(pick_long) as kept:
        serve_lib.generate(model, params, long_batch, 1, P + T)
    (_, args, kw), = kept.values()
    _, iters = pim_attention(*args, **kw, return_iters=True)
    exp = expected_kv_block_iters(P, P, 0, 32, 256, window=W)
    full = expected_kv_block_iters(P, P, 0, 32, 256)
    check(kw.get("window") == W and bool((iters.sum(dim=1) == exp).all()),
          f"recurrentgemma-9b prefill: window {kw.get('window')}, iterations per head "
          f"== expected_kv_block_iters ({exp}; {full} without the window)")
    decode_ms = (wall - prefill_s) / (T - 1) * 1e3
    print(f"  long request (batch {Bs}, prompt {P}, {T} new tokens): prefill "
          f"{prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / wall:.1f} tokens/s; launches {launches}; first sequence "
          f"{toks[0, :12].tolist()}", flush=True)
    out["long"] = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                       tokens_per_s=Bs * T / wall, launches=launches)
    griffin_launches(entries, "lut_softmax", "recurrentgemma-9b long, ring decode",
                 launches["lut_softmax"])
    griffin_launches(entries, "pim_attention", "recurrentgemma-9b long, windowed prefill",
                 launches["pim_attention"])
    # a served ring-decode launch of kernel 4 (its broadcast slot mask read
    # in place) against the plain version, bit for bit
    with recorded(lambda n, i: "ring decode, first attention layer" if i == 0 else None,
                  {"lut_softmax": ADC_TARGETS["lut_softmax"]}) as kept:
        serve_lib.generate(model, params, long_batch, 2, P + T)
    replay_adc("recurrentgemma-9b ring decode", kept,
               {"ring decode, first attention layer": Bs})
    out["long_profile"] = profile_cut(
        model, params, long_batch, PROFILED_TOKENS, P + T,
        f"recurrentgemma-9b long request cut to {PROFILED_TOKENS} new tokens", entries,
        (("pim_attention_kernel", "pim_attention"), ("lut_softmax_kernel", "lut_softmax")))

    # (c) the reference's own identity (tests/test_models_smoke.py, on its
    # default behavioral path, at its SMOKE depth of 3 layers: one
    # repetition of the pattern): token P's logits from one prefill against
    # a prefill of P - 1 tokens and one ring-decode step, held within 0.05
    # at full width.  At full depth it is printed, not held: the prefill
    # folds V scales over every earlier position, the ring over its window
    # (both the reference's rule), and 38 random layers amplify that; the
    # reference's own identity at 38 layers is 0.069 in bf16 (SMOKE widths,
    # a CPU run).  On the kernel path the prefill's online LUT exps meet the
    # ring decode's behavioral codes: printed
    dev = model.device
    toks_d = long_batch["tokens"].to(dev)
    out["prefill_decode_rel"] = {}
    for impl, layers in (("behavioral", 3), ("behavioral", cfg.num_layers),
                         ("kernel", cfg.num_layers)):
        c, p = cut_depth(cfg, params, layers) if layers < cfg.num_layers else (cfg, params)
        m = build_model(dataclasses.replace(c, attn_impl=impl))
        with torch.inference_mode():
            la, _ = m.forward_serve(p, {"tokens": toks_d}, m.init_cache(Bs, P + T), 0)
            _, cb = m.forward_serve(p, {"tokens": toks_d[:, :P - 1]},
                                    m.init_cache(Bs, P + T), 0)
            lb, _ = m.forward_serve(p, {"tokens": toks_d[:, P - 1:]}, cb, P - 1)
        a, b = la.float(), lb.float()
        rel = float(torch.linalg.norm(a - b) / (torch.linalg.norm(a) + 1e-9))
        out["prefill_decode_rel"][f"{impl} {layers} layers"] = rel
        what = (f"recurrentgemma-9b, {layers} layers, {impl} attention: token {P}'s "
                f"logits from one prefill vs a prefill of {P - 1} and one ring-decode "
                f"step, relative error {rel:.4f}")
        if impl == "behavioral" and layers == 3:
            check(bool(torch.isfinite(a).all()) and rel < 0.05, f"{what} < 0.05")
        else:
            print(f"  {what}", flush=True)
        del la, lb, cb

    # (b) the classic request at max_len 160: no ring, kernel 2 with the window
    Bc, Pc = 4, 128
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bc, Pc, V)).long()}
    check(model.init_cache(Bc, Pc + T)["blocks"][2].positions is None,
          "recurrentgemma-9b at max_len 160: no ring")

    def pick_classic(name, i):
        if name == "pim_decode" and i == 3 * n_attn - 1:
            return "windowed decode forward 4, last attention layer"
        return None

    serve_lib.generate(model, params, batch, 2, Pc + T)           # warm-up
    toks, launches, wall = classic_run(
        model, params, batch, T, Pc + T, "recurrentgemma-9b classic request",
        {"pim_attention": n_attn, "pim_decode": (T - 1) * n_attn}, pick_classic, compare)
    print(f"  classic request (batch {Bc}, prompt {Pc}, {T} new tokens): "
          f"{Bc * T / wall:.1f} tokens/s, {wall:.2f} s; launches {launches}", flush=True)
    out["classic"] = dict(tokens_per_s=Bc * T / wall, wall_s=wall, launches=launches)
    griffin_launches(entries, "pim_decode", "recurrentgemma-9b classic, windowed",
                 launches["pim_decode"])
    out["profile"] = profile_cut(model, params, batch, PROFILED_TOKENS, Pc + T,
                                 f"recurrentgemma-9b request cut to {PROFILED_TOKENS} "
                                 "new tokens", entries, ATTENTION_KERNELS)
    out["split"] = griffin_split(model, params, cfg, long_batch)
    out["paper_fidelity"] = fidelity_run(cfg, params, batch, "recurrentgemma-9b",
                                         6 * n_rg + LINEARS_PER_LAYER * n_attn)
    return out


def griffin_phase(entries, compare, results) -> None:
    """Phase 15: gemma-7b and recurrentgemma-9b at full width and depth."""
    torch.backends.cuda.matmul.allow_tf32 = False
    results["griffin"] = {"gemma-7b": gemma_serve(entries, compare)}
    torch.cuda.empty_cache()
    results["griffin"]["recurrentgemma-9b"] = recurrentgemma_serve(entries, compare)


# ---- 16. phi-3-vision-4.2b: head_dim 96 and the image projection -------------
PHI3_PROMPT = 640    # the classic request's prompt: the 576 image patches and more
PHI3_TRACE = 8       # requests of phase 7's trace through its Scheduler, each pool


def phi3_phase(entries, compare, results) -> None:
    """Phase 16, phi-3-vision-4.2b at full width and depth (32 layers,
    d_model 3,072, 32/32 heads of 96, SwiGLU d_ff 8,192, vocab 32,064,
    576 image patches through `img_proj`)."""
    stamp("phase 16: phi-3-vision-4.2b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("phi-3-vision-4.2b"), attn_impl="kernel",
                              decode_block_k=PAGE)
    model, params, out = load_model(cfg, "phi-3-vision-4.2b")
    dev = model.device
    L, V, Pn = cfg.num_layers, cfg.vocab_size, cfg.num_image_patches
    Bs, P, T = 4, PHI3_PROMPT, 32
    shape = types.SimpleNamespace(global_batch=Bs, seq_len=P)
    batch = {k: torch.from_numpy(v) for k, v in data.make_batch(cfg, shape, 0).items()}
    batch["tokens"] = batch["tokens"].long()
    check(tuple(batch["image_embeds"].shape) == (Bs, Pn, cfg.d_model),
          f"phi-3: make_batch gives ({Bs}, {Pn}, {cfg.d_model}) image embeddings")

    # the image is live: the prefill's input embedding with and without it
    with torch.inference_mode():
        x_img = TT._embed_inputs(params, {k: v.to(dev) for k, v in batch.items()}, cfg)
        x_txt = TT._embed_inputs(params, {"tokens": batch["tokens"].to(dev)}, cfg)
    moved = (x_img != x_txt).any(dim=-1)
    check(bool(moved[:, :Pn].all()) and not bool(moved[:, Pn:].any()),
          f"phi-3: the image moves the prefill's input at every position < {Pn} and "
          f"leaves every position >= {Pn} equal bit for bit")
    del x_img, x_txt, moved

    serve_lib.generate(model, params, batch, 2, P + T)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, P + T)           # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pick(name, i):
        if name == "pim_attention" and i == 0:
            return "prefill layer 0"
        if name == "pim_decode" and i == 3 * L - 1:
            return f"decode forward 4 layer {L - 1}"
        return None

    toks, launches, wall = classic_run(
        model, params, batch, T, P + T, "phi-3-vision-4.2b classic request",
        {"pim_attention": L, "pim_decode": (T - 1) * L}, pick, compare)
    decode_ms = (wall - prefill_s) / (T - 1) * 1e3
    print(f"  classic request (batch {Bs}, prompt {P} with {Pn} image patches, {T} new "
          f"tokens): prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / wall:.1f} tokens/s; launches {launches}; first sequence "
          f"{toks[0, :12].tolist()}", flush=True)
    out["classic"] = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                          tokens_per_s=Bs * T / wall, launches=launches)
    for name in ("pim_attention", "pim_decode"):
        griffin_launches(entries, name, "phi-3-vision-4.2b classic", launches[name])
    out["profile"] = profile_cut(model, params, batch, PROFILED_TOKENS, P + T,
                                 f"phi-3-vision-4.2b request cut to {PROFILED_TOKENS} "
                                 "new tokens", entries, ATTENTION_KERNELS)

    # dense == paged on prompts of one page, text only (the Scheduler takes
    # token lists, as the reference's does)
    one_page = {"tokens": batch["tokens"][:, :PAGE]}
    dense = serve_lib.generate(model, params, one_page, 32, PAGE + 32)
    with plain_calls() as n_plain:
        paged = serve_lib.generate(model, params, one_page, 32, PAGE + 32,
                                   continuous_batching=True, page_size=PAGE)
    check(not n_plain, f"phi-3 paged: no plain-version call ({n_plain})")
    check(torch.equal(dense, paged), f"phi-3: prompts of one page ({PAGE} tokens), "
          "32 new tokens: dense == paged token for token")

    trace = sched_trace(V)[0][:PHI3_TRACE]
    n_tok = sum(b for _, b in trace)
    out["scheduler"] = {}
    for kv_bits in (8, 4):
        label = f"phi-3 Scheduler, kv{kv_bits} pool"
        sched = serve_lib.Scheduler(model, params, page_size=PAGE, kv_bits=kv_bits,
                                    **SCHED_KW)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with plain_calls() as n_plain:
            t0 = time.perf_counter()
            streams = run_audited(sched, trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        check(not n_plain, f"{label}: no plain-version call ({n_plain})")
        check(all(len(st) == b for st, (_, b) in zip(streams, trace))
              and all(0 <= t < V for st in streams for t in st),
              f"{label}: every request got its budget of in-vocabulary tokens")
        check(len(sched.free_pages) == sched.num_pages - 1,
              f"{label}: every page returned to the free list (audit() clean after "
              "every step)")
        check(launches.get("pim_attention", 0) > 0 and launches.get("pim_decode", 0) > 0,
              f"{label}: kernels 1 and 2 launched ({launches})")
        check(sched.cache["blocks"][0].k_q.shape[-1] == cfg.resolved_head_dim * kv_bits // 8,
              f"{label}: pages hold {cfg.resolved_head_dim * kv_bits // 8} bytes a head "
              "and token")
        st = sched.stats
        print(f"  Scheduler, {PHI3_TRACE} requests of phase 7's trace ({n_tok} tokens), "
              f"kv{kv_bits}: {wall:.2f} s, {n_tok / wall:.1f} tokens/s, {st['steps']} "
              f"steps, {st['model_steps']} forwards, peak pages {sched.peak_pages_in_use}, "
              f"launches {launches}", flush=True)
        out["scheduler"][f"kv{kv_bits}"] = dict(
            wall_s=wall, tokens_per_s=n_tok / wall, steps=st["steps"],
            model_steps=st["model_steps"], launches=launches)
        del sched
    out["paper_fidelity"] = fidelity_run(cfg, params, batch, "phi-3-vision-4.2b",
                                         LINEARS_PER_LAYER * L, prefill_rows=(Bs * Pn,))
    results["phi3"] = out


# ---- 17. whisper-tiny: the encoder, cross-attention, head_dim 64 ------------
WHISPER_PROMPT = 32     # the classic request's prompt tokens (beside 1,500 frames)
WHISPER_TOKENS = 96     # and its new tokens
ENC_LINEARS = 6         # PIM linears of an encoder layer: wq wk wv wo w_in w_out
DEC_LINEARS = 8         # of a decoder layer and forward: wq wk wv wo, xattn wq wo,
                        # w_in w_out (and its xattn wk / wv at the prefill)


def whisper_kernels(dev, entries, compare) -> None:
    """Phase 17 (a): kernels 1 and 2 at whisper-tiny's heads (6/6 of 64,
    batch 4) against their plain versions, iteration maps against the
    analytic count, each timed beside its bound and non-causal bf16 SDPA:
    kernel 1 not causal, Sq 32 and 448 over the 1,500-token cross cache;
    kernel 2 not causal over it at block_k 256 (six partitions, the last
    of 220 rows), int8 and 4-bit, where the query's offset bounds nothing;
    kernel 2 causal at kv_len 4096."""
    cfg = get_config("whisper-tiny")
    pim_cfg, lut_cfg = cfg.pim, cfg.lut
    H, Dh, B, Se = cfg.num_heads, cfg.resolved_head_dim, 4, cfg.encoder_seq_len
    gen = torch.Generator(device=dev).manual_seed(17)
    kw = dict(pim_cfg=pim_cfg, lut_cfg=lut_cfg, return_iters=True)
    timed = {}

    def operands(Sq, Sk, kv_bits=8):
        q = torch.randn(B, Sq, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn(B, Sk, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn(B, Sk, H, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        cache = A.init_kv_cache(B, Sk, H, Dh, kv_bits=kv_bits, device=dev)
        A.cache_write(cache, k, v, 0, pim_cfg)
        kf = torch.randn(B, H, Sk, Dh, generator=gen, device=dev, dtype=torch.bfloat16)
        return q, kf, ops.kernel_attention_layout(q, cache, pim_cfg.input_bits)

    def report(key, t, nbytes, pairs):
        t["bound_ms"], t["bound_by"] = attention_bound(nbytes, pairs, Dh)
        timed[key] = t
        print(f"  {key}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, sdpa bf16 "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of it", flush=True)

    print(f"kernels vs plain versions at whisper-tiny's heads ({H}/{H} of {Dh}):",
          flush=True)
    for Sq in (32, 448):
        q, kf, opnd = operands(Sq, Se)
        name = f"prefill Dh{Dh} cross Sq{Sq} over {Se}, not causal"
        got = pim_attention(*opnd, 0, Se, causal=False, **kw)
        compare(name, got, pim_attention_plain(*opnd, 0, Se, causal=False, **kw))
        exp = expected_kv_block_iters(Sq, Se, 0, 32, 256, causal=False)
        check(bool((got[1].sum(dim=1) == exp).all()),
              f"{name}: iterations per head == expected_kv_block_iters ({exp})")
        t = timed_call(
            lambda: pim_attention(*opnd, 0, Se, pim_cfg, lut_cfg, causal=False),
            lambda: pim_attention_plain(*opnd, 0, Se, pim_cfg, lut_cfg, causal=False),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kf, kf),
            "pim_attention_kernel", 20)
        report(f"prefill 6/6 Sq{Sq} over {Se}, not causal", t,
               sum(x.numel() * x.element_size() for x in opnd) + B * H * Sq * Dh * 4,
               B * H * Sq * Se)
    kwd = dict(kw, block_k=256)
    for kv_bits in (8, 4):
        q, kf, opnd = operands(1, Se, kv_bits)
        name = f"decode Dh{Dh} cross over {Se} kv{kv_bits}, not causal"
        got = pim_decode(*opnd, 0, Se, causal=False, **kwd)
        compare(name, got, pim_decode_plain(*opnd, 0, Se, causal=False, **kwd))
        exp = expected_kv_block_iters(1, Se, 0, 1, 256, causal=False)
        check(bool((got[1].sum(dim=1) == exp).all()) and exp == 6,
              f"{name}: partitions per KV head == expected_kv_block_iters ({exp})")
        at = pim_decode(*opnd, WHISPER_PROMPT + 7, Se, causal=False, **kwd)
        check(torch.equal(at[0], got[0]) and torch.equal(at[1], got[1]),
              f"{name}: a query offset of {WHISPER_PROMPT + 7} gives the same bits "
              "(it bounds nothing)")
        plan = dec_k._checked_plan(1, Dh, Dh * kv_bits // 8, 256, 6, B * H, False,
                                   dev.index or 0)
        t = timed_call(
            lambda: pim_decode(*opnd, 0, Se, pim_cfg, lut_cfg, causal=False, block_k=256),
            lambda: pim_decode_plain(*opnd, 0, Se, pim_cfg, lut_cfg, causal=False,
                                     block_k=256),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kf, kf),
            "pim_decode_kernel", 50)
        t["grid"] = dict(rows=plan.rows, dsplit=plan.dsplit, chunks=plan.chunks)
        report(f"decode 6/6 over {Se} kv{kv_bits}, not causal", t,
               B * H * Se * (2 * Dh * kv_bits // 8 + 8) + B * H * (Dh + 4 + 4 * Dh),
               B * H * Se)
    kv = 4096
    q, kf, opnd = operands(1, kv)
    name = f"decode Dh{Dh} 6/6 kv_len {kv}, causal"
    got = pim_decode(*opnd, kv - 1, kv, **kwd)
    compare(name, got, pim_decode_plain(*opnd, kv - 1, kv, **kwd))
    exp = expected_kv_block_iters(1, kv, kv - 1, 1, 256, kv_valid_len=kv)
    check(bool((got[1].sum(dim=1) == exp).all()),
          f"{name}: partitions per KV head == expected_kv_block_iters ({exp})")
    t = timed_call(lambda: pim_decode(*opnd, kv - 1, kv, pim_cfg, lut_cfg, block_k=256),
                   lambda: pim_decode_plain(*opnd, kv - 1, kv, pim_cfg, lut_cfg,
                                            block_k=256),
                   lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kf, kf),
                   "pim_decode_kernel", 50)
    report(f"decode 6/6 kv_len {kv}, causal", t,
           B * H * kv * (2 * Dh + 8) + B * H * (Dh + 4 + 4 * Dh), B * H * kv)
    for name, prefix in (("pim_attention", "prefill"), ("pim_decode", "decode")):
        if name in entries:
            entries[name]["dh64"] = {k: v for k, v in timed.items() if k.startswith(prefix)}


def cross_planes(cache) -> list:
    """Copies of every cross-attention layer's cross K/V planes."""
    return [getattr(st["cross"], f).clone() for st in cache["blocks"]
            for f in ("k_q", "v_q", "k_scale", "v_scale")]


def softmax_sum_gap(args) -> dict:
    """Kernel 4 at a served launch beside the reference's order: its codes
    (an integer sum of a row's exps) against `lut_softmax_codes` (the
    reference's float32 sum, which is exact below 2^24), and the largest
    row sum of exps."""
    scores, mask, lut = args
    codes = sm_k.lut_softmax(scores, mask, lut)
    ref = lut_softmax_codes(scores, lut, mask=mask.expand(scores.shape))
    s = torch.where(mask, scores.to(torch.int32), -(1 << 24))
    table, _ = build_exp_table(lut, scores.device)
    e = torch.where(mask, table[torch.clamp(s.amax(-1, keepdim=True) - s, 0, 255).long()], 0)
    return dict(codes_differing=int((codes != ref).sum()), codes=codes.numel(),
                max_row_sum=int(e.long().sum(-1).max()))


def whisper_fidelity(cfg, params, batch, out) -> None:
    """Phase 17 (c): the classic request cut to 4 new tokens at the paper's
    fidelity: every PIM linear through the 6-bit ADC (kernel 3), the
    encoder's at M = B x 1,500 included, and behavioral attention, whose LUT
    softmax is kernel 4 on self rows and on cross rows of 1,500 positions.
    Launch counts from the code: the encoder's ENC_LINEARS a layer and each
    decoder layer's xattn wk / wv at the prefill, DEC_LINEARS a decoder
    layer and forward; two kernel 4 launches a decoder layer and forward.
    Kernel 3's launches of the encoder's first layer, the prefill's first
    decoder layer and the first decode forward's first layer, and kernel 4's
    of both attentions of the first layer at the prefill and the first
    decode forward, held against the plain versions bit for bit; kernel 4
    on the cross rows beside the reference's float32 sum (`softmax_sum_gap`)."""
    pcfg = dataclasses.replace(cfg, attn_impl="behavioral",
                               pim=dataclasses.replace(cfg.pim, adc_mode="quantized"))
    model = build_model(pcfg)
    L, n_enc, Se = cfg.num_layers, cfg.num_encoder_layers, cfg.encoder_seq_len
    B, P = batch["tokens"].shape
    T = 4
    pre = ENC_LINEARS * n_enc + (DEC_LINEARS + 2) * L   # the prefill's linears

    def pick(name, i):
        if name == "pim_matmul":
            if i < ENC_LINEARS:
                return f"encoder layer 0 linear {i}"
            j = i - ENC_LINEARS * n_enc
            if 0 <= j < DEC_LINEARS + 2:
                return f"prefill decoder layer 0 linear {j}"
            if 0 <= i - pre < DEC_LINEARS:
                return f"decode forward 2 layer 0 linear {i - pre}"
            return None
        return {0: "prefill self attention", 1: "prefill cross attention",
                2 * L: "decode forward 2 self attention",
                2 * L + 1: "decode forward 2 cross attention"}.get(i)

    # the decoder layer's M: its own rows, but B x Se for xattn wk / wv (4, 5)
    rows = {**{f"encoder layer 0 linear {i}": B * Se for i in range(ENC_LINEARS)},
            **{f"prefill decoder layer 0 linear {j}": B * Se if j in (4, 5) else B * P
               for j in range(DEC_LINEARS + 2)},
            **{f"decode forward 2 layer 0 linear {j}": B for j in range(DEC_LINEARS)},
            "prefill self attention": B * P, "prefill cross attention": B * P,
            "decode forward 2 self attention": B, "decode forward 2 cross attention": B}
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    with plain_calls() as n_plain, recorded(pick, ADC_TARGETS) as kept:
        t0 = time.perf_counter()
        toks = serve_lib.generate(model, params, batch, T, P + T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    want = {"pim_matmul": pre + (T - 1) * DEC_LINEARS * L, "lut_softmax": 2 * L * T}
    check(not n_plain, f"whisper-tiny paper fidelity: no plain-version call ({n_plain})")
    check(launches == want, f"whisper-tiny paper fidelity: launches {launches} == {want}")
    gap = softmax_sum_gap(kept["prefill cross attention"][1])
    check(tuple(kept["prefill cross attention"][1][0].shape[-1:]) == (Se,),
          f"whisper-tiny paper fidelity: kernel 4 served cross rows of {Se} positions")
    replay_adc("whisper-tiny paper fidelity", kept, rows)
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "whisper-tiny paper fidelity: tokens in the vocabulary")
    print(f"  paper fidelity (whisper-tiny): prompt {P} with {Se} frames, {T} new tokens "
          f"in {wall:.2f} s, launches {launches}; kernel 3 == plain bit for bit at M "
          f"{sorted({int(a[0].shape[0]) for n, a, _ in kept.values() if n == 'pim_matmul'})}"
          f"; kernel 4 on the prefill's cross rows: largest row sum of exps "
          f"{gap['max_row_sum']:,} ({gap['max_row_sum'] / 2 ** 24:.2f} x 2^24), "
          f"{gap['codes_differing']} of {gap['codes']:,} codes differ from a float32 "
          f"sum's; first sequence {toks[0].tolist()}", flush=True)
    out["paper_fidelity"] = dict(wall_s=wall, launches=launches, cross_softmax=gap)


def whisper_phase(dev, entries, compare, results) -> None:
    """Phase 17, whisper-tiny at full width and depth (4 encoder and 4
    decoder layers, d_model 384, 6/6 heads of 64, GELU d_ff 1,536,
    layernorm, absolute positions, vocab 51,865, 1,500 frames)."""
    stamp("phase 17 (a): kernels 1 and 2 at whisper-tiny's heads")
    whisper_kernels(dev, entries, compare)
    stamp("phase 17 (b): whisper-tiny")
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("whisper-tiny"), attn_impl="kernel")
    model, params, out = load_model(cfg, "whisper-tiny")
    L, V, Se = cfg.num_layers, cfg.vocab_size, cfg.encoder_seq_len
    Bs, P, T = 4, WHISPER_PROMPT, WHISPER_TOKENS
    max_len = P + T
    shape = types.SimpleNamespace(global_batch=Bs, seq_len=P)
    batch = {k: torch.from_numpy(v) for k, v in data.make_batch(cfg, shape, 0).items()}
    batch["tokens"] = batch["tokens"].long()
    check(tuple(batch["frames"].shape) == (Bs, Se, cfg.d_model),
          f"whisper-tiny: make_batch gives ({Bs}, {Se}, {cfg.d_model}) frames")
    dbatch = {k: v.to(dev) for k, v in batch.items()}

    # the encoder alone, and the cross planes across decode steps
    with torch.inference_mode():
        enc = TT.encode(params, dbatch["frames"], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = TT.encode(params, dbatch["frames"], cfg)
        torch.cuda.synchronize()
        enc_wall = time.perf_counter() - t0
        check(tuple(enc.shape) == (Bs, Se, cfg.d_model) and bool(torch.isfinite(enc).all()),
              f"whisper-tiny: the encoder's output is ({Bs}, {Se}, {cfg.d_model}), finite")
        enc_dev = device_ms(lambda: TT.encode(params, dbatch["frames"], cfg), 3,
                            "the whisper-tiny encoder")
        del enc
        cache = model.init_cache(Bs, max_len)
        logits, cache = model.forward_serve(params, dbatch, cache, 0)
        before = cross_planes(cache)
        for t in range(8):
            logits, cache = model.forward_serve(
                params, {"tokens": logits.argmax(-1)[:, None]}, cache, P + t)
        after = cross_planes(cache)
    check(all(torch.equal(a, b) for a, b in zip(before, after))
          and all(st["cross"].length == Se and st["self"].length == P + 8
                  for st in cache["blocks"]),
          f"whisper-tiny: the cross K/V planes written at the prefill are unchanged by 8 "
          f"decode steps (cross length {Se}, self length {P + 8})")
    del cache, before, after
    print(f"  encoder ({Bs} x {Se} frames, {cfg.num_encoder_layers} layers): wall "
          f"{enc_wall * 1e3:.2f} ms, device {enc_dev:.3f} ms", flush=True)

    serve_lib.generate(model, params, batch, 2, max_len)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, max_len)          # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pick(name, i):
        first = 2 * (2 * L)        # decode forward 4's first layer (2L launches a forward)
        return {("pim_attention", 0): "self prefill layer 0",
                ("pim_attention", 1): "cross prefill layer 0",
                ("pim_decode", first): "self decode forward 4 layer 0",
                ("pim_decode", first + 1): "cross decode forward 4 layer 0"}.get((name, i))

    toks, launches, wall = classic_run(
        model, params, batch, T, max_len, "whisper-tiny classic request",
        {"pim_attention": 2 * L, "pim_decode": (T - 1) * 2 * L}, pick, compare)
    decode_ms = (wall - prefill_s) / (T - 1) * 1e3
    print(f"  classic request (batch {Bs}, {Se} frames, prompt {P}, {T} new tokens): "
          f"prefill {prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / wall:.1f} tokens/s; launches {launches}; first sequence "
          f"{toks[0, :12].tolist()}", flush=True)
    out["encoder"] = dict(wall_ms=enc_wall * 1e3, device_ms=enc_dev)
    out["classic"] = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                          tokens_per_s=Bs * T / wall, launches=launches)
    for name in ("pim_attention", "pim_decode"):
        griffin_launches(entries, name, "whisper-tiny classic", launches[name])
    out["profile"] = profile_cut(model, params, batch, PROFILED_TOKENS, max_len,
                                 f"whisper-tiny request cut to {PROFILED_TOKENS} new "
                                 "tokens", entries, ATTENTION_KERNELS)
    stamp("phase 17 (c): whisper-tiny at the paper's fidelity")
    whisper_fidelity(cfg, params, batch, out)
    try:
        serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused and not serve_lib.scheduler_supported(cfg),
          "whisper-tiny: the Scheduler refuses the encoder-decoder arch, as the "
          "reference's does")
    results["whisper"] = out


# ---- 18. xlstm-1.3b: the mLSTM chunk scan and the sLSTM recurrence ----------
XLSTM_PROMPT = 1100   # the classic request's prompt: a whole 1,024-step chunk and a padded one
XLSTM_TOKENS = 16     # and its new tokens
XLSTM_CUT = 8         # layers of the prefill / recurrence bound: one 7:1 repetition
# (K, N) of xlstm-1.3b's PIM linears: w_up / w_gate and the sLSTM MLP's w_in;
# wq / wk / wv; w_down and the sLSTM MLP's w_out
XLSTM_LINEARS = ((2048, 4096), (4096, 4096), (4096, 2048))


def xlstm_kernel3(dev, entries) -> list:
    """(c) Kernel 3 at M 4 (a decode step's rows) on xlstm-1.3b's three
    linear shapes in both ADC modes: bit for bit against its plain version
    on the deployed (K, N) view of an (N, K) store, then timed."""
    cfg = get_config("xlstm-1.3b")
    pim_q = dataclasses.replace(cfg.pim, adc_mode="quantized")
    pim_i = dataclasses.replace(cfg.pim, adc_mode="ideal")
    gen = torch.Generator(device=dev).manual_seed(18)
    rows = []
    for K, N in XLSTM_LINEARS:
        w = int8_codes((N, K), gen, dev).t()
        x = int8_codes((4, K), gen, dev)
        for pc in (pim_q, pim_i):
            check(torch.equal(mm_k.pim_matmul_int(x, w, pc),
                              mm_k.pim_matmul_int_plain(x, w, pc)),
                  f"xlstm-1.3b kernel 3, M4 K{K} N{N} {pc.adc_mode}: kernel == plain "
                  "bit for bit")
        rows.append(timed_matmul(x, w, pim_q, pim_i))
    if "pim_matmul" in entries:
        entries["pim_matmul"]["xlstm"] = rows
    return rows


def forward_launches(fn, what: str) -> dict:
    """Host kernel launches (cudaLaunchKernel), device kernels and device ms
    of one call of `fn`, under torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times, host = raw_device_us(prof)
    out = dict(host_launches=host, device_kernels=sum(n for _, n in times.values()),
               device_ms=sum(us for us, _ in times.values()) / 1e3)
    print(f"  {what}: {host} kernel launches, {out['device_kernels']} device kernels "
          f"and copies, {out['device_ms']:.2f} ms of device time", flush=True)
    return out


@contextlib.contextmanager
def xlstm_layer_inputs():
    """Within the block, keeps the parameters, input and state (copies
    taken before the call) of the first mLSTM and the first sLSTM layer of
    each sequence length served: yields {(kind, S): (params, x, state)}."""
    from repro_torch.models import blocks as TB
    fns = {"mlstm": TB.mlstm_block_fwd_serve, "slstm": TB.slstm_block_fwd_serve}
    xs = {}

    def keeper(kind):
        def keep(p, x, state, c):
            if (kind, x.shape[1]) not in xs:
                xs[kind, x.shape[1]] = (p, x.clone(),
                                        {k: v.clone() for k, v in state.items()})
            return fns[kind](p, x, state, c)
        return keep

    TB.mlstm_block_fwd_serve, TB.slstm_block_fwd_serve = keeper("mlstm"), keeper("slstm")
    try:
        yield xs
    finally:
        TB.mlstm_block_fwd_serve, TB.slstm_block_fwd_serve = fns["mlstm"], fns["slstm"]


def xlstm_split(xs: dict, cfg) -> dict:
    """(d) Device ms (and the wall of back-to-back calls) and host launches
    of one mLSTM and one sLSTM layer at the classic request's prefill and
    at a decode step, on the inputs and states `xlstm_layer_inputs` kept
    (each call carries its state on); the sLSTM prefill's CUDA-graph replay
    held against its loop of steps bit for bit."""
    from repro_torch.models import blocks as TB
    from repro_torch.models import layers as TL
    fns = {"mlstm": TB.mlstm_block_fwd_serve, "slstm": TB.slstm_block_fwd_serve}
    out = {}
    with torch.inference_mode():
        p, x, state = xs["slstm", XLSTM_PROMPT]
        h = TL.norm_apply(p["norm"], x, cfg.norm)
        runs = []
        for steps in (TB._SLSTM_GRAPH_STEPS, XLSTM_PROMPT + 1):   # replayed, looped
            saved, TB._SLSTM_GRAPH_STEPS = TB._SLSTM_GRAPH_STEPS, steps
            try:
                st = {k: v.clone() for k, v in state.items()}
                runs.append((TB._slstm_scan(p, h, st, cfg), st))
            finally:
                TB._SLSTM_GRAPH_STEPS = saved
        (y_g, st_g), (y_l, st_l) = runs
        check(torch.equal(y_g, y_l) and all(torch.equal(st_g[k], st_l[k]) for k in st_g),
              f"xlstm-1.3b sLSTM prefill of {XLSTM_PROMPT} steps: the CUDA-graph replay "
              "equals the loop of steps bit for bit (outputs and state)")
        for (kind, S), (p, x, state) in sorted(xs.items()):
            what = "prefill" if S > 1 else "decode"
            ms, wall = layer_ms(lambda: fns[kind](p, x, state, cfg),
                                f"an {kind} layer at {what}", iters=1 if S > 1 else 5)
            launches = forward_launches(lambda: fns[kind](p, x, state, cfg),
                                        f"an {kind} layer at {what}")["host_launches"]
            out[f"{kind} {what}"] = dict(device_ms=ms, wall_ms=wall, launches=launches)
            print(f"  xlstm-1.3b {kind} layer at {what} (S {S}, batch {x.shape[0]}): "
                  f"{ms:.3f} ms of device time a layer, {wall:.3f} ms wall back to back",
                  flush=True)
    return out


def xlstm_phase(dev, entries, compare, results) -> None:
    """Phase 18, xlstm-1.3b at full width and depth (48 layers, 7 mLSTM : 1
    sLSTM, d_model 2,048, 4 heads; the mLSTM's inner width 4,096 in heads
    of 1,024; vocab 50,304), random weights from seed 0, bf16."""
    stamp("phase 18 (c): kernel 3 at xlstm-1.3b's linears")
    out = {"kernel3": xlstm_kernel3(dev, entries)}
    stamp("phase 18 (a): xlstm-1.3b")
    torch.cuda.empty_cache()
    cfg = get_config("xlstm-1.3b")
    model, params, facts = load_model(cfg, "xlstm-1.3b")
    out.update(facts)
    kinds = (cfg.block_pattern * cfg.num_layers)[:cfg.num_layers]
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    linears = 6 * n_m + 2 * n_s
    check((n_m, n_s, linears) == (42, 6, 264), f"42 mLSTM and 6 sLSTM layers, 264 PIM "
          f"linears a forward ({n_m}, {n_s}, {linears})")
    V, Bs, P, T = cfg.vocab_size, 4, XLSTM_PROMPT, XLSTM_TOKENS
    max_len = P + T
    batch = {"tokens": torch.from_numpy(data.lm_batch(0, Bs, P, V)).long()}
    toks_d = batch["tokens"].to(dev)
    cache = model.init_cache(Bs, max_len)
    state_gb = sum(t.untyped_storage().nbytes() for t in ckpt_flatten(cache)
                   if isinstance(t, torch.Tensor)) / 1e9
    # the prefill and a decode step, warming both paths: the layers' inputs
    # kept for (d), the prefill's logits for (e)
    with torch.inference_mode(), xlstm_layer_inputs() as xs:
        logits, cache = model.forward_serve(params, {"tokens": toks_d}, cache, 0)
        m0 = cache["blocks"][0]
        check(tuple(logits.shape) == (Bs, V) and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(m0["C"]).all()) and bool((m0["m"] > -1e29).all()),
              f"xlstm-1.3b prefill of {Bs} x {P} tokens (chunks of 1,024, the second "
              f"padded): finite ({Bs}, {V}) logits and mLSTM states, every m moved off "
              "-1e30")
        prefill_logits = logits.float()
        model.forward_serve(params, {"tokens": logits.argmax(-1)[:, None]}, cache, P)
    with torch.inference_mode():
        out["decode_launches"] = forward_launches(
            lambda: model.forward_serve(params, {"tokens": toks_d[:, :1]}, cache, P + 1),
            "xlstm-1.3b decode forward")
    del cache, logits, m0
    print(f"  serve states at batch {Bs}: {state_gb:.2f} GB (mLSTM C, n, m and sLSTM "
          f"c, n, m, h, float32)", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lib.generate(model, params, batch, 1, max_len)          # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    toks, launches, wall = classic_run(model, params, batch, T, max_len,
                                       "xlstm-1.3b classic request (ideal ADC: no "
                                       "kernel of the port's)", {})
    decode_ms = (wall - prefill_s) / (T - 1) * 1e3
    print(f"  classic request (batch {Bs}, prompt {P}, {T} new tokens): prefill "
          f"{prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token, "
          f"{Bs * T / wall:.1f} tokens/s; first sequence {toks[0, :12].tolist()}",
          flush=True)
    out["classic"] = dict(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
                          tokens_per_s=Bs * T / wall, wall_s=wall)

    def cut(_):
        serve_lib.generate(model, params, batch, PROFILED_TOKENS, max_len)

    _, cut_wall = unprofiled_wall(lambda: None, cut, contextlib.nullcontext)
    prof = profiled_report(
        lambda: None, cut, f"xlstm-1.3b request cut to {PROFILED_TOKENS} new tokens",
        cut_wall, kernel_names=())
    out["profile"] = prof
    # the cut is a prefill and PROFILED_TOKENS - 1 decode forwards
    out["prefill_launches"] = (prof["host_launches"] - (PROFILED_TOKENS - 1)
                               * out["decode_launches"]["host_launches"])
    print(f"  kernel launches a forward: prefill {out['prefill_launches']} (the cut's "
          f"{prof['host_launches']} less {PROFILED_TOKENS - 1} decode forwards), decode "
          f"{out['decode_launches']['host_launches']}", flush=True)
    stamp("phase 18 (d): one mLSTM and one sLSTM layer")
    out["split"] = xlstm_split(xs, cfg)
    del xs

    # (e) the prefill against the recurrence: token P's logits from one
    # prefill, and from a prefill of P - 1 tokens and one decode step (the
    # reference's test_prefill_decode_consistency, bound 0.05), held at one
    # 7:1 repetition and printed at full depth
    stamp("phase 18 (e): the prefill against the recurrence")
    out["prefill_decode_rel"] = {}
    for layers in (XLSTM_CUT, cfg.num_layers):
        c, p = cut_depth(cfg, params, layers) if layers < cfg.num_layers else (cfg, params)
        m = build_model(c)
        with torch.inference_mode():
            if layers < cfg.num_layers:
                a, _ = m.forward_serve(p, {"tokens": toks_d}, m.init_cache(Bs, P), 0)
                a = a.float()
            else:
                a = prefill_logits
            _, cb = m.forward_serve(p, {"tokens": toks_d[:, :P - 1]},
                                    m.init_cache(Bs, P), 0)
            b, _ = m.forward_serve(p, {"tokens": toks_d[:, P - 1:]}, cb, P - 1)
        b = b.float()
        rel = float(torch.linalg.norm(a - b) / (torch.linalg.norm(a) + 1e-9))
        out["prefill_decode_rel"][f"{layers} layers"] = rel
        what = (f"xlstm-1.3b, {layers} layers: token {P}'s logits from one prefill vs a "
                f"prefill of {P - 1} and one decode step, relative L2 gap {rel:.3g}")
        if layers == XLSTM_CUT:
            check(bool(torch.isfinite(a).all()) and rel <= 0.05, f"{what} <= 0.05")
        else:
            print(f"  {what}", flush=True)
        del a, b, cb

    stamp("phase 18 (b): xlstm-1.3b at the paper's fidelity")
    out["paper_fidelity"] = fidelity_run(cfg, params, batch, "xlstm-1.3b", linears,
                                         first=6)
    griffin_launches(entries, "pim_matmul", "xlstm-1.3b paper fidelity",
                     out["paper_fidelity"]["launches"]["pim_matmul"])
    try:
        serve_lib.Scheduler(model, params, page_size=PAGE, **SCHED_KW)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused and not serve_lib.scheduler_supported(cfg),
          "xlstm-1.3b: the Scheduler refuses the recurrent arch, as the reference's does")
    results["xlstm"] = out


# ---- 19. training: internlm2-1.8b trained at full width and depth ----------
TRAIN_BATCH, TRAIN_SEQ = 4, 1025   # T = 1,024 predicted positions: two CE chunks of 512
TRAIN_STEPS = 3
TRAIN_SMOKE_STEPS = 50
TRAIN_CUT = 2                       # layers of (b)'s kernel-against-plain step
TRAIN_CUT_SEQ = 129


@contextlib.contextmanager
def deterministic():
    """torch's deterministic implementations within the block (the
    embedding's and the CE gather's backward sum without atomics); an op
    that has none warns (the warnings are printed) instead of raising."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
    for w in {str(w.message)[:160] for w in caught
              if "deterministic" in str(w.message)}:
        print(f"  deterministic mode warned: {w}", flush=True)


def train_cfg(cfg, adc: str):
    return dataclasses.replace(cfg, remat="block",
                               pim=dataclasses.replace(cfg.pim, adc_mode=adc))


def train_batch(step: int, B: int, S: int, V: int, dev) -> dict:
    return {"tokens": torch.from_numpy(data.lm_batch(step, B, S, V)).long().to(dev)}


def train_launch_ms(args, kw) -> float:
    """Device ms of one kernel-3 launch on a train step's recorded operands
    (torch.profiler, padded retries; CUDA events where no session saw every
    launch)."""
    *_, M, K = args[0].shape
    N = args[1].shape[-1]

    def call():
        return mm_k.pim_matmul_int(*args, **kw)

    times = profiled_until(call, 10, lambda t: kernel_us(t, "pim_matmul_kernel")[1] == 10,
                           f"some of the 10 pim_matmul launches at M{M} K{K} N{N}")
    if times is None:
        return event_timed(call, 10, f"train M{M} K{K} N{N} pim_matmul")
    return per_call_ms(times, 10)


def train_full(dev, entries) -> dict:
    """(a) internlm2-1.8b at full width and depth: float32 master weights
    drawn from a CUDA generator, bf16 compute, the 6-bit ADC (kernel 3 in
    every PIM linear of every forward and of every block's recompute),
    per-block remat; TRAIN_STEPS steps of `lm_batch` at 4 x 1,025 tokens,
    lr 3e-4, warmup 1, each with its kernel counts set to 0 just before
    and read just after; step 0's layer-0 launches replayed against
    kernel 3's plain version; then one more step under torch.profiler."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime import train_lib
    cfg = train_cfg(get_config("internlm2-1.8b"), "quantized")
    B, S, V, L = TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, cfg.num_layers
    per_step = 2 * LINEARS_PER_LAYER * L        # a forward and the recompute
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), deploy=False)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    opt = train_lib.init_opt_state(params, tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = ckpt_flatten(params)
    n_params = sum(t.numel() for t in leaves)
    check(all(t.dtype == torch.float32 and t.is_cuda for t in leaves)
          and n_params == cfg.param_count() + cfg.d_model,
          f"internlm2-1.8b fp32 master tree on the card: {n_params:,} parameters "
          f"== param_count() {cfg.param_count():,} + the final norm's {cfg.d_model}")
    print(f"train internlm2-1.8b: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {V}; {n_params / 1e9:.3f} B float32 parameters, init + "
          f"AdamW state {init_s:.1f} s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          "GiB", flush=True)
    probe = params["blocks"][0]["mlp"]["w_gate"]["w"][0, :64, :64].clone()
    step = train_lib.make_train_step(model, tcfg)
    out = dict(steps=[], launches_per_step=per_step)
    bounds = None
    # step 0 keeps the operands of its first LINEARS_PER_LAYER launches
    # (layer 0's forward: every K x N of the stack at M = B x S), which are
    # then held against kernel 3's plain version bit for bit
    first = {f"step 0 linear {i}": B * S for i in range(LINEARS_PER_LAYER)}

    def pick(name, i):
        return f"step 0 linear {i}" if i < LINEARS_PER_LAYER else None

    for s in range(TRAIN_STEPS):
        batch = train_batch(s, B, S, V, dev)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        rec = adc_bounds() if s == TRAIN_STEPS - 1 else contextlib.nullcontext({})
        keep = (recorded(pick, {"pim_matmul": ADC_TARGETS["pim_matmul"]}) if s == 0
                else contextlib.nullcontext({}))
        with plain_calls() as n_plain, rec as seen, keep as kept:
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        bounds = seen or bounds
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        check(not n_plain, f"train step {s}: no plain-version call ({n_plain})")
        check(launches == {"pim_matmul": per_step},
              f"train step {s}: launches {launches} == pim_matmul {per_step} "
              f"({LINEARS_PER_LAYER} linears x {L} layers, forward and recompute)")
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
              f"train step {s}: finite loss {loss:.4f} and grad norm {gnorm:.4f}")
        out["steps"].append(dict(loss=loss, grad_norm=gnorm, lr=float(met["lr"]),
                                 ms=wall * 1e3))
        print(f"  train step {s}: loss {loss:.4f}, |g| {gnorm:.4f}, lr "
              f"{float(met['lr']):.2e}, {wall * 1e3:.1f} ms, "
              f"{B * S / wall:.1f} tokens/s", flush=True)
        del batch, met
        if s == 0:
            replay_adc("train step 0", kept, first)
            k3_ms = [train_launch_ms(args, kw) for _, args, kw in kept.values()]
            print(f"  train step 0: kernel 3 == plain bit for bit at M {B * S}, K x N "
                  f"{[tuple(a[1].shape) for _, a, _ in kept.values()]}; device ms a "
                  f"launch {[round(t, 4) for t in k3_ms]}", flush=True)
            kept.clear()
    moved = (params["blocks"][0]["mlp"]["w_gate"]["w"][0, :64, :64] - probe).abs().max()
    check(float(moved) > 0 and int(opt["step"]) == TRAIN_STEPS,
          f"the parameters moved (max |dw| {float(moved):.3g} over a 64 x 64 probe) "
          f"and the optimizer counted {int(opt['step'])} steps")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = [r["ms"] for r in out["steps"][1:]]
    out["step_ms"] = sum(steady) / len(steady)
    out["tokens_per_s"] = B * S / (out["step_ms"] / 1e3)
    print(f"  steady step {out['step_ms']:.1f} ms (steps 1-{TRAIN_STEPS - 1}), "
          f"{out['tokens_per_s']:.1f} training tokens/s ({B} x {S} a step), peak "
          f"{out['peak_gib']:.2f} GiB", flush=True)

    # the profiled steps replace the state: no other reference to the old
    # trees may stay live, or a profiling retry holds two of them beside
    # the step's own new ones (21 GiB each at full width)
    state = {"params": params, "opt": opt}
    del params, opt

    def run(_):
        state["params"], state["opt"], m = step(state["params"], state["opt"],
                                                train_batch(TRAIN_STEPS, B, S, V, dev))
        float(m["loss"])

    # the busy share and the step's top kernels only: late in a long
    # process the profiler can drop an event of a 23,000-kernel session, so
    # kernel 3's time per launch comes from its own sessions above
    report = profiled_report(lambda: None, run, "full-width train step",
                             out["step_ms"] / 1e3, kernel_names=())
    k3_us = sum(k3_ms) / len(k3_ms) * 1e3
    b_us = sum(bounds["pim_matmul"]) / len(bounds["pim_matmul"])
    check(len(bounds["pim_matmul"]) == per_step,
          f"kernel 3's bounds recorded at each of the step's {per_step} launches")
    # the step is device-bound: its device time under the profiler passes
    # the unprofiled wall, so its busy share is over the profiled wall
    busy = report["device_busy_ms"] / report["profiled_wall_ms"]
    print(f"  device busy {busy:.1%} of the profiled step's wall", flush=True)
    out.update(profile=report, kernel3_us=k3_us, kernel3_bound_us=b_us,
               busy_share=busy)
    print(f"  kernel 3 in the train step (M {B * S}): {k3_us:.2f} us per launch (the "
          f"mean of its {LINEARS_PER_LAYER} shapes, each {per_step // LINEARS_PER_LAYER}"
          f" times a step), bound {b_us:.3f} us (mean over its {per_step} launches' "
          f"shapes), {b_us / k3_us:.1%} of it; {per_step} launches {k3_us * per_step / 1e3:.1f}"
          f" ms = {k3_us * per_step / 1e3 / report['device_busy_ms']:.1%} of the "
          "profiled step's device time", flush=True)
    if "pim_matmul" in entries:
        entries["pim_matmul"]["train"] = dict(
            launches_per_step=per_step, us_per_launch=k3_us,
            bound_us=b_us, step_ms=out["step_ms"], tokens_per_s=out["tokens_per_s"],
            busy_share=busy, peak_gib=out["peak_gib"], M=B * S)
    del state, step
    torch.cuda.empty_cache()
    return out


def train_kernel_vs_plain(dev) -> dict:
    """(b) The first TRAIN_CUT layers at full width, batch 1 x 129: the
    loss and every gradient of a step through kernel 3 equal, bit for bit,
    those of the same step through kernel 3's plain version on the card
    (deterministic algorithms on)."""
    from repro_torch.runtime import train_lib
    cfg = dataclasses.replace(train_cfg(get_config("internlm2-1.8b"), "quantized"),
                              num_layers=TRAIN_CUT)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), deploy=False)
    batch = train_batch(0, 1, TRAIN_CUT_SEQ, cfg.vocab_size, dev)
    runs = {}
    for route in ("kernel", "plain"):
        saved = core_pim._adc_matmul
        if route == "plain":
            core_pim._adc_matmul = mm_k.pim_matmul_int_plain
        try:
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            with deterministic():
                grads, loss, _ = train_lib.grad_fn(model)(params, batch)
                torch.cuda.synchronize()
        finally:
            core_pim._adc_matmul = saved
        runs[route] = (grads, loss, {k: n for k, n in _build.LAUNCHES.items() if n})
    (gk, lk, nk), (gp, lp, npl) = runs["kernel"], runs["plain"]
    want = 2 * LINEARS_PER_LAYER * TRAIN_CUT
    check(nk == {"pim_matmul": want} and not npl,
          f"(b) kernel 3 launched {nk} ({want} expected), the plain route {npl or 'none'}")
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in zip(ckpt_flatten(gk), ckpt_flatten(gp))]
    check(torch.equal(lk, lp) and max(diffs) == 0.0,
          f"(b) {TRAIN_CUT} layers at full width, batch 1 x {TRAIN_CUT_SEQ}: loss "
          f"{float(lk):.6f} and all {len(diffs)} gradients through kernel 3 == through "
          f"its plain version bit for bit (max |diff| {max(diffs):.3g})")
    out = dict(loss=float(lk), leaves=len(diffs), launches=nk["pim_matmul"])
    del gk, gp, params, runs
    torch.cuda.empty_cache()
    return out


def train_smoke(dev) -> dict:
    """(c) SMOKE internlm2-1.8b from seed 0: TRAIN_SMOKE_STEPS steps of
    `lm_batch` (8 x 32) at lr 1e-2 lower the loss by 0.5 at least in both
    ADC modes; each trained tree, deployed by `deploy_tree`, then serves 8
    greedy tokens on the kernel path (kernels 1 and 2; kernel 3 too at the
    quantized ADC)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model_zoo import deploy_tree
    from repro_torch.runtime import train_lib
    out = {}
    for adc in ("ideal", "quantized"):
        cfg = train_cfg(get_config("internlm2-1.8b", smoke=True), adc)
        model = build_model(cfg)
        params = model.init(seed=0, deploy=False)
        tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=5,
                           total_steps=TRAIN_SMOKE_STEPS)
        step, opt = train_lib.make_train_step(model, tcfg), train_lib.init_opt_state(params, tcfg)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(TRAIN_SMOKE_STEPS):
            params, opt, m = step(params, opt, train_batch(s, 8, 32, cfg.vocab_size, dev))
            losses.append(float(m["loss"]))
        wall = time.perf_counter() - t0
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0] - 0.5,
              f"(c) SMOKE, {adc} ADC: {TRAIN_SMOKE_STEPS} steps lower the loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} by 0.5 at least")
        served = dataclasses.replace(cfg, attn_impl="kernel")
        smodel = build_model(served)
        batch = {"tokens": torch.from_numpy(data.lm_batch(0, 2, 16, cfg.vocab_size)).long()}
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with plain_calls() as n_plain:
            toks = serve_lib.generate(smodel, deploy_tree(params, served), batch, 8, 24)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        L = cfg.num_layers
        want = {"pim_attention": L, "pim_decode": 7 * L}
        if adc == "quantized":
            want["pim_matmul"] = LINEARS_PER_LAYER * L * 8
        check(not n_plain and launches == want
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"(c) the trained {adc}-ADC tree deployed and served 8 tokens on the kernel "
              f"path: launches {launches} == {want}, tokens in the vocabulary")
        print(f"  (c) {adc} ADC: {TRAIN_SMOKE_STEPS} SMOKE steps in {wall:.2f} s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; served {toks[0].tolist()}", flush=True)
        out[adc] = dict(first=losses[0], last=losses[-1], wall_s=wall)
    return out


def train_restart(dev) -> dict:
    """(d) The train CLI at SMOKE (10 steps, a checkpoint every 2) with a
    crash injected at step 7 equals an uninterrupted run bit for bit
    (deterministic algorithms on)."""
    from repro_torch.launch import train as train_cli
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "10", "--batch", "8",
            "--seq", "32", "--ckpt-every", "2"]
    make_batch = data.make_batch
    crashed = []

    def crashing(cfg, shape, step, **kw):
        if step == 7 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected failure at step 7")
        return make_batch(cfg, shape, step, **kw)

    states = []
    for crash in (False, True):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
            data.make_batch = crashing if crash else make_batch
            try:
                with deterministic():
                    state, metrics = train_cli.main(argv + ["--ckpt-dir", d])
            finally:
                data.make_batch = make_batch
        states.append((state, metrics))
    (a, ma), (b, mb) = states
    la, lb = ckpt_flatten(a), ckpt_flatten(b)
    check(crashed == [7] and len(la) == len(lb)
          and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))
          and ma["loss"] == mb["loss"],
          f"(d) the train CLI crashed at step 7 and restored from its step-5 checkpoint "
          f"ends bit for bit where an uninterrupted run ends ({len(la)} leaves, final "
          f"loss {mb['loss']:.4f})")
    return dict(final_loss=mb["loss"], leaves=len(la))


def train_phase(dev, entries, results) -> None:
    """Phase 19: the training path (see the module docstring)."""
    stamp("phase 19 (a): internlm2-1.8b trained at full width")
    out = {"full": train_full(dev, entries)}
    stamp("phase 19 (b): kernel 3 against its plain version inside a train step")
    out["kernel_vs_plain"] = train_kernel_vs_plain(dev)
    stamp("phase 19 (c): SMOKE training in both ADC modes, then served")
    out["smoke"] = train_smoke(dev)
    stamp("phase 19 (d): the train CLI restarted after a crash")
    out["restart"] = train_restart(dev)
    results["train"] = out


# ---- 20. training of MoE, encoder-decoder and image-patch stacks -----------
MOE_TRAIN_LAYERS = 3     # deepseek-moe-16b's dense layer and first two MoE layers
MOE_CUT_LAYERS = 2       # (c)'s deepseek cut: the dense layer and one MoE layer
PHI3_CUT_LAYERS = 2      # (c)'s phi-3-vision-4.2b cut
PHI3_CUT_SEQ = 641       # its 576 image patches and 65 more tokens
ZOO_SMOKE = ("deepseek-moe-16b", "dbrx-132b", "whisper-tiny", "phi-3-vision-4.2b")
# step 0's kernel-3 launches kept and replayed, by index among the step's
# launches: deepseek's dense layer (0-6), its first MoE layer's attention
# (7-10), routed (11-13) and shared (14-16) stacks; whisper's first encoder
# layer (0-5, M 6,000), then after the encoder's 24 its first decoder
# layer: self wq (24), cross wk (29, M 6,000), MLP (32-33)
ZOO_KEPT = {
    "deepseek-moe-16b": {0: "dense wq", 4: "dense w_gate", 6: "dense w_out",
                         11: "routed w_gate", 13: "routed w_out",
                         14: "shared w_gate", 16: "shared w_out"},
    "whisper-tiny": {0: "encoder wq", 4: "encoder w_in", 5: "encoder w_out",
                     24: "decoder wq", 29: "cross wk", 32: "decoder w_in",
                     33: "decoder w_out"},
}


def zoo_cfg(name: str, layers=None, smoke: bool = False):
    """The arch at the 6-bit ADC with per-block remat, cut to `layers`;
    dbrx-132b's SMOKE at head_dim 32 (its 16 is no kernel head dim)."""
    cfg = train_cfg(get_config(name, smoke=smoke), "quantized")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if smoke and name == "dbrx-132b":
        cfg = dataclasses.replace(cfg, head_dim=32)
    return cfg


def zoo_batch(cfg, step: int, B: int, S: int, dev) -> dict:
    """`make_batch`'s step: tokens, and the frames or image embeddings the
    arch takes."""
    b = data.make_batch(cfg, types.SimpleNamespace(global_batch=B, seq_len=S), step)
    out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _linears(cfg, kind: str, prefill: bool = True) -> tuple:
    """(dense PIM linears, expert stacks) of one block's forward: the
    attention's 4, a cross block's 4 more (2 at decode: its cross K/V are
    cached), the MLP's 2 or 3, or a MoE FFN's 3 stacks, routed and
    shared."""
    mlp = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if kind == "moe":
        return 4, 3 * (1 + (cfg.moe.num_shared > 0))
    return 4 + (4 if prefill else 2) * (kind == "xattn") + mlp, 0


def _counts(dense: int, stacks: int) -> dict:
    return {k: n for k, n in (("pim_matmul", dense), ("pim_matmul_experts", stacks)) if n}


def train_launches(cfg) -> dict:
    """Kernel-3 launches of one train step at the 6-bit ADC with per-block
    remat: every PIM linear of the forward, those of the stacked blocks
    again in their recompute; the dense prefix, the encoder, the unrolled
    tail and `img_proj` run once."""
    pat, R, tail = TT.pattern_layout(cfg)
    dense = stacks = 0
    for kind, times in ([(k, 2 * R) for k in pat] + [(k, 1) for k in tail]
                        + [("attn", 1)] * (cfg.num_dense_layers if "moe" in pat else 0)
                        + [("enc_attn", 1)] * cfg.num_encoder_layers):
        d, e = _linears(cfg, kind)
        dense, stacks = dense + d * times, stacks + e * times
    return _counts(dense + bool(cfg.num_image_patches), stacks)


def served_launches(cfg, new: int) -> dict:
    """Launches of `generate`'s `new` tokens on the kernel path at the 6-bit
    ADC: kernel 1 once a layer (twice a cross layer) in the prefill,
    kernel 2 so in each decode forward; kernel 3 in every PIM linear of
    every forward (the encoder and `img_proj` in the prefill only)."""
    pat, R, tail = TT.pattern_layout(cfg)
    kinds = [k for k in pat for _ in range(R)] + list(tail)
    kinds += ["attn"] * (cfg.num_dense_layers if "moe" in pat else 0)
    attn = sum(2 if k == "xattn" else 1 for k in kinds)
    dense = stacks = 0
    for prefill, forwards in ((True, 1), (False, new - 1)):
        for k in kinds:
            d, e = _linears(cfg, k, prefill)
            dense, stacks = dense + d * forwards, stacks + e * forwards
    dense += cfg.num_encoder_layers * _linears(cfg, "enc_attn")[0]
    dense += bool(cfg.num_image_patches)
    return {"pim_attention": attn, "pim_decode": (new - 1) * attn,
            **_counts(dense, stacks)}


def zoo_probes(params, cfg) -> dict:
    """Views of the leaves the step must move: deepseek's router, every
    routed and shared stack and its dense layer; whisper's encoder, its
    decoder's self and cross linears."""
    if cfg.moe.num_experts:
        moe = params["blocks"][0]["moe"]
        out = {"router": moe["router"][:, :64]}
        for stack in ("experts", "shared"):
            for k, w in moe[stack].items():
                out[f"{stack} {k}"] = w[..., :64, :64]
        out["dense wq"] = params["dense_prefix"][0]["attn"]["wq"]["w"][:64, :64]
        out["dense w_gate"] = params["dense_prefix"][0]["mlp"]["w_gate"]["w"][:64, :64]
        return out
    enc, dec = params["enc_blocks"], params["blocks"][0]
    return {"encoder wq": enc["attn"]["wq"]["w"][:, :64, :64],
            "encoder w_in": enc["mlp"]["w_in"]["w"][:, :64, :64],
            "decoder wq": dec["attn"]["wq"]["w"][:, :64, :64],
            "cross wk": dec["xattn"]["wk"]["w"][:, :64, :64],
            "cross wv": dec["xattn"]["wv"]["w"][:, :64, :64]}


def zoo_train_full(dev, entries, name: str, layers=None) -> dict:
    """(a) / (b): `name` at full width (cut to `layers`), float32 master
    weights from a CUDA generator (seed 0), bf16 compute, the 6-bit ADC,
    per-block remat: TRAIN_STEPS steps of `make_batch` at 4 x 1,025 tokens
    (whisper's with 4 x 1,500 frames), lr 3e-4, warmup 1, each with its
    kernel counts set to 0 just before and read just after; step 0's
    `ZOO_KEPT` launches replayed against kernel 3's plain version bit for
    bit and timed; then one more step under torch.profiler."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime import train_lib
    cfg = zoo_cfg(name, layers)
    B, S, V = TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size
    want = train_launches(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), deploy=False)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    opt = train_lib.init_opt_state(params, tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = ckpt_flatten(params)
    n_params = sum(t.numel() for t in leaves)
    check(all(t.dtype == torch.float32 and t.is_cuda for t in leaves),
          f"{name}: fp32 master tree on the card, {n_params:,} parameters")
    print(f"train {name}: {cfg.num_layers} layers ({cfg.num_encoder_layers} encoder), "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, experts {cfg.moe.num_experts} "
          f"top-{cfg.moe.top_k} + {cfg.moe.num_shared} shared, vocab {V}; "
          f"{n_params / 1e9:.3f} B float32 parameters, init + AdamW state {init_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    probes = {k: v.clone() for k, v in zoo_probes(params, cfg).items()}
    step = train_lib.make_train_step(model, tcfg)
    out = dict(steps=[], launches_per_step=want, params=n_params)
    keep_at = ZOO_KEPT[name]
    C = moe_mod.capacity(B * S, cfg) if cfg.moe.num_experts else 0
    Se = cfg.encoder_seq_len

    def tokens(label):
        if label.startswith("routed"):
            return cfg.moe.num_experts * C
        if label.startswith("shared"):
            return cfg.moe.num_shared * B * S
        return B * (Se if label.startswith(("encoder", "cross")) else S)

    for s in range(TRAIN_STEPS):
        batch = zoo_batch(cfg, s, B, S, dev)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        keep = (recorded(lambda n, i: keep_at.get(i), {"pim_matmul": ADC_TARGETS["pim_matmul"]})
                if s == 0 else contextlib.nullcontext({}))
        with plain_calls() as n_plain, keep as kept:
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            loss, gnorm, aux = float(met["loss"]), float(met["grad_norm"]), float(met["aux"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        check(not n_plain, f"{name} train step {s}: no plain-version call ({n_plain})")
        check(launches == want, f"{name} train step {s}: launches {launches} == {want}")
        check(all(map(math.isfinite, (loss, gnorm, aux))) and gnorm > 0
              and (aux > 0) == bool(cfg.moe.num_experts),
              f"{name} train step {s}: finite loss {loss:.4f}, grad norm {gnorm:.4f} and "
              f"aux {aux:.6f}")
        out["steps"].append(dict(loss=loss, grad_norm=gnorm, aux=aux, lr=float(met["lr"]),
                                 ms=wall * 1e3))
        print(f"  {name} train step {s}: loss {loss:.4f} (aux {aux:.6f}), |g| {gnorm:.4f}, "
              f"{wall * 1e3:.1f} ms, {B * S / wall:.1f} tokens/s", flush=True)
        del batch, met
        if s == 0:
            replay_adc(f"{name} train step 0", kept, {k: tokens(k) for k in keep_at.values()})
            timed = {}
            for label, (_, args, kw) in kept.items():
                *lead, M, K = args[0].shape
                N = args[1].shape[-1]
                E = lead[0] if lead else 1
                b_ms = expert_bound(E, M, K, N, True)[0]
                timed[label] = dict(E=E, M=M, K=K, N=N, us=train_launch_ms(args, kw) * 1e3,
                                    bound_us=b_ms * 1e3)
            for label, t in timed.items():
                print(f"  {label}: E {t['E']} M {t['M']} K {t['K']} N {t['N']}, kernel 3 == "
                      f"plain bit for bit, {t['us']:.2f} us a launch, bound "
                      f"{t['bound_us']:.2f} us ({t['bound_us'] / t['us']:.1%})", flush=True)
            out["kept"] = timed
            kept.clear()
    moved = {k: float((v - probes[k]).abs().max())
             for k, v in zoo_probes(params, cfg).items()}
    check(all(d > 0 for d in moved.values()) and int(opt["step"]) == TRAIN_STEPS,
          f"{name}: every probed leaf moved ({ {k: f'{d:.3g}' for k, d in moved.items()} }) "
          f"and the optimizer counted {int(opt['step'])} steps")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = [r["ms"] for r in out["steps"][1:]]
    out["step_ms"] = sum(steady) / len(steady)
    out["tokens_per_s"] = B * S / (out["step_ms"] / 1e3)
    print(f"  {name}: steady step {out['step_ms']:.1f} ms, {out['tokens_per_s']:.1f} "
          f"training tokens/s ({B} x {S} a step), peak {out['peak_gib']:.2f} GiB", flush=True)
    state = {"params": params, "opt": opt}
    del params, opt

    def run(_):
        state["params"], state["opt"], m = step(state["params"], state["opt"],
                                                zoo_batch(cfg, TRAIN_STEPS, B, S, dev))
        float(m["loss"])

    report = profiled_report(lambda: None, run, f"{name} train step",
                             out["step_ms"] / 1e3, kernel_names=())
    busy = report["device_busy_ms"] / report["profiled_wall_ms"]
    print(f"  {name}: device busy {busy:.1%} of the profiled step's wall", flush=True)
    out.update(profile=report, busy_share=busy)
    del state, step
    torch.cuda.empty_cache()
    return out


def zoo_kernel_vs_plain(dev, name: str, layers: int, seq: int) -> dict:
    """(c) `name`'s first `layers` layers at full width, batch 1 x `seq`
    (`make_batch`'s, phi-3's with its image): the loss and every gradient
    of a step through kernel 3 equal, bit for bit, those through its plain
    version on the card (deterministic algorithms on)."""
    from repro_torch.runtime import train_lib
    cfg = zoo_cfg(name, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), deploy=False)
    batch = zoo_batch(cfg, 0, 1, seq, dev)
    runs = {}
    for route in ("kernel", "plain"):
        saved = core_pim._adc_matmul
        if route == "plain":
            core_pim._adc_matmul = mm_k.pim_matmul_int_plain
        try:
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            with deterministic():
                grads, loss, _ = train_lib.grad_fn(model)(params, batch)
                torch.cuda.synchronize()
        finally:
            core_pim._adc_matmul = saved
        runs[route] = (grads, loss, {k: n for k, n in _build.LAUNCHES.items() if n})
    (gk, lk, nk), (gp, lp, npl) = runs["kernel"], runs["plain"]
    want = train_launches(cfg)
    check(nk == want and not npl,
          f"(c) {name}: kernel 3 launched {nk} ({want} expected), the plain route "
          f"{npl or 'none'}")
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in zip(ckpt_flatten(gk), ckpt_flatten(gp))]
    check(torch.equal(lk, lp) and max(diffs) == 0.0,
          f"(c) {name}, {layers} layers at full width, batch 1 x {seq}: loss "
          f"{float(lk):.6f} and all {len(diffs)} gradients through kernel 3 == through "
          f"its plain version bit for bit (max |diff| {max(diffs):.3g})")
    out = dict(loss=float(lk), leaves=len(diffs), launches=nk)
    del gk, gp, params, runs
    torch.cuda.empty_cache()
    return out


def zoo_smoke(dev) -> dict:
    """(d) ZOO_SMOKE's SMOKE models (dbrx-132b's at head_dim 32) from seed
    0 at the 6-bit ADC: TRAIN_SMOKE_STEPS steps of `make_batch` (8 x 32,
    with frames or image embeddings) at lr 1e-2 lower each loss by 0.5 at
    least; each trained tree, deployed by `deploy_tree`, then serves 8
    greedy tokens on the kernel path (whisper with its frames, phi-3 with
    its image), its launches counted."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model_zoo import deploy_tree
    from repro_torch.runtime import train_lib
    out = {}
    for name in ZOO_SMOKE:
        cfg = zoo_cfg(name, smoke=True)
        model = build_model(cfg)
        params = model.init(seed=0, deploy=False)
        tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=5,
                           total_steps=TRAIN_SMOKE_STEPS)
        step, opt = train_lib.make_train_step(model, tcfg), train_lib.init_opt_state(params, tcfg)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(TRAIN_SMOKE_STEPS):
            params, opt, m = step(params, opt, zoo_batch(cfg, s, 8, 32, dev))
            losses.append(float(m["loss"]))
        wall = time.perf_counter() - t0
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0] - 0.5,
              f"(d) {name} SMOKE: {TRAIN_SMOKE_STEPS} steps lower the loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} by 0.5 at least")
        served = dataclasses.replace(cfg, attn_impl="kernel")
        smodel = build_model(served)
        batch = {k: torch.from_numpy(v) for k, v in data.make_batch(
            cfg, types.SimpleNamespace(global_batch=2, seq_len=16), 0).items()}
        batch["tokens"] = batch["tokens"].long()
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        with plain_calls() as n_plain:
            toks = serve_lib.generate(smodel, deploy_tree(params, served), batch, 8, 24)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        want = served_launches(cfg, 8)
        check(not n_plain and launches == want
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"(d) the trained {name} tree deployed and served 8 tokens on the kernel "
              f"path: launches {launches} == {want}, tokens in the vocabulary")
        print(f"  (d) {name}: {TRAIN_SMOKE_STEPS} SMOKE steps in {wall:.2f} s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; served {toks[0].tolist()}", flush=True)
        out[name] = dict(first=losses[0], last=losses[-1], wall_s=wall)
    return out


def zoo_train_phase(dev, entries, results) -> None:
    """Phase 20: training of MoE, encoder-decoder and image-patch stacks
    (see the module docstring)."""
    stamp("phase 20 (a): deepseek-moe-16b trained at full width, 3 layers")
    out = {"deepseek": zoo_train_full(dev, entries, "deepseek-moe-16b", MOE_TRAIN_LAYERS)}
    stamp("phase 20 (b): whisper-tiny trained at full width and depth")
    out["whisper"] = zoo_train_full(dev, entries, "whisper-tiny")
    stamp("phase 20 (c): kernel 3 against its plain version inside MoE and image steps")
    out["kernel_vs_plain"] = {
        "deepseek": zoo_kernel_vs_plain(dev, "deepseek-moe-16b", MOE_CUT_LAYERS,
                                        TRAIN_CUT_SEQ),
        "phi3": zoo_kernel_vs_plain(dev, "phi-3-vision-4.2b", PHI3_CUT_LAYERS, PHI3_CUT_SEQ)}
    stamp("phase 20 (d): SMOKE training of the MoE, whisper and phi-3 archs, then served")
    out["smoke"] = zoo_smoke(dev)
    ds = out["deepseek"]
    routed = [t for k, t in ds["kept"].items() if k.startswith(("routed", "shared"))]
    train = dict(launches_per_step=ds["launches_per_step"].get("pim_matmul_experts"),
                 us_per_launch={k: t["us"] for k, t in ds["kept"].items()
                                if k.startswith(("routed", "shared"))},
                 bound_us={k: t["bound_us"] for k, t in ds["kept"].items()
                           if k.startswith(("routed", "shared"))},
                 shapes=[(t["E"], t["M"], t["K"], t["N"]) for t in routed],
                 step_ms=ds["step_ms"], tokens_per_s=ds["tokens_per_s"],
                 busy_share=ds["busy_share"], peak_gib=ds["peak_gib"])
    if "pim_matmul_experts" in entries:
        entries["pim_matmul_experts"]["train"] = train
    if "pim_matmul" in entries:
        entries["pim_matmul"]["train_zoo"] = {
            k: dict(launches_per_step=out[k]["launches_per_step"].get("pim_matmul"),
                    step_ms=out[k]["step_ms"], tokens_per_s=out[k]["tokens_per_s"],
                    busy_share=out[k]["busy_share"], peak_gib=out[k]["peak_gib"])
            for k in ("deepseek", "whisper")}
    results["train_zoo"] = out


if __name__ == "__main__":
    sys.exit(main())
