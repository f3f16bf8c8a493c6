"""Training entry point of the port: restartable, checkpointed,
watchdog-monitored.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /path/to/ckpts

The CLI of the JAX package's `launch/train.py`: fp master weights from
`--seed`, AdamW with warmup and cosine decay, `--microbatches` of gradient
accumulation, a checkpoint generation every `--ckpt-every` steps under
`--ckpt-dir` (a run resumes from the newest intact one there, and a step
that raises is restored from it), batches of `data.make_batch` (`--data
lm`, a Markov chain, or `copy`; whisper-tiny's batches carry `frames`,
phi-3-vision-4.2b's `image_embeds`).  The port trains every arch but the
recurrent ones: attention stacks (internlm2-1.8b, qwen2-72b,
mistral-large-123b, gemma-7b), MoE stacks with their load-balance aux
term (deepseek-moe-16b, dbrx-132b), whisper-tiny's encoder-decoder and
phi-3-vision-4.2b's image patches (the tests hold their SMOKE models
against the JAX package's); recurrentgemma-9b and xlstm-1.3b raise
(ROADMAP.md §1 item 8), as do `--mesh` and `--compression int8_ef` (item
9).  Runs on the GPU; `--device cpu` runs the plain PyTorch versions
instead (use `--smoke` there).
"""
from __future__ import annotations

import argparse
import time
import types

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as data
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import fault, train_lib


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="", help="e.g. 4,2 -> (data,model)")
    ap.add_argument("--ckpt-dir", default=TrainConfig.checkpoint_dir)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--data", default="lm", choices=["lm", "copy"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh: training over a mesh is "
                                  "ROADMAP.md §1 item 9")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    T.check_trainable(cfg)
    model = build_model(cfg, args.device)
    tcfg = TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps, microbatches=args.microbatches,
        grad_compression=args.compression, seed=args.seed,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir)
    step_fn = train_lib.make_train_step(model, tcfg)
    shape = types.SimpleNamespace(global_batch=args.batch, seq_len=args.seq)

    def make_state():
        params = model.init(seed=tcfg.seed, deploy=False)
        return {"params": params,
                "opt": train_lib.init_opt_state(params, tcfg)}

    wd = fault.StepWatchdog(
        on_straggler=lambda s, dt, med: print(
            f"[watchdog] step {s} straggled: {dt:.2f}s vs median {med:.2f}s"))
    t_start = time.time()

    def one_step(state, step):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in data.make_batch(cfg, shape, step, seed=tcfg.seed,
                                             kind=args.data).items()}
        batch["tokens"] = batch["tokens"].long()
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss={metrics['loss']:.4f}"
                  f" lr={metrics.get('lr', 0):.2e}"
                  f" |g|={metrics.get('grad_norm', 0):.3f}"
                  f" ({time.time() - t_start:.1f}s)")
        return {"params": params, "opt": opt}, metrics

    state, metrics = fault.run_restartable(
        args.steps, make_state, one_step, args.ckpt_dir,
        checkpoint_every=tcfg.checkpoint_every, keep=tcfg.keep_checkpoints,
        watchdog=wd)
    print(f"[train] done: final loss {metrics.get('loss', float('nan')):.4f}, "
          f"median step {wd.median:.2f}s, stragglers {wd.stragglers}")
    return state, metrics


if __name__ == "__main__":
    main()
