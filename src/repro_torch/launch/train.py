"""Training launcher: --arch X --steps N, with checkpoint / restart.

Counterpart of ``repro.launch.train`` with the same flags, plus
``--device`` (default cuda: cuda:0).  It runs real steps of the local train
step (``training/step.py``) on one device; the data is deterministic by
(seed, step), and a run auto-resumes from the newest checkpoint in
``--ckpt-dir`` at the data step its manifest records.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen15_0_5b --smoke \\
      --steps 50 --ckpt-dir /tmp/ck --ckpt-every 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen15_0_5b --smoke \\
      --steps 50
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import LanguageModel
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import Hyper, adamw_init
from repro_torch.training.step import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the model (cuda: cuda:0)")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")

    cfg = get_config(args.arch, smoke=args.smoke)
    lm = LanguageModel(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(args.seed))
    h = Hyper(lr=args.lr, warmup_steps=max(5, args.steps // 20),
              total_steps=args.steps, grad_accum=args.grad_accum)
    opt = adamw_init(dict(lm.named_parameters()))
    step_fn = build_train_step(lm, h)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=args.seed)

    ck = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ck and ck.latest_step() is not None:
        state, man = ck.restore({"params": lm.state_dict(), "opt": opt})
        lm.load_state_dict(state["params"])
        opt = state["opt"]
        start = man["extra"]["data_step"]
        print(f"[train] resumed from step {start}")

    t0 = time.time()
    for t in range(start, args.steps):
        m = step_fn(opt, pipe.global_batch_at(t), t)
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"[train] step {t:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ck and (t + 1) % args.ckpt_every == 0:
            ck.save(t + 1, {"params": lm.state_dict(), "opt": opt},
                    extra={"data_step": t + 1})
    if ck:
        if start < args.steps and args.steps % args.ckpt_every:
            ck.save(args.steps, {"params": lm.state_dict(), "opt": opt},
                    extra={"data_step": args.steps})
        ck.wait()   # the loop's last save may still be in flight
    print("[train] done")


if __name__ == "__main__":
    main()
