"""End-to-end training example: train a small LM for a few hundred steps.

Counterpart of ``examples/train_lm.py``: AdamW + clip + schedule, the
deterministic pipeline, checkpoint / restart (kill it mid-run and run it
again: it resumes from the newest checkpoint).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import LanguageModel
from repro_torch.training import CheckpointManager, Hyper, adamw_init, build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm_ck"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")

    # a 5.3M-parameter qwen-family model (a CPU-trainable stand-in; scale
    # d_model / n_layers up on the card)
    cfg = get_config("qwen15_0_5b").replace(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_head=32, d_ff=704,
        vocab_size=8192, vocab_pad_multiple=64,
    )
    lm = LanguageModel(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(0))
    step = build_train_step(lm, Hyper(lr=3e-3, warmup_steps=20, total_steps=args.steps))
    pipe = TokenPipeline(cfg.vocab_size, seq_len=128, global_batch=16, seed=0)
    ck = CheckpointManager(args.ckpt, keep=2)
    opt = adamw_init(dict(lm.named_parameters()))

    start = 0
    if ck.latest_step() is not None:
        state, man = ck.restore({"params": lm.state_dict(), "opt": opt})
        lm.load_state_dict(state["params"])
        opt = state["opt"]
        start = man["extra"]["data_step"]
        print(f"resumed from checkpoint at step {start}")

    n_params = sum(p.numel() for p in lm.parameters())
    print(f"{cfg.name}-mini: {n_params / 1e6:.1f}M params, {args.steps} steps, "
          f"batch 16 x 128 tokens, on {device}")

    t0, first_loss, loss = time.time(), float("nan"), float("nan")
    for t in range(start, args.steps):
        m = step(opt, pipe.global_batch_at(t), t)
        loss = float(m["loss"])
        first_loss = loss if t == start else first_loss
        if t % 25 == 0 or t == args.steps - 1:
            tok_s = (t - start + 1) * 16 * 128 / (time.time() - t0)
            print(f"step {t:4d}  loss {loss:.4f}  lr {float(m['lr']):.2e}  "
                  f"{tok_s:.0f} tok/s", flush=True)
        if (t + 1) % 100 == 0 and t + 1 < args.steps:
            ck.save(t + 1, {"params": lm.state_dict(), "opt": opt},
                    extra={"data_step": t + 1})
    if start < args.steps:
        ck.save(args.steps, {"params": lm.state_dict(), "opt": opt},
                extra={"data_step": args.steps}, block=True)
    print(f"final loss {loss:.4f} (from {first_loss:.4f}); checkpoints in {args.ckpt}")


if __name__ == "__main__":
    main()
