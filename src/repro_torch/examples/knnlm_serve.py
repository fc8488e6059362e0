"""kNN-LM serving: the paper's technique integrated with the LM stack.

Counterpart of ``examples/knnlm_serve.py``: trains a tiny LM briefly,
builds a buffer k-d tree datastore over its context embeddings (projected
to d = 16, k-d tree territory), and serves interpolated next-token
predictions.  On Markov data the kNN memorisation moves next-token
probability mass onto the true successor set.

    PYTHONPATH=src python -m repro_torch.examples.knnlm_serve [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import LanguageModel
from repro_torch.serving import KNNLM
from repro_torch.training import Hyper, adamw_init, build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")

    cfg = get_config("qwen15_0_5b", smoke=True).replace(vocab_size=512)
    lm = LanguageModel(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(0))

    # brief training so the embeddings carry signal
    pipe = TokenPipeline(cfg.vocab_size, 64, 8, seed=0, branching=2)
    step = build_train_step(lm, Hyper(lr=5e-3, warmup_steps=5, total_steps=args.steps))
    opt = adamw_init(dict(lm.named_parameters()))
    for t in range(args.steps):
        m = step(opt, pipe.global_batch_at(t), t)
    print(f"trained {args.steps} steps, loss {float(m['loss']):.3f}")

    # the datastore over a held-out slice of the corpus
    knn = KNNLM(lm, proj_dim=16, k=10, lam=0.5, tree_height=4)
    corpus = np.concatenate([pipe.global_batch_at(1000 + t)["tokens"] for t in range(8)])
    knn.build_datastore(corpus)
    print(f"datastore: {knn.values.shape[0]} (context -> next token) pairs, "
          f"engine={knn.index.engine_name} tree height {knn.index.height}")

    # the probability mass on the Markov table's successors
    test = pipe.global_batch_at(2000)["tokens"][:16]
    p_mix = knn.next_token_probs(test)
    with torch.no_grad():
        logits, _ = lm({"tokens": test})
    p_lm = torch.softmax(logits[:, -1, : cfg.vocab_size], -1).cpu().numpy()
    succ = [pipe.table[test[b, -1]] for b in range(test.shape[0])]
    mass_lm = np.mean([p_lm[b, s].sum() for b, s in enumerate(succ)])
    mass_mix = np.mean([p_mix[b, s].sum() for b, s in enumerate(succ)])
    print(f"P(true successor set): LM alone {mass_lm:.3f}  with kNN-LM {mass_mix:.3f}")


if __name__ == "__main__":
    main()
