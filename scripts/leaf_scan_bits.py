#!/usr/bin/env python3
"""Hold the CUDA leaf scan's fp32 outputs of one tree against another's, bit for bit.

    python3 scripts/leaf_scan_bits.py write build/bits.pt   # from one tree's root
    python3 scripts/leaf_scan_bits.py check build/bits.pt   # from the other's

Runs the fp32 kernel on fixed seeded inputs: the main-path shape (W=4096
units, TQ=128, L_pad=4096, d=10) with a register list (k=10), a
shared-memory list (k=18) and the output rows (k=300), and the wide kernel
(d=130).  ``check`` exits non-zero unless every distance and index equals
the file's.  Needs one CUDA device.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

CASES = [  # (name, W, TQ, L_pad, d, k)
    ("main_k10", 4096, 128, 4096, 10, 10),
    ("main_k18", 4096, 128, 4096, 10, 18),
    ("k300", 64, 128, 600, 10, 300),
    ("wide_d130", 64, 128, 600, 130, 10),
]


def outputs() -> dict:
    from repro_torch.kernels import knn_scan

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for name, w, tq, lp, d, k in CASES:
        q = torch.randn((w, tq, d), device=dev, generator=gen)
        x = torch.randn((w, lp, d), device=dev, generator=gen)
        kd, ki = knn_scan.leaf_scan_cuda(q, x, k=k)
        out[name] = (kd.cpu(), ki.cpu())
    return out


def main(argv) -> int:
    if len(argv) != 2 or argv[0] not in ("write", "check") or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    got = outputs()
    if argv[0] == "write":
        torch.save(got, argv[1])
        return 0
    want = torch.load(argv[1])
    bad = [n for n in want if not (torch.equal(got[n][0], want[n][0])
                                   and torch.equal(got[n][1], want[n][1]))]
    for n in want:
        print(f"{n}: {'differs' if n in bad else 'identical'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
