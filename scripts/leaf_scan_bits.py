#!/usr/bin/env python3
"""Hold the CUDA leaf scan's outputs of one tree against another's, bit for bit.

    python3 scripts/leaf_scan_bits.py write build/bits.pt   # from one tree's root
    python3 scripts/leaf_scan_bits.py check build/bits.pt   # from the other's

The script may be a newer tree's copy: it imports the package of the tree
it is run from (``src/`` under the working directory), and uses only the
wrapper's ``leaf_scan_cuda(q, slab, k=, scale=, offset=, dead=)``.

Runs the kernel on fixed seeded inputs: the main-path shape (W=4096 units,
TQ=128, L_pad=4096, d=10) with fp32 rows at k = 10 (a register list), 18
(a quantized k = 10 query's list) and 74 (the refining pass's), and with
uint8 and float16 codes (5 % dead rows) at the same k; a list of 300 and
the wide kernel (d = 30, 130, 300 and 520 in chunks of features; fp32,
uint8 and float16).  ``write`` stores a SHA-256 of every output's
distances and indices; ``check`` exits non-zero unless every one equals
the file's.  Needs one CUDA device.
"""

import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.getcwd(), "src"))

CASES = [  # (name, W, TQ, L_pad, d, k, code)
    ("main_k10", 4096, 128, 4096, 10, 10, "f32"),
    ("main_k18", 4096, 128, 4096, 10, 18, "f32"),
    ("main_k74", 4096, 128, 4096, 10, 74, "f32"),
    ("k300", 64, 128, 600, 10, 300, "f32"),
    ("wide_d130", 64, 128, 600, 130, 10, "f32"),
    ("wide_d130_k74", 64, 128, 600, 130, 74, "f32"),
    ("wide_d30_k16", 256, 128, 4096, 30, 16, "f32"),
    ("wide_d30_k74", 256, 128, 4096, 30, 74, "f32"),
    ("wide_d300_k300", 16, 128, 600, 300, 300, "f32"),
    ("wide_d520_k16", 16, 128, 600, 520, 16, "f32"),
    ("wide_u8_d30_k18", 256, 128, 4096, 30, 18, "u8"),
    ("wide_f16_d30_k74", 64, 128, 600, 30, 74, "f16"),
    ("u8_k10", 4096, 128, 4096, 10, 10, "u8"),
    ("u8_k18", 4096, 128, 4096, 10, 18, "u8"),
    ("u8_k74", 4096, 128, 4096, 10, 74, "u8"),
    ("f16_k10", 4096, 128, 4096, 10, 10, "f16"),
    ("f16_k18", 4096, 128, 4096, 10, 18, "f16"),
    ("f16_k74", 4096, 128, 4096, 10, 74, "f16"),
]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()


def _codes(gen, code, w, lp, d, dev):
    """A code slab and its metadata: random codes, per-leaf u8 scale and
    offset, and 5 % dead rows packed in np.packbits order."""
    meta = {}
    if code == "u8":
        slab = torch.randint(0, 256, (w, lp, d), device=dev, generator=gen).to(torch.uint8)
        meta["scale"] = 0.01 + 0.02 * torch.rand((w, d), device=dev, generator=gen)
        meta["offset"] = 3.0 * torch.randn((w, d), device=dev, generator=gen)
    else:
        slab = torch.randn((w, lp, d), device=dev, generator=gen).half()
    dead = torch.rand((w, lp), device=dev, generator=gen) < 0.05
    bits = torch.nn.functional.pad(dead.to(torch.uint8), (0, -lp % 8)).reshape(w, -1, 8)
    meta["dead"] = (bits * 2 ** torch.arange(7, -1, -1, device=dev)).sum(-1).to(torch.uint8)
    return slab, meta


def outputs() -> dict:
    from repro_torch.kernels import knn_scan

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for name, w, tq, lp, d, k, code in CASES:
        q = torch.randn((w, tq, d), device=dev, generator=gen)
        if code == "f32":
            slab, meta = torch.randn((w, lp, d), device=dev, generator=gen), {}
        else:
            slab, meta = _codes(gen, code, w, lp, d, dev)
        kd, ki = knn_scan.leaf_scan_cuda(q, slab, k=k, **meta)
        out[name] = (_digest(kd), _digest(ki))
        del q, slab, meta, kd, ki
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
    bad = [n for n in want if got.get(n) != want[n]]
    for n in want:
        print(f"{n}: {'differs' if n in bad else 'identical'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
