#!/usr/bin/env python3
"""Time the narrow leaf scan's list placements against each other on one GPU.

    python3 scripts/leaf_scan_lists.py            # main-path shape, k = 16, 18, 74
    python3 scripts/leaf_scan_lists.py --reps 20

At the main-path shape (W=4096 units, TQ=128, L_pad=4096, d=10) and for
fp32 rows, uint8 codes and float16 codes: at k = 18 (a quantized k = 10
query's list) and k = 74 (the refining pass) the heap in shared memory,
which ``choose_variant`` picks, against the same heap in the output rows
(which it takes only where shared memory is too small); at k = 16 the
register list, also launched with the shared memory of a k = 74 heap (so
as few blocks per SM), which shows what the heap's shared memory costs the
filter.  Every launch must give the first one's outputs bit for bit (the
script exits non-zero if one does not).  The first version of this script
in the repository's history timed the designs the heap was chosen over.
Each is timed with CUDA events twice, in the order listed and then in
reverse, so drift of the card falls on all alike.  Prints one line per
launch and a JSON line; needs one CUDA device.
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def designs(knn_scan, k, code):
    """(name, Variant) of every launch timed at list length k, the first
    being ``choose_variant``'s, which the others are held against."""
    base = knn_scan.choose_variant(10, k, 128, 4096, code)
    if base.list_at == "reg":
        big = knn_scan.choose_variant(10, 74, 128, 4096, code).smem_bytes
        return [(f"reg{base.kmax}", base),
                (f"reg{base.kmax}_smem{big}", dataclasses.replace(base, smem_bytes=big))]
    assert base.list_at == "smem"
    no_list = base.smem_bytes - 8 * k * base.qpt * base.threads
    return [("heap_smem", base),
            ("heap_out", dataclasses.replace(base, list_at="out", smem_bytes=no_list))]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("leaf_scan_lists: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.kernels import knn_scan

    dev = torch.device("cuda", 0)
    smi = chip_smoke.phase_env(torch)
    chip_smoke.phase_build()
    s = chip_smoke.MAIN_SHAPE
    w, tq, lp, d = s["w"], s["tq"], s["l_pad"], s["d"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q = torch.randn((w, tq, d), device=dev, generator=gen)
    x = torch.randn((w, lp, d), device=dev, generator=gen)
    qpad = q.reshape(w * tq, d).contiguous()
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    nu = torch.tensor(w, dtype=torch.int32, device=dev)
    results, failed = [], []
    for code in ("f32", "u8", "f16"):
        if code == "f32":
            slab, meta = x, {}
        else:
            slab, meta, _ = chip_smoke.code_slab(torch, dev, gen, code, w, lp, d, x=x)
        for k in (16, chip_smoke.CODE_K, 74):
            runs = designs(knn_scan, k, code)

            def call(v):
                return knn_scan._launch(v, qpad, slab, ul, uq, nu, k, meta.get("scale"),
                                        meta.get("offset"), meta.get("dead"))

            want = call(runs[0][1])
            same = {runs[0][0]: True}
            for name, v in runs[1:]:
                got = call(v)
                torch.cuda.synchronize()
                same[name] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
                if not same[name]:
                    bad = (got[0] != want[0]) | (got[1] != want[1])
                    print(f"[lists] {code} k={k} {name} ({v.name}) differs from "
                          f"{runs[0][0]} at {int(bad.sum())} entries, first at "
                          f"{bad.nonzero()[0].tolist()}", flush=True)
                    failed.append(f"{code}_k{k}_{name}")
                del got
            del want
            ms = {name: [] for name, _ in runs}
            for order in (runs, runs[::-1]):
                for name, v in order:
                    ms[name].append(chip_smoke.cuda_ms(torch, lambda: call(v), reps=args.reps))
            for name, v in runs:
                mean = sum(ms[name]) / len(ms[name])
                chip_smoke.log("lists", code=code, k=k, design=name, variant=v.name,
                               ms=f"{mean:.4f}", runs=",".join(f"{t:.4f}" for t in ms[name]),
                               smem_bytes=v.smem_bytes, identical=same[name])
                results.append(dict(code=code, k=k, design=name, variant=v.name, ms=mean,
                                    runs=ms[name]))
        del slab, meta
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "lists": results, "differ": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
