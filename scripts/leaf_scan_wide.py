#!/usr/bin/env python3
"""Check and time the wide leaf scan (rows of d > 16 features) on one GPU.

    python3 scripts/leaf_scan_wide.py --check     # every placement against the plain version
    python3 scripts/leaf_scan_wide.py             # --check, then the timed candidates
    python3 scripts/leaf_scan_wide.py --reps 5 --shapes 30:16,130:10

``--check`` runs the wide kernel on small work plans against its plain
version (distances within 1e-5, indices permutation-aware; on integer
lattices bit for bit): whole rows and chunks of features, register lists,
heaps in shared memory and in the output rows, fp32, uint8 and float16
slabs with dead rows, pad rows, tiles of fewer than 128 query slots; then every placement on rows whose columns
past 16 are zero against the narrow kernel's k = 16 register list, bit for
bit.  It prints the registers and spills of every wide instance.

The timed part runs at W=4096 units, TQ=128, L_pad=4096 for each d:k of
``--shapes`` (fp32): ``choose_variant``'s launch beside the candidates
it was chosen over (whole rows of a wide d staged as chunks of 64
features; a heap in the output rows), each held
to the first launch's outputs bit for bit, timed with CUDA events in the
order listed and again in reverse.  Prints one line per launch and a JSON
line; needs one CUDA device.
"""

import argparse
import dataclasses
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check(torch, dev, knn_scan, chip_smoke) -> int:
    from repro_torch.kernels.ref import PAD_COORD, leaf_scan_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    cases = 0

    def variants(d, k, tq, lp, code):
        v = knn_scan.choose_variant(d, k, tq, lp, code)
        out = [v]
        slots = v.qpt * v.threads
        no_list = v.smem_bytes - (8 * k * slots if v.list_at == "smem" else 0)
        if v.width == 0 and -(-d // 4) * 4 > 64:   # the rows as chunks of 64 features
            base = knn_scan._wide_base_bytes(code, d, 64, slots)
            out.append(dataclasses.replace(
                v, width=64, smem_bytes=base + (v.smem_bytes - no_list)))
        if v.list_at == "smem":
            out.append(dataclasses.replace(v, list_at="out", smem_bytes=no_list))
        return [u for u in out if u.smem_bytes <= knn_scan.SMEM_LIMIT]

    def run(v, qpad, slab, ul, uq, nu, k, meta):
        return knn_scan._launch(v, qpad, slab, ul, uq, nu, k, meta.get("scale"),
                                meta.get("offset"), meta.get("dead"))

    for code in ("f32", "u8", "f16"):
        for (w, tq, lp, d, k, pad_rows, lattice) in (
                (2, 128, 300, 17, 10, 0, False), (2, 128, 300, 30, 16, 0, False),
                (2, 128, 300, 30, 74, 7, False), (2, 100, 333, 31, 18, 0, False),
                (3, 37, 200, 130, 10, 0, False), (2, 128, 300, 130, 74, 0, False),
                (1, 128, 320, 300, 300, 37, False), (1, 64, 100, 520, 16, 0, False),
                (2, 128, 4096, 30, 16, 0, True), (2, 128, 1000, 30, 74, 0, True),
                (1, 128, 96, 30, 96, 0, False)):
            q = torch.randn((w, tq, d), device=dev, generator=gen)
            if lattice:
                q = torch.randint(-2, 3, (w, tq, d), device=dev, generator=gen).float()
            qpad = q.reshape(w * tq, d).contiguous()
            ul = torch.arange(w, dtype=torch.int32, device=dev)
            uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
            nu = torch.tensor(w, dtype=torch.int32, device=dev)
            if code == "f32":
                x = (torch.randint(-2, 3, (w, lp, d), device=dev, generator=gen).float()
                     if lattice else torch.randn((w, lp, d), device=dev, generator=gen))
                if pad_rows:
                    x[:, lp - pad_rows:] = PAD_COORD
                slab, meta, xs = x, {}, x
            else:
                slab, meta, _ = chip_smoke.code_slab(torch, dev, gen, code, w, lp, d,
                                                     lattice=lattice, dead_frac=0.2)
                xs = knn_scan.dequantize(slab, meta.get("scale"), meta.get("offset"),
                                         meta["dead"])
            rd, ri = leaf_scan_ref(q, xs, k=k)
            first = None
            for v in variants(d, k, tq, lp, code):
                kd, ki = run(v, qpad, slab, ul, uq, nu, k, meta)
                torch.cuda.synchronize()
                err = chip_smoke.check_scan(torch, q, xs, kd, ki, rd, ri, exact_ties=lattice)
                if first is None:
                    first = (kd, ki)
                else:
                    assert torch.equal(kd, first[0]) and torch.equal(ki, first[1]), v.name
                print(f"[check] code={code} shape={(w, tq, lp, d)} k={k} variant={v.name} "
                      f"qpt={v.qpt} max_abs_err={err:.3e} ok=True", flush=True)
                cases += 1

    # every wide placement on rows with zero columns past 16 equals the
    # narrow k = 16 register list's first 16 entries
    q = torch.randn((2, 128, 40), device=dev, generator=gen)
    x = torch.randn((2, 1000, 40), device=dev, generator=gen)
    q[..., 16:] = 0.0
    x[..., 16:] = 0.0
    base = knn_scan.leaf_scan_cuda(q[..., :16].contiguous(), x[..., :16].contiguous(), k=16)
    qpad = q.reshape(256, 40).contiguous()
    ul = torch.arange(2, dtype=torch.int32, device=dev)
    uq = torch.arange(256, dtype=torch.int32, device=dev).reshape(2, 128)
    nu = torch.tensor(2, dtype=torch.int32, device=dev)
    for d in (17, 30, 40):
        qd = qpad[:, :d].contiguous()
        xd = x[..., :d].contiguous()
        for k in (16, 17, 300):
            for v in variants(d, k, 128, 1000, "f32"):
                kd, ki = run(v, qd, xd, ul, uq, nu, k, {})
                torch.cuda.synchronize()
                assert torch.equal(kd[..., :16], base[0]) and torch.equal(
                    ki[..., :16], base[1]), (d, k, v.name)
                print(f"[check] agree d={d} k={k} variant={v.name} qpt={v.qpt} "
                      "bit_for_bit=True", flush=True)
                cases += 1
    return cases


def timed(torch, dev, knn_scan, chip_smoke, d, k, reps) -> list:
    s = chip_smoke.MAIN_SHAPE
    w, tq, lp = s["w"], s["tq"], s["l_pad"]
    gen = torch.Generator(device=dev).manual_seed(d * 1000 + k)
    q = torch.randn((w, tq, d), device=dev, generator=gen)
    x = torch.randn((w, lp, d), device=dev, generator=gen)
    qpad = q.reshape(w * tq, d)
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    nu = torch.tensor(w, dtype=torch.int32, device=dev)
    v = knn_scan.choose_variant(d, k, tq, lp)
    slots = v.qpt * v.threads
    lst = 8 * k * slots if v.list_at == "smem" else 0
    cands = [("chosen", v)]
    if v.width == 0 and d > 64:
        cands.append(("chunk64", dataclasses.replace(
            v, width=64, smem_bytes=knn_scan._wide_base_bytes("f32", d, 64, slots) + lst)))
    if v.list_at == "smem":
        cands.append(("heap_out", dataclasses.replace(v, list_at="out",
                                                      smem_bytes=v.smem_bytes - lst)))
    cands = [(n, c) for n, c in cands if c.smem_bytes <= knn_scan.SMEM_LIMIT]
    outs = {}
    for name, c in cands:
        outs[name] = knn_scan._launch(c, qpad, x, ul, uq, nu, k, None, None, None)
    torch.cuda.synchronize()
    for name, _ in cands[1:]:
        assert torch.equal(outs[name][0], outs["chosen"][0]), name
        assert torch.equal(outs[name][1], outs["chosen"][1]), name
    del outs
    times = {n: [] for n, _ in cands}
    for order in (cands, cands[::-1]):
        for name, c in order:
            times[name].append(chip_smoke.cuda_ms(torch, lambda: knn_scan._launch(
                c, qpad, x, ul, uq, nu, k, None, None, None), reps=reps))
    bound_ms, bound_by = chip_smoke.scan_bound(w, tq, lp, d, k)
    rows = []
    for name, c in cands:
        ms = sum(times[name]) / len(times[name])
        print(f"[time] d={d} k={k} design={name} variant={c.name} qpt={c.qpt} "
              f"threads={c.threads} smem={c.smem_bytes} ms={ms:.4f} "
              f"runs={','.join(f'{t:.4f}' for t in times[name])} bound_ms={bound_ms:.4f} "
              f"bound_by={bound_by}", flush=True)
        rows.append(dict(d=d, k=k, design=name, variant=c.name, ms=ms,
                         runs=times[name], bound_ms=bound_ms))
    del q, x, qpad
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true", help="only the correctness checks")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default="30:16,30:74,130:10,130:74",
                    help="comma-separated d:k of the timed launches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("leaf_scan_wide: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    import repro_torch.api  # noqa: F401  (import order: api before kernels.ops)
    from repro_torch.kernels import build, knn_scan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    lib = build.load("leaf_scan", ("LEAF_SCAN_PART=0",))
    print(f"[build] wide library {lib.build_s:.1f} s", flush=True)
    name = None
    for line in lib.ptxas_log.splitlines():
        m = re.search(r"leaf_scan_wide_kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            name = f"wide<kmax={m.group(1)},list={m.group(2)}>"
        elif name and ("registers" in line or "spill" in line):
            print(f"[build] {name}: {line.strip()}", flush=True)
    n = check(torch, dev, knn_scan, chip_smoke)
    print(f"[check] cases={n} ok=True", flush=True)
    rows = []
    if not args.check:
        for dk in args.shapes.split(","):
            d, k = (int(v) for v in dk.split(":"))
            rows += timed(torch, dev, knn_scan, chip_smoke, d, k, args.reps)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "timed": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
