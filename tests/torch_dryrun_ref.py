"""The reference side of tests/test_torch_dryrun.py and
tests/test_torch_roofline.py, run in a subprocess with four forced host
devices (the dry run's meshes need several): prints one JSON object with

  * ``collectives``: ``repro.roofline.collective_bytes`` of the optimized
    HLO of psum / all_gather / psum_scatter over ``model`` under
    ``shard_map`` on a 2 x 2 mesh (each followed by an add: the
    reference's parser skips a collective that is the HLO's ROOT);
  * ``argument_bytes``: ``memory_analysis().argument_size_in_bytes`` of
    ``repro.launch.dryrun``'s train / prefill / decode compiles of four
    smoke configs on that mesh (``CELLS``);
  * ``run_cell_keys``: the keys of ``repro.launch.dryrun.run_cell``'s
    result for an LM cell and the kNN cell, on the 2 x 2 mesh with smoke
    sizes (``make_production_mesh``, ``get_config``, ``SHAPES`` and the
    kNN sizes replaced);
  * ``exps``: ``repro.launch.perf.EXPS``'s names.

    python tests/torch_dryrun_ref.py
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import json  # noqa: E402

ARCHS = ("qwen2_7b", "olmoe_1b_7b", "recurrentgemma_9b", "mamba2_370m")
POLICY = {"param_mode": "mp_zero1", "grad_accum": 2, "param_dtype": "bfloat16"}
# (kind, seq_len, global batch) of each smoke cell, as tests/test_dryrun_small.py
CELLS = (("train", 64, 8), ("prefill", 64, 4), ("decode", 64, 4))
ROW = 8     # rows of the collectives' operand (2 per slot)


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.compat import make_mesh, shard_map
    from repro.configs.base import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch import dryrun as dr
    from repro.roofline.analysis import collective_bytes

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"collectives": {}, "argument_bytes": {}}
    x = jax.ShapeDtypeStruct((ROW, 16), jnp.float32)
    bodies = {
        "all_sum": lambda a: jax.lax.psum(a, "model"),
        "all_gather": lambda a: jax.lax.all_gather(a, "model", axis=0, tiled=True),
        "reduce_scatter": lambda a: jax.lax.psum_scatter(a, "model", scatter_dimension=0,
                                                         tiled=True),
    }
    for name, body in bodies.items():
        f = shard_map(lambda a, body=body: body(a) + 1.0, mesh=mesh,
                      in_specs=(P(("data", "model"), None),),
                      out_specs=P(("data", "model"), None))
        with mesh:
            comp = jax.jit(f).lower(x).compile()
        out["collectives"][name] = collective_bytes(comp.as_text()).as_dict()

    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for kind, s, b in CELLS:
            if kind == "decode" and not cfg.supports_decode():
                continue
            sh = ShapeSpec(kind[0], kind, s, b)
            if kind == "train":
                comp = dr.compile_train(cfg, sh, mesh, policy=POLICY)
            elif kind == "prefill":
                comp = dr.compile_prefill(cfg, sh, mesh)
            else:
                comp = dr.compile_decode(cfg, sh, mesh)
            out["argument_bytes"][f"{arch}/{kind}"] = int(
                comp.memory_analysis().argument_size_in_bytes)

    # run_cell's keys at smoke sizes on the 2 x 2 mesh
    dr.make_production_mesh = lambda multi_pod=False: mesh
    dr.get_config = lambda arch: get_config(arch, smoke=True)
    dr.SHAPES = {"t": ShapeSpec("t", "train", 64, 8)}
    dr.TRAIN_POLICY = dict(dr.TRAIN_POLICY, qwen2_7b=POLICY)
    dr.KNN_N, dr.KNN_M = 1 << 12, 1 << 8
    lm = dr.run_cell("qwen2_7b", "t", False)
    knn = dr.run_cell(dr.KNN_ARCH, "knn_1M", False)
    out["run_cell_keys"] = {"lm": sorted(lm), "lm_memory": sorted(lm["memory"]),
                            "knn": sorted(knn), "knn_memory": sorted(knn["memory"])}
    from repro.launch import perf

    out["exps"] = sorted(perf.EXPS)
    print("REF_JSON " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
