"""PyTorch + CUDA port of the buffer k-d tree (``repro`` is the JAX
reference it is held against).

    from repro_torch.api import KNNIndex
    index = KNNIndex.build(points)            # runs on cuda:0
    dists, idx = index.query(queries, k=10)

Pass ``devices=(torch.device("cpu"),)`` in the ``IndexSpec`` to run on the
CPU.  The package imports torch and numpy, never jax or ``repro``.
"""
