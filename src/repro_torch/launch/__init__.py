"""repro_torch.launch — command-line entry points: ``python -m
repro_torch.launch.knn`` (the kNN service), ``python -m
repro_torch.launch.serve`` (LM decode, or ``--knn`` traffic through the
``KNNServer``), ``python -m repro_torch.launch.train`` (training with
checkpoint / restart), ``python -m repro_torch.launch.dryrun`` (the
pod-scale dry run on meta slots) and ``python -m repro_torch.launch.perf``
(its named experiments).  Counterpart of ``repro.launch``; ``mesh`` has the
pod meshes (``make_production_mesh``), ``data_axes_of`` and ``tp_of``."""
