"""repro_torch.launch — command-line entry points: ``python -m
repro_torch.launch.knn`` (the kNN service), ``python -m
repro_torch.launch.serve`` (LM decode, or ``--knn`` traffic through the
``KNNServer``) and ``python -m repro_torch.launch.train`` (training with
checkpoint / restart).  Counterpart of ``repro.launch``; its dry-run and
perf launchers wait for ROADMAP Queue 1 item 19."""
