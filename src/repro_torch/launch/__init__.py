"""repro_torch.launch — command-line entry points: ``python -m
repro_torch.launch.knn`` (the kNN service), ``python -m
repro_torch.launch.serve`` (LM decode, or ``--knn`` traffic through the
``KNNServer``) and ``python -m repro_torch.launch.train`` (training with
checkpoint / restart).  Counterpart of ``repro.launch``; ``mesh`` has
``data_axes_of`` / ``tp_of``; the dry-run and perf launchers and the pod
meshes (``mesh.make_production_mesh``) wait for ROADMAP Queue 1 item 19."""
