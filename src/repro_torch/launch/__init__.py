"""repro_torch.launch — command-line entry points (``python -m
repro_torch.launch.knn``).  Counterpart of ``repro.launch``'s kNN
launcher; its LM-stack launchers are ROADMAP Queue 1 items 19 and 20."""
