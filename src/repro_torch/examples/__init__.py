"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``train_lm`` (training with checkpoint / restart) and ``knnlm_serve``
(a briefly trained LM served through a kNN-LM datastore)."""
