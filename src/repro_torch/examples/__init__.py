"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the front door: build, query, verify, out-of-core),
``outlier_detection`` (density outliers through the radius op),
``train_lm`` (training with checkpoint / restart) and ``knnlm_serve``
(a briefly trained LM served through a kNN-LM datastore)."""
