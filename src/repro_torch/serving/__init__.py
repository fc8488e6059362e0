"""repro_torch.serving — online serving on the port.

``KNNServer`` (``knn_server.py``) fronts a ``streaming`` or ``dynamic``
``KNNIndex``: admission queue, rung-shaped micro-batches, SLA-aware batch
close, typed errors.  ``ServeEngine`` (``engine.py``) decodes requests with
continuous batching over a ``LanguageModel``; ``KNNLM`` (``knnlm.py``)
interpolates its next-token distribution with a buffer-k-d-tree datastore.
"""

from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.knn_server import (
    DEFAULT_DEADLINE_MS,
    Cancelled,
    DeadlineExceeded,
    KNNServer,
    Overloaded,
    SchedulerDied,
    ServingError,
    Ticket,
)
from repro_torch.serving.knnlm import KNNLM

__all__ = [
    "ServeEngine",
    "Request",
    "KNNLM",
    "KNNServer",
    "Ticket",
    "ServingError",
    "Overloaded",
    "DeadlineExceeded",
    "SchedulerDied",
    "Cancelled",
    "DEFAULT_DEADLINE_MS",
]
