"""repro_torch.serving — online kNN serving on the port.

``KNNServer`` (``knn_server.py``) fronts a ``streaming`` or ``dynamic``
``KNNIndex``: admission queue, rung-shaped micro-batches, SLA-aware batch
close, typed errors.  The reference's ``ServeEngine`` and ``KNNLM`` (the LM
stack) are ROADMAP Queue 1 item 20.
"""

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

__all__ = [
    "KNNServer",
    "Ticket",
    "ServingError",
    "Overloaded",
    "DeadlineExceeded",
    "SchedulerDied",
    "Cancelled",
    "DEFAULT_DEADLINE_MS",
]
