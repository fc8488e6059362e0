"""Roofline analysis on the card: collective counts, the three-term model,
and counted step costs (counterpart of ``repro.roofline``)."""

from repro_torch.roofline.analysis import (
    HW,
    collective_bytes,
    roofline_terms,
    dominant_term,
)
from repro_torch.roofline.model_flops import param_counts, model_flops

__all__ = [
    "HW",
    "collective_bytes",
    "roofline_terms",
    "dominant_term",
    "param_counts",
    "model_flops",
]
