"""Leaf-scan kernel (CUDA, ``csrc/leaf_scan.cu``), its plain-torch
reference and the dispatch between them."""
