"""Arithmetic and sampling kernels (the reference's L1 layer, batched)."""
