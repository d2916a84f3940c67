"""Batched device engine (JAX/XLA).

See ARCHITECTURE.md for the stage map. All kernels operate on padded
`(B, L)` batches in float64 on the decision path and are tested for
concordance against the exact oracle engine.
"""
