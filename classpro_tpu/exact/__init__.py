"""Bit-exact scalar oracle engine.

A faithful re-implementation of the reference per-read classification
pipeline (wall.c / class_rel.c / class_unrel.c) with identical float64
semantics.  This is the correctness oracle the batched device engine is
tested against, and the byte-identity path for `.class` parity with the
reference binary.
"""

from classpro_tpu.exact.pipeline import classify_read, classify_file  # noqa: F401
