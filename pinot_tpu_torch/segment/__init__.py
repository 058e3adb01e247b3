"""Immutable columnar segments (trimmed copies of pinot_tpu.segment) and
the converter that builds them from plain arrays."""
