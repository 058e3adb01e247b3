"""Schema, request and response models (trimmed copies of pinot_tpu.common)."""
