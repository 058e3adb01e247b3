"""Seeded data generators."""
