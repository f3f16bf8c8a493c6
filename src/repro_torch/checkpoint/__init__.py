"""Checkpoint generations on disk (atomic, checksummed)."""
