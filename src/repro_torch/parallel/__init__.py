"""Logical-axis sharding rules (the single-device half)."""
