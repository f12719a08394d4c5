"""Synthetic, seeded data pipelines of the port (numpy only)."""
