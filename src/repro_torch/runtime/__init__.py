"""Runtime seams of the port (the clock)."""
