"""Arch configs of the port, one module per ported arch; each registers
itself with ``repro_torch.config.registry`` when imported."""
