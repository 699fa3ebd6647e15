"""Conformance command-line checks of the port (``python -m
repro_torch.testing.<name>``)."""
