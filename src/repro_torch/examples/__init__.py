"""End-to-end examples, run with ``python -m repro_torch.examples.<name>``."""
