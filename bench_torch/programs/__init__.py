"""Programs other than the serving engine. A configuration that names
``"program": "<name>"`` has its whole run handed to ``<name>.py``'s
``run_cell``, which takes :func:`bench_torch.harness.run_cell`'s arguments
and returns the same result."""
