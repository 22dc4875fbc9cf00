"""Command-line entry points, each runnable as ``python -m
chronoedit_tpu_torch.scripts.<name>``: ``run_inference`` (one edit),
``serve`` (the batching HTTP server) and ``check_environment``."""
