"""Command-line entry points, each runnable as ``python -m
chronoedit_tpu_torch.scripts.<name>``: ``run_inference`` (one edit),
``serve`` (the batching HTTP server), ``train`` (LoRA or full-parameter
training), ``convert_weights`` (trainer checkpoints <-> diffusers) and
``check_environment``."""
