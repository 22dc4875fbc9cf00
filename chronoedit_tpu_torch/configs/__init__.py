from chronoedit_tpu_torch.configs.presets import (  # noqa: F401
    EXPERIMENTS, chronoedit_14b, chronoedit_14b_distilled, chronoedit_tiny, get_experiment)
