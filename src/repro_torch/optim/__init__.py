from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     global_norm, init_opt, warmup_cosine)

__all__ = ["AdamWConfig", "OptState", "apply_updates", "global_norm",
           "init_opt", "warmup_cosine"]
