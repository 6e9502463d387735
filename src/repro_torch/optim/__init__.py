from repro_torch.optim.optim import (Optimizer, adamw,  # noqa: F401
                                     constant_schedule, cosine_schedule,
                                     make_optimizer, sgd, warmup_cosine)
