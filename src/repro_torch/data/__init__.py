from repro_torch.data.dirichlet import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import (SyntheticLM,  # noqa: F401
                                        make_agent_lm_batches)
