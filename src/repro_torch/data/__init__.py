from repro_torch.data.dirichlet import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import (SyntheticClassification,  # noqa: F401
                                        SyntheticLM, make_agent_batches,
                                        make_agent_lm_batches)
