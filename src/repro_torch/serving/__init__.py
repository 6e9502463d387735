from repro_torch.serving.engine import (Request, ServingEngine,  # noqa: F401
                                        generate, make_decode_fn,
                                        make_prefill_fn, mask_oov,
                                        sample_token)
