"""Wire codecs of the gossip payload (counterpart of ``repro/wire``)."""
from repro_torch.wire.codec import (CODECS, Codec, F32Codec,  # noqa: F401
                                    Int8Codec, TopKCodec, get_codec)
