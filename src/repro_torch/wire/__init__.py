"""Wire codecs of the gossip payload (counterpart of ``repro/wire``)."""
from repro_torch.wire.codec import (CODECS, Codec, DtypeCodec,  # noqa: F401
                                    F32Codec, Int4Codec, Int8Codec, TopKCodec,
                                    dtype_codec, get_codec)
