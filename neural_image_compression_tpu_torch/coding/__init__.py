"""Real bitstreams for the model families, port of the JAX package's
``coding``: ``JointARCodec`` (single images, batches, interleaved and tiled
streams, portable streams), ``CheckerboardCodec``,
``MeanScaleHyperpriorCodec`` and ``ChannelCheckerboardCodec`` (the
parallel-decode families: single images, batches, lanes, portable
streams), ``FactorizedPriorCodec`` (single images, portable streams), the
native rANS, wavefront and portable coders they drive (``backend``, built
from ``csrc/rans/`` with g++ at first use), the factorized tables
(``cdf_tables``), the integer spec of portable streams and its cards
(``portable``: ``PortableCard``, ``ChannelCBCards``, ``FactorizedCard``) and
encode-time latent refinement (``refine``)."""

from neural_image_compression_tpu_torch.coding.backend import (
    RansDecoder, encode_gaussian, encode_indexed,
)
from neural_image_compression_tpu_torch.coding.cdf_tables import (
    factorized_tables, quantize_pmf_rows,
)
from neural_image_compression_tpu_torch.coding.codec import (
    ChannelCheckerboardCodec, CheckerboardCodec, FactorizedPriorCodec, JointARCodec,
    MeanScaleHyperpriorCodec, bitstream_bpp, stream_size,
)
from neural_image_compression_tpu_torch.coding.portable import (
    ChannelCBCards, FactorizedCard, PortableCard, build_channel_cb_cards,
)
from neural_image_compression_tpu_torch.coding.refine import make_refiner, refine_latents

__all__ = ["RansDecoder", "encode_gaussian", "encode_indexed", "factorized_tables",
           "quantize_pmf_rows", "JointARCodec", "CheckerboardCodec",
           "MeanScaleHyperpriorCodec", "ChannelCheckerboardCodec", "FactorizedPriorCodec",
           "bitstream_bpp", "stream_size", "PortableCard", "ChannelCBCards", "FactorizedCard",
           "build_channel_cb_cards", "make_refiner", "refine_latents"]
