"""Real bitstreams for the flagship, port of the JAX package's ``coding``:
``JointARCodec`` (one image at a time), the native rANS and wavefront
coders it drives (``backend``, built from ``csrc/rans/`` with g++ at first
use) and the factorized z tables (``cdf_tables``)."""

from neural_image_compression_tpu_torch.coding.backend import (
    RansDecoder, encode_gaussian, encode_indexed,
)
from neural_image_compression_tpu_torch.coding.cdf_tables import (
    factorized_tables, quantize_pmf_rows,
)
from neural_image_compression_tpu_torch.coding.codec import (
    JointARCodec, bitstream_bpp, stream_size,
)

__all__ = ["RansDecoder", "encode_gaussian", "encode_indexed", "factorized_tables",
           "quantize_pmf_rows", "JointARCodec", "bitstream_bpp", "stream_size"]
