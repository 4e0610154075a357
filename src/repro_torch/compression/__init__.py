from repro_torch.compression.codecs import (
    CODECS,
    CompressionResult,
    compress_delta,
    compression_ratio,
    wire_bytes,
)

__all__ = ["CODECS", "CompressionResult", "compress_delta",
           "compression_ratio", "wire_bytes"]
