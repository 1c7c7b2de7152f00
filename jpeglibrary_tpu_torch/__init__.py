"""jpeglibrary_tpu_torch — the serving decode and the device encode of
jpeglibrary_tpu in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper.

The package imports nothing of ``jpeglibrary_tpu``. Its host layers
(container parsing, the native entropy scanner and emitter, frame
geometry, the host decoder and encoder, the encoder's tables) are its
own copy of the JAX package's JAX-free host code, under ``host/``. The
rest is the device side: for the decode, the densify of every wire (v2
split-stream, v1 MCU, v1 plane-order, dense planes), the K1 dequantize +
IDCT kernel (``csrc/dequant_idct.cu``, full size or reduced for
thumbnails, one quant table per image of a batch), upsampling and colour
conversion, and the batched and streaming pipelines; for the encode,
padding, box subsampling and the K2 FDCT + quantize kernel
(``csrc/fdct_quant.cu``). Every entry point takes an explicit
``device``; CPU tensors run the kernels' plain PyTorch versions, CUDA
tensors the kernels. ``decode``, ``JpegDecoder``, ``DecodeResult``,
``JpegEncoder`` and the two error classes are the host layers', under
the JAX package's names.
"""

from .host.models.decoder import DecodeResult, JpegDecoder, decode
from .host.models.encoder import JpegEncodeError, JpegEncoder
from .host.models.huffman_baseline import JpegDecodeError
from .models.decoder import device_inputs, to_rgb8_device
from .models.encoder import encode, encode_gray, encode_rgb
from .ops.pipeline import (
    transform_delta,
    transform_dense,
    transform_mcu,
    transform_mcu2,
    transform_to_rgb8,
)
from .parallel.batch import decode_batch_rgb, decode_stream_rgb

__all__ = [
    "DecodeResult", "JpegDecodeError", "JpegDecoder", "JpegEncodeError", "JpegEncoder",
    "decode", "decode_batch_rgb", "decode_stream_rgb", "device_inputs", "encode",
    "encode_gray", "encode_rgb", "to_rgb8_device", "transform_delta", "transform_dense",
    "transform_mcu", "transform_mcu2", "transform_to_rgb8",
]
