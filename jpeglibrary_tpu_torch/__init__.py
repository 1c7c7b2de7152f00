"""jpeglibrary_tpu_torch — the serving decode of jpeglibrary_tpu in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The host layers (container parsing, the native entropy scanner, frame
geometry) are the JAX package's own, imported as they are; they load no
JAX. This package holds the device side: the v2-wire densify, the K1
dequantize + IDCT kernel (``csrc/dequant_idct.cu``), upsampling and
colour conversion, and the streaming pipeline. Every entry point takes
an explicit ``device``; CPU tensors run the kernels' plain PyTorch
versions, CUDA tensors the kernels.
"""

from .models.decoder import device_inputs, to_rgb8_device
from .ops.pipeline import transform_mcu2
from .parallel.batch import decode_stream_rgb

__all__ = ["decode_stream_rgb", "device_inputs", "to_rgb8_device", "transform_mcu2"]
