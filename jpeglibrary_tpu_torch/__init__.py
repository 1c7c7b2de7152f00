"""jpeglibrary_tpu_torch — jpeglibrary_tpu in PyTorch, on one device or
over a mesh of ``torch.distributed`` ranks, with hand-written CUDA kernels
for NVIDIA Hopper.

The package imports nothing of ``jpeglibrary_tpu``. Its host layers
(container parsing, the native entropy scanner and emitter, frame
geometry, the host decoders and encoders, the optimizer, transcoder and
region decode) are its own copy of the JAX package's JAX-free host code,
under ``host/``. The rest is the device side: for the decode, the densify
of every wire (v2 split-stream, v1 MCU, v1 plane-order, dense planes),
the K1 dequantize + IDCT kernel (``csrc/dequant_idct.cu``, full size or
reduced for thumbnails, one quant table per image of a batch), duplicate
or fancy upsampling, colour conversion or the 16-bit writer, and the
batched, streaming and stripe pipelines; for the encode, the K2 pad + box
subsample + FDCT + quantize kernel (``csrc/fdct_quant.cu``) behind the RGB,
gray and CMYK/YCCK encoders. Every device entry point takes a
``device`` (or a mesh, whose ranks each run on their own device) and runs
on the card when given none: where the JAX package defaults to its
default device, or, for the encoders, to the host (``xp=np``), the port
takes ``ops._device.default_device()``, which raises without a card
rather than fall back to the CPU. The encoders take ``xp`` too: ``np``
for the host encoder, ``torch`` or a ``torch.device`` for the device
encode. CPU tensors run the kernels' plain PyTorch versions, CUDA tensors
the kernels. The host decode's ``xp`` takes a torch device where the JAX
package takes ``jnp`` (``jtt.decode(data, xp=torch)`` on the card,
``xp=torch.device(...)`` on any): its ``planes`` then come from the K4
butterfly IDCT kernel (``csrc/butterfly_idct.cu``), bit-equal to the
host's. ``parallel`` holds the mesh layer, ``graft_entry`` the
repository's entry points and ``cli`` the five command-line tools.

``__all__`` holds the JAX package's public names, each the port's device
form where it has one (``encode_rgb``, ``encode_gray``, ``encode_cmyk``,
``encode_batch_rgb``, ``decode_batch_rgb``, ``decode_stream_rgb``) and
the host copy's otherwise, and the port's own device entry points. The
JAX package's ``enable_compile_cache`` (XLA's persistent compile cache)
has no counterpart: the kernels are built once per source hash into
``_build/``, under a file lock, and reused from there.
"""

from .host.models.decoder import DecodeResult, ImageInfo, JpegDecoder, decode, decode_rgb8
from .host.models.encoder import (
    JpegEncodeError,
    JpegEncoder,
    encode_rgb_stream,
    encode_rgb_stripes,
)
from .host.models.hierarchical import encode_hierarchical
from .host.models.huffman_baseline import JpegDecodeError
from .host.models.arithmetic_lossless import encode_lossless_arithmetic
from .host.models.lossless import encode_lossless
from .host.models.optimizer import JpegOptimizer, optimize
from .host.models.region import decode_region
from .host.models.transcode import autorotate, crop, transcode, transform
from .models.decoder import device_inputs, to_rgb8_device
from .models.encoder import encode, encode_cmyk, encode_gray, encode_rgb
from .models.streaming import decode_rgb_streaming, decode_rgb_stripes
from .ops.pipeline import (
    transform_delta,
    transform_dense,
    transform_mcu,
    transform_mcu2,
    transform_packed,
    transform_to_rgb8,
    transform_to_u16,
)
from .parallel.batch import decode_batch_rgb, decode_stream_rgb, encode_batch_rgb

__all__ = [
    # The JAX package's names (all but enable_compile_cache).
    "JpegDecoder", "DecodeResult", "ImageInfo", "decode", "decode_rgb8", "decode_batch_rgb",
    "decode_region", "decode_stream_rgb", "JpegEncoder", "encode_batch_rgb", "encode_rgb",
    "encode_rgb_stream", "encode_rgb_stripes", "encode_gray", "encode_cmyk", "encode_lossless",
    "encode_lossless_arithmetic", "encode_hierarchical", "JpegOptimizer", "optimize",
    "autorotate", "crop", "transcode", "transform",
    # The port's own.
    "JpegDecodeError", "JpegEncodeError", "decode_rgb_stripes", "decode_rgb_streaming",
    "device_inputs", "encode", "to_rgb8_device", "transform_delta", "transform_dense",
    "transform_mcu", "transform_mcu2", "transform_packed", "transform_to_rgb8",
    "transform_to_u16",
]
