"""jpeg_tpu_torch: the PyTorch + CUDA port of jpeg_tpu for NVIDIA Hopper.

A second package beside ``jpeg_tpu`` (the JAX reference, which it never
imports). It decodes every stream the JAX package decodes (baseline,
extended or progressive DCT at 8 and 12 bits, Huffman or arithmetic, gray,
YCbCr, RGB-direct, CMYK, YCCK, and lossless SOF3), encodes all of them, and
each of the JAX package's Pallas kernels has a Hopper kernel.

The hybrid corpus decode:

- host parse (``io/container.py``) and host C++ entropy decode
  (``runtime``: the port's copy of the JAX package's C++ library, bound
  with ctypes);
- K3, the lane-per-restart-segment Huffman kernel
  (``entropy/device_huffman.py``, ``csrc/huffman_lanes.cu``), under every
  device-entropy tier name of the JAX package: ``entropy/device_window.py``
  (v5), ``device_decode.py`` (v1) and ``device_decode2.py`` (v2, v3);
- K1, the fused dequant + IDCT + upsample + colour kernel
  (``ops/fused_plane.py``, ``csrc/fused_plane.cu``);
- the corpus decoders (``parallel/pipeline.py``: ``BatchedCorpusDecoder``
  and the thread-pooled ``CorpusDecoder``), and ``decode_batch``, the compat
  pipeline over a batch (``parallel/batch.py``).

Scale-out (``parallel/``): a (data, seg) device grid (``mesh.py``), the
sharded batch decoders and encoder (``batch.py``), the corpus decoder's
``mesh=``, multi-process coordination on ``torch.distributed``
(``distributed.py``, ``corpus --distributed``) and ``dryrun.py``.

The encoder (``models/encoder.py``):

- ``encode_rgb`` (8 or 12 bits, Huffman or arithmetic),
  ``encode_rgb_progressive`` and ``encode_cmyk``: forward transform in
  NumPy on the host, as in the JAX package, then the C++ entropy encoder
  (``runtime``) or the Python one; ``entropy/lossless.py::encode_lossless``
  writes SOF3;
- ``encode_rgb_device``: K2, the fused colour + box mean + forward DCT +
  quantise kernel (``ops/fused_encode.py``, ``csrc/fused_encode.cu``;
  batched by ``parallel/batch.py::encode_batch_device``). On a CUDA device
  the frame goes up as it stands and is transposed and edge-padded there,
  and K8 (``ops/huffman_encode.py``) packs the scan; on the CPU and with
  ``optimize`` the C++ entropy encoder packs it.

The other kernels:

- K4, the word-column Huffman kernel of the v4 in-kernel tier
  (``entropy/device_kernel.py``, ``csrc/huffman_words.cu``);
- K5 and K6, the bare dequant + IDCT roofline instrument
  (``ops/idct_only.py``, ``csrc/idct_only.cu``).

Every public entry point takes an explicit ``device`` (default ``"cuda"``).
On CPU tensors each kernel wrapper runs its plain PyTorch twin; on CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"

from jpeg_tpu_torch.io.container import DecodePlan, JPEGError, parse_jpeg  # noqa: F401
from jpeg_tpu_torch.models.decoder import decode_bytes, decode_file  # noqa: F401
from jpeg_tpu_torch.models.encoder import (  # noqa: F401
    encode_cmyk,
    encode_rgb,
    encode_rgb_device,
    encode_rgb_progressive,
)
from jpeg_tpu_torch.parallel.batch import decode_batch  # noqa: F401
from jpeg_tpu_torch.parallel.pipeline import (  # noqa: F401
    BatchedCorpusDecoder,
    CorpusDecoder,
    DecodeResult,
)
