"""axctdprocessor_tpu_torch — the PyTorch/CUDA port of axctdprocessor_tpu.

The AXCTD decode paths of the JAX package's TPU engine in PyTorch, for one
NVIDIA H100 (the mesh paths: several): the fused single-drop decode (``models.engine.decode_wav`` /
``decode_waveform``, and the ``cli``), the segmented and prestaged decode
(``models.segmented``), the push-style stream decoder
(``models.stream_device``), the batch path (``parallel.batch``), the
two-stage pipeline (``parallel.pipeline``), the archive runner
(``parallel.archive``) and the multi-device paths over a mesh of
``torch.device``s (``parallel.mesh``, ``parallel.timeshard``, the ``mesh=`` of
the batch and archive paths, ``parallel.multihost``); and the host byte-parity engine with its push decoder
(``models.parity_engine``, ``models.stream``), the host reference, which
touch no device and are asked for by name (``decode_wav_parity``,
``AXCTDStreamDecoder``, the CLI's ``--engine parity``).  It
follows the JAX package's layout module for module; the JAX package stays
the reference it is tested against.  This package imports ``torch`` and
nothing of ``jax`` or of the JAX package: it carries its own copy of each
host module it needs (``utils.config``, ``utils.lut`` with ``data/
temp_LUT.txt``, ``utils.wavio``, ``utils.timeparse``, ``utils.profiling``,
``utils.native`` with ``native/wavio.cpp``, ``models.metadata``,
``ops.wire``, and the others that name their source).  Every entry point
runs on the card unless it is given ``device="cpu"``.  The names below
resolve lazily: importing the package loads neither ``torch`` nor a kernel.

The one TPU kernel of the decode paths, the Pallas tone-ratio kernel, is a
hand-written sm_90a CUDA kernel here (``ops/kernels/tone_ratios.cu``), for
one signal or a batch in one launch.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "decode_wav": ("axctdprocessor_tpu_torch.models.engine", "decode_wav"),
    "decode_waveform": ("axctdprocessor_tpu_torch.models.engine", "decode_waveform"),
    "decode_wav_parity": ("axctdprocessor_tpu_torch.models.parity_engine", "decode_wav"),
    "decode_waveform_parity": (
        "axctdprocessor_tpu_torch.models.parity_engine", "decode_waveform"),
    "decode_batch": ("axctdprocessor_tpu_torch.parallel.batch", "decode_batch"),
    "decode_batches_pipelined": (
        "axctdprocessor_tpu_torch.parallel.pipeline", "decode_batches_pipelined"),
    "reprocess_corpus": ("axctdprocessor_tpu_torch.parallel.archive", "reprocess_corpus"),
    "AXCTDStreamDecoder": ("axctdprocessor_tpu_torch.models.stream", "AXCTDStreamDecoder"),
    "DeviceStreamDecoder": (
        "axctdprocessor_tpu_torch.models.stream_device", "DeviceStreamDecoder"),
    "decode_waveform_segmented": (
        "axctdprocessor_tpu_torch.models.segmented", "decode_waveform_segmented"),
    "prestage_waveform": (
        "axctdprocessor_tpu_torch.models.segmented", "prestage_waveform"),
    "PrestagedDrop": ("axctdprocessor_tpu_torch.models.segmented", "PrestagedDrop"),
    "DecoderConfig": ("axctdprocessor_tpu_torch.utils.config", "DecoderConfig"),
    "resolve_settings": ("axctdprocessor_tpu_torch.utils.config", "resolve_settings"),
}


def __getattr__(name):
    """Lazy top-level API: importing the package alone loads no torch."""
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
