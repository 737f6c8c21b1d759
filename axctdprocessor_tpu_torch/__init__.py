"""axctdprocessor_tpu_torch — the PyTorch/CUDA port of axctdprocessor_tpu.

The AXCTD decode paths of the JAX package's TPU engine in PyTorch, for one
NVIDIA H100: the fused single-drop decode (``models.engine.decode_wav`` /
``decode_waveform``, and the ``cli``), the segmented and prestaged decode
(``models.segmented``), the push-style stream decoder
(``models.stream_device``) and the batch path (``parallel.batch``).  It
follows the JAX package's layout module for module; the JAX package stays
the reference it is tested against.  This package imports ``torch`` and
nothing of ``jax`` or of the JAX package: it carries its own copy of each
host module it needs (``utils.config``, ``utils.lut`` with ``data/
temp_LUT.txt``, ``utils.wavio``, ``utils.timeparse``, ``utils.profiling``,
``utils.native`` with ``native/wavio.cpp``, ``models.metadata``,
``ops.wire``, and the others that name their source).  Every entry point
runs on the card unless it is given ``device="cpu"``.

The one TPU kernel of the decode paths, the Pallas tone-ratio kernel, is a
hand-written sm_90a CUDA kernel here (``ops/kernels/tone_ratios.cu``), for
one signal or a batch in one launch.
"""

__version__ = "0.1.0"
