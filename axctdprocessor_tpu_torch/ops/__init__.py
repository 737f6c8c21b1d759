"""Device ops of the port: plain PyTorch functions on tensors, plus the
hand-written CUDA kernel under ``ops.kernels`` (``ops.tonepower``), and
jax-free numpy copies of the host codec pieces (``ops.bits``, ``ops.crc``,
``ops.seawater``)."""
