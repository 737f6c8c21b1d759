"""Decode engines (``models.engine``, ``models.segmented``, the stream
decoder ``models.stream_device``) and the jax-free host pieces they need:
``result``, ``convert``, ``frames`` and the signal ``simulator``."""
