"""Decode engine (``models.engine``) and the jax-free host pieces it needs:
``result``, ``convert``, ``frames`` and the signal ``simulator``."""
