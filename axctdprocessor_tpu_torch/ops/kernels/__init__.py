"""Build and load the port's hand-written CUDA kernels.

The kernels are compiled from the sources in this directory at first use,
with ``torch.utils.cpp_extension.load``, into ``axctdprocessor_tpu_torch/
_build/`` (listed in ``.gitignore``).  Only the small binding file includes
PyTorch's headers; the ``.cu`` file has a plain C interface, so nvcc does not
parse PyTorch.  Nothing is imported or built when this module is imported:
a CPU-only machine never reaches :func:`extension`.
"""

from __future__ import annotations

import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
SOURCES = ("tone_ratios_binding.cpp", "tone_ratios.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_ext = None


def extension():
    """The compiled extension module (built on the first call; raises if
    the build fails — there is no fallback)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(
                name="axctd_tone_ratios",
                sources=[os.path.join(_HERE, s) for s in SOURCES],
                build_directory=BUILD_DIR,
                extra_cflags=["-O3"],
                extra_cuda_cflags=CUDA_FLAGS,
            )
        return _ext
