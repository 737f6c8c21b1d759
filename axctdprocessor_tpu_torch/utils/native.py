"""ctypes bindings for the native (C++) data-path components.

A copy of axctdprocessor_tpu.utils.native that builds the port's own copy of
the C++ source (``axctdprocessor_tpu_torch/native/wavio.cpp``) into
``axctdprocessor_tpu_torch/_build/`` (git-ignored), never into the JAX
package: the port imports nothing of the JAX package.  Only the wire
encoders' wrappers are copied (``ops.wire`` calls them); the port reads WAVs
with ``utils.wavio``.

The shared library is compiled on demand with g++ at first use (no build
step to forget), into a temporary name that is then renamed, so that two
processes building at once never load a half-written file.  Every entry
point has a pure-Python fallback: with no compiler, or with
``AXCTD_NO_NATIVE`` set, the callers use the numpy encoders.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "wavio.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libaxctd_wavio.so")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_library() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", SOURCE, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native wavio build failed (%s); using python fallback", e)
        with contextlib.suppress(OSError):
            os.remove(tmp)
        return False


def get_library():
    """The loaded native library, or None if unavailable.

    ``AXCTD_NO_NATIVE=1`` disables it (pure-Python fallbacks everywhere);
    useful for fault isolation."""
    global _lib, _lib_failed
    if os.environ.get("AXCTD_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(LIB_PATH) or (
            os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE)
        ):
            if not _build_library():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:
            logger.warning("native wavio load failed (%s)", e)
            _lib_failed = True
            return None
        lib.axctd_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.axctd_wav_info.restype = ctypes.c_int
        lib.axctd_wav_read_conditioned.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.axctd_wav_read_conditioned.restype = ctypes.c_int
        lib.axctd_quantize_int8.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS"),
        ]
        lib.axctd_quantize_int8.restype = None
        lib.axctd_quantize_int4.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.axctd_quantize_int4.restype = None
        lib.axctd_quantize_int4_ns.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.axctd_quantize_int4_ns.restype = None
        lib.axctd_quantize_int4_ns_stats.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.axctd_quantize_int4_ns_stats.restype = None
        lib.axctd_sum_peak_int16.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.axctd_sum_peak_int16.restype = None
        lib.axctd_quantize_int4_ns_chunk.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        lib.axctd_quantize_int4_ns_chunk.restype = None
        _lib = lib
        return _lib


def quantize_int8_native(x: np.ndarray):
    """int16 -> int8 wire quantization in C (ops.wire contract), or None.

    One peak pass + one fused scale/round/store pass; rounding is the
    magic-constant nearest-even form (wavio.cpp round_ne — NOT lrintf,
    whose gcc -O3 vectorization truncates), bit-matching np.rint."""
    lib = get_library()
    if lib is None or x.dtype != np.int16:
        return None
    x = np.ascontiguousarray(x)
    out = np.empty(len(x), np.int8)
    lib.axctd_quantize_int8(x, len(x), out)
    return out


def quantize_int4_ns_native(x: np.ndarray):
    """int16 -> packed int4 with first-order noise shaping in C, or None.

    Same wire format/device unpack as the plain int4 quantizer; the
    error-feedback loop moves quantization noise out of the <=1300 Hz
    demod band (wavio.cpp axctd_quantize_int4_ns)."""
    lib = get_library()
    if lib is None or x.dtype != np.int16:
        return None
    x = np.ascontiguousarray(x)
    out = np.empty((len(x) + 1) // 2, np.uint8)
    lib.axctd_quantize_int4_ns(x, len(x), out)
    return out


def quantize_int4_ns_stats_native(x: np.ndarray):
    """(packed, dc, peak) in one fused C pass, or None.

    Same encoding as quantize_int4_ns_native; the emitted-level sum and
    max magnitude accumulate inside the quantization loop, so the
    segmented decoder's (dc, peak) conditioning statistics cost nothing
    extra (a separate stats pass over the packed bytes is ~60-100 ms at
    600 s scale)."""
    lib = get_library()
    if lib is None or x.dtype != np.int16:
        return None
    x = np.ascontiguousarray(x)
    out = np.empty((len(x) + 1) // 2, np.uint8)
    s = ctypes.c_int64()
    m = ctypes.c_int32()
    lib.axctd_quantize_int4_ns_stats(x, len(x), out, ctypes.byref(s),
                                     ctypes.byref(m))
    n = len(x)
    return out, (float(s.value) / n if n else 0.0), float(max(m.value, 1))
