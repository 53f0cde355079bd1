"""ctypes bindings to the native IO library (native/fastdnn_io.cc).

The native library is this engine's analog of the reference's C++
BinaryLoader/BatchData (/root/reference/src/cpp/float_dnn.cc): host-side
big-endian parsing of model/feature files, kept native for bulk byte-swap
speed.  Everything degrades gracefully to the pure-numpy implementations in
formats/binary.py when the library isn't built (`make -C native`) or when
FASTDNN_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from .binary import RawLayer, RawNetwork

def _lib_filename() -> str:
    """Platform-native library name, the reference's NativeUtils.java:30-80
    .so/.dll selection done the Python way."""
    import sys

    if sys.platform == "win32":
        return "fastdnn_io.dll"
    if sys.platform == "darwin":
        return "libfastdnn_io.dylib"
    return "libfastdnn_io.so"


_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_native",
    _lib_filename(),
)

_lib: Optional[ctypes.CDLL] = None
_load_failed = False  # cache the negative result: dlopen + ~20 symbol
# binds + a warning per IO call would otherwise repeat for every file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    if os.environ.get("FASTDNN_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = _bind(ctypes.CDLL(_LIB_PATH))
    except (OSError, AttributeError) as e:
        # a stale .so built before newer fd_* symbols must degrade to the
        # numpy parsers (the module contract), not crash at symbol binding
        import logging

        logging.getLogger(__name__).warning(
            "native IO library unusable (%s: %s); using numpy fallback",
            type(e).__name__,
            e,
        )
        _load_failed = True
        return None
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fd_read_model.restype = ctypes.c_void_p
    lib.fd_read_model.argtypes = [ctypes.c_char_p]
    lib.fd_model_layer_count.restype = ctypes.c_int32
    lib.fd_model_layer_count.argtypes = [ctypes.c_void_p]
    for fn in ("fd_model_input_dim", "fd_model_output_dim"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("fd_model_weights", "fd_model_bias"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_float)
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("fd_model_shift", "fd_model_scale"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_float)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fd_model_free.argtypes = [ctypes.c_void_p]
    lib.fd_read_features.restype = ctypes.c_int32
    lib.fd_read_features.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fd_write_features.restype = ctypes.c_int32
    lib.fd_write_features.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.fd_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.fd_read_features_text.restype = ctypes.c_void_p
    lib.fd_read_features_text.argtypes = [ctypes.c_char_p]
    lib.fd_ftext_count.restype = ctypes.c_int32
    lib.fd_ftext_count.argtypes = [ctypes.c_void_p]
    lib.fd_ftext_id.restype = ctypes.c_char_p
    lib.fd_ftext_id.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("fd_ftext_frames", "fd_ftext_dim"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fd_ftext_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.fd_ftext_data.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fd_ftext_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


def read_model(path) -> RawNetwork:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    if not os.path.exists(path):
        raise FileNotFoundError(f"model file not found: {path}")
    handle = lib.fd_read_model(os.fspath(path).encode())
    if not handle:
        raise ValueError(f"failed to parse model file {path}")
    try:
        layers: List[RawLayer] = []
        for i in range(lib.fd_model_layer_count(handle)):
            in_dim = lib.fd_model_input_dim(handle, i)
            out_dim = lib.fd_model_output_dim(handle, i)
            w = np.ctypeslib.as_array(
                lib.fd_model_weights(handle, i), shape=(out_dim, in_dim)
            ).copy()
            b = np.ctypeslib.as_array(lib.fd_model_bias(handle, i), shape=(out_dim,)).copy()
            layers.append(RawLayer(w, b))
        in0 = layers[0].input_dim
        shift = np.ctypeslib.as_array(lib.fd_model_shift(handle), shape=(in0,)).copy()
        scale = np.ctypeslib.as_array(lib.fd_model_scale(handle), shape=(in0,)).copy()
        return RawNetwork(layers, shift, scale)
    finally:
        lib.fd_model_free(handle)


def read_features(path) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    data = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int32()
    dim = ctypes.c_int32()
    if not os.path.exists(path):
        raise FileNotFoundError(f"feature file not found: {path}")
    rc = lib.fd_read_features(
        os.fspath(path).encode(), ctypes.byref(data), ctypes.byref(frames), ctypes.byref(dim)
    )
    if rc != 0:
        raise ValueError(f"failed to read feature file {path} (code {rc})")
    try:
        return np.ctypeslib.as_array(data, shape=(frames.value, dim.value)).copy()
    finally:
        lib.fd_buffer_free(data)


def read_features_text(path):
    """Kaldi text feature file -> {utterance_id: [frames, dim] f32}
    (BatchData.loadMultipleFromText analog, ~10x the Python regex parser)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    if not os.path.exists(path):
        raise FileNotFoundError(f"text feature file not found: {path}")
    handle = lib.fd_read_features_text(os.fspath(path).encode())
    if not handle:
        raise ValueError(f"failed to parse text feature file {path}")
    try:
        out = {}
        for i in range(lib.fd_ftext_count(handle)):
            n = lib.fd_ftext_frames(handle, i)
            d = lib.fd_ftext_dim(handle, i)
            mat = np.ctypeslib.as_array(lib.fd_ftext_data(handle, i), shape=(n, d)).copy()
            out[lib.fd_ftext_id(handle, i).decode()] = mat
        return out
    finally:
        lib.fd_ftext_free(handle)


def write_features(data: np.ndarray, path) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    arr = np.ascontiguousarray(data, dtype=np.float32)
    rc = lib.fd_write_features(
        os.fspath(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arr.shape[0],
        arr.shape[1],
    )
    if rc != 0:
        raise ValueError(f"failed to write feature file {path} (code {rc})")
