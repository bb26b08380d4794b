"""ctypes binding of the port's clip IO library (``native/io.cpp``):
threaded PNG decode + antialiased resize + normalize (the data-loading hot
path of ``--native-io``), label decode, and CPU NMS / soft-NMS.

The counterpart of the JAX package's binding, with the same functions.  The
library is built from this package's own ``io.cpp`` by ``g++`` at first use,
never at import (``ops/kernels/build.py``: ``_build/io-<hash>.so``, renamed
into place atomically).  There is no fallback: a failed build raises with
the compiler's output wherever native IO is asked for; ``available()`` only
reports whether the library loads.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from blockcopy_tpu_torch.ops.kernels import build

    lib = build.library("io")
    lib.bc_decode_image.restype = ctypes.c_int
    lib.bc_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, _F32P, _F32P, _F32P]
    lib.bc_decode_batch.restype = ctypes.c_int
    lib.bc_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _F32P, _F32P, _F32P, ctypes.c_int]
    lib.bc_decode_label.restype = ctypes.c_int
    lib.bc_decode_label.argtypes = [
        ctypes.c_char_p, _U8P, _I32P, _I32P, ctypes.c_int]
    lib.bc_nms.restype = ctypes.c_int
    lib.bc_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_float, _I32P]
    lib.bc_soft_nms.restype = ctypes.c_int
    lib.bc_soft_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                _I32P]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (nothing switches on it)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _stats(mean, std):
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean and std need 3 values, got {mean.shape}, "
                         f"{std.shape}")
    return mean, std


def _size(out_w: int, out_h: int):
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"output size {out_w}x{out_h}")
    return int(out_w), int(out_h)


def decode_image(path: str, out_w: int, out_h: int, mean, std) -> np.ndarray:
    """One PNG as a (out_h, out_w, 3) float32 array: resized (PIL's
    antialiased bilinear, in doubles) and normalized ``(x/255 - mean)/std``."""
    lib = _load()
    out_w, out_h = _size(out_w, out_h)
    mean, std = _stats(mean, std)
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.bc_decode_image(os.fsencode(path), out_w, out_h, _fptr(mean),
                             _fptr(std), _fptr(out))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out


def decode_clip(paths, out_w: int, out_h: int, mean, std,
                num_threads: int = 6) -> np.ndarray:
    """Decode a clip into one contiguous (T, H, W, 3) float32 array, frames
    decoded on ``num_threads`` threads."""
    lib = _load()
    out_w, out_h = _size(out_w, out_h)
    mean, std = _stats(mean, std)
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.bc_decode_batch(arr, n, out_w, out_h, _fptr(mean),
                                   _fptr(std), _fptr(out), num_threads)
    if failures:
        raise IOError(f"native clip decode: {failures}/{n} frames failed "
                      f"({paths[0]} ...)")
    return out


def decode_label(path: str, max_hw=(2048, 4096)) -> np.ndarray:
    """A label PNG as (H, W) uint8: a palette file's indices, else the gray
    (or red) value; no resize."""
    lib = _load()
    buf = np.empty(max_hw[0] * max_hw[1], np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.bc_decode_label(os.fsencode(path), buf.ctypes.data_as(_U8P),
                             ctypes.byref(w), ctypes.byref(h), buf.size)
    if rc != 0:
        raise IOError(f"native label decode failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def _dets(dets) -> np.ndarray:
    dets = np.ascontiguousarray(dets, np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError(f"dets must be (n, 5) xyxy + score, got "
                         f"{dets.shape}")
    return dets


def nms(dets: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy NMS of (n, 5) xyxy + score rows: the kept row indices, in
    descending score order."""
    lib = _load()
    dets = _dets(dets)
    keep = np.empty(len(dets), np.int32)
    k = lib.bc_nms(_fptr(dets), len(dets), iou_thr,
                   keep.ctypes.data_as(_I32P))
    return keep[:k].copy()


def soft_nms(dets: np.ndarray, iou_thr: float = 0.3, method: str = "linear",
             sigma: float = 0.5, min_score: float = 1e-3):
    """Soft-NMS (the reference's Cython protocol); returns ``(rows, keep)``:
    rows ``[0, k)`` are the kept detections with their decayed scores,
    positionally aligned with the kept original indices ``keep`` (the
    contract of ``ops.nms.soft_nms_numpy``)."""
    lib = _load()
    dets = _dets(dets).copy()
    keep = np.empty(len(dets), np.int32)
    m = {"linear": 0, "gaussian": 1, "naive": 2}[method]
    k = lib.bc_soft_nms(_fptr(dets), len(dets), iou_thr, m, sigma, min_score,
                        keep.ctypes.data_as(_I32P))
    return dets[:k].copy(), keep[:k].copy()
