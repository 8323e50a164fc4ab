"""ctypes binding + on-demand build of the C++ MIS loader.

The shared object is compiled from ``csrc/*.cpp`` (g++, zlib, and libjpeg /
libpng where their headers are installed) into a cache directory, under a
key made from the sources, the compiler command, the compiler's version and
the host CPU, so a library built on one machine is never loaded on another.
A build without libjpeg or libpng still reads RAW and JPEG-LS stores; JPEG
or PNG payloads then fail with a message that names the missing library.
``Loader`` falls back to the pure-Python ``StoreReader`` when the build
fails, and prints why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
_SRCS = [
    os.path.join(_REPO_ROOT, "csrc", "mis_loader.cpp"),
    os.path.join(_REPO_ROOT, "csrc", "dicom_codecs.cpp"),
    os.path.join(_REPO_ROOT, "csrc", "jpegls_codec.cpp"),
    os.path.join(_REPO_ROOT, "csrc", "j2k_codec.cpp"),
]


def _cache_dir() -> str:
    d = os.environ.get("MIS_NATIVE_CACHE", os.path.join(_REPO_ROOT, "build", "native"))
    os.makedirs(d, exist_ok=True)
    return d


# error code of a payload whose codec library was not compiled in
# (kErrCodecMissing in csrc/mis_loader.cpp)
ERR_CODEC_MISSING = -10


def _has_header(cxx: str, header: str) -> bool:
    src = f"#include <cstdio>\n#include <{header}>\n"
    try:
        r = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull], input=src.encode(),
                           capture_output=True, timeout=60)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    return r.returncode == 0


def _host_cpu() -> str:
    """The CPU model and feature flags (``-march=native`` compiles for them)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith(("model name", "flags", "Features"))]
        return "\n".join(sorted(set(lines)))
    except OSError:
        import platform

        return platform.processor() or platform.machine()


def build_command(out: str, cxx: str = "g++", jpeg: bool = True, png: bool = True) -> list:
    """The compiler command for the loader library at ``out``."""
    defines, libs = [], []
    if jpeg:
        libs.append("-ljpeg")
    else:
        defines.append("-DMIS_NO_JPEG")
    if png:
        libs.append("-lpng")
    else:
        defines.append("-DMIS_NO_PNG")
    return [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", *defines,
            *_SRCS, *libs, "-lz", "-pthread", "-o", out]


def build_key(cmd: list, compiler_version: str, cpu: str) -> str:
    """Cache key of a build: the sources, the command, the compiler and the CPU."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    for part in (" ".join(cmd[:-1]), compiler_version, cpu):  # cmd[-1] is the output path
        h.update(b"\0" + part.encode())
    return h.hexdigest()[:16]


def _build() -> Optional[str]:
    cxx = os.environ.get("CXX", "g++")
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, timeout=60).stdout.decode()
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        print(f"mis_loader native build failed: no C++ compiler ({e})", file=sys.stderr)
        return None
    jpeg, png = _has_header(cxx, "jpeglib.h"), _has_header(cxx, "png.h")
    key = build_key(build_command("", cxx, jpeg, png), version, _host_cpu())
    out = os.path.join(_cache_dir(), f"libmisloader-{key}.so")
    if os.path.exists(out):
        return out
    missing = [name for name, ok in (("libjpeg", jpeg), ("libpng", png)) if not ok]
    if missing:
        print(f"mis_loader: building without {' and '.join(missing)} (headers not found); "
              "stores of those codecs will not load natively", file=sys.stderr)
    tmp = f"{out}.{os.getpid()}.tmp"  # pid-unique: concurrent builders must
    # not interleave writes into one -o target before the atomic publish
    try:
        subprocess.run(build_command(tmp, cxx, jpeg, png), check=True, capture_output=True,
                       timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        print(f"mis_loader native build failed: {e}\n{stderr.decode()[:2000]}", file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native loader; None if unavailable."""
    global _LIB, _BUILD_FAILED
    with _LOCK:
        if _LIB is not None or _BUILD_FAILED:
            return _LIB
        so = _build()
        if so is None:
            _BUILD_FAILED = True
            return None
        lib = ctypes.CDLL(so)
        lib.mis_open.restype = ctypes.c_void_p
        lib.mis_open.argtypes = [ctypes.c_char_p]
        lib.mis_close.argtypes = [ctypes.c_void_p]
        lib.mis_num_samples.restype = ctypes.c_int64
        lib.mis_num_samples.argtypes = [ctypes.c_void_p]
        lib.mis_shape.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.mis_fetch.restype = ctypes.c_int
        lib.mis_fetch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.mis_fetch_views.restype = ctypes.c_int
        lib.mis_fetch_views.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        # uint16-store variants (header FLAG_U16): same contracts, u16 buffers
        lib.mis_sample_u16.restype = ctypes.c_int
        lib.mis_sample_u16.argtypes = [ctypes.c_void_p]
        lib.mis_fetch_u16.restype = ctypes.c_int
        lib.mis_fetch_u16.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.mis_fetch_views_u16.restype = ctypes.c_int
        lib.mis_fetch_views_u16.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        # compressed-DICOM codecs (csrc/dicom_codecs.cpp)
        lib.jls_probe.restype = ctypes.c_int
        lib.jls_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.jls_decode.restype = ctypes.c_int
        lib.jls_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ]
        # JPEG-LS T.87 codec (csrc/jpegls_codec.cpp)
        lib.jpegls_probe.restype = ctypes.c_int
        lib.jpegls_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.jpegls_decode.restype = ctypes.c_int
        lib.jpegls_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ]
        # row-limited decode (crop-at-decode for JLS; bit-identical prefix)
        lib.jpegls_decode_rows.restype = ctypes.c_int
        lib.jpegls_decode_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int,
        ]
        lib.jpegls_encode.restype = ctypes.c_int
        lib.jpegls_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        # JPEG 2000 T.800 codec (csrc/j2k_codec.cpp)
        lib.j2k_probe.restype = ctypes.c_int
        lib.j2k_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.j2k_decode.restype = ctypes.c_int
        lib.j2k_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        _LIB = lib
        return _LIB


def _fetch_error(fn: str, rc: int) -> str:
    if rc == ERR_CODEC_MISSING:
        return (f"{fn}: the store holds JPEG or PNG payloads, but the native loader "
                "was built without libjpeg/libpng (their headers were not found); "
                "install them, or write the store with the raw or JPEG-LS codec")
    return f"{fn} error {rc}"


class NativeStore:
    """Thin RAII wrapper over the C++ store handle."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._handle = lib.mis_open(path.encode())
        if not self._handle:
            raise IOError(f"mis_open failed for {path}")
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        lib.mis_shape(self._handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
        self.shape = (h.value, w.value, c.value)
        self.num_samples = int(lib.mis_num_samples(self._handle))
        self.dtype = np.dtype(np.uint16 if lib.mis_sample_u16(self._handle) else np.uint8)

    def fetch(
        self,
        indices: np.ndarray,
        out: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        out_hw: Optional[tuple] = None,
        num_threads: int = 4,
    ):
        """Decode ``indices`` into (B, H, W, C) samples (store dtype: uint8,
        or uint16 for FLAG_U16 stores) + (B,) int32 labels."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        oh, ow = out_hw or self.shape[:2]
        oc = self.shape[2]
        if out is None:
            out = np.empty((n, oh, ow, oc), self.dtype)
        if labels is None:
            labels = np.empty((n,), np.int32)
        if self.dtype == np.uint16:
            fn = self._lib.mis_fetch_u16
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        else:
            fn = self._lib.mis_fetch
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = fn(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out_ptr,
            oh, ow, oc,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_threads,
        )
        if rc != 0:
            raise IOError(_fetch_error("mis_fetch", rc))
        return out, labels

    def fetch_views(
        self,
        indices: np.ndarray,
        params: np.ndarray,
        out_hw: tuple,
        out: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        num_threads: int = 4,
    ):
        """Host-side RandomResizedCrop fast path: decode each sample once and
        emit V bilinear crop-resized views, SAMPLE-major.

        ``params`` is float32 (B, V, 5) = (y0, x0, crop_h, crop_w, flip) per
        view in source-pixel coordinates (same convention as
        ``ops.augment._resize_matrix``). Returns ((B*V, vh, vw, C) uint8,
        (B,) int32) — SAMPLE-major: view v of sample i lives at row
        ``i*V + v``, so per-host shards concatenate into a correct global
        batch and the on-device (B, V, ...) reshape/split is shard-local
        (see the layout note in csrc/mis_loader.cpp::mis_fetch_views).
        """
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        params = np.ascontiguousarray(params, np.float32)
        if params.shape[0] != n or params.shape[-1] != 5:
            raise ValueError(f"params must be (B, V, 5); got {params.shape}")
        views = int(params.shape[1]) if params.ndim == 3 else 1
        vh, vw = out_hw
        oc = self.shape[2]
        if out is None:
            out = np.empty((n * views, vh, vw, oc), self.dtype)
        if labels is None:
            labels = np.empty((n,), np.int32)
        if self.dtype == np.uint16:
            fn = self._lib.mis_fetch_views_u16
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        else:
            fn = self._lib.mis_fetch_views
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = fn(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), views,
            out_ptr,
            vh, vw, oc,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_threads,
        )
        if rc != 0:
            raise IOError(_fetch_error("mis_fetch_views", rc))
        return out, labels

    def close(self):
        if self._handle:
            self._lib.mis_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
