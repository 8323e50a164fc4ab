"""MIS store — a memory-mapped sample-record format (the `.beton` replacement).

The reference stores its curated dataset as FFCV `.beton` files written by
`ffcv.writer.DatasetWriter` (`medical_image_segmentation/analyze_data/
create_ffcv_subset.py:100-108`) and memory-maps them at train time with
`os_cache=True` (`train/data_loaders/lightning_module.py:141-151`). The MIS
store provides the same capability with a layout designed for the
host loader:

    [ header | index table | data region ]

- header (64 B): magic/version, sample count, nominal (max) image shape,
  label dtype flag.
- index table: one fixed 32-byte record per sample — data offset/length,
  per-sample (h, w, c), codec (raw/JPEG/PNG), int32 label. Fixed-size
  records make random access O(1) and let the C++ loader prefetch pages.
- data region: sample payloads, 64-byte aligned (DMA-friendly copies).

Like FFCV, images may be stored raw (uint8, zero-decode) or JPEG/PNG
compressed (smaller, decode on load) — per sample, so a writer can compress
large images and keep small ones raw (FFCV's RGBImageField behavior).

16-bit stores (header flag ``FLAG_U16``): samples are uint16 — the native
bit depth of CT/MR DICOM pixel data. The reference's FFCV path squashes to
uint8 RGB at dataset-build time (`create_ffcv_subset.py:36-65`), losing the
HU dynamic range that window/level augmentation operates on; a u16 store
preserves it end-to-end (decode → device → XLA windowing). u16
stores are single-channel (radiology grayscale); valid codecs are RAW
(little-endian uint16), PNG (16-bit grayscale), and JLS (our from-scratch
ITU-T T.87 JPEG-LS codec — the DICOM-native lossless codec for exactly
this data, `data/jpegls.py` + `csrc/jpegls_codec.cpp`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"MISTORE1"
VERSION = 1
HEADER_SIZE = 64
RECORD_SIZE = 32
ALIGN = 64

CODEC_RAW = 0
CODEC_JPEG = 1
CODEC_PNG = 2
CODEC_JLS = 3

LABEL_NONE = 0
LABEL_INT32 = 1

# header flags
FLAG_U16 = 1  # samples are uint16 (little-endian); header/records otherwise identical

_HEADER_FMT = "<8sIIQHHBBBB"  # magic, version, flags, n, h, w, c, codec, label_dtype, pad
_RECORD_FMT = "<QQHHBBhi4x"   # offset, length, h, w, c, codec, pad, label, 4 reserved


@dataclass
class StoreHeader:
    num_samples: int
    height: int          # nominal/max height (loader output buffer size)
    width: int
    channels: int
    default_codec: int = CODEC_RAW
    label_dtype: int = LABEL_NONE
    flags: int = 0

    @property
    def sample_dtype(self):
        return np.uint16 if self.flags & FLAG_U16 else np.uint8

    def pack(self) -> bytes:
        body = struct.pack(
            _HEADER_FMT,
            MAGIC, VERSION, self.flags, self.num_samples,
            self.height, self.width, self.channels,
            self.default_codec, self.label_dtype, 0,
        )
        return body + b"\x00" * (HEADER_SIZE - len(body))

    @classmethod
    def unpack(cls, raw: bytes) -> "StoreHeader":
        magic, version, flags, n, h, w, c, codec, label_dtype, _ = struct.unpack(
            _HEADER_FMT, raw[: struct.calcsize(_HEADER_FMT)]
        )
        if magic != MAGIC:
            raise ValueError(f"not a MIS store (magic={magic!r})")
        if version != VERSION:
            raise ValueError(f"unsupported store version {version}")
        if flags & ~FLAG_U16:
            raise ValueError(f"unknown store flags {flags:#x}")
        return cls(num_samples=n, height=h, width=w, channels=c,
                   default_codec=codec, label_dtype=label_dtype, flags=flags)


@dataclass
class SampleRecord:
    offset: int
    length: int
    height: int
    width: int
    channels: int
    codec: int
    label: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _RECORD_FMT, self.offset, self.length,
            self.height, self.width, self.channels, self.codec, 0, self.label,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "SampleRecord":
        off, ln, h, w, c, codec, _pad, label = struct.unpack(_RECORD_FMT, raw[:RECORD_SIZE])
        return cls(offset=off, length=ln, height=h, width=w, channels=c, codec=codec, label=label)


assert struct.calcsize(_RECORD_FMT) == RECORD_SIZE


def import_cv2(purpose: str):
    """OpenCV, or an ImportError that names it and what needed it (the
    JPEG/PNG codecs; RAW and JPEG-LS payloads need no OpenCV)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"OpenCV (the cv2 module, e.g. opencv-python-headless) is needed to {purpose}; "
            "RAW and JPEG-LS store payloads work without it") from e
    return cv2
