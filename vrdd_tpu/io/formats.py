"""Binary format readers/writers for the reference's data files.

The reference parses 8 little-endian binary formats (SURVEY.md §2.4,
volumeRender.cpp:538-997). We implement both directions: writers so synthetic
datasets can round-trip through the *exact* on-disk layouts, readers with the
same validation the reference performs (range checks, sum-to-one, span
ordering) raised as exceptions instead of printf+exit.

Format quirks preserved:

- C++ ``bool`` on disk is 1 byte (reflectionFlag).
- spanList interleaves low/high per axis on disk: the reader at
  volumeRender.cpp:734-739 reads the six ints into
  (lowX, highX, lowY, highY, lowZ, highZ) in that order.
- simple-histogram spans are straight-ordered (lowX..highZ) and 0-indexed.
- template/codebook frequencies are doubles on disk, floats in memory.

A native C++ implementation of the hot readers lives in
``vrdd_tpu/native`` (same formats, same validation); this module is the
reference implementation and fallback.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Tuple

import numpy as np


class FormatError(ValueError):
    """Raised on malformed data (replaces the reference's printf + exit)."""


def _read(fp: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    buf = fp.read(size)
    if len(buf) != size:
        raise FormatError(f"truncated file: wanted {size} bytes, got {len(buf)}")
    return struct.unpack("<" + fmt, buf)


# ---------------------------------------------------------------- raw blob (1)


def write_raw_histograms(path: str, hist: np.ndarray) -> None:
    """``(n_blocks, n_bins)`` float32 blob (loadRawFile, volumeRender.cpp:538-556)."""
    np.asarray(hist, dtype="<f4").tofile(path)


def read_raw_histograms(path: str, n_blocks: int, n_bins: int) -> np.ndarray:
    data = np.fromfile(path, dtype="<f4", count=n_blocks * n_bins)
    if data.size != n_blocks * n_bins:
        raise FormatError(f"expected {n_blocks * n_bins} floats, got {data.size}")
    return data.reshape(n_blocks, n_bins)


def read_histograms_bins_major(
    path: str, dims: tuple, n_bins: int, dtype="bfloat16"
) -> np.ndarray:
    """Block-histogram blob -> the framework's bins-MAJOR device layout.

    The reference stores histograms voxel-major / bins-minor (Z*Y*X
    records of n_bins floats, volumeRender.cpp:583-597); the decode
    (ops/histogram.py ``decode_with_rows``) and the distributed sweep take
    them bins-major ``(nz, n_bins, ny, nx)``, so a z-slab is contiguous.
    ``dtype='bfloat16'`` halves the bytes the decode reads (the decode
    computes in float32). Pure-numpy specification; the native C++
    loader (io/native.py, vrdd_io.cpp) transposes during the sequential
    file read instead of materializing a second full-size array.
    """
    import ml_dtypes

    nz, ny, nx = dims
    flat = read_raw_histograms(path, nz * ny * nx, n_bins)
    out = np.ascontiguousarray(
        flat.reshape(nz, ny, nx, n_bins).transpose(0, 3, 1, 2)
    )
    if str(dtype) in ("bfloat16", "bf16"):
        return out.astype(ml_dtypes.bfloat16)
    return out.astype(dtype)


# ------------------------------------------------------------- codebooks (2, 5)


def write_codebook(
    path: str,
    codebook: np.ndarray,  # (n, 4) templateId, shift, flip, nErrors
    error_bins: np.ndarray,  # (n, E)
    error_values: np.ndarray,  # (n, E)
    span_ids: np.ndarray,  # (n,)
    n_steps: int = 1,
) -> None:
    """Shared layout of the fixed codebook (volumeRender.cpp:558-642) and the
    flexible codebook0.bin (volumeRender.cpp:773-875)."""
    with open(path, "wb") as fp:
        fp.write(struct.pack("<ii", n_steps, len(codebook)))
        for i, (tid, shift, flip, ne) in enumerate(np.asarray(codebook)):
            fp.write(struct.pack("<iii", int(span_ids[i]), int(tid), int(shift)))
            fp.write(struct.pack("<?", bool(flip)))
            fp.write(struct.pack("<i", int(ne)))
            fp.write(np.asarray(error_bins[i, :ne], dtype="<i4").tobytes())
            fp.write(np.asarray(error_values[i, :ne], dtype="<f8").tobytes())


def read_codebook(
    path: str, n_bins: int, max_errors: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns ``(codebook (n,4), error_bins (n,E), error_values (n,E), span_ids)``."""
    max_errors = max_errors or n_bins
    with open(path, "rb") as fp:
        _, n = _read(fp, "ii")
        codebook = np.zeros((n, 4), dtype=np.int32)
        ebins = np.zeros((n, max_errors), dtype=np.int32)
        evals = np.zeros((n, max_errors), dtype=np.float32)
        span_ids = np.zeros(n, dtype=np.int32)
        for i in range(n):
            (span_id, tid, shift) = _read(fp, "iii")
            (flip,) = _read(fp, "?")
            (ne,) = _read(fp, "i")
            if ne < 0 or ne > n_bins:
                raise FormatError(f"entry {i}: nErrors {ne} out of [0, {n_bins}]")
            span_ids[i] = span_id
            codebook[i] = (tid, shift, int(flip), ne)
            if ne:
                ebins[i, :ne] = np.frombuffer(fp.read(4 * ne), dtype="<i4")
                evals[i, :ne] = np.frombuffer(fp.read(8 * ne), dtype="<f8")
                # the decode (ops/fractal.py) scatter-adds all sparse errors
                # then clamps ONCE — equivalent to the reference's
                # clamp-after-each-add (volumeRender_kernel.cu:817-825) only
                # for unique bin ids; reject duplicates (and out-of-range
                # ids, volumeRender.cpp:701-707) rather than decode
                # differently on such data.
                ids = ebins[i, :ne]
                if (ids < 0).any() or (ids >= n_bins).any():
                    raise FormatError(
                        f"entry {i}: error bin id out of [0, {n_bins})"
                    )
                if np.unique(ids).size != ne:
                    raise FormatError(
                        f"entry {i}: duplicate error bin ids (the fractal "
                        "decode's single-clamp form requires unique bins)"
                    )
    return codebook, ebins, evals, span_ids


# -------------------------------------------------------------- templates (3, 7)


def write_templates(path: str, templates: np.ndarray, limits: np.ndarray = None) -> None:
    """``<nTemplates>`` then per template 6 doubles (limits) + n_bins doubles
    (volumeRender.cpp:644-691 / 951-997)."""
    t = np.asarray(templates, dtype=np.float64)
    n, n_bins = t.shape
    limits = np.zeros((n, 6)) if limits is None else np.asarray(limits, dtype=np.float64)
    with open(path, "wb") as fp:
        fp.write(struct.pack("<i", n))
        for i in range(n):
            fp.write(limits[i].astype("<f8").tobytes())
            fp.write(t[i].astype("<f8").tobytes())


def read_templates(path: str, n_bins: int) -> np.ndarray:
    with open(path, "rb") as fp:
        (n,) = _read(fp, "i")
        out = np.zeros((n, n_bins), dtype=np.float32)
        for i in range(n):
            fp.read(8 * 6)  # limits, ignored (volumeRender.cpp:664-671)
            freqs = np.frombuffer(fp.read(8 * n_bins), dtype="<f8")
            if ((freqs < 0) | (freqs > 1)).any():
                raise FormatError(f"template {i}: frequency out of [0, 1]")
            out[i] = freqs
    return out


# ---------------------------------------------------------------- span list (4)


def write_span_list(path: str, low: np.ndarray, high: np.ndarray) -> None:
    """Interleaved per-axis layout: lowX, highX, lowY, highY, lowZ, highZ."""
    low = np.asarray(low, dtype=np.int32)
    high = np.asarray(high, dtype=np.int32)
    inter = np.stack(
        [low[:, 0], high[:, 0], low[:, 1], high[:, 1], low[:, 2], high[:, 2]], -1
    )
    with open(path, "wb") as fp:
        fp.write(struct.pack("<i", len(low)))
        fp.write(inter.astype("<i4").tobytes())


def read_span_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(low (n, 3), high (n, 3))`` xyz; validates like checkSpanLimit."""
    with open(path, "rb") as fp:
        (n,) = _read(fp, "i")
        inter = np.frombuffer(fp.read(4 * 6 * n), dtype="<i4").reshape(n, 6)
    low = np.stack([inter[:, 0], inter[:, 2], inter[:, 4]], -1)
    high = np.stack([inter[:, 1], inter[:, 3], inter[:, 5]], -1)
    if ((low > high) | (low < 0) | (high < 0)).any():
        raise FormatError("span list: low > high or negative bound")
    return low, high


# ---------------------------------------------------- simple histogram trio (6)


def write_simple_histograms(
    counts_path: str,
    bin_ids_path: str,
    freqs_path: str,
    spans_low: np.ndarray,  # (n, 3) 0-indexed
    spans_high: np.ndarray,
    bin_ids: np.ndarray,  # (n, E)
    freqs: np.ndarray,  # (n, E)
    counts: np.ndarray,  # (n,)
) -> None:
    """Three-file layout (volumeRender.cpp:877-949)."""
    n = len(counts)
    with open(counts_path, "wb") as fc, open(bin_ids_path, "wb") as fb, open(
        freqs_path, "wb"
    ) as ff:
        fc.write(struct.pack("<i", n))
        for i in range(n):
            row = np.concatenate([spans_low[i], spans_high[i]]).astype("<i4")
            fc.write(row.tobytes())
            c = int(counts[i])
            fc.write(struct.pack("<i", c))
            fb.write(np.asarray(bin_ids[i, :c], dtype="<i4").tobytes())
            ff.write(np.asarray(freqs[i, :c], dtype="<f8").tobytes())


def read_simple_histograms(
    counts_path: str, bin_ids_path: str, freqs_path: str, n_bins: int
):
    """Returns ``(low (n,3), high (n,3), bin_ids (n,E), freqs (n,E), counts)``.

    Validates per checkHistogram + the sum-to-one check
    (volumeRender.cpp:701-707, 940-942).
    """
    with open(counts_path, "rb") as fc, open(bin_ids_path, "rb") as fb, open(
        freqs_path, "rb"
    ) as ff:
        (n,) = _read(fc, "i")
        low = np.zeros((n, 3), dtype=np.int32)
        high = np.zeros((n, 3), dtype=np.int32)
        counts = np.zeros(n, dtype=np.int32)
        bin_ids = np.zeros((n, n_bins), dtype=np.int32)
        freqs = np.zeros((n, n_bins), dtype=np.float32)
        for i in range(n):
            row = np.frombuffer(fc.read(4 * 6), dtype="<i4")
            low[i], high[i] = row[:3], row[3:]
            (c,) = _read(fc, "i")
            if c < 0 or c > n_bins:
                raise FormatError(f"simple {i}: bad nonzero count {c}")
            counts[i] = c
            ids = np.frombuffer(fb.read(4 * c), dtype="<i4")
            fr = np.frombuffer(ff.read(8 * c), dtype="<f8")
            if ((ids < 0) | (ids > n_bins)).any() or ((fr < 0) | (fr > 1.0)).any():
                raise FormatError(f"simple {i}: histogram entry out of range")
            total = fr.sum()
            if c and not (0.999999 <= total <= 1.000001):
                raise FormatError(f"simple {i}: total {total} != 1")
            bin_ids[i, :c] = ids
            freqs[i, :c] = fr
    return low, high, bin_ids, freqs, counts


# --------------------------------------------------------------------- PPM (8)


def write_ppm(path: str, rgba_u8: np.ndarray) -> None:
    """P6 PPM from (H, W, 4) uint8, alpha dropped (sdkSavePPM4ub semantics)."""
    h, w = rgba_u8.shape[:2]
    with open(path, "wb") as fp:
        fp.write(f"P6\n{w} {h}\n255\n".encode())
        fp.write(np.ascontiguousarray(rgba_u8[..., :3]).tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as fp:
        magic = fp.readline().strip()
        if magic != b"P6":
            raise FormatError(f"not a P6 PPM: {magic!r}")
        line = fp.readline()
        while line.startswith(b"#"):
            line = fp.readline()
        w, h = (int(v) for v in line.split())
        maxval = int(fp.readline())
        if maxval != 255:
            raise FormatError(f"unsupported maxval {maxval}")
        data = np.frombuffer(fp.read(w * h * 3), dtype=np.uint8)
    return data.reshape(h, w, 3)


def compare_ppm(
    img: np.ndarray,
    ref: np.ndarray,
    epsilon: float = 5.0,
    threshold: float = 0.30,
) -> Tuple[bool, float]:
    """Golden-image comparison with the reference's tolerance model.

    Passes when the fraction of pixels with any channel differing by more than
    ``epsilon`` (out of 255) is at most ``threshold``
    (MAX_EPSILON_ERROR/THRESHOLD, volumeRender.cpp:57-58, 1077).
    Returns ``(passed, outlier_fraction)``.
    """
    a = np.asarray(img, dtype=np.int32)
    b = np.asarray(ref, dtype=np.int32)
    if a.shape != b.shape:
        raise FormatError(f"shape mismatch {a.shape} vs {b.shape}")
    bad = (np.abs(a - b) > epsilon).any(axis=-1)
    frac = float(bad.mean())
    return frac <= threshold, frac
