"""QR code encoder (ISO/IEC 18004, byte mode, versions 1-10, EC levels L/M).

Counterpart of ``sitewhere_tpu/labels/qr.py``, whole.

Reference: ``service-label-generation`` renders entity QR labels via an
external JVM library (``service-label-generation/src/main/java/com/sitewhere/
labels/symbology/QrCodeGenerator.java``).  No QR library is baked into this
image, so the symbology is implemented here from the spec: byte-mode
segment encoding, Reed-Solomon ECC over GF(256), block interleaving, module
placement, all 8 mask patterns with penalty-based selection, and BCH-encoded
format/version info.

The output is a numpy ``uint8[N, N]`` module matrix (1 = dark).  Rendering
to PNG lives in :mod:`sitewhere_tpu_torch.labels.png`; batched rendering for the
mixed-workload benchmark in :mod:`sitewhere_tpu_torch.labels.png`.

A structural decoder (:func:`decode_matrix`) is included so tests can
round-trip: it re-extracts codewords from the matrix, verifies the
Reed-Solomon syndromes are zero, and returns the original payload.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------
# GF(256) arithmetic (primitive polynomial x^8+x^4+x^3+x^2+1 = 0x11d)

_EXP = np.zeros(512, dtype=np.int32)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]

# Plain-list twins of the GF tables: python-int indexing of a list is
# several times faster than extracting numpy scalars, and the RS inner
# loop is pure scalar work.
_EXP_L: List[int] = _EXP.tolist()
_LOG_L: List[int] = _LOG.tolist()


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP_L[_LOG_L[a] + _LOG_L[b]]


@functools.lru_cache(maxsize=None)
def _rs_generator(n_ec: int) -> Tuple[int, ...]:
    """Generator polynomial coefficients (descending powers), monic.

    Cached: there is one polynomial per EC-codeword count, and computing
    it cost more than the per-block division it feeds.
    """
    gen = [1]
    for i in range(n_ec):
        nxt = [0] * (len(gen) + 1)
        for j, c in enumerate(gen):
            nxt[j] ^= _gf_mul(c, 1)
            nxt[j + 1] ^= _gf_mul(c, _EXP_L[i])
        gen = nxt
    return tuple(gen)


@functools.lru_cache(maxsize=None)
def _rs_generator_logs(n_ec: int) -> Tuple[int, ...]:
    """log of each non-leading generator coefficient (-1 for zero)."""
    return tuple(_LOG_L[g] if g else -1 for g in _rs_generator(n_ec)[1:])


def rs_ecc(data: bytes, n_ec: int) -> bytes:
    """Reed-Solomon error-correction codewords for ``data``."""
    glog = _rs_generator_logs(n_ec)
    rem = [0] * n_ec
    exp, rng = _EXP_L, range(n_ec)
    for byte in data:
        factor = byte ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            lf = _LOG_L[factor]
            for i in rng:
                lg = glog[i]
                if lg >= 0:
                    rem[i] ^= exp[lf + lg]
    return bytes(rem)


def rs_syndromes_zero(codewords: bytes, n_ec: int) -> bool:
    """True iff the RS syndromes of data+ecc are all zero (no corruption)."""
    for i in range(n_ec):
        s = 0
        for byte in codewords:
            s = _gf_mul(s, int(_EXP[i])) ^ byte
        if s != 0:
            return False
    return True


# --------------------------------------------------------------------------
# Version tables (ISO 18004 table 9), byte mode, EC levels L and M.
# Per (version, level): list of (count, total_codewords, data_codewords);
# ec codewords per block = total - data (same for every block of a version).

_BLOCKS = {
    ("L", 1): [(1, 26, 19)],
    ("L", 2): [(1, 44, 34)],
    ("L", 3): [(1, 70, 55)],
    ("L", 4): [(1, 100, 80)],
    ("L", 5): [(1, 134, 108)],
    ("L", 6): [(2, 86, 68)],
    ("L", 7): [(2, 98, 78)],
    ("L", 8): [(2, 121, 97)],
    ("L", 9): [(2, 146, 116)],
    ("L", 10): [(2, 86, 68), (2, 87, 69)],
    ("M", 1): [(1, 26, 16)],
    ("M", 2): [(1, 44, 28)],
    ("M", 3): [(1, 70, 44)],
    ("M", 4): [(2, 50, 32)],
    ("M", 5): [(2, 67, 43)],
    ("M", 6): [(4, 43, 27)],
    ("M", 7): [(4, 49, 31)],
    ("M", 8): [(2, 60, 38), (2, 61, 39)],
    ("M", 9): [(3, 58, 36), (2, 59, 37)],
    ("M", 10): [(4, 69, 43), (1, 70, 44)],
}

# Alignment pattern center coordinates per version.
_ALIGN = {
    1: [],
    2: [6, 18],
    3: [6, 22],
    4: [6, 26],
    5: [6, 30],
    6: [6, 34],
    7: [6, 22, 38],
    8: [6, 24, 42],
    9: [6, 26, 46],
    10: [6, 28, 50],
}

_EC_BITS = {"L": 0b01, "M": 0b00}  # format-info EC level indicator

MAX_VERSION = 10


def _data_capacity(level: str, version: int) -> int:
    return sum(count * data for count, _, data in _BLOCKS[(level, version)])


def data_capacity_bytes(level: str, version: int) -> int:
    """Max byte-mode payload length for a version/level (header removed)."""
    # mode (4 bits) + length (8 bits for v1-9, 16 for v10+) → 12 or 20 bits
    header_bits = 12 if version <= 9 else 20
    return (8 * _data_capacity(level, version) - header_bits) // 8


def pick_version(payload_len: int, level: str) -> int:
    for version in range(1, MAX_VERSION + 1):
        if data_capacity_bytes(level, version) >= payload_len:
            return version
    raise ValueError(
        f"payload of {payload_len} bytes exceeds version-{MAX_VERSION} "
        f"level-{level} capacity"
    )


# --------------------------------------------------------------------------
# Bit assembly


def _encode_codewords(payload: bytes, level: str, version: int) -> bytes:
    """Byte-mode segment → padded data codewords (pre-ECC)."""
    n_data = _data_capacity(level, version)
    bits: List[int] = []

    def put(value: int, width: int) -> None:
        for i in range(width - 1, -1, -1):
            bits.append((value >> i) & 1)

    put(0b0100, 4)  # byte mode
    put(len(payload), 8 if version <= 9 else 16)
    for byte in payload:
        put(byte, 8)
    # terminator (up to 4 zero bits), then pad to byte boundary
    put(0, min(4, 8 * n_data - len(bits)))
    while len(bits) % 8:
        bits.append(0)
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = 0
        for b in bits[i : i + 8]:
            byte = (byte << 1) | b
        out.append(byte)
    # pad codewords 0xEC / 0x11 alternating
    pads = (0xEC, 0x11)
    i = 0
    while len(out) < n_data:
        out.append(pads[i & 1])
        i += 1
    return bytes(out)


def _interleave(data: bytes, level: str, version: int) -> bytes:
    """Split into blocks, compute per-block ECC, interleave (spec §8.6)."""
    blocks: List[bytes] = []
    eccs: List[bytes] = []
    pos = 0
    for count, total, n_data in _BLOCKS[(level, version)]:
        n_ec = total - n_data
        for _ in range(count):
            block = data[pos : pos + n_data]
            pos += n_data
            blocks.append(block)
            eccs.append(rs_ecc(block, n_ec))
    out = bytearray()
    for i in range(max(len(b) for b in blocks)):
        for b in blocks:
            if i < len(b):
                out.append(b[i])
    for i in range(max(len(e) for e in eccs)):
        for e in eccs:
            if i < len(e):
                out.append(e[i])
    return bytes(out)


# --------------------------------------------------------------------------
# Matrix construction

_FINDER = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 1, 1, 1, 0, 1],
        [1, 0, 1, 1, 1, 0, 1],
        [1, 0, 1, 1, 1, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    dtype=np.uint8,
)

_ALIGN_PAT = np.array(
    [
        [1, 1, 1, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 0, 1, 0, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1],
    ],
    dtype=np.uint8,
)


def matrix_size(version: int) -> int:
    return 17 + 4 * version


def _function_patterns(version: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (matrix, reserved) with finder/timing/alignment/format areas
    stamped; ``reserved`` marks every non-data module."""
    n = matrix_size(version)
    mat = np.zeros((n, n), dtype=np.uint8)
    res = np.zeros((n, n), dtype=bool)

    def stamp(r: int, c: int, pat: np.ndarray) -> None:
        h, w = pat.shape
        mat[r : r + h, c : c + w] = pat
        res[r : r + h, c : c + w] = True

    # finders + separators (separators are light: leave 0, just reserve)
    stamp(0, 0, _FINDER)
    stamp(0, n - 7, _FINDER)
    stamp(n - 7, 0, _FINDER)
    res[0:8, 0:8] = True
    res[0:8, n - 8 : n] = True
    res[n - 8 : n, 0:8] = True

    # timing patterns
    for i in range(8, n - 8):
        mat[6, i] = mat[i, 6] = (i + 1) % 2
        res[6, i] = res[i, 6] = True

    # alignment patterns (skip any overlapping a finder)
    centers = _ALIGN[version]
    for r in centers:
        for c in centers:
            if (r < 9 and c < 9) or (r < 9 and c > n - 10) or (r > n - 10 and c < 9):
                continue
            stamp(r - 2, c - 2, _ALIGN_PAT)

    # format info areas (filled later) + dark module
    res[8, 0:9] = True
    res[0:9, 8] = True
    res[8, n - 8 : n] = True
    res[n - 8 : n, 8] = True
    mat[n - 8, 8] = 1  # dark module

    # version info areas (v >= 7)
    if version >= 7:
        res[0:6, n - 11 : n - 8] = True
        res[n - 11 : n - 8, 0:6] = True

    return mat, res


@functools.lru_cache(maxsize=None)
def _placement_order(version: int) -> Tuple[np.ndarray, np.ndarray]:
    """Data-cell coordinates in zigzag placement order (two columns at a
    time, right→left, skipping timing col 6) — a pure function of the
    version's reserved grid, so computed once."""
    _, res = _function_patterns(version)
    n = res.shape[0]
    rr: List[int] = []
    cc: List[int] = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:  # vertical timing column
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not res[r, c]:
                    rr.append(r)
                    cc.append(c)
        upward = not upward
        col -= 2
    r_arr, c_arr = np.asarray(rr, np.intp), np.asarray(cc, np.intp)
    # frozen: these are shared cache singletons — a caller mutating one
    # would silently corrupt every later encode/decode for this version
    r_arr.flags.writeable = False
    c_arr.flags.writeable = False
    return r_arr, c_arr


def _place_data(mat: np.ndarray, res: np.ndarray, codewords: bytes) -> None:
    """Zigzag placement via the cached per-version order; cells past the
    codeword bits are the spec's remainder bits (zero)."""
    del res  # the cached order already encodes the reserved grid
    r_idx, c_idx = _placement_order((mat.shape[0] - 17) // 4)
    bits = np.unpackbits(np.frombuffer(codewords, np.uint8))
    k = min(len(bits), len(r_idx))
    mat[r_idx[:k], c_idx[:k]] = bits[:k]
    mat[r_idx[k:], c_idx[k:]] = 0


_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def _mask_grid(mask: int, n: int) -> np.ndarray:
    r, c = np.indices((n, n))
    return _MASKS[mask](r, c)


@functools.lru_cache(maxsize=None)
def _mask_stack(n: int) -> np.ndarray:
    """All 8 mask grids for symbol size ``n`` as one [8, n, n] stack
    (cached: mask patterns depend only on coordinates; frozen because
    the cache entry is shared by every encode at this size)."""
    r, c = np.indices((n, n))
    stack = np.stack([_MASKS[m](r, c) for m in range(8)])
    stack.flags.writeable = False
    return stack


def _run_penalty(grid: np.ndarray) -> int:
    """Rule 1 over rows: sum of (3 + len - 5) for same-color runs >= 5."""
    rows, n = grid.shape
    change = np.ones((rows, n), bool)
    change[:, 1:] = grid[:, 1:] != grid[:, :-1]
    # run id per cell, disambiguated across rows; bincount = run lengths
    ids = np.cumsum(change, axis=1) + (
        np.arange(rows)[:, None] * (n + 1))
    lengths = np.bincount(ids.ravel())
    runs = lengths[lengths >= 5]
    return int((runs - 2).sum())  # 3 + len - 5


def _finder_penalty(grid: np.ndarray) -> int:
    """Rule 3 over rows: 40 per 1011101 core with 4 light modules on a
    side (truncated border windows do not count, matching the spec)."""
    from numpy.lib.stride_tricks import sliding_window_view

    # border sentinel 2: never equal to light (0), so a flank that runs
    # off the symbol edge cannot satisfy the 4-light requirement
    pad = np.pad(grid.astype(np.int8), ((0, 0), (4, 4)),
                 constant_values=2)
    win = sliding_window_view(pad, 15, axis=1)  # [rows, n - 6, 15]
    pat = np.array([1, 0, 1, 1, 1, 0, 1], np.int8)
    core = (win[:, :, 4:11] == pat).all(axis=2)
    before = (win[:, :, 0:4] == 0).all(axis=2)
    after = (win[:, :, 11:15] == 0).all(axis=2)
    return 40 * int((core & (before | after)).sum())


def _penalty(mat: np.ndarray) -> int:
    """The four penalty rules of spec §8.8.2 (vectorized)."""
    n = mat.shape[0]
    score = 0
    # rule 1: runs of >= 5 same-color modules, rows and columns
    score += _run_penalty(mat) + _run_penalty(mat.T)
    # rule 2: 2x2 blocks of same color
    same = (
        (mat[:-1, :-1] == mat[:-1, 1:])
        & (mat[:-1, :-1] == mat[1:, :-1])
        & (mat[:-1, :-1] == mat[1:, 1:])
    )
    score += 3 * int(same.sum())
    # rule 3: finder-like 1011101 pattern with 4 light modules on either side
    score += _finder_penalty(mat) + _finder_penalty(mat.T)
    # rule 4: dark-module proportion deviation from 50%
    dark_pct = 100.0 * mat.sum() / (n * n)
    score += 10 * int(abs(dark_pct - 50) // 5)
    return score


def _run_penalty_all(grids: np.ndarray) -> np.ndarray:
    """Rule 1 over rows for a [m, R, n] stack → per-matrix totals [m]."""
    m, rows, n = grids.shape
    g = grids.reshape(m * rows, n)
    change = np.ones((m * rows, n), bool)
    change[:, 1:] = g[:, 1:] != g[:, :-1]
    ids = np.cumsum(change, axis=1) + (
        np.arange(m * rows)[:, None] * (n + 1))
    lengths = np.bincount(ids.ravel(), minlength=m * rows * (n + 1) + 1)
    contrib = np.where(lengths >= 5, lengths - 2, 0)
    # id space is strided (n+1) per row: fold back to per-row, then per-mask
    per_row = contrib[: m * rows * (n + 1)].reshape(m * rows, n + 1).sum(1)
    return per_row.reshape(m, rows).sum(1)


def _finder_penalty_all(grids: np.ndarray) -> np.ndarray:
    """Rule 3 over rows for a [m, R, n] stack → per-matrix totals [m].

    Slice algebra instead of a 15-wide window view: the core 1011101 is
    seven shifted slices ANDed, the 4-light flanks are prefix-sum range
    queries — no [.., 15]-materialized comparison arrays.  Window i
    (i in [0, n-6)) covers padded columns [i, i+15); border sentinel 2
    keeps a flank that runs off the symbol edge from counting as light,
    matching the truncated-window rule of the spec."""
    m, rows, n = grids.shape
    w = n - 6  # window positions per row
    g = np.pad(grids.astype(np.int8), ((0, 0), (0, 0), (4, 4)),
               constant_values=2)
    eq1 = g == 1
    eq0 = g == 0

    def s(a: np.ndarray, off: int) -> np.ndarray:
        # padded column (i+4)+off for every window position i
        return a[:, :, 4 + off: 4 + off + w]

    core = (s(eq1, 0) & s(eq0, 1) & s(eq1, 2) & s(eq1, 3)
            & s(eq1, 4) & s(eq0, 5) & s(eq1, 6))
    # exclusive prefix sums of light cells: range [a, b) light-count is
    # cp[b] - cp[a]; flanks are [i, i+4) and [i+11, i+15)
    cp = np.zeros((m, rows, g.shape[2] + 1), np.int32)
    np.cumsum(eq0, axis=2, out=cp[:, :, 1:])
    before = (cp[:, :, 4: 4 + w] - cp[:, :, 0: w]) == 4
    after = (cp[:, :, 15: 15 + w] - cp[:, :, 11: 11 + w]) == 4
    return 40 * (core & (before | after)).sum(axis=(1, 2))


def _penalty_all(mats: np.ndarray) -> np.ndarray:
    """§8.8.2 penalties for a [m, n, n] stack of candidate matrices at
    once — one set of numpy calls instead of m of them (mask selection
    evaluates all 8 masks; the per-call overhead dominated at n≤57).
    Pinned equal to per-matrix :func:`_penalty` by tests."""
    m, n, _ = mats.shape
    score = _run_penalty_all(mats) + _run_penalty_all(
        mats.transpose(0, 2, 1))
    same = (
        (mats[:, :-1, :-1] == mats[:, :-1, 1:])
        & (mats[:, :-1, :-1] == mats[:, 1:, :-1])
        & (mats[:, :-1, :-1] == mats[:, 1:, 1:])
    )
    score = score + 3 * same.sum(axis=(1, 2))
    score = score + _finder_penalty_all(mats) + _finder_penalty_all(
        mats.transpose(0, 2, 1))
    dark_pct = 100.0 * mats.sum(axis=(1, 2)) / (n * n)
    score = score + 10 * (np.abs(dark_pct - 50) // 5).astype(np.int64)
    return score


def _bch(value: int, poly: int, total_bits: int, data_bits: int) -> int:
    """Append BCH remainder bits: value << (total-data), mod poly."""
    rem = value << (total_bits - data_bits)
    poly_deg = poly.bit_length() - 1
    for i in range(total_bits - 1, poly_deg - 1, -1):
        if rem & (1 << i):
            rem ^= poly << (i - poly_deg)
    return (value << (total_bits - data_bits)) | rem


def _format_bits(level: str, mask: int) -> int:
    value = (_EC_BITS[level] << 3) | mask
    return _bch(value, 0b10100110111, 15, 5) ^ 0b101010000010010


def _version_bits(version: int) -> int:
    return _bch(version, 0b1111100100101, 18, 6)


def _write_format(mat: np.ndarray, level: str, mask: int) -> None:
    n = mat.shape[0]
    f = _format_bits(level, mask)
    bits = [(f >> i) & 1 for i in range(14, -1, -1)]  # MSB first: bit 14..0
    # copy 1 around top-left finder: bits 0..14
    coords1 = (
        [(8, c) for c in range(6)] + [(8, 7), (8, 8), (7, 8)]
        + [(r, 8) for r in range(5, -1, -1)]
    )
    # copy 2: down the right of top-right finder + left of bottom-left finder
    coords2 = [(n - 1 - r, 8) for r in range(7)] + [(8, n - 8 + c) for c in range(8)]
    for (r, c), bit in zip(coords1, bits):
        mat[r, c] = bit
    for (r, c), bit in zip(coords2, bits):
        mat[r, c] = bit


def _write_version(mat: np.ndarray, version: int) -> None:
    if version < 7:
        return
    n = mat.shape[0]
    v = _version_bits(version)
    for i in range(18):
        bit = (v >> i) & 1
        mat[i // 3, n - 11 + i % 3] = bit
        mat[n - 11 + i % 3, i // 3] = bit


def encode(payload: bytes | str, level: str = "M",
           version: Optional[int] = None, mask: Optional[int] = None) -> np.ndarray:
    """Encode ``payload`` into a QR module matrix (``uint8[N, N]``, 1=dark)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    if level not in _EC_BITS:
        raise ValueError(f"EC level must be L or M, got {level!r}")
    if version is None:
        version = pick_version(len(payload), level)
    elif not 1 <= version <= MAX_VERSION:
        raise ValueError(f"version must be 1..{MAX_VERSION}")
    elif data_capacity_bytes(level, version) < len(payload):
        raise ValueError("payload too long for requested version")

    codewords = _interleave(_encode_codewords(payload, level, version), level, version)
    base, res = _function_patterns(version)
    _place_data(base, res, codewords)

    n = base.shape[0]
    if mask is not None:
        mat = base.copy()
        flip = _mask_grid(mask, n) & ~res
        mat[flip] ^= 1
        _write_format(mat, level, mask)
        _write_version(mat, version)
        return mat
    # all 8 candidates as one stack; penalties vectorized across the
    # mask axis (_penalty_all) — selection was the encoder's hot loop
    stack = np.where(_mask_stack(n) & ~res, base ^ 1, base)
    for m in range(8):
        _write_format(stack[m], level, m)
        _write_version(stack[m], version)
    return stack[int(np.argmin(_penalty_all(stack)))]


# --------------------------------------------------------------------------
# Structural decoder (for round-trip tests and journal audits)


def read_format(mat: np.ndarray) -> Tuple[str, int]:
    """Read (ec_level, mask) back from the format info around the TL finder."""
    coords = (
        [(8, c) for c in range(6)] + [(8, 7), (8, 8), (7, 8)]
        + [(r, 8) for r in range(5, -1, -1)]
    )
    f = 0
    for r, c in coords:
        f = (f << 1) | int(mat[r, c])
    f ^= 0b101010000010010
    value = f >> 10
    level_bits, mask = value >> 3, value & 0b111
    for name, bits in _EC_BITS.items():
        if bits == level_bits:
            return name, mask
    raise ValueError(f"unknown EC level bits {level_bits:#b}")


def decode_matrix(mat: np.ndarray) -> bytes:
    """Recover the payload from a module matrix produced by :func:`encode`.

    Verifies Reed-Solomon syndromes per block; raises on corruption.  Not a
    camera-image decoder — it assumes an axis-aligned, unscaled matrix.
    """
    n = mat.shape[0]
    version = (n - 17) // 4
    level, mask = read_format(mat)
    _, res = _function_patterns(version)
    unmasked = mat.copy()
    flip = _mask_grid(mask, n) & ~res
    unmasked[flip] ^= 1

    # extract bits in placement order — the SAME cached order encode
    # placed them in, so the two sides cannot drift
    r_idx, c_idx = _placement_order(version)
    bits = unmasked[r_idx, c_idx].tolist()
    total = sum(count * tot for count, tot, _ in _BLOCKS[(level, version)])
    codewords = bytearray()
    for i in range(total):
        byte = 0
        for b in bits[8 * i : 8 * i + 8]:
            byte = (byte << 1) | b
        codewords.append(byte)

    # de-interleave
    shapes: List[Tuple[int, int]] = []  # (n_data, n_ec) per block
    for count, tot, n_data in _BLOCKS[(level, version)]:
        shapes += [(n_data, tot - n_data)] * count
    data_blocks: List[bytearray] = [bytearray() for _ in shapes]
    ecc_blocks: List[bytearray] = [bytearray() for _ in shapes]
    pos = 0
    for i in range(max(d for d, _ in shapes)):
        for bi, (d, _) in enumerate(shapes):
            if i < d:
                data_blocks[bi].append(codewords[pos])
                pos += 1
    for i in range(max(e for _, e in shapes)):
        for bi, (_, e) in enumerate(shapes):
            if i < e:
                ecc_blocks[bi].append(codewords[pos])
                pos += 1
    for bi, (d, e) in enumerate(shapes):
        if not rs_syndromes_zero(bytes(data_blocks[bi]) + bytes(ecc_blocks[bi]), e):
            raise ValueError(f"RS syndrome check failed for block {bi}")

    stream = b"".join(bytes(b) for b in data_blocks)
    # parse byte-mode segment
    def get_bits(byte_stream: bytes, start: int, width: int) -> int:
        v = 0
        for i in range(start, start + width):
            v = (v << 1) | ((byte_stream[i // 8] >> (7 - i % 8)) & 1)
        return v

    mode = get_bits(stream, 0, 4)
    if mode != 0b0100:
        raise ValueError(f"expected byte mode, got {mode:#06b}")
    len_width = 8 if version <= 9 else 16
    length = get_bits(stream, 4, len_width)
    start = 4 + len_width
    payload = bytearray(
        get_bits(stream, start + 8 * i, 8) for i in range(length)
    )
    return bytes(payload)
