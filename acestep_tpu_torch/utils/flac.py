"""Dependency-free FLAC encoder and decoder (16-bit, numpy only): port of the
JAX package's utils/flac.py, the same bytes for the same PCM.

The stream (per the xiph FLAC format):
  * a STREAMINFO metadata block and fixed-blocksize frames of 4096 samples;
  * per channel and block the smallest of a CONSTANT, a FIXED (order 0-4,
    Rice-coded residuals, partition order 0) or a VERBATIM subframe, so
    silence collapses to a few bytes and noise never grows past verbatim;
  * the frame-header CRC-8 (poly 0x07), the frame CRC-16 (poly 0x8005, in
    numpy lockstep across frames) and the MD5 of the PCM in STREAMINFO.

``decode_flac`` reads everything ``encode_flac`` writes (constant, fixed and
verbatim subframes): uploads and round trips.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Tuple

import numpy as np

BLOCK = 4096

# compress=False on encode_flac forces the verbatim-only stream (WAV-sized)


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _make_crc16_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32) << 8
    for _ in range(8):
        t = np.where(t & 0x8000, ((t << 1) ^ 0x8005), t << 1) & 0xFFFF
    return t.astype(np.uint16)


_CRC16_TABLE = _make_crc16_table()


def _crc16(data: bytes) -> int:
    crc = 0
    tbl = _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFF00) ^ int(tbl[((crc >> 8) ^ b) & 0xFF])
    return crc


def _crc16_batch(frames: List[bytes]) -> np.ndarray:
    """CRC-16/8005 of many byte strings, computed in numpy lockstep over the
    byte index (the recurrence is sequential per frame but independent across
    frames — ~5000 vector steps instead of ~35M Python iterations at 600 s)."""
    n = len(frames)
    lens = np.fromiter((len(f) for f in frames), np.int64, n)
    maxlen = int(lens.max()) if n else 0
    mat = np.zeros((n, maxlen), np.uint8)
    for i, f in enumerate(frames):
        mat[i, : lens[i]] = np.frombuffer(f, np.uint8)
    crc = np.zeros(n, np.uint16)
    tbl = _CRC16_TABLE
    for i in range(maxlen):
        nxt = ((crc << 8) & 0xFF00) ^ tbl[((crc >> 8) ^ mat[:, i]) & 0xFF]
        crc = np.where(i < lens, nxt, crc).astype(np.uint16)
    return crc


def _utf8_coded(n: int) -> bytes:
    """FLAC frame-number coding (UTF-8-style, up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    n_bytes = 2
    while bits > 5 * n_bytes + (7 - n_bytes) - 1 and n_bytes < 7:
        n_bytes += 1
    # leading byte: n_bytes ones, a zero, then the top bits
    payload_bits = 6 * (n_bytes - 1)
    lead_data_bits = 7 - n_bytes
    lead = ((0xFF << (8 - n_bytes)) & 0xFF) | ((n >> payload_bits) & ((1 << lead_data_bits) - 1))
    out.append(lead)
    for i in range(n_bytes - 1):
        shift = payload_bits - 6 * (i + 1)
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


# ---------------------------------------------------------------------------
# vectorized subframe bit generation
# ---------------------------------------------------------------------------

def _bits_of(values: np.ndarray, width: int) -> np.ndarray:
    """Unsigned values -> flat MSB-first bit array [len(values)*width]."""
    v = values.astype(np.int64)[:, None]
    return ((v >> np.arange(width - 1, -1, -1)) & 1).astype(np.uint8).ravel()


def _rice_cost(u: np.ndarray) -> Tuple[int, int]:
    """Best 4-bit Rice parameter and total bit cost for zigzag values u."""
    best_k, best_cost = 0, None
    n = len(u)
    for k in range(15):
        cost = int((u >> k).sum()) + n * (k + 1)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
        elif cost > best_cost * 2:
            break
    return best_k, best_cost


def _rice_bits(u: np.ndarray, k: int) -> np.ndarray:
    """Rice-code zigzag values: q zeros, a 1, then k remainder bits each."""
    q = (u >> k).astype(np.int64)
    w = q + 1 + k
    off = np.cumsum(w) - w
    total = int(off[-1] + w[-1]) if len(u) else 0
    bits = np.zeros(total, np.uint8)
    bits[off + q] = 1
    if k:
        r = u & ((1 << k) - 1)
        pos = off + q + 1
        for j in range(k):
            bits[pos + j] = (r >> (k - 1 - j)) & 1
    return bits


_SUBFRAME_HDR = {
    "constant": 0b000000,
    "verbatim": 0b000001,
}


def _subframe_bits(col: np.ndarray, compress: bool) -> np.ndarray:
    """One channel of one block -> subframe bit array (header included)."""
    bs = len(col)
    c64 = col.astype(np.int64)

    def hdr(type_code: int) -> np.ndarray:
        h = np.zeros(8, np.uint8)
        for j in range(6):
            h[1 + j] = (type_code >> (5 - j)) & 1
        return h  # [pad=0, type(6), wasted=0]

    if compress and bs > 8:
        if (c64 == c64[0]).all():
            return np.concatenate([hdr(0b000000), _bits_of(c64[:1] & 0xFFFF, 16)])
        # candidate fixed predictors, order 0-4
        best = None  # (cost, order, k, u, warmup)
        res = c64
        for order in range(5):
            if order > 0:
                res = np.diff(res)
            u = np.where(res >= 0, res << 1, (-res << 1) - 1).astype(np.int64)
            k, cost = _rice_cost(u)
            cost += order * 16 + 2 + 4 + 4
            if best is None or cost < best[0]:
                best = (cost, order, k, u, c64[:order])
        if best[0] < 16 * bs:
            _, order, k, u, warmup = best
            parts = [hdr(0b001000 | order)]
            if order:
                parts.append(_bits_of(warmup & 0xFFFF, 16))
            # residual: coding method 00 (4-bit rice), partition order 0, param
            tail = np.zeros(2 + 4 + 4, np.uint8)
            for j in range(4):
                tail[2 + j] = 0
                tail[6 + j] = (k >> (3 - j)) & 1
            parts.append(tail)
            parts.append(_rice_bits(u, k))
            return np.concatenate(parts)

    return np.concatenate([hdr(0b000001), _bits_of(c64 & 0xFFFF, 16)])


def encode_flac(audio: np.ndarray, sample_rate: int = 48000,
                compress: bool = True) -> bytes:
    """[L, C] float in [-1, 1] (or int16) -> FLAC bytes (16-bit)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    if audio.dtype != np.int16:
        pcm = np.round(np.clip(audio.astype(np.float64), -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        pcm = audio
    n, ch = pcm.shape
    assert 1 <= ch <= 8

    md5 = hashlib.md5(pcm.astype("<i2").tobytes()).digest()

    # STREAMINFO (34 bytes)
    si = _BitWriter()
    si.write(min(BLOCK, max(n, 16)), 16)      # min blocksize
    si.write(BLOCK if n > BLOCK else max(n, 16), 16)  # max blocksize
    si.write(0, 24)                           # min framesize unknown
    si.write(0, 24)                           # max framesize unknown
    si.write(sample_rate, 20)
    si.write(ch - 1, 3)
    si.write(16 - 1, 5)
    si.write(n, 36)
    si.align()
    streaminfo = si.bytes() + md5

    out = bytearray(b"fLaC")
    out += bytes([0x80 | 0x00])               # last-metadata-block, type 0
    out += struct.pack(">I", len(streaminfo))[1:]
    out += streaminfo

    frames: List[bytes] = []
    frame_idx = 0
    pos = 0
    while pos < n:
        bs = min(BLOCK, n - pos)
        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)                 # sync
        hdr.write(0, 1)                       # reserved
        hdr.write(0, 1)                       # fixed blocksize strategy
        hdr.write(0b0111, 4)                  # blocksize: 16-bit at end of header
        hdr.write(0b0000, 4)                  # sample rate: from STREAMINFO
        hdr.write(ch - 1, 4)                  # independent channels
        hdr.write(0b100, 3)                   # 16 bits/sample
        hdr.write(0, 1)                       # reserved
        hdr.align()
        head = hdr.bytes() + _utf8_coded(frame_idx) + struct.pack(">H", bs - 1)
        head += bytes([_crc8(head)])

        blk = pcm[pos:pos + bs]
        body_bits = np.concatenate(
            [_subframe_bits(blk[:, c], compress) for c in range(ch)]
        )
        pad = (-len(body_bits)) % 8
        if pad:
            body_bits = np.concatenate([body_bits, np.zeros(pad, np.uint8)])
        frames.append(head + np.packbits(body_bits).tobytes())
        frame_idx += 1
        pos += bs

    crcs = _crc16_batch(frames)
    for f, crc in zip(frames, crcs):
        out += f
        out += struct.pack(">H", int(crc))
    return bytes(out)


def write_flac(path: str, audio: np.ndarray, sample_rate: int = 48000) -> None:
    with open(path, "wb") as f:
        f.write(encode_flac(audio, sample_rate))


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            b = (self.data[self.byte] >> (7 - self.bit)) & 1
            v = (v << 1) | b
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def read_unary(self) -> int:
        """Count zeros up to and including the terminating 1 bit."""
        q = 0
        data = self.data
        while True:
            cur = data[self.byte] & (0xFF >> self.bit)
            if cur:
                # highest set bit within the remaining bits of this byte
                top = 7 - cur.bit_length() + 1
                q += top - self.bit
                self.bit = top + 1
                if self.bit == 8:
                    self.bit = 0
                    self.byte += 1
                return q
            q += 8 - self.bit
            self.bit = 0
            self.byte += 1

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1


_FIXED_UNDIFF = True


def _read_subframe(r: _BitReader, bs: int) -> np.ndarray:
    pad = r.read(1)
    assert pad == 0, "bad subframe pad bit"
    st = r.read(6)
    r.read(1)                                # wasted bits (never emitted)
    if st == 0b000000:                       # CONSTANT
        v = r.read(16)
        v = v - 65536 if v >= 32768 else v
        return np.full(bs, v, np.int64)
    if st == 0b000001:                       # VERBATIM
        out = np.empty(bs, np.int64)
        for i in range(bs):
            v = r.read(16)
            out[i] = v - 65536 if v >= 32768 else v
        return out
    assert st & 0b111000 == 0b001000, f"unsupported subframe type {st:06b}"
    order = st & 0b000111
    warmup = np.empty(order, np.int64)
    for i in range(order):
        v = r.read(16)
        warmup[i] = v - 65536 if v >= 32768 else v
    method = r.read(2)
    assert method == 0, "only 4-bit rice partitions supported"
    porder = r.read(4)
    assert porder == 0, "only partition order 0 supported"
    k = r.read(4)
    assert k != 0b1111, "escape partitions not supported"
    nres = bs - order
    res = np.empty(nres, np.int64)
    for i in range(nres):
        q = r.read_unary()
        u = (q << k) | (r.read(k) if k else 0)
        res[i] = (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)
    # integrate the fixed predictor: d^j[n] = d^j[j] + sum d^(j+1)[j+1..n];
    # each level prepends exactly one warmup-derived value
    cur = res
    for j in range(order - 1, -1, -1):
        init = int(np.diff(warmup, n=j)[0])  # d^j[j]
        cur = np.concatenate([[init], init + np.cumsum(cur)])
    return cur


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream produced by encode_flac (constant / fixed /
    verbatim subframes) -> ([L, C] float32 in [-1, 1], sample_rate)."""
    assert data[:4] == b"fLaC", "not a FLAC stream"
    pos = 4
    sample_rate = ch = bps = total = None
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        if btype == 0:
            r = _BitReader(data, pos + 4)
            r.read(16); r.read(16); r.read(24); r.read(24)
            sample_rate = r.read(20)
            ch = r.read(3) + 1
            bps = r.read(5) + 1
            total = r.read(36)
        pos += 4 + size
        if last:
            break
    assert bps == 16, "decoder supports 16-bit only"

    out = np.zeros((total, ch), np.int16)
    got = 0
    while got < total and pos < len(data):
        r = _BitReader(data, pos)
        sync = r.read(14)
        assert sync == 0x3FFE, f"bad frame sync at {pos}"
        r.read(2)
        bs_code = r.read(4)
        r.read(4)                       # sample-rate code
        r.read(4)                       # channel assignment
        r.read(3); r.read(1)
        # frame number (utf8-coded)
        first = r.read(8)
        extra = 0
        m = first
        while m & 0x80 and (m & 0xC0) != 0x80:
            lead_ones = 0
            mm = first
            while mm & 0x80:
                lead_ones += 1
                mm = (mm << 1) & 0xFF
            extra = lead_ones - 1
            break
        for _ in range(extra):
            r.read(8)
        if bs_code == 0b0111:
            bs = r.read(16) + 1
        elif bs_code == 0b0110:
            bs = r.read(8) + 1
        else:
            bs = {1: 192}.get(bs_code, 4096)
        r.read(8)                       # crc8
        for c in range(ch):
            out[got:got + bs, c] = _read_subframe(r, bs).astype(np.int16)
        r.align()
        pos = r.byte + 2                # frame crc16
        got += bs
    return out.astype(np.float32) / 32767.0, sample_rate
