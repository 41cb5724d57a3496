"""Pure-Python FLAC decoder (a copy of the JAX package's ``data/flac.py``).

The decoder beside the native one (``native/audio/flac_decoder.cc``) for a
machine where the native library cannot load, and the oracle the native
decoder is held to in the tests. Covers STREAMINFO, frame headers with
UTF-8 coded numbers, constant / verbatim / fixed / LPC subframes, Rice
residual partitions (4- and 5-bit), wasted bits, stereo decorrelation and
CRC-8/CRC-16 verification.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

_BLOCKSIZE = [-1, 192, 576, 1152, 2304, 4608, -8, -16,
              256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_SAMPLERATE = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
               32000, 44100, 48000, 96000, -8, -16, -160, -1]
_BPS = [0, 8, 12, -1, 16, 20, 24, 32]


class FlacError(ValueError):
    pass


class _BitReader:
    __slots__ = ("data", "n", "byte", "bit")

    def __init__(self, data: bytes, start: int = 0):
        self.data = data
        self.n = len(data)
        self.byte = start
        self.bit = 0

    def read_bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            if self.byte >= self.n:
                raise FlacError("unexpected end of stream")
            v = (v << 1) | ((self.data[self.byte] >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def read_signed(self, k: int) -> int:
        if k == 0:
            return 0
        v = self.read_bits(k)
        return v - (1 << k) if v >> (k - 1) else v

    def read_unary(self) -> int:
        q = 0
        while True:
            if self.byte >= self.n:
                raise FlacError("unexpected end of stream")
            b = (self.data[self.byte] >> (7 - self.bit)) & 1
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
            if b:
                return q
            q += 1

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _read_coded_number(br: _BitReader) -> int:
    b0 = br.read_bits(8)
    if b0 & 0x80 == 0:
        return b0
    if b0 & 0xE0 == 0xC0:
        extra, v = 1, b0 & 0x1F
    elif b0 & 0xF0 == 0xE0:
        extra, v = 2, b0 & 0x0F
    elif b0 & 0xF8 == 0xF0:
        extra, v = 3, b0 & 0x07
    elif b0 & 0xFC == 0xF8:
        extra, v = 4, b0 & 0x03
    elif b0 & 0xFE == 0xFC:
        extra, v = 5, b0 & 0x01
    elif b0 == 0xFE:
        extra, v = 6, 0
    else:
        raise FlacError("bad coded number")
    for _ in range(extra):
        b = br.read_bits(8)
        if b & 0xC0 != 0x80:
            raise FlacError("bad coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


@dataclass
class StreamInfo:
    sample_rate: int
    channels: int
    bps: int
    total_samples: int
    frames_start: int


def parse_streaminfo(data: bytes) -> StreamInfo:
    if len(data) < 42 or data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    pos, last, si = 4, False, None
    while not last:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        last = bool(data[pos] & 0x80)
        btype = data[pos] & 0x7F
        blen = int.from_bytes(data[pos + 1 : pos + 4], "big")
        pos += 4
        if pos + blen > len(data):
            raise FlacError("truncated metadata block")
        if btype == 0:
            s = data[pos:]
            sr = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4)
            ch = ((s[12] >> 1) & 0x7) + 1
            bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1
            total = ((s[13] & 0x0F) << 32) | int.from_bytes(s[14:18], "big")
            si = StreamInfo(sr, ch, bps, total, 0)
        pos += blen
    if si is None:
        raise FlacError("no STREAMINFO")
    si.frames_start = pos
    return si


def _read_residual(br: _BitReader, order: int, blocksize: int) -> List[int]:
    method = br.read_bits(2)
    if method > 1:
        raise FlacError("bad residual method")
    pbits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    porder = br.read_bits(4)
    partitions = 1 << porder
    if blocksize % partitions:
        raise FlacError("bad partition order")
    psize = blocksize >> porder
    res: List[int] = []
    for p in range(partitions):
        count = psize - (order if p == 0 else 0)
        if count < 0:
            raise FlacError("bad partition size")
        param = br.read_bits(pbits)
        if param == escape:
            raw = br.read_bits(5)
            res.extend(br.read_signed(raw) if raw else 0 for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                r = br.read_bits(param) if param else 0
                u = (q << param) | r
                res.append(-(u >> 1) - 1 if u & 1 else u >> 1)
    return res


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> List[int]:
    if br.read_bits(1):
        raise FlacError("bad subframe padding bit")
    stype = br.read_bits(6)
    wasted = br.read_unary() + 1 if br.read_bits(1) else 0
    eff = bps - wasted
    if eff <= 0:
        raise FlacError("bad effective bps")

    if stype == 0:  # CONSTANT
        out = [br.read_signed(eff)] * blocksize
    elif stype == 1:  # VERBATIM
        out = [br.read_signed(eff) for _ in range(blocksize)]
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        out = [br.read_signed(eff) for _ in range(order)]
        out += _read_residual(br, order, blocksize)
        for i in range(order, blocksize):
            if order == 1:
                out[i] += out[i - 1]
            elif order == 2:
                out[i] += 2 * out[i - 1] - out[i - 2]
            elif order == 3:
                out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]
            elif order == 4:
                out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]
    elif stype >= 32:  # LPC
        order = (stype & 31) + 1
        out = [br.read_signed(eff) for _ in range(order)]
        prec = br.read_bits(4)
        if prec == 15:
            raise FlacError("bad LPC precision")
        precision = prec + 1
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coef = [br.read_signed(precision) for _ in range(order)]
        out += _read_residual(br, order, blocksize)
        for i in range(order, blocksize):
            acc = sum(coef[j] * out[i - 1 - j] for j in range(order))
            out[i] += acc >> shift
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        out = [v << wasted for v in out]
    return out


def decode_f32_mono(data: bytes) -> np.ndarray:
    """Decode a whole FLAC stream to float32 mono (channel mean, [-1, 1))."""
    si = parse_streaminfo(data)
    br = _BitReader(data, si.frames_start)
    scale = 1.0 / (1 << (si.bps - 1))
    blocks: List[np.ndarray] = []

    while br.byte < len(data):
        frame_start = br.byte
        try:
            sync = br.read_bits(14)
        except FlacError:
            break  # trailing padding
        if sync != 0x3FFE:
            raise FlacError("lost frame sync")
        if br.read_bits(1):
            raise FlacError("bad reserved bit")
        br.read_bits(1)  # blocking strategy
        bs_code = br.read_bits(4)
        sr_code = br.read_bits(4)
        ch_code = br.read_bits(4)
        ss_code = br.read_bits(3)
        if br.read_bits(1):
            raise FlacError("bad reserved bit")
        _read_coded_number(br)

        c = _BLOCKSIZE[bs_code]
        if c == -1:
            raise FlacError("bad blocksize code")
        blocksize = br.read_bits(8) + 1 if c == -8 else br.read_bits(16) + 1 if c == -16 else c

        c = _SAMPLERATE[sr_code]
        if c == -1:
            raise FlacError("bad samplerate code")
        if c == -8:
            br.read_bits(8)
        elif c in (-16, -160):
            br.read_bits(16)

        bps = _BPS[ss_code]
        if bps == -1:
            raise FlacError("bad sample size code")
        bps = bps or si.bps

        br.align()
        if _crc8(data[frame_start : br.byte]) != br.read_bits(8):
            raise FlacError("frame header CRC-8 mismatch")

        if ch_code < 8:
            channels = ch_code + 1
        elif ch_code <= 10:
            channels = 2
        else:
            raise FlacError("bad channel assignment")

        chan = []
        for ch in range(channels):
            sub_bps = bps + (
                1 if (ch_code == 8 and ch == 1) or (ch_code == 9 and ch == 0)
                or (ch_code == 10 and ch == 1) else 0
            )
            chan.append(_decode_subframe(br, blocksize, sub_bps))

        if ch_code == 8:  # left/side
            chan[1] = [l - s for l, s in zip(chan[0], chan[1])]
        elif ch_code == 9:  # side/right
            chan[0] = [s + r for s, r in zip(chan[0], chan[1])]
        elif ch_code == 10:  # mid/side
            for i in range(blocksize):
                side = chan[1][i]
                mid = (chan[0][i] << 1) | (side & 1)
                chan[0][i] = (mid + side) >> 1
                chan[1][i] = (mid - side) >> 1

        br.align()
        if _crc16(data[frame_start : br.byte]) != br.read_bits(16):
            raise FlacError("frame CRC-16 mismatch")

        arr = np.asarray(chan, np.float64)
        blocks.append((scale * arr.mean(axis=0)).astype(np.float32))

    if not blocks:
        return np.zeros((0,), np.float32)
    return np.concatenate(blocks)
