"""JPEG output writer: marker/segment byte emission plus the entropy
bit mode with 0xFF stuffing.

Capability parity with the reference writer
(yigolden/JpegLibrary/src/JpegLibrary/JpegWriter.cs:13-324): byte mode writes
markers and length-prefixed segments; bit mode packs MSB-first codes,
stuffs 0x00 after every 0xFF data byte (FlushRegister,
JpegWriter.cs:104-128), and pads the final partial byte with 1-bits on
exit (ExitBitMode, JpegWriter.cs:141-167).
"""

from __future__ import annotations




class JpegWriter:
    # Payloads at least this large are kept as zero-copy chunks and
    # joined once in to_bytes() instead of being copied into the
    # working bytearray (a multi-MB entropy blob otherwise gets copied
    # twice: into _out, then again by to_bytes()).
    _CHUNK_THRESHOLD = 1 << 16

    def __init__(self):
        self._chunks = []  # closed zero-copy segments (bytes/memoryview)
        self._out = bytearray()  # open tail being appended to
        self._register = 0  # bits accumulated MSB-first, right-justified
        self._bit_count = 0
        self._bit_mode = False

    # -- byte mode --

    def write_marker(self, marker: int) -> None:
        self._out += bytes([0xFF, marker])

    def write_length(self, payload_length: int) -> None:
        """Length field = payload bytes + 2 (the field itself)."""
        value = payload_length + 2
        self._out += bytes([(value >> 8) & 0xFF, value & 0xFF])

    def write_bytes(self, data) -> None:
        if len(data) >= self._CHUNK_THRESHOLD:
            if self._out:
                self._chunks.append(self._out)
                self._out = bytearray()
            self._chunks.append(data)
        else:
            self._out += data

    def write_segment(self, marker: int, payload: bytes) -> None:
        self.write_marker(marker)
        self.write_length(len(payload))
        self.write_bytes(payload)

    # -- bit mode --

    def enter_bit_mode(self) -> None:
        self._bit_mode = True
        self._register = 0
        self._bit_count = 0

    def write_bits(self, value: int, length: int) -> None:
        """Append `length` bits (MSB-first), flushing whole bytes with
        0xFF -> 0xFF 0x00 stuffing."""
        if length == 0:
            return
        self._register = (self._register << length) | (value & ((1 << length) - 1))
        self._bit_count += length
        while self._bit_count >= 8:
            self._bit_count -= 8
            b = (self._register >> self._bit_count) & 0xFF
            self._out.append(b)
            if b == 0xFF:
                self._out.append(0x00)
        self._register &= (1 << self._bit_count) - 1

    def exit_bit_mode(self) -> None:
        """Pad the final partial byte with 1-bits (JpegWriter.cs:141-167)."""
        if self._bit_count > 0:
            pad = 8 - self._bit_count
            self.write_bits((1 << pad) - 1, pad)
        self._bit_mode = False

    # -- output --

    def to_bytes(self) -> bytes:
        if not self._chunks:
            return bytes(self._out)
        return b"".join(self._chunks + [self._out])

    def __len__(self) -> int:
        return sum(len(c) for c in self._chunks) + len(self._out)
