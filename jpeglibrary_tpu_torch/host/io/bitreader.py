"""Sequential MSB-first bit reader over *unstuffed* entropy bytes.

Behavioral parity with the reference bit reader
(yigolden/JpegLibrary/src/JpegLibrary/JpegBitReader.cs:95-218):

- Peeks past end-of-data are padded with 1-bits (JpegBitReader.cs:157-172),
  which is what lets truncated streams decode the reference way.
- Advancing consumes at most the bits that exist; reads that would cross
  the end fail (TryReadBits semantics).

This is the host *reference* implementation used for correctness
testing and as the semantic spec for the native scanner
(jpeglibrary_tpu_torch/host/native) and device kernels. It operates on bytes that
were already 0xFF00-unstuffed and split at markers by
``jpeglibrary_tpu_torch.host.io.reader`` — the stateful marker handling of the
reference collapses into the static span structure.
"""

from __future__ import annotations


class MarkerEncountered(Exception):
    """Raised where the reference reports isMarkerEncountered=true."""


class EndOfStream(Exception):
    """Raised where the reference reports a premature end of bits."""


class BitReader:
    __slots__ = ("_data", "_nbits", "_pos", "ends_at_marker")

    def __init__(self, data: bytes, *, ends_at_marker: bool = True):
        self._data = data
        self._nbits = 8 * len(data)
        self._pos = 0  # bit position
        #: whether the span terminates at a marker (vs raw EOF)
        self.ends_at_marker = ends_at_marker

    @property
    def bit_position(self) -> int:
        return self._pos

    @property
    def remaining_bits(self) -> int:
        return max(0, self._nbits - self._pos)

    def peek_bits(self, length: int) -> tuple[int, int]:
        """Peek up to ``length`` bits, 1-padded past the end.

        Returns (bits, bits_actually_available) like PeekBits'
        (value, bitsPeeked) pair.
        """
        pos = self._pos
        byte_idx = pos >> 3
        bit_off = pos & 7
        # Grab enough bytes to cover length+7 bits, padded with 0xFF.
        need = (bit_off + length + 7) >> 3
        chunk = self._data[byte_idx : byte_idx + need]
        if len(chunk) < need:
            chunk = chunk + b"\xff" * (need - len(chunk))
        window = int.from_bytes(chunk, "big")
        total = 8 * need
        bits = (window >> (total - bit_off - length)) & ((1 << length) - 1)
        available = min(length, max(0, self._nbits - pos))
        return bits, available

    def advance(self, length: int) -> None:
        """Consume bits (clamped to what exists, mirroring
        bitsRead = min(codeSize, bitsPeeked) at the call sites)."""
        self._pos = min(self._pos + length, self._nbits)

    def read_bits(self, length: int) -> int:
        """Read exactly ``length`` bits or raise (TryReadBits semantics)."""
        if self._pos + length > self._nbits:
            # isMarkerEncountered is only true when *zero* bits remain and
            # the span ends at a marker (JpegBitReader.cs:208-216).
            at_marker = self._pos >= self._nbits and self.ends_at_marker
            self._pos = self._nbits
            if at_marker:
                raise MarkerEncountered()
            raise EndOfStream()
        bits, _ = self.peek_bits(length)
        self._pos += length
        return bits

    def try_read_bits(self, length: int) -> int:
        """Read ``length`` bits, or return 0 without consuming anything
        when not enough real bits remain — the out-value semantics of
        TryReadBits (JpegBitReader.cs:190-206) that the arithmetic
        decoder relies on for zero-padding past the data end."""
        if self._pos + length > self._nbits:
            return 0
        bits, _ = self.peek_bits(length)
        self._pos += length
        return bits

    def align_to_byte(self) -> None:
        self._pos = (self._pos + 7) & ~7
