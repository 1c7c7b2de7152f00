"""Huffman tables: DHT parse, canonical code generation, and the
two-level decode LUT (8-bit lookahead + maxcode/valoffset slow path).

Capability parity with the reference decoding table
(yigolden/JpegLibrary/src/JpegLibrary/JpegHuffmanDecodingTable.cs:122-390).
The LUT layout is kept as flat numpy arrays so the same tables can be
shipped to device memory for gather-based decoding kernels, and to the
native scanner via ctypes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


class JpegHuffmanError(ValueError):
    pass


def generate_size_table(code_lengths: np.ndarray) -> np.ndarray:
    """T.81 Figure C.1: per-symbol code sizes from the 16 length counts."""
    sizes = []
    for i in range(1, 17):
        sizes.extend([i] * int(code_lengths[i - 1]))
    return np.asarray(sizes, dtype=np.uint8)


def generate_code_table(huff_size: np.ndarray) -> np.ndarray:
    """T.81 Figure C.2: canonical codes for each symbol, given sizes.

    Rejects code counts that violate the Kraft prefix condition (the
    canonical code would need more bits than its declared length —
    fuzz-found as a raw uint16 OverflowError; the native table builder
    already validates this, scanner.cpp build_hufftable)."""
    codes = np.zeros(len(huff_size), dtype=np.uint16)
    code = 0
    si = int(huff_size[0]) if len(huff_size) else 0
    for k in range(len(huff_size)):
        while int(huff_size[k]) != si:
            code <<= 1
            si += 1
        if code >= (1 << si):
            raise JpegHuffmanError(
                "Invalid Huffman table: code counts violate the prefix "
                "condition."
            )
        codes[k] = code
        code += 1
    return codes


@dataclasses.dataclass(eq=False)  # identity hash: pack_huffman_table caches by object
class HuffmanDecodingTable:
    """Decode-side Huffman table with a two-level lookup structure.

    - ``lookahead_size``/``lookahead_value``: 256-entry 8-bit-prefix LUT
      (size 0 means "longer than 8 bits, use the slow path").
    - ``maxcode``: per-length largest code, left-justified in 16 bits and
      1-filled (index 1..16; 17 is a 0xFFFF sentinel).
    - ``valoffset``: per-length value-array offset (mod 256).
    - ``values``: the symbol values, in code order (padded to 256).

    Mirrors JpegHuffmanDecodingTable.Configure/Lookup
    (JpegHuffmanDecodingTable.cs:88-113, :339-390).
    """

    table_class: int  # 0 = DC, 1 = AC
    identifier: int
    code_lengths: np.ndarray  # uint8[16]
    values: np.ndarray  # uint8[256]
    maxcode: np.ndarray  # uint16[18]
    valoffset: np.ndarray  # uint8[19]
    lookahead_size: np.ndarray  # uint8[256]
    lookahead_value: np.ndarray  # uint8[256]

    @staticmethod
    def build(table_class: int, identifier: int, code_lengths, symbol_values) -> "HuffmanDecodingTable":
        code_lengths = np.asarray(code_lengths, dtype=np.uint8)
        symbol_values = np.asarray(symbol_values, dtype=np.uint8)
        if code_lengths.shape != (16,):
            raise JpegHuffmanError("code_lengths must have 16 entries.")
        code_count = int(code_lengths.sum())
        if code_count > 256:
            raise JpegHuffmanError("Huffman table has more than 256 codes.")
        if len(symbol_values) < code_count:
            raise JpegHuffmanError("Not enough symbol values for code counts.")
        symbol_values = symbol_values[:code_count]

        huff_size = generate_size_table(code_lengths)
        huff_code = generate_code_table(huff_size)

        values = np.zeros(256, dtype=np.uint8)
        values[:code_count] = symbol_values

        maxcode = np.zeros(18, dtype=np.uint16)
        valoffset = np.zeros(19, dtype=np.uint8)
        p = 0
        for length in range(1, 17):
            count = int(code_lengths[length - 1])
            if count != 0:
                # valoffset[l] = p - huffCode[p]  (mod 256, like the byte field)
                valoffset[length] = (p - int(huff_code[p])) & 0xFF
                p += count
                mc = int(huff_code[p - 1]) << (16 - length)
                mc |= (1 << (16 - length)) - 1
                maxcode[length] = mc & 0xFFFF
            else:
                maxcode[length] = 0
        maxcode[17] = 0xFFFF
        valoffset[18] = 0

        lookahead_size = np.zeros(256, dtype=np.uint8)
        lookahead_value = np.zeros(256, dtype=np.uint8)
        p = 0
        for length in range(1, 9):
            for _ in range(int(code_lengths[length - 1])):
                free_bits = 8 - length
                base = (int(huff_code[p]) << free_bits) & 0xFF
                span = 1 << free_bits
                lookahead_size[base : base + span] = length
                lookahead_value[base : base + span] = values[p]
                p += 1

        return HuffmanDecodingTable(
            table_class=table_class,
            identifier=identifier,
            code_lengths=code_lengths,
            values=values,
            maxcode=maxcode,
            valoffset=valoffset,
            lookahead_size=lookahead_size,
            lookahead_value=lookahead_value,
        )

    def lookup(self, code16: int) -> Tuple[int, int]:
        """Decode the next symbol from 16 lookahead bits.

        Returns (code_size, symbol_value). Mirrors
        JpegHuffmanDecodingTable.Lookup/LookupSlow.
        """
        high8 = (code16 >> 8) & 0xFF
        size = int(self.lookahead_size[high8])
        if size != 0:
            return size, int(self.lookahead_value[high8])
        size = 9
        while code16 > int(self.maxcode[size]):
            size += 1
        if size > 16:
            raise JpegHuffmanError("Invalid Huffman code encountered.")
        code = code16 >> (16 - size)
        return size, int(self.values[(int(self.valoffset[size]) + code) & 0xFF])


def parse_dht_segment(payload: bytes) -> List[HuffmanDecodingTable]:
    """Parse all Huffman tables in one DHT segment (T.81 B.2.4.2)."""
    tables = []
    off = 0
    n = len(payload)
    while off < n:
        tc_th = payload[off]
        table_class = tc_th >> 4
        identifier = tc_th & 0xF
        off += 1
        if off + 16 > n:
            raise JpegHuffmanError("DHT segment truncated (length counts).")
        code_lengths = np.frombuffer(payload, dtype=np.uint8, count=16, offset=off)
        off += 16
        code_count = int(code_lengths.sum())
        if off + code_count > n:
            raise JpegHuffmanError("DHT segment truncated (symbol values).")
        symbol_values = np.frombuffer(payload, dtype=np.uint8, count=code_count, offset=off)
        off += code_count
        tables.append(
            HuffmanDecodingTable.build(table_class, identifier, code_lengths, symbol_values)
        )
    return tables


@dataclasses.dataclass(frozen=True)
class HuffmanEncodingTable:
    """Encode-side Huffman table: symbol -> (code, length) maps.

    Mirrors JpegHuffmanEncodingTable (JpegHuffmanEncodingTable.cs:50-102).
    ``code_lengths``/``symbol_values`` keep the DHT wire form for
    serialization.
    """

    code_lengths: np.ndarray  # uint8[16]
    symbol_values: np.ndarray  # uint8[n]
    codes: np.ndarray  # uint16[256], indexed by symbol
    sizes: np.ndarray  # uint8[256], indexed by symbol (0 = absent)

    @staticmethod
    def build(code_lengths, symbol_values) -> "HuffmanEncodingTable":
        code_lengths = np.asarray(code_lengths, dtype=np.uint8)
        symbol_values = np.asarray(symbol_values, dtype=np.uint8)
        huff_size = generate_size_table(code_lengths)
        huff_code = generate_code_table(huff_size)
        codes = np.zeros(256, dtype=np.uint16)
        sizes = np.zeros(256, dtype=np.uint8)
        for k, symbol in enumerate(symbol_values):
            codes[int(symbol)] = huff_code[k]
            sizes[int(symbol)] = huff_size[k]
        return HuffmanEncodingTable(
            code_lengths=code_lengths,
            symbol_values=symbol_values,
            codes=codes,
            sizes=sizes,
        )

    def get_code(self, symbol: int) -> Tuple[int, int]:
        """Returns (code, length) for a symbol."""
        return int(self.codes[symbol]), int(self.sizes[symbol])

    def serialize(self, table_class: int, identifier: int) -> bytes:
        """DHT payload bytes for this table."""
        head = bytes([((table_class & 0xF) << 4) | (identifier & 0xF)])
        return head + self.code_lengths.tobytes() + self.symbol_values.tobytes()

    def to_decoding_table(self, table_class: int, identifier: int) -> HuffmanDecodingTable:
        return HuffmanDecodingTable.build(
            table_class, identifier, self.code_lengths, self.symbol_values
        )
