"""Huffman encoding-table construction from symbol frequencies.

Capability parity with the reference builder
(yigolden/JpegLibrary/src/JpegLibrary/JpegHuffmanEncodingTableBuilder.cs:62-494):
two algorithms selected by ``optimal`` —

- the ITU-T T.81 Annex K standard method (Figures K.1-K.4 incl. the
  16-bit length limiting and the reserved all-ones code point via a
  dummy symbol), and
- optimal length-limited coding via package-merge.

Both produce (code_lengths[16], values-in-code-order) ready for DHT
serialization. Frequencies are plain arrays so they can be produced by
device-side histogram reductions (psum across a mesh) and summed on
host.
"""

from __future__ import annotations

import numpy as np

from ..syntax.huffman import HuffmanEncodingTable

_DUMMY = 256  # reserved symbol guaranteeing the all-ones code is unused


class HuffmanTableBuilder:
    """Frequency accumulator + table construction."""

    def __init__(self):
        self.frequencies = np.zeros(256, dtype=np.int64)

    def increment(self, symbol: int, count: int = 1) -> None:
        self.frequencies[symbol] += count

    def add_frequencies(self, freqs) -> None:
        self.frequencies += np.asarray(freqs, dtype=np.int64)

    def reset(self) -> None:
        self.frequencies[:] = 0

    def build(self, optimal: bool = False) -> HuffmanEncodingTable:
        present = np.nonzero(self.frequencies)[0]
        if len(present) == 0:
            raise ValueError("No symbol is recorded.")
        if optimal:
            lengths = _package_merge_lengths(self.frequencies)
        else:
            lengths = _standard_lengths(self.frequencies)
        return _canonical_table(lengths)


def _standard_lengths(frequencies: np.ndarray) -> dict:
    """Annex K standard method: Figure K.1 code sizes, K.2 counts, K.3
    16-bit limiting, K.4 assignment. Returns {symbol: length}."""
    freq = {int(s): int(frequencies[s]) for s in np.nonzero(frequencies)[0]}
    work = dict(freq)
    work[_DUMMY] = 1  # reserve a code point (reference :103-109)

    codesize = {s: 0 for s in work}
    others = {s: None for s in work}

    # Figure K.1: repeatedly merge the two least-frequent trees.
    active = dict(work)
    while len(active) > 1:
        # v1: least frequency (ties -> smallest symbol, then v2 next least)
        v1 = min(active, key=lambda s: (active[s], s))
        rest = {s: f for s, f in active.items() if s != v1}
        v2 = min(rest, key=lambda s: (rest[s], s))
        active[v1] += active[v2]
        del active[v2]
        codesize[v1] += 1
        t = v1
        while others[t] is not None:
            t = others[t]
            codesize[t] += 1
        others[t] = v2
        codesize[v2] += 1
        t = v2
        while others[t] is not None:
            t = others[t]
            codesize[t] += 1

    # Figure K.2: counts per size.
    max_size = max(codesize.values())
    bits = [0] * (max(33, max_size + 1))
    for s, size in codesize.items():
        bits[size] += 1

    # Figure K.3: limit to 16 bits.
    for i in range(len(bits) - 1, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # remove the reserved code point

    # Figure K.4: symbols in increasing-code-size order get the limited
    # lengths in order.
    order = sorted(freq, key=lambda s: (codesize[s], s))
    expanded = []
    for length in range(1, 17):
        expanded.extend([length] * bits[length])
    assert len(expanded) == len(order)
    return {s: l for s, l in zip(order, expanded)}


def _package_merge_lengths(frequencies: np.ndarray, limit: int = 16) -> dict:
    """Optimal length-limited code lengths via package-merge
    (reference RunPackageMerge, :347-413). Returns {symbol: length}."""
    items = [(int(frequencies[s]), int(s)) for s in np.nonzero(frequencies)[0]]
    items.append((0, _DUMMY))
    n = len(items)
    lengths = {s: 0 for _, s in items}
    if n == 1:
        lengths[items[0][1]] = 1
        return {s: l for s, l in lengths.items() if s != _DUMMY}

    # leaf = (freq, symbol); package = (freq, [children...])
    leaves = sorted((f, s) for f, s in items)

    def merge_level(packages):
        """One package-merge step: package pairs of the current level,
        merge with the fresh leaf list for the next level up."""
        paired = []
        srt = sorted(packages, key=lambda node: node[0])
        for i in range(0, len(srt) - 1, 2):
            a, b = srt[i], srt[i + 1]
            paired.append((a[0] + b[0], (a, b)))
        merged = sorted(
            [(f, s) for f, s in leaves] + paired, key=lambda node: node[0]
        )
        return merged

    level = [(f, s) for f, s in leaves]
    for _ in range(limit - 1):
        level = merge_level(level)

    select = max(1, 2 * (n - 1))

    def count(node):
        payload = node[1]
        if isinstance(payload, tuple):
            count(payload[0])
            count(payload[1])
        else:
            lengths[payload] += 1

    for node in level[:select]:
        count(node)

    assert max(lengths.values()) <= limit
    return {s: l for s, l in lengths.items() if s != _DUMMY and l > 0}


def _canonical_table(lengths: dict) -> HuffmanEncodingTable:
    """Canonical code assignment from {symbol: length}, DHT-ready."""
    code_lengths = np.zeros(16, dtype=np.uint8)
    order = sorted(lengths, key=lambda s: (lengths[s], s))
    values = np.asarray(order, dtype=np.uint8)
    for s in order:
        code_lengths[lengths[s] - 1] += 1
    return HuffmanEncodingTable.build(code_lengths, values)
