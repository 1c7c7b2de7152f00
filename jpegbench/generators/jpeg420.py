"""The decode cells' inputs, copied from the repository's ``chip_smoke.py``
(``synth_image`` and its numpy baseline 4:2:0 encoder ``encode_420``), so
that the benchmark makes its JPEG streams with no import of the program's
scripts: a smooth colour gradient with noise, and ITU-T T.81 Annex K
quantisation (IJG quality scaling) and Huffman tables K.3-K.6, the AC
tables' 16-bit codes taking the symbols left over in ascending order."""

from __future__ import annotations

import numpy as np

from ..reference.tables import CHROMA_Q, DCT, LUMA_Q, ZIGZAG


def synth_image(seed, size):
    """A smooth colour gradient plus Gaussian noise, one seed per image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = np.stack(
        [255 * xx / size, 255 * yy / size, 127.5 + 100 * np.sin(xx / 97 + yy / 61 + seed)], -1
    )
    return np.clip(base + rng.normal(0, 16, (size, size, 3)), 0, 255).astype(np.uint8)


AC_SYMBOLS = [0x00, 0xF0] + [run << 4 | size for run in range(16) for size in range(1, 11)]


def ac_symbols(head):
    """An AC table's symbols: those with codes shorter than 16 bits, then the rest."""
    return head + sorted(set(AC_SYMBOLS) - set(head))


HUFFMAN = {  # (class, table id): (code counts by length 1..16, symbols in code order)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], ac_symbols([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13,
        0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42,
        0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82])),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], ac_symbols([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51,
        0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1,
        0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24,
        0x34, 0xE1, 0x25, 0xF1])),
}


def huffman_codes(counts, symbols):
    """Canonical codes: (code, length) arrays indexed by symbol."""
    if not sum(counts) == len(symbols) == len(set(symbols)):
        raise ValueError("malformed Huffman table")
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    next_code, k = 0, 0
    for n_bits, count in enumerate(counts, 1):
        for _ in range(count):
            code[symbols[k]], length[symbols[k]] = next_code, n_bits
            next_code, k = next_code + 1, k + 1
        next_code <<= 1
    return code, length


def magnitude_bits(v):
    """The size category of each value and its amplitude bits (T.81 F.1.2.1)."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return size, np.where(v >= 0, v, v + (np.int64(1) << size) - 1)


def pack_bits(values, lengths):
    """Concatenate the codes MSB first, pad with 1 bits, stuff 0x00 after 0xFF."""
    item = np.repeat(np.arange(len(values)), lengths)
    last_bit = np.cumsum(lengths) - 1
    bits = (values[item] >> (last_bit[item] - np.arange(len(item)))) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    return np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0).tobytes()


def quantised_planes(rgb, quality):
    """The Y, Cb and Cr planes of quantised zig-zag blocks ([Hb, Wb, 64]
    each) of an ``[H, W, 3]`` uint8 image whose sides are multiples of
    16, and the two quant tables (natural order): JFIF YCbCr, 2x2 mean
    chroma subsampling, float DCT, Annex K tables at IJG ``quality``."""
    h, w, _ = rgb.shape
    if h % 16 or w % 16:
        raise ValueError(f"{h}x{w} is not a multiple of 16")
    r, g, b = np.moveaxis(rgb.astype(np.float64), -1, 0)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    cb, cr = (c.reshape(h // 2, 2, w // 2, 2).mean((1, 3)) for c in (cb, cr))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    quants = [np.clip((q * scale + 50) // 100, 1, 255) for q in (LUMA_Q, CHROMA_Q)]

    def blocks(plane, quant):
        hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
        tiles = (plane - 128).reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,hwxy,vy->hwuv", DCT, tiles, DCT).reshape(hb, wb, 64)
        return np.rint(coef / quant).astype(np.int64)[..., ZIGZAG]

    return [blocks(y, quants[0]), blocks(cb, quants[1]), blocks(cr, quants[1])], quants


def encode_420(rgb, quality=75):
    """Baseline sequential JPEG, 4:2:0, of :func:`quantised_planes`."""
    h, w, _ = rgb.shape
    (y, cb, cr), quants = quantised_planes(rgb, quality)
    mh, mw = h // 16, w // 16
    mcus = np.concatenate([
        y.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh * mw, 4, 64),
        cb.reshape(mh * mw, 1, 64),
        cr.reshape(mh * mw, 1, 64),
    ], 1).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], mh * mw)
    table = np.minimum(comp, 1)
    codes = {key: huffman_codes(*spec) for key, spec in HUFFMAN.items()}
    dc_code, dc_len = (np.stack([codes[0, t][i] for t in (0, 1)]) for i in (0, 1))
    ac_code, ac_len = (np.stack([codes[1, t][i] for t in (0, 1)]) for i in (0, 1))

    # DC: the difference from the previous block of the same component.
    n = len(mcus)
    diff = np.empty(n, np.int64)
    for c in range(3):
        diff[comp == c] = np.diff(mcus[comp == c, 0], prepend=0)
    size, amp = magnitude_bits(diff)
    parts = [(np.arange(n) * 65, (dc_code[table, size] << size) | amp,
              dc_len[table, size] + size)]

    # AC: a (run, size) symbol per non-zero coefficient, each after one
    # ZRL per 16 zeros of its run; EOB where the block's tail is zero.
    blk, k = np.nonzero(mcus[:, 1:])
    zz = k + 1
    first_in_block = np.r_[True, blk[1:] != blk[:-1]]
    run = zz - np.where(first_in_block, 0, np.r_[0, zz[:-1]]) - 1
    size, amp = magnitude_bits(mcus[blk, zz])
    t = table[blk]
    sym = (run & 15) << 4 | size
    sym_code = (ac_code[t, sym] << size) | amp
    sym_len = ac_len[t, sym] + size
    reps = (run >> 4) + 1
    src = np.repeat(np.arange(len(zz)), reps)
    is_sym = np.arange(len(src)) - np.repeat(np.cumsum(reps) - reps, reps) == reps[src] - 1
    parts.append((blk[src] * 65 + zz[src],
                  np.where(is_sym, sym_code[src], ac_code[t[src], 0xF0]),
                  np.where(is_sym, sym_len[src], ac_len[t[src], 0xF0])))
    last = np.zeros(n, np.int64)
    block_end = np.r_[first_in_block[1:], True]
    last[blk[block_end]] = zz[block_end]
    eob = np.nonzero(last < 63)[0]
    parts.append((eob * 65 + 64, ac_code[table[eob], 0x00], ac_len[table[eob], 0x00]))

    keys, values, lengths = (np.concatenate(p) for p in zip(*parts))
    order = np.argsort(keys, kind="stable")
    scan_data = pack_bits(values[order], lengths[order])

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    return b"".join([
        b"\xff\xd8",
        segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        segment(0xDB, b"".join(bytes([i]) + q[ZIGZAG].astype(np.uint8).tobytes()
                               for i, q in enumerate(quants))),
        segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        segment(0xC4, b"".join(bytes([cls << 4 | tid]) + bytes(counts) + bytes(symbols)
                               for (cls, tid), (counts, symbols) in HUFFMAN.items())),
        segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan_data,
        b"\xff\xd9",
    ])

