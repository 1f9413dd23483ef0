"""A Zstandard decoder (RFC 8878), decode only, in numpy and Python.

orbax stores every array chunk and every OCDBT node as a zstd frame;
this module reads them on a machine that has neither ``zstandard`` nor
``libzstd``.  :func:`decompress` takes one or more frames (skippable
frames are passed over) and returns their content.  It handles what the
format allows but dictionaries: frame headers with and without a content
size, raw, RLE and compressed blocks, raw, RLE, Huffman and treeless
literals in one or four streams, predefined, RLE, FSE and repeated
sequence tables, the three repeat offsets and the content checksum
(xxh64).  A malformed or truncated frame raises ``ValueError``; every
loop is bounded by the input's length, so none can spin.

Huffman literals decode through a table of every 16-bit window, each
entry holding the up to four symbols that window decodes to; the loop
collects the windows and numpy expands them into bytes.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

_FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MAGIC = 0x184D2A50     # the low four bits are free
_MAX_BLOCK = 128 * 1024
_PAD = 8                          # zero bytes before and after a bitstream

# Literals_Length and Match_Length codes: (baseline, extra bits)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]

# the predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                   2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                   -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                   -1, -1, -1, -1, -1])
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1])
# (max symbol, max accuracy log) of the three sequence tables
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS = (35, 9), (31, 8), (52, 9)

_WIDE_BITS = 16                   # window of the multi-symbol Huffman table
_WIDE_SYMBOLS = 4
_WIDE_MIN_COUNT = 4096            # streams shorter than this decode one by one


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data``, concatenated."""
    data = bytes(data)
    if not data:
        raise ValueError("zstd: empty input")
    out: List[bytes] = []
    pos = 0
    while pos < len(data):
        if len(data) - pos < 4:
            raise ValueError("zstd: truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIPPABLE_MAGIC:
            if len(data) - pos < 8:
                raise ValueError("zstd: truncated skippable frame")
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            pos += 8 + size
            if pos > len(data):
                raise ValueError("zstd: truncated skippable frame")
            continue
        if magic != _FRAME_MAGIC:
            raise ValueError(f"zstd: bad frame magic {magic:#010x}")
        content, pos = _frame(data, pos + 4)
        out.append(content)
    return b"".join(out)


# -- frames and blocks ---------------------------------------------------


def _need(data: bytes, pos: int, n: int, what: str) -> None:
    if n < 0 or pos + n > len(data):
        raise ValueError(f"zstd: truncated {what}")


def _frame(data: bytes, pos: int) -> Tuple[bytes, int]:
    _need(data, pos, 1, "frame header")
    fhd = data[pos]
    pos += 1
    if fhd & 0x08:
        raise ValueError("zstd: reserved bit set in the frame header")
    single_segment = bool(fhd & 0x20)
    window: Optional[int] = None
    if not single_segment:
        _need(data, pos, 1, "window descriptor")
        exponent, mantissa = data[pos] >> 3, data[pos] & 7
        base = 1 << (10 + exponent)
        window = base + (base >> 3) * mantissa
        pos += 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    _need(data, pos, did_size, "dictionary id")
    if int.from_bytes(data[pos:pos + did_size], "little"):
        raise ValueError("zstd: frames that need a dictionary are not supported")
    pos += did_size
    fcs_size = (1 if single_segment else 0, 2, 4, 8)[fhd >> 6]
    content_size: Optional[int] = None
    if fcs_size:
        _need(data, pos, fcs_size, "frame content size")
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        content_size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    if window is None:
        window = content_size
    out = bytearray()
    state = _FrameState(window)
    while True:
        _need(data, pos, 3, "block header")
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = header & 1, (header >> 1) & 3, header >> 3
        if size > _MAX_BLOCK:
            raise ValueError(f"zstd: block of {size} bytes exceeds 128 KiB")
        if kind == 0:
            _need(data, pos, size, "raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            _need(data, pos, 1, "RLE block")
            out += data[pos:pos + 1] * size
            pos += 1
        elif kind == 2:
            _need(data, pos, size, "compressed block")
            before = len(out)
            _compressed_block(data[pos:pos + size], out, state)
            if len(out) - before > _MAX_BLOCK:
                raise ValueError("zstd: a block decodes past 128 KiB")
            pos += size
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    if fhd & 0x04:
        _need(data, pos, 4, "content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if _xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ValueError("zstd: content checksum mismatch")
        pos += 4
    if content_size is not None and len(out) != content_size:
        raise ValueError(f"zstd: frame decodes to {len(out)} bytes, its header "
                         f"says {content_size}")
    return bytes(out), pos


class _FrameState:
    """What later blocks of a frame reuse: the Huffman table (treeless
    literals), the sequence tables (repeat mode) and the repeat offsets."""

    __slots__ = ("window", "huffman", "tables", "offsets")

    def __init__(self, window: Optional[int]):
        self.window = window
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_Fse]] = [None, None, None]  # LL, OF, ML
        self.offsets = [1, 4, 8]


def _compressed_block(block: bytes, out: bytearray, state: _FrameState) -> None:
    literals, pos = _literals(block, state)
    sequences = _sequences(block, pos, state)
    _execute(sequences, literals, out, state)


# -- bitstreams ----------------------------------------------------------


def _words(data: bytes) -> List[int]:
    """The 64-bit little-endian word at every byte offset of ``data``
    padded with :data:`_PAD` zero bytes on both sides."""
    buf = np.zeros(len(data) + 2 * _PAD, np.uint8)
    buf[_PAD:_PAD + len(data)] = np.frombuffer(data, np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(buf, 8)[:len(data) + _PAD]
    return np.ascontiguousarray(windows).view("<u8").ravel().tolist()


class _Backward:
    """A bitstream read from its end towards its start (RFC 8878 4.1):
    the last byte's highest set bit marks the end.  ``pos`` counts the
    bits left; reading past the start yields zeros, and the caller checks
    that a stream ends exactly at 0."""

    __slots__ = ("words", "pos")

    def __init__(self, data: bytes, what: str):
        if not data or data[-1] == 0:
            raise ValueError(f"zstd: {what} bitstream has no end mark")
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1
        self.words = _words(data)

    def read(self, n: int) -> int:
        if not n:
            return 0
        self.pos -= n
        p = self.pos + 8 * _PAD
        if p < 0:
            raise ValueError("zstd: bitstream read past its start")
        return (self.words[p >> 3] >> (p & 7)) & ((1 << n) - 1)


# -- FSE -----------------------------------------------------------------


class _Fse:
    """An FSE decoding table: per state its symbol, the bits to read and
    the baseline of the next state."""

    __slots__ = ("log", "symbol", "bits", "base")

    def __init__(self, log: int, symbol: List[int], bits: List[int],
                 base: List[int]):
        self.log, self.symbol, self.bits, self.base = log, symbol, bits, base


def _read_distribution(data: bytes, pos: int, end: int, max_symbol: int,
                       max_log: int) -> Tuple[int, List[int], int]:
    """An FSE table description (RFC 8878 4.1.1) at ``data[pos:end]``:
    returns ``(accuracy log, normalized counts, bytes used)``."""
    chunk = data[pos:min(end, pos + 512)]
    if not chunk:
        raise ValueError("zstd: truncated FSE table description")
    value = int.from_bytes(chunk, "little")
    avail = 8 * len(chunk)
    log = (value & 0xF) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} above {max_log}")
    off = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol or off + nbits > avail:
            raise ValueError("zstd: malformed FSE table description")
        limit = 2 * threshold - 1 - remaining
        low = (value >> off) & (threshold - 1)
        if low < limit:
            count = low
            off += nbits - 1
        else:
            count = (value >> off) & (2 * threshold - 1)
            if count >= threshold:
                count -= limit
            off += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        if remaining < 1:
            raise ValueError("zstd: FSE counts exceed the table")
        counts.append(count)
        if count == 0:
            while True:
                if off + 2 > avail:
                    raise ValueError("zstd: truncated FSE zero run")
                repeat = (value >> off) & 3
                off += 2
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if len(counts) > max_symbol + 1:
        raise ValueError("zstd: FSE table has too many symbols")
    return log, counts, (off + 7) >> 3


def _fse_table(log: int, counts: Sequence[int]) -> _Fse:
    """The decoding table of a normalized distribution (RFC 8878
    4.1.1): "less than 1" symbols take the last states, the others are
    spread with the fixed step, and each state's next-state baseline
    follows from its symbol's running count."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    running = []
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            running.append(1)
        else:
            running.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos:
        raise ValueError("zstd: FSE distribution does not fill its table")
    bits = [0] * size
    base = [0] * size
    for state in range(size):
        s = symbol[state]
        n = running[s]
        running[s] += 1
        nb = log - (n.bit_length() - 1)
        bits[state] = nb
        base[state] = (n << nb) - size
    return _Fse(log, symbol, bits, base)


@functools.lru_cache(maxsize=None)
def _predefined(kind: int) -> _Fse:
    return _fse_table(*(_LL_DEFAULT, _OF_DEFAULT, _ML_DEFAULT)[kind])


# -- literals ------------------------------------------------------------


class _Huffman:
    """A Huffman decoding table of ``2**max_bits`` entries (symbol, code
    length), and, built once when a long stream needs it, the 16-bit
    multi-symbol table."""

    __slots__ = ("max_bits", "symbol", "bits", "wide")

    def __init__(self, max_bits: int, symbol: np.ndarray, bits: np.ndarray):
        self.max_bits, self.symbol, self.bits = max_bits, symbol, bits
        self.wide: Optional[Tuple[np.ndarray, np.ndarray, List[int]]] = None

    def wide_table(self) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """(symbols (2**16, 4) u8, count per window, bits per window):
        the symbols whose codes lie wholly inside each 16-bit window."""
        if self.wide is None:
            width = _WIDE_BITS
            window = np.arange(1 << width, dtype=np.int64)
            used = np.zeros(1 << width, np.int64)
            count = np.zeros(1 << width, np.int64)
            symbols = np.zeros((1 << width, _WIDE_SYMBOLS), np.uint8)
            bits = self.bits.astype(np.int64)
            for k in range(_WIDE_SYMBOLS):
                index = ((window << used) & ((1 << width) - 1)) >> (width - self.max_bits)
                n = bits[index]
                ok = (count == k) & (used + n <= width)
                symbols[ok, k] = self.symbol[index[ok]]
                used = np.where(ok, used + n, used)
                count = np.where(ok, count + 1, count)
            self.wide = (symbols, count, used.tolist())
        return self.wide


def _huffman_from_weights(weights: List[int]) -> _Huffman:
    """RFC 8878 4.2.1: the last symbol's weight completes the sum to a
    power of two; codes go to symbols by weight, then by value."""
    if any(w > 11 for w in weights):
        raise ValueError("zstd: Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise ValueError("zstd: Huffman table with no weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > 11 or rest & (rest - 1):
        raise ValueError("zstd: Huffman weights do not sum to a power of two")
    w = np.array(weights + [rest.bit_length()], np.int64)
    order = np.argsort(w, kind="stable")
    order = order[w[order] > 0]
    span = 1 << (w[order] - 1)
    symbol = np.repeat(order, span).astype(np.uint8)
    bits = np.repeat(max_bits + 1 - w[order], span).astype(np.uint8)
    return _Huffman(max_bits, symbol, bits)


def _read_huffman_tree(data: bytes) -> Tuple[_Huffman, int]:
    """The Huffman tree description at the start of ``data``; returns
    the table and the bytes used."""
    if not data:
        raise ValueError("zstd: truncated Huffman tree description")
    header = data[0]
    if header >= 128:
        n = header - 127
        size = (n + 1) // 2
        _need(data, 1, size, "Huffman weights")
        weights = []
        for byte in data[1:1 + size]:
            weights += [byte >> 4, byte & 15]
        return _huffman_from_weights(weights[:n]), 1 + size
    _need(data, 1, header, "FSE-coded Huffman weights")
    log, counts, used = _read_distribution(data, 1, 1 + header, 255, 6)
    table = _fse_table(log, counts)
    bits = _Backward(data[1 + used:1 + header], "Huffman weights")
    states = [bits.read(log), bits.read(log)]
    weights: List[int] = []
    turn = 0
    while True:
        if len(weights) >= 255:
            raise ValueError("zstd: too many Huffman weights")
        state = states[turn]
        weights.append(table.symbol[state])
        states[turn] = table.base[state] + bits.read(table.bits[state])
        turn ^= 1
        if bits.pos < 0:
            weights.append(table.symbol[states[turn]])
            break
    return _huffman_from_weights(weights), 1 + header


def _huffman_stream(stream: bytes, table: _Huffman, count: int) -> np.ndarray:
    """``count`` literals of one Huffman-coded stream."""
    bits = _Backward(stream, "Huffman")
    words, p = bits.words, bits.pos + 8 * _PAD
    end = 8 * _PAD
    chunks: List[np.ndarray] = []
    if count >= _WIDE_MIN_COUNT:
        symbols, per_window, used = table.wide_table()
        width, mask = _WIDE_BITS, (1 << _WIDE_BITS) - 1
        windows: List[int] = []
        append = windows.append
        floor = end + width
        while p >= floor:
            q = p - width
            v = (words[q >> 3] >> (q & 7)) & mask
            append(v)
            p -= used[v]
        if windows:
            v = np.array(windows, np.int64)
            keep = np.arange(_WIDE_SYMBOLS) < per_window[v][:, None]
            chunks.append(symbols[v][keep])
    done = sum(len(c) for c in chunks)
    if done > count:
        raise ValueError("zstd: Huffman stream decodes too many literals")
    symbol, nbits = table.symbol.tolist(), table.bits.tolist()
    shift, mask = table.max_bits, (1 << table.max_bits) - 1
    tail = []
    for _ in range(count - done):
        if p < end:
            raise ValueError("zstd: Huffman stream read past its start")
        q = p - shift
        v = (words[q >> 3] >> (q & 7)) & mask
        tail.append(symbol[v])
        p -= nbits[v]
    if p != end:
        raise ValueError("zstd: Huffman stream not consumed exactly")
    chunks.append(np.array(tail, np.uint8))
    return np.concatenate(chunks)


def _literals(block: bytes, state: _FrameState) -> Tuple[bytes, int]:
    """The literals section at the start of ``block``: the literals and
    the offset of the sequences section."""
    _need(block, 0, 1, "literals header")
    kind, size_format = block[0] & 3, (block[0] >> 2) & 3
    if kind < 2:                        # raw, RLE
        if size_format in (0, 2):
            size, head = block[0] >> 3, 1
        elif size_format == 1:
            _need(block, 0, 2, "literals header")
            size, head = (block[0] >> 4) + (block[1] << 4), 2
        else:
            _need(block, 0, 3, "literals header")
            size, head = (block[0] >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            _need(block, head, size, "raw literals")
            return block[head:head + size], head + size
        _need(block, head, 1, "RLE literals")
        return block[head:head + 1] * size, head + 1
    head = (3, 3, 4, 5)[size_format]
    _need(block, 0, head, "literals header")
    fields = int.from_bytes(block[:head], "little") >> 4
    width = (10, 10, 14, 18)[size_format]
    regenerated = fields & ((1 << width) - 1)
    compressed = fields >> width
    if regenerated > _MAX_BLOCK:
        raise ValueError("zstd: literals exceed 128 KiB")
    _need(block, head, compressed, "Huffman literals")
    data = block[head:head + compressed]
    if kind == 2:
        state.huffman, used = _read_huffman_tree(data)
        data = data[used:]
    elif state.huffman is None:
        raise ValueError("zstd: treeless literals without an earlier Huffman table")
    table = state.huffman
    if size_format == 0:
        literals = _huffman_stream(data, table, regenerated)
    else:
        _need(data, 0, 6, "Huffman jump table")
        sizes = [int.from_bytes(data[i:i + 2], "little") for i in (0, 2, 4)]
        sizes.append(len(data) - 6 - sum(sizes))
        segment = (regenerated + 3) // 4
        counts = [segment] * 3 + [regenerated - 3 * segment]
        if sizes[3] < 1 or counts[3] < 0:
            raise ValueError("zstd: malformed Huffman jump table")
        streams, start = [], 6
        for size, count in zip(sizes, counts):
            streams.append(_huffman_stream(data[start:start + size], table, count))
            start += size
        literals = np.concatenate(streams)
    return literals.tobytes(), head + compressed


# -- sequences -----------------------------------------------------------


def _sequences(block: bytes, pos: int,
               state: _FrameState) -> List[Tuple[int, int, int]]:
    """The sequences section at ``block[pos:]``: (literals length, match
    length, offset value) per sequence."""
    _need(block, pos, 1, "sequences header")
    first = block[pos]
    if first == 0:
        if pos + 1 != len(block):
            raise ValueError("zstd: bytes after an empty sequences section")
        return []
    if first < 128:
        count, pos = first, pos + 1
    elif first < 255:
        _need(block, pos, 2, "sequences header")
        count, pos = ((first - 128) << 8) + block[pos + 1], pos + 2
    else:
        _need(block, pos, 3, "sequences header")
        count, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    _need(block, pos, 1, "symbol compression modes")
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the compression modes")
    tables = []
    for kind, mode, (max_symbol, max_log) in (
            (0, modes >> 6, _LL_LIMITS), (1, (modes >> 4) & 3, _OF_LIMITS),
            (2, (modes >> 2) & 3, _ML_LIMITS)):
        if mode == 0:
            table = _predefined(kind)
        elif mode == 1:
            _need(block, pos, 1, "RLE sequence symbol")
            if block[pos] > max_symbol:
                raise ValueError("zstd: RLE sequence symbol out of range")
            table = _Fse(0, [block[pos]], [0], [0])
            pos += 1
        elif mode == 2:
            log, counts, used = _read_distribution(block, pos, len(block),
                                                   max_symbol, max_log)
            table = _fse_table(log, counts)
            pos += used
        else:
            table = state.tables[kind]
            if table is None:
                raise ValueError("zstd: repeated sequence table without an earlier one")
        state.tables[kind] = table
        tables.append(table)
    ll_t, of_t, ml_t = tables
    bits = _Backward(block[pos:], "sequences")
    read = bits.read
    ll_state, of_state, ml_state = read(ll_t.log), read(of_t.log), read(ml_t.log)
    sequences = []
    for i in range(count):
        of_code = of_t.symbol[of_state]
        ml_code = ml_t.symbol[ml_state]
        ll_code = ll_t.symbol[ll_state]
        if of_code > 31:
            raise ValueError("zstd: offset code out of range")
        offset = (1 << of_code) + read(of_code)
        match = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        length = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        sequences.append((length, match, offset))
        if i + 1 < count:
            ll_state = ll_t.base[ll_state] + read(ll_t.bits[ll_state])
            ml_state = ml_t.base[ml_state] + read(ml_t.bits[ml_state])
            of_state = of_t.base[of_state] + read(of_t.bits[of_state])
        if bits.pos < 0:
            raise ValueError("zstd: sequences bitstream read past its start")
    if bits.pos != 0:
        raise ValueError("zstd: sequences bitstream not consumed exactly")
    return sequences


def _execute(sequences: List[Tuple[int, int, int]], literals: bytes,
             out: bytearray, state: _FrameState) -> None:
    """Append a block's output: each sequence's literals, then its match
    copied from ``offset`` bytes back (RFC 8878 3.1.1.4-5)."""
    rep = state.offsets
    lit = 0
    window = state.window
    for length, match, value in sequences:
        if lit + length > len(literals):
            raise ValueError("zstd: sequences use more literals than the block has")
        out += literals[lit:lit + length]
        lit += length
        if value > 3:
            offset = value - 3
            rep = [offset, rep[0], rep[1]]
        else:
            index = value - 1 + (length == 0)
            if index == 0:
                offset = rep[0]
            elif index == 1:
                offset = rep[1]
                rep = [rep[1], rep[0], rep[2]]
            elif index == 2:
                offset = rep[2]
                rep = [rep[2], rep[0], rep[1]]
            else:
                offset = rep[0] - 1
                rep = [offset, rep[0], rep[1]]
        start = len(out) - offset
        if offset < 1 or start < 0 or (window is not None and offset > window):
            raise ValueError(f"zstd: match offset {offset} outside the window")
        if offset >= match:
            out += out[start:start + match]
        else:
            out += (out[start:] * (match // offset + 1))[:match]
    out += literals[lit:]
    state.offsets = rep


# -- xxh64 ---------------------------------------------------------------

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of ``data`` (zstd's content checksum keeps its
    low 32 bits)."""
    n = len(data)
    stripes = n // 32 * 32
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = np.frombuffer(data, "<u8", stripes // 8).tolist()
        v1, v2, v3, v4 = v
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for lane in (v1, v2, v3, v4):
            h = ((h ^ _round(0, lane)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    pos = stripes
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos:pos + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)
