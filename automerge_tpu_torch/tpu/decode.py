"""Vectorized columnar decode: chunk byte tensors in, struct-of-arrays out.

The scalar codecs (codecs.py) walk one byte at a time through a per-op
state machine — ~5.5 s of pure Python per bench round on hosts without the
native library (BENCH_r05). This module re-expresses the change-chunk
column codecs as data-parallel transforms over concatenated chunk byte
tensors, the control-flow-duplication-for-columnar-arrays technique
(PAPERS.md: arxiv 2302.10098): every branch of the decode state machine
becomes a masked vector pass over the whole batch.

- **LEB128** becomes one pass: the continuation bit (``byte & 0x80``)
  masks value boundaries, a prefix scan over the boundary mask assigns
  each byte its varint id and in-varint position, and the payload
  contributions (``(byte & 0x7f) << 7*pos``) reduce segment-wise
  (``np.add.reduceat`` — exact int64). One scan covers EVERY varint
  column of EVERY chunk in the batch.
- **RLE / Delta** become a record-level walk (O(runs) Python, not
  O(bytes)) emitting (kind, count, value-index) triples, expanded to rows
  by segment-id gather + ``np.repeat``; Delta adds one cumulative-sum
  pass over the null-masked deltas.
- **Boolean** columns are a single ``np.repeat`` of alternating values
  over the run-length varints.

The scalar decoders remain the parity oracle: whenever a vector pass
meets bytes it cannot prove well-formed (truncated varints, bad run
structure, out-of-range values), the affected chunk is re-decoded through
the scalar path, which produces the canonical result or raises the
canonical ``DecodeError``/``ChecksumError``. The byte-corpus suite
(tests/test_decode_vectorized.py) pins bit-for-bit parity over the
reference corpus, fuzzed changes and corrupt inputs.

Importing this module registers the single-chunk vector pass as
columnar.decode_change's fallback backend (after the native library,
before the per-op decoder chain). The farm's delivery hot path and the
sync receive paths call ``warm_decode_cache`` to decode all cache misses
of a delivery together in one batch.

A device assist exists for byte tensors already on the card:
``leb128_scan_device`` builds the boundary mask, segment ids and payload
planes in torch and reduces the planes per varint with the hand-written
CUDA segmented sum (``leb_kernels.leb128_segment_sum``, ``csrc/leb128.cu``).
It returns what ``leb128_scan`` returns. The NumPy host pass is what the
farm and the sync paths run everywhere; the device scan is an entry point
of its own, as in the JAX package.
"""
# amlint: hot-path
from __future__ import annotations

import numpy as np
import torch

from .. import columnar, native
from ..codecs import MAX_SAFE_INTEGER, Decoder
from ..columnar import NULL_SENTINEL, ColumnType
from ..obs.metrics import get_metrics

_METRICS = get_metrics()
_M_CHUNKS = _METRICS.counter(
    "codecs.vector.chunks", "change chunks decoded by the vectorized passes"
)
_M_BYTES = _METRICS.counter(
    "codecs.vector.bytes", "column bytes decoded by the vectorized passes"
)
_M_LOOKUPS = _METRICS.counter(
    "decode.cache.lookups",
    "change buffers a delivery looked up in the decode LRU "
    "(warm_decode_cache); with codecs.vector.chunks, the LRU's miss rate",
)

#: expansion guard: a corrupt run count must not allocate unbounded rows
#: before validation can reject it — over the cap, the scalar oracle owns
#: the buffer (and its error)
ROW_CAP = 1 << 24


class _Fallback(Exception):
    """Internal: the vector pass met bytes it cannot prove well-formed; the
    caller re-runs the scalar oracle for the exact result or error."""


# ---------------------------------------------------------------------- #
# LEB128: continuation-bit mask + prefix scan

def leb128_scan(data: np.ndarray):
    """One masked vector pass over a byte tensor of back-to-back LEB128
    varints. Returns ``(starts, lengths, unsigned, signed)``: per-varint
    start offsets and byte lengths, and both int64 interpretations (the
    caller picks per column type). Raises _Fallback for streams the pass
    cannot decode exactly in int64 (a trailing continuation byte, or a
    varint wider than 8 bytes — legal values there exceed the 53-bit
    wire range anyway, so the oracle owns them and their errors)."""
    n = data.shape[0]
    if n == 0:
        e = np.empty(0, np.int64)
        return e, e, e, e
    cont = (data & 0x80) != 0
    if cont[-1]:
        raise _Fallback("stream ends inside a varint")
    ends = np.flatnonzero(~cont)
    starts = np.empty(ends.shape[0], np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lengths = ends + 1 - starts
    if int(lengths.max()) > 8:
        raise _Fallback("varint wider than 8 bytes")
    pos = np.arange(n, dtype=np.int64) - np.repeat(starts, lengths)
    contrib = (data & 0x7F).astype(np.int64) << (7 * pos)
    unsigned = np.add.reduceat(contrib, starts)
    sign = (data[ends] & 0x40) != 0
    signed = unsigned - (sign.astype(np.int64) << (7 * lengths))
    return starts, lengths, unsigned, signed


class _Scan:
    """The shared varint scan over a list of column buffers (one chunk's
    columns, or every varint column of a whole delivery batch): the byte
    tensors concatenate, one leb128_scan covers them all, and each segment
    reads its own varint index range. Buffer boundaries must land on varint
    boundaries (each column decodes independently) — a misaligned boundary
    means some buffer ends mid-varint, and the whole scan defers."""

    __slots__ = ("u", "s", "_vi")

    def __init__(self, bufs):
        sizes = np.fromiter((len(b) for b in bufs), np.int64, len(bufs))
        offsets = np.zeros(len(bufs) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        data = np.frombuffer(b"".join(bufs), np.uint8)
        starts, _lengths, self.u, self.s = leb128_scan(data)
        nvar = starts.shape[0]
        vi = np.searchsorted(starts, offsets)
        if nvar > 0:
            interior = offsets < data.shape[0]
            aligned = starts[np.minimum(vi, nvar - 1)] == offsets
            if not np.all(aligned | ~interior):
                raise _Fallback("column boundary inside a varint")
        self._vi = vi

    def seg(self, k: int):
        """(lo, hi) varint index range of segment `k`."""
        return int(self._vi[k]), int(self._vi[k + 1])


# ---------------------------------------------------------------------- #
# RLE / Delta / Boolean: record walk + segment-id expansion

_REP, _LIT, _NULL = 0, 1, 2


def _rle_expand(scan: _Scan, lo: int, hi: int, signed: bool,
                row_cap: int = ROW_CAP) -> np.ndarray:
    """Expands one RLE column chunk (varint indexes [lo, hi) of `scan`)
    into an int64 row array with nulls as NULL_SENTINEL.

    The walk is O(records): each iteration consumes a whole repetition,
    literal run or null run. Row materialisation is vectorized — a
    segment-id gather into the varint value array plus one np.repeat.
    Structural violations (the scalar decoder's run-grammar errors) and
    out-of-range values raise _Fallback; the oracle re-raises exactly."""
    u, s = scan.u, scan.s
    vals = s if signed else u
    # the record walk runs on plain ints: local list views of the varint
    # slice beat numpy scalar indexing ~10x at record granularity
    s_l = s[lo:hi].tolist()
    vals_l = vals[lo:hi].tolist()
    kinds, counts, vidx = [], [], []
    i = 0
    n = hi - lo
    state = -1
    last_vi = -1
    while i < n:
        c = s_l[i]
        if c > 1:
            if c > MAX_SAFE_INTEGER or i + 1 >= n:
                raise _Fallback("bad repetition")
            if state in (_REP, _LIT) and vals_l[i + 1] == vals_l[last_vi]:
                raise _Fallback("successive repetitions of one value")
            kinds.append(_REP)
            counts.append(c)
            vidx.append(lo + i + 1)
            state, last_vi = _REP, i + 1
            i += 2
        elif c == 1:
            raise _Fallback("repetition count of 1")
        elif c < 0:
            m = -c
            if m > MAX_SAFE_INTEGER or i + 1 + m > n:
                raise _Fallback("truncated literal run")
            if state == _LIT:
                raise _Fallback("successive literals")
            kinds.append(_LIT)
            counts.append(m)
            vidx.append(lo + i + 1)
            state, last_vi = _LIT, i + m
            i += 1 + m
        else:
            if i + 1 >= n:
                raise _Fallback("truncated null run")
            m = int(u[lo + i + 1])  # null counts read unsigned
            if m == 0 or m > MAX_SAFE_INTEGER or state == _NULL:
                raise _Fallback("bad null run")
            kinds.append(_NULL)
            counts.append(int(m))
            vidx.append(lo)  # never read; keeps the gather in range
            state, last_vi = _NULL, -1
            i += 2
    if not kinds:
        return np.empty(0, np.int64)

    kind_arr = np.asarray(kinds, np.int64)
    count_arr = np.asarray(counts, np.int64)
    total = int(count_arr.sum())
    if total > row_cap:
        raise _Fallback("row cap exceeded")
    rec = np.repeat(np.arange(kind_arr.shape[0], dtype=np.int64), count_arr)
    rec_start = np.concatenate(([0], np.cumsum(count_arr)[:-1]))
    offset = np.arange(total, dtype=np.int64) - rec_start[rec]
    row_kind = kind_arr[rec]
    is_lit = row_kind == _LIT
    is_null = row_kind == _NULL
    src = np.asarray(vidx, np.int64)[rec] + np.where(is_lit, offset, 0)
    out = np.where(is_null, NULL_SENTINEL, vals[src])

    live = out[~is_null]
    if live.size:
        if signed:
            if int(np.abs(live).max()) > MAX_SAFE_INTEGER:
                raise _Fallback("value out of range")
        elif int(live.max()) > MAX_SAFE_INTEGER:
            raise _Fallback("value out of range")
    # literal grammar: a literal value must differ from its predecessor
    # (the scalar decoder's read-time check), unless that predecessor was
    # a null run (last_value is None there)
    if is_lit.any():
        dup = np.zeros(total, bool)
        dup[1:] = is_lit[1:] & ~is_null[:-1] & (out[1:] == out[:-1])
        if dup.any():
            raise _Fallback("repetition inside literal")
    return out


def _delta_expand(scan: _Scan, lo: int, hi: int,
                  row_cap: int = ROW_CAP) -> np.ndarray:
    """Delta column: signed RLE over successive differences, then one
    cumulative-sum pass (nulls pass through without touching the running
    absolute — exactly DeltaDecoder.read_value)."""
    deltas = _rle_expand(scan, lo, hi, signed=True, row_cap=row_cap)
    nulls = deltas == NULL_SENTINEL
    stepped = np.where(nulls, 0, deltas)
    # |delta| <= 2^53 and rows <= ROW_CAP, but the running sum could still
    # overflow int64 on adversarial input: bound it in float first
    if stepped.size and float(np.abs(stepped, dtype=np.float64).sum()) >= 2.0**62:
        raise _Fallback("absolute value overflow")
    out = np.cumsum(stepped)
    return np.where(nulls, NULL_SENTINEL, out)


def _bool_expand(scan: _Scan, lo: int, hi: int,
                 row_cap: int = ROW_CAP) -> np.ndarray:
    """Boolean column: alternating run lengths starting with false — one
    np.repeat over the run-length varints."""
    counts = scan.u[lo:hi]
    if counts.shape[0] == 0:
        return np.zeros(0, bool)
    if int(counts.max()) > MAX_SAFE_INTEGER:
        raise _Fallback("run length out of range")
    if counts.shape[0] > 1 and int(counts[1:].min()) == 0:
        raise _Fallback("zero-length run")
    total = int(counts.sum())
    if total > row_cap:
        raise _Fallback("row cap exceeded")
    vals = (np.arange(counts.shape[0], dtype=np.int64) & 1) == 1
    return np.repeat(vals, counts)


def _strrle_expand(buf: bytes, row_cap: int = ROW_CAP):
    """utf8 RLE column: value-level walk (strings interleave with the run
    varints, so this column cannot ride the shared varint scan). O(records
    + strings) Python — runs and length prefixes amortise the per-byte
    cost the scalar chain pays. Returns (blob, offsets int64[n, 2]) in
    native.strrle_decode's format: row i is blob[o[i,0]:o[i,1]], null rows
    are (-1, -1)."""
    dec = Decoder(buf)
    n_bytes = len(buf)
    parts = []          # blob fragments, in row order
    rec_rows = []       # per record: (kind, count, start, end) into blob
    blob_len = 0
    total = 0
    state = -1
    last_bytes = None

    def read_str():
        """One length-prefixed string: single-byte prefixes (the common
        case) slice directly; multi-byte prefixes ride the Decoder."""
        o = dec.offset
        if o >= n_bytes:
            raise _Fallback("truncated string run")
        ln = buf[o]
        if ln < 0x80:
            start = o + 1
        else:
            ln = dec.read_uint53()
            start = dec.offset
        end = start + ln
        if end > n_bytes:
            raise _Fallback("string exceeds buffer")
        dec.offset = end
        return buf[start:end]

    try:
        while not dec.done:
            c = dec.read_int53()
            if c > 1:
                raw = read_str()
                if state in (_REP, _LIT) and raw == last_bytes:
                    raise _Fallback("successive repetitions of one value")
                parts.append(raw)
                rec_rows.append((_REP, c, blob_len, blob_len + len(raw)))
                blob_len += len(raw)
                state, last_bytes = _REP, raw
                total += c
            elif c == 1:
                raise _Fallback("repetition count of 1")
            elif c < 0:
                if state == _LIT:
                    raise _Fallback("successive literals")
                for _ in range(-c):
                    raw = read_str()
                    if raw == last_bytes and last_bytes is not None:
                        raise _Fallback("repetition inside literal")
                    parts.append(raw)
                    rec_rows.append((_LIT, 1, blob_len, blob_len + len(raw)))
                    blob_len += len(raw)
                    last_bytes = raw
                state = _LIT
                total += -c
            else:
                m = dec.read_uint53()
                if m == 0 or state == _NULL:
                    raise _Fallback("bad null run")
                rec_rows.append((_NULL, m, -1, -1))
                state, last_bytes = _NULL, None
                total += m
            if total > row_cap:
                raise _Fallback("row cap exceeded")
    except _Fallback:
        raise
    except Exception as exc:  # truncated varint/string: oracle owns the error
        raise _Fallback(str(exc)) from None
    if not rec_rows:
        return b"", np.empty((0, 2), np.int64)
    recs = np.asarray([(r[1], r[2], r[3]) for r in rec_rows], np.int64)
    offs = np.repeat(recs[:, 1:], recs[:, 0], axis=0)
    return b"".join(parts), offs


# ---------------------------------------------------------------------- #
# chunk-level decode: columns -> struct-of-arrays -> ops

def _collect_columns(cols):
    """Splits one chunk's (column_id, buffer) list into varint segments,
    string columns and raw columns, keyed by canonical change-column name.
    Returns None when an unknown column is present (the generic path
    preserves those)."""
    varints, strs, raws = [], {}, {}
    for cid, buf in cols:
        name = columnar._CHANGE_COLUMN_IDS.get(cid)
        if name is None:
            return None
        t = cid & 7
        buf = bytes(buf)
        if t == ColumnType.STRING_RLE:
            strs[name] = buf
        elif t == ColumnType.VALUE_RAW:
            raws[name] = buf
        elif t == ColumnType.INT_DELTA:
            varints.append((name, "delta", buf))
        elif t == ColumnType.BOOLEAN:
            varints.append((name, "bool", buf))
        else:  # GROUP_CARD / ACTOR_ID / INT_RLE / VALUE_LEN: uint RLE
            varints.append((name, "uint", buf))
    return varints, strs, raws


def _soa_from_columns(varints, strs, raws, scan: _Scan, seg_of):
    """Materialises the struct-of-arrays for one chunk: every varint
    column expands through the shared scan (`seg_of` maps the position in
    `varints` to its scan segment), strings and raw columns decode
    locally."""
    arrs = {}
    for j, (name, kind, _buf) in enumerate(varints):
        lo, hi = scan.seg(seg_of(j))
        if kind == "bool":
            arrs[name] = _bool_expand(scan, lo, hi)
        elif kind == "delta":
            arrs[name] = _delta_expand(scan, lo, hi)
        else:
            arrs[name] = _rle_expand(scan, lo, hi, signed=False)
    for name, buf in strs.items():
        if buf and native.available():
            try:
                arrs[name] = native.strrle_decode(buf)
                continue
            except ValueError:
                pass  # the Python walk re-validates and classifies
        arrs[name] = _strrle_expand(buf)
    for name, buf in raws.items():
        arrs[name] = buf
    return arrs


def _count_bytes(varints, strs, raws) -> int:
    return (
        sum(len(b) for _, _, b in varints)
        + sum(len(b) for b in strs.values())
        + sum(len(b) for b in raws.values())
    )


def _vector_change_ops(cols, actor_ids):
    """Single-chunk vectorized change-op decode — the backend registered
    with columnar.set_vector_decoder (same contract as the native path:
    ops list, or None to defer to the generic per-op decoder chain)."""
    grouped = _collect_columns(cols)
    if grouped is None:
        return None
    varints, strs, raws = grouped
    try:
        scan = _Scan([b for _, _, b in varints])
        arrs = _soa_from_columns(varints, strs, raws, scan, lambda j: j)
        ops = columnar.ops_from_column_arrays(arrs, actor_ids)
    except Exception:
        # anything the vector pass cannot decode — structural fallbacks
        # AND real decode errors — defers to the per-op decoder chain,
        # which produces the canonical result or raises the canonical
        # taxonomy error
        return None
    if ops is not None and _M_CHUNKS.enabled:
        _M_CHUNKS.inc()
        _M_BYTES.inc(_count_bytes(varints, strs, raws))
    return ops


def _decode_batch(keys):
    """Decodes a batch of distinct change buffers, sharing ONE varint scan
    across every column of every chunk. Returns one entry per buffer:
    the change's record (``columnar.change_record``), built from the
    column arrays, or the exception that buffer raises.

    Chunks the vector pass cannot prove well-formed re-decode through
    columnar.decode_change (native/scalar), which produces the canonical
    result or error — corrupt inputs cost one extra parse, the clean bulk
    path stays batched."""
    metas = [None] * len(keys)
    grouped = [None] * len(keys)
    results = [None] * len(keys)
    seg_bufs = []
    seg_base = [0] * len(keys)
    for i, buf in enumerate(keys):
        try:
            metas[i] = columnar.decode_change_columns(buf)
        except Exception as exc:  # per-buffer isolation: header/checksum
            results[i] = exc
            continue
        g = _collect_columns(
            [(c["columnId"], c["buffer"]) for c in metas[i]["columns"]]
        )
        grouped[i] = g
        if g is not None:
            seg_base[i] = len(seg_bufs)
            seg_bufs.extend(b for _, _, b in g[0])

    scan = None
    try:
        scan = _Scan(seg_bufs)
    except _Fallback:
        pass  # some buffer is malformed: every chunk re-scans locally

    decoded_chunks = 0
    decoded_bytes = 0
    for i, buf in enumerate(keys):
        if results[i] is not None or metas[i] is None:
            continue
        ops = None
        if grouped[i] is not None:
            varints, strs, raws = grouped[i]
            try:
                if scan is not None:
                    base = seg_base[i]
                    arrs = _soa_from_columns(
                        varints, strs, raws, scan, lambda j, b=base: b + j
                    )
                else:
                    local = _Scan([b for _, _, b in varints])
                    arrs = _soa_from_columns(
                        varints, strs, raws, local, lambda j: j
                    )
                ops = columnar.op_records_from_column_arrays(
                    arrs, metas[i]["actorIds"])
                if ops is not None:
                    decoded_chunks += 1
                    decoded_bytes += _count_bytes(varints, strs, raws)
            except Exception:
                ops = None  # scalar re-decode owns the result AND the error
        if ops is not None:
            results[i] = columnar.change_record(metas[i], ops)
        else:
            try:
                results[i] = columnar.record_of_change(
                    columnar.decode_change(buf))
            except Exception as exc:
                results[i] = exc
    if decoded_chunks and _M_CHUNKS.enabled:
        _M_CHUNKS.inc(decoded_chunks)
        _M_BYTES.inc(decoded_bytes)
    return results


def decode_changes_vector(buffers):
    """Batched `columnar.decode_change` over a list of change buffers:
    misses decode together in one vector pass; the first buffer that fails
    raises its canonical error (list-order semantics, like decoding the
    buffers one by one)."""
    results = _decode_batch([bytes(b) for b in buffers])
    for res in results:
        if isinstance(res, BaseException):
            raise res
    return [columnar.record_view(res) for res in results]


def warm_decode_cache(buffers) -> int:
    """Best-effort batched decode of the delivery's cache misses into the
    shared change LRU, as records (columnar.decode_change_cached then hits
    for every buffer). Buffers that fail to decode are left uncached — the
    per-document delivery path re-raises their exact error inside its own
    fault domain. Returns the number of chunks decoded."""
    _M_LOOKUPS.inc(len(buffers))
    cache = columnar._DECODED_CHANGE_CACHE
    misses = []
    seen = set()
    for b in buffers:
        k = bytes(b)
        if k in seen or k in cache._entries:
            continue
        seen.add(k)
        misses.append(k)
    if not misses:
        return 0
    decoded = 0
    for k, res in zip(misses, _decode_batch(misses)):
        if not isinstance(res, BaseException):
            cache.put(k, res)
            decoded += 1
    return decoded


# ---------------------------------------------------------------------- #
# device path: torch + the CUDA segmented sum for byte tensors on the card

def leb128_scan_device(data: torch.Tensor):
    """leb128_scan for a uint8 tensor: boundary mask, segment ids and
    payload planes as torch ops on the tensor's device, the per-varint
    plane reduction through ``leb_kernels.leb128_segment_sum`` (the CUDA
    kernel for a card tensor, its plain version for a CPU one). Returns
    the same (starts, lengths, unsigned, signed) tuple as the NumPy pass,
    as host arrays, and raises the same _Fallback cases."""
    from .leb_kernels import leb128_segment_sum

    n = int(data.shape[0])
    if n == 0:
        e = np.empty(0, np.int64)
        return e, e, e, e
    is_end = (data & 0x80) == 0
    if not bool(is_end[-1]):
        raise _Fallback("stream ends inside a varint")
    end_i = is_end.to(torch.int32)
    seg = torch.cumsum(end_i, 0, dtype=torch.int32) - end_i
    nvar = int(seg[-1]) + 1
    ends = torch.nonzero(is_end).flatten()
    starts = torch.cat([ends.new_zeros(1), ends[:-1] + 1])
    lengths = ends + 1 - starts
    if int(lengths.max()) > 8:
        raise _Fallback("varint wider than 8 bytes")
    pos = torch.arange(n, dtype=torch.int64, device=data.device) \
        - starts[seg.long()]
    contrib = (data & 0x7F).long() << (7 * pos)
    # 14-bit planes keep every float32 partial sum an exact integer
    planes = torch.stack(
        [(contrib >> (14 * k)) & 0x3FFF for k in range(4)], dim=1
    ).float()
    sums = leb128_segment_sum(planes, seg, nvar)
    unsigned = sum(sums[:, k].long() << (14 * k) for k in range(4))
    sign = (data[ends] & 0x40) != 0
    signed = unsigned - (sign.long() << (7 * lengths))
    return tuple(
        t.cpu().numpy() for t in (starts, lengths, unsigned, signed)
    )


# register the vectorized backend with the host-only codec layer
columnar.set_vector_decoder(_vector_change_ops)
