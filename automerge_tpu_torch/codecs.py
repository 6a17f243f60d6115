"""L0 byte-level codecs: LEB128, RLE, Delta, Boolean run-length.

Byte-compatible with the reference implementation's encoding layer
(the reference implementation's backend/encoding.js). The encoders here are rewritten
for Python (bytearray-backed, arbitrary-precision ints) but produce
bit-identical output for the same value sequences:

- LEB128 unsigned/signed varints (minimal encodings), bounded at 64 bits
  on decode and 53 bits for the JS-safe-integer entry points.
- RLE columns: records of (count, value) where count > 0 is a repetition,
  count < 0 a literal run, count == 0 a null run (encoding.js:536-556).
- Delta columns: RLE over successive differences (encoding.js:922).
- Boolean columns: alternating run lengths starting with false
  (encoding.js:1053).
"""
# amlint: host-only — pure-host layer: must not import tpu/ or jax
from __future__ import annotations

from .errors import DecodeError, EncodeError
from .obs.metrics import get_metrics

MAX_SAFE_INTEGER = 2**53 - 1
MIN_SAFE_INTEGER = -(2**53 - 1)


class DecodeCache:
    """Bounded LRU of decoded artefacts keyed by the raw chunk bytes.

    A change gossiped to N documents, or replayed across sync rounds, is
    parsed once: the decoded object is cached under the chunk bytes (the
    change hash is the sha256 of those bytes, so byte-keying IS hash-keying
    without paying the digest on every lookup). Cached values are shared
    between callers — treat them as immutable; callers that need to attach
    per-delivery state must copy (columnar.decode_change_cached keeps
    immutable records and builds a fresh view per hit).

    Capacity bounds the working set by entry count; `max_bytes` additionally
    bounds it by the total size of the cached chunk bytes (the key), so a
    few huge document chunks cannot pin unbounded host memory however small
    the entry count stays. Oldest-used entries evict first under either
    bound. Hits/misses/evictions are counted on the process-wide metrics
    registry under the instrument names ``<name>.{hits,misses,evictions}``,
    and ``<name>.bytes`` gauges the bytes currently pinned; caches
    constructed with the same name share one set of instruments (the bytes
    gauge aggregates across them).
    """

    __slots__ = ("capacity", "max_bytes", "name", "_entries", "_bytes",
                 "_m_hits", "_m_misses", "_m_evictions", "_m_bytes")

    #: per-name aggregate of pinned bytes across cache instances (the two
    #: module-level caches share the default name and one gauge)
    _name_bytes: dict = {}

    def __init__(self, capacity: int, name: str = "codecs.decode_cache",
                 max_bytes: int | None = None):
        if capacity <= 0:
            raise ValueError("DecodeCache capacity must be positive")  # amlint: disable=AM401 — API-usage validation
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("DecodeCache max_bytes must be positive")  # amlint: disable=AM401 — API-usage validation
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.name = name
        self._entries: dict = {}
        self._bytes = 0
        metrics = get_metrics()
        self._m_hits = metrics.counter(
            f"{name}.hits", "decode calls served from the LRU"
        )
        self._m_misses = metrics.counter(
            f"{name}.misses", "decode calls that parsed the bytes"
        )
        self._m_evictions = metrics.counter(
            f"{name}.evictions", "entries dropped by the LRU capacity bound"
        )
        self._m_bytes = metrics.gauge(
            f"{name}.bytes", "chunk bytes currently pinned by the LRU"
        )

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _cost(key) -> int:
        """Byte cost of one entry: the chunk bytes ARE the key, and the
        decoded value's size tracks the chunk size, so the key length is
        the budgeted proxy."""
        try:
            return len(key)
        except TypeError:
            return 0

    def _account(self, delta: int) -> None:
        self._bytes += delta
        total = self._name_bytes.get(self.name, 0) + delta
        self._name_bytes[self.name] = total
        self._m_bytes.set(total)

    def get(self, key):
        """The cached value for `key` (refreshing its recency), else None."""
        entry = self._entries.pop(key, None)
        if entry is None:
            self._m_misses.inc()
            return None
        self._entries[key] = entry  # dicts iterate in insertion order: re-
        self._m_hits.inc()          # inserting makes this the newest entry
        return entry

    def put(self, key, value) -> None:
        if key in self._entries:
            self._entries.pop(key)
            self._account(-self._cost(key))
        elif len(self._entries) >= self.capacity:
            self._evict_oldest()
        self._entries[key] = value
        self._account(self._cost(key))
        if self.max_bytes is not None:
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                self._evict_oldest()

    def _evict_oldest(self) -> None:
        oldest = next(iter(self._entries))
        self._entries.pop(oldest)
        self._account(-self._cost(oldest))
        self._m_evictions.inc()

    def clear(self) -> None:
        self._entries.clear()
        self._account(-self._bytes)


def hex_to_bytes(value: str) -> bytes:
    if not isinstance(value, str):
        raise TypeError("value is not a string")  # amlint: disable=AM401 — argument-type validation
    try:
        return bytes.fromhex(value)
    except ValueError:
        raise DecodeError("value is not hexadecimal") from None


def bytes_to_hex(data) -> str:
    return bytes(data).hex()


class Encoder:
    """Append-only byte buffer with LEB128 primitives."""

    def __init__(self):
        self.buf = bytearray()

    @property
    def buffer(self) -> bytes:
        self.finish()
        return bytes(self.buf)

    def append_byte(self, value: int) -> None:
        self.buf.append(value)

    def append_uint(self, value: int, max_bits: int = 64) -> int:
        """LEB128-encode a nonnegative integer. Returns bytes written."""
        if not isinstance(value, int) or isinstance(value, bool):
            raise EncodeError("value is not an integer")
        if value < 0 or value >= (1 << max_bits):
            raise EncodeError("number out of range")
        n = 0
        while True:
            byte = value & 0x7F
            value >>= 7
            if value:
                self.buf.append(byte | 0x80)
                n += 1
            else:
                self.buf.append(byte)
                return n + 1

    def append_int(self, value: int, max_bits: int = 64) -> int:
        """LEB128-encode a signed integer. Returns bytes written."""
        if not isinstance(value, int) or isinstance(value, bool):
            raise EncodeError("value is not an integer")
        if value < -(1 << (max_bits - 1)) or value >= (1 << (max_bits - 1)):
            raise EncodeError("number out of range")
        n = 0
        while True:
            byte = value & 0x7F
            value >>= 7
            if (value == 0 and not (byte & 0x40)) or (value == -1 and (byte & 0x40)):
                self.buf.append(byte)
                return n + 1
            self.buf.append(byte | 0x80)
            n += 1

    def append_uint32(self, value: int) -> int:
        return self.append_uint(value, 32)

    def append_int32(self, value: int) -> int:
        return self.append_int(value, 32)

    def append_uint53(self, value: int) -> int:
        if not isinstance(value, int) or isinstance(value, bool):
            raise EncodeError("value is not an integer")
        if value < 0 or value > MAX_SAFE_INTEGER:
            raise EncodeError("number out of range")
        return self.append_uint(value, 64)

    def append_int53(self, value: int) -> int:
        if not isinstance(value, int) or isinstance(value, bool):
            raise EncodeError("value is not an integer")
        if value < MIN_SAFE_INTEGER or value > MAX_SAFE_INTEGER:
            raise EncodeError("number out of range")
        return self.append_int(value, 64)

    def append_raw_bytes(self, data) -> int:
        self.buf.extend(data)
        return len(data)

    def append_raw_string(self, value: str) -> int:
        if not isinstance(value, str):
            raise TypeError("value is not a string")  # amlint: disable=AM401 — argument-type validation
        return self.append_raw_bytes(value.encode("utf-8", "surrogatepass"))

    def append_prefixed_bytes(self, data) -> "Encoder":
        self.append_uint53(len(data))
        self.append_raw_bytes(data)
        return self

    def append_prefixed_string(self, value: str) -> "Encoder":
        if not isinstance(value, str):
            raise TypeError("value is not a string")  # amlint: disable=AM401 — argument-type validation
        self.append_prefixed_bytes(value.encode("utf-8", "surrogatepass"))
        return self

    def append_hex_string(self, value: str) -> "Encoder":
        self.append_prefixed_bytes(hex_to_bytes(value))
        return self

    def finish(self) -> None:
        pass


class Decoder:
    """Cursor over a byte buffer with LEB128 primitives."""

    def __init__(self, buffer):
        if not isinstance(buffer, (bytes, bytearray, memoryview)):
            raise TypeError(f"Not a byte array: {buffer!r}")  # amlint: disable=AM401 — argument-type validation
        self.buf = bytes(buffer)
        self.offset = 0

    @property
    def done(self) -> bool:
        return self.offset == len(self.buf)

    def reset(self) -> None:
        self.offset = 0

    def skip(self, num_bytes: int) -> None:
        if self.offset + num_bytes > len(self.buf):
            raise DecodeError("cannot skip beyond end of buffer")
        self.offset += num_bytes

    def read_byte(self) -> int:
        self.offset += 1
        return self.buf[self.offset - 1]

    def _read_leb_bytes(self):
        """Reads raw LEB128 bytes (up to 10); returns (unsigned_value, shift, last_byte)."""
        result = 0
        shift = 0
        # amlint: disable=AM106 — scalar parity oracle: the per-byte walk
        # the vectorized passes (tpu/decode.py) are differentially tested
        # against, and the canonical raiser for malformed varints
        while self.offset < len(self.buf):
            byte = self.buf[self.offset]
            if shift == 63 and byte > 1 and byte != 0x7F:
                raise DecodeError("number out of range")
            if shift > 63:
                raise DecodeError("number out of range")
            result |= (byte & 0x7F) << shift
            shift += 7
            self.offset += 1
            if not (byte & 0x80):
                return result, shift, byte
        raise DecodeError("buffer ended with incomplete number")

    def read_uint(self, max_bits: int = 64) -> int:
        value, _shift, _last = self._read_leb_bytes()
        if value >= (1 << max_bits):
            raise DecodeError("number out of range")
        return value

    def read_int(self, max_bits: int = 64) -> int:
        value, shift, last = self._read_leb_bytes()
        if last & 0x40 and shift < 70:
            value -= 1 << shift  # sign-extend
        if value < -(1 << (max_bits - 1)) or value >= (1 << (max_bits - 1)):
            raise DecodeError("number out of range")
        return value

    def read_uint32(self) -> int:
        return self.read_uint(32)

    def read_int32(self) -> int:
        return self.read_int(32)

    def read_uint53(self) -> int:
        value = self.read_uint(64)
        if value > MAX_SAFE_INTEGER:
            raise DecodeError("number out of range")
        return value

    def read_int53(self) -> int:
        value = self.read_int(64)
        if value < MIN_SAFE_INTEGER or value > MAX_SAFE_INTEGER:
            raise DecodeError("number out of range")
        return value

    def read_raw_bytes(self, length: int) -> bytes:
        start = self.offset
        if start + length > len(self.buf):
            raise DecodeError("subarray exceeds buffer size")
        self.offset += length
        return self.buf[start : self.offset]

    def read_raw_string(self, length: int) -> str:
        return self.read_raw_bytes(length).decode("utf-8", "surrogatepass")

    def read_prefixed_bytes(self) -> bytes:
        return self.read_raw_bytes(self.read_uint53())

    def read_prefixed_string(self) -> str:
        return self.read_prefixed_bytes().decode("utf-8", "surrogatepass")

    def read_hex_string(self) -> str:
        return bytes_to_hex(self.read_prefixed_bytes())


class RLEEncoder(Encoder):
    """Run-length encoder for int/uint/utf8 columns (nullable).

    State machine identical to encoding.js:558 (states: empty, loneValue,
    repetition, literal, nulls) so that byte output matches the reference
    for any value sequence.
    """

    def __init__(self, type_: str):
        super().__init__()
        self.type = type_
        self.state = "empty"
        self.last_value = None
        self.count = 0
        self.literal = []

    def append_value(self, value, repetitions: int = 1) -> None:
        self._append_value(value, repetitions)

    def _append_value(self, value, repetitions: int = 1) -> None:
        if repetitions <= 0:
            return
        st = self.state
        if st == "empty":
            self.state = (
                "nulls" if value is None else ("loneValue" if repetitions == 1 else "repetition")
            )
            self.last_value = value
            self.count = repetitions
        elif st == "loneValue":
            if value is None:
                self.flush()
                self.state = "nulls"
                self.count = repetitions
            elif value == self.last_value:
                self.state = "repetition"
                self.count = 1 + repetitions
            elif repetitions > 1:
                self.flush()
                self.state = "repetition"
                self.count = repetitions
                self.last_value = value
            else:
                self.state = "literal"
                self.literal = [self.last_value]
                self.last_value = value
        elif st == "repetition":
            if value is None:
                self.flush()
                self.state = "nulls"
                self.count = repetitions
            elif value == self.last_value:
                self.count += repetitions
            elif repetitions > 1:
                self.flush()
                self.state = "repetition"
                self.count = repetitions
                self.last_value = value
            else:
                self.flush()
                self.state = "loneValue"
                self.last_value = value
        elif st == "literal":
            if value is None:
                self.literal.append(self.last_value)
                self.flush()
                self.state = "nulls"
                self.count = repetitions
            elif value == self.last_value:
                self.flush()
                self.state = "repetition"
                self.count = 1 + repetitions
            elif repetitions > 1:
                self.literal.append(self.last_value)
                self.flush()
                self.state = "repetition"
                self.count = repetitions
                self.last_value = value
            else:
                self.literal.append(self.last_value)
                self.last_value = value
        elif st == "nulls":
            if value is None:
                self.count += repetitions
            elif repetitions > 1:
                self.flush()
                self.state = "repetition"
                self.count = repetitions
                self.last_value = value
            else:
                self.flush()
                self.state = "loneValue"
                self.last_value = value

    def flush(self) -> None:
        st = self.state
        if st == "loneValue":
            self.append_int32(-1)
            self._append_raw_value(self.last_value)
        elif st == "repetition":
            self.append_int53(self.count)
            self._append_raw_value(self.last_value)
        elif st == "literal":
            self.append_int53(-len(self.literal))
            for v in self.literal:
                self._append_raw_value(v)
        elif st == "nulls":
            self.append_int32(0)
            self.append_uint53(self.count)
        self.state = "empty"

    def _append_raw_value(self, value) -> None:
        if self.type == "int":
            self.append_int53(value)
        elif self.type == "uint":
            self.append_uint53(value)
        elif self.type == "utf8":
            self.append_prefixed_string(value)
        else:
            raise EncodeError(f"Unknown RLEEncoder datatype: {self.type}")

    def finish(self) -> None:
        if self.state == "literal":
            self.literal.append(self.last_value)
        # Don't write anything if the only values we have seen are nulls
        if self.state != "nulls" or len(self.buf) > 0:
            self.flush()


class RLEDecoder(Decoder):
    """Counterpart to RLEEncoder."""

    def __init__(self, type_: str, buffer):
        super().__init__(buffer)
        self.type = type_
        self.last_value = None
        self.count = 0
        self.state = None

    @property
    def done(self) -> bool:
        return self.count == 0 and self.offset == len(self.buf)

    def reset(self) -> None:
        self.offset = 0
        self.last_value = None
        self.count = 0
        self.state = None

    def read_value(self):
        if self.done:
            return None
        if self.count == 0:
            self._read_record()
        self.count -= 1
        if self.state == "literal":
            value = self._read_raw_value()
            if value == self.last_value:
                raise DecodeError("Repetition of values is not allowed in literal")
            self.last_value = value
            return value
        return self.last_value

    def skip_values(self, num_skip: int) -> None:
        while num_skip > 0 and not self.done:
            if self.count == 0:
                self.count = self.read_int53()
                if self.count > 0:
                    if self.count <= num_skip:
                        self._skip_raw_values(1)
                    else:
                        self.last_value = self._read_raw_value()
                    self.state = "repetition"
                elif self.count < 0:
                    self.count = -self.count
                    self.state = "literal"
                else:
                    self.count = self.read_uint53()
                    self.last_value = None
                    self.state = "nulls"
            consume = min(num_skip, self.count)
            if self.state == "literal":
                self._skip_raw_values(consume)
            num_skip -= consume
            self.count -= consume

    def _read_record(self) -> None:
        self.count = self.read_int53()
        if self.count > 1:
            value = self._read_raw_value()
            if self.state in ("repetition", "literal") and self.last_value == value:
                raise DecodeError("Successive repetitions with the same value are not allowed")
            self.state = "repetition"
            self.last_value = value
        elif self.count == 1:
            raise DecodeError("Repetition count of 1 is not allowed, use a literal instead")
        elif self.count < 0:
            self.count = -self.count
            if self.state == "literal":
                raise DecodeError("Successive literals are not allowed")
            self.state = "literal"
        else:
            if self.state == "nulls":
                raise DecodeError("Successive null runs are not allowed")
            self.count = self.read_uint53()
            if self.count == 0:
                raise DecodeError("Zero-length null runs are not allowed")
            self.last_value = None
            self.state = "nulls"

    def _read_raw_value(self):
        if self.type == "int":
            return self.read_int53()
        if self.type == "uint":
            return self.read_uint53()
        if self.type == "utf8":
            return self.read_prefixed_string()
        raise DecodeError(f"Unknown RLEDecoder datatype: {self.type}")

    def _skip_raw_values(self, num: int) -> None:
        if self.type == "utf8":
            for _ in range(num):
                self.skip(self.read_uint53())
        else:
            # amlint: disable=AM106 — scalar parity oracle (see _read_leb_bytes)
            while num > 0 and self.offset < len(self.buf):
                if not (self.buf[self.offset] & 0x80):
                    num -= 1
                self.offset += 1
            if num > 0:
                raise DecodeError("cannot skip beyond end of buffer")


class DeltaEncoder(RLEEncoder):
    """RLE over successive differences (good for opId counters)."""

    def __init__(self):
        super().__init__("int")
        self.absolute_value = 0

    def append_value(self, value, repetitions: int = 1) -> None:
        if repetitions <= 0:
            return
        if value is not None:
            super().append_value(value - self.absolute_value, 1)
            self.absolute_value = value
            if repetitions > 1:
                super().append_value(0, repetitions - 1)
        else:
            super().append_value(value, repetitions)


class DeltaDecoder(RLEDecoder):
    """Counterpart to DeltaEncoder."""

    def __init__(self, buffer):
        super().__init__("int", buffer)
        self.absolute_value = 0

    def reset(self) -> None:
        super().reset()
        self.absolute_value = 0

    def read_value(self):
        value = super().read_value()
        if value is None:
            return None
        self.absolute_value += value
        return self.absolute_value

    def skip_values(self, num_skip: int) -> None:
        while num_skip > 0 and not self.done:
            if self.count == 0:
                self._read_record()
            consume = min(num_skip, self.count)
            if self.state == "literal":
                for _ in range(consume):
                    self.last_value = self._read_raw_value()
                    self.absolute_value += self.last_value
            elif self.state == "repetition":
                self.absolute_value += consume * self.last_value
            num_skip -= consume
            self.count -= consume


class BooleanEncoder(Encoder):
    """Alternating false/true run lengths, starting with false."""

    def __init__(self):
        super().__init__()
        self.last_value = False
        self.count = 0

    def append_value(self, value, repetitions: int = 1) -> None:
        if value is not False and value is not True:
            raise EncodeError(f"Unsupported value for BooleanEncoder: {value}")
        if repetitions <= 0:
            return
        if self.last_value == value:
            self.count += repetitions
        else:
            self.append_uint53(self.count)
            self.last_value = value
            self.count = repetitions

    def finish(self) -> None:
        if self.count > 0:
            self.append_uint53(self.count)
            self.count = 0


class BooleanDecoder(Decoder):
    """Counterpart to BooleanEncoder."""

    def __init__(self, buffer):
        super().__init__(buffer)
        self.last_value = True  # negated the first time we read a count
        self.first_run = True
        self.count = 0

    @property
    def done(self) -> bool:
        return self.count == 0 and self.offset == len(self.buf)

    def reset(self) -> None:
        self.offset = 0
        self.last_value = True
        self.first_run = True
        self.count = 0

    def read_value(self):
        if self.done:
            return False
        while self.count == 0:
            self.count = self.read_uint53()
            self.last_value = not self.last_value
            if self.count == 0 and not self.first_run:
                raise DecodeError("Zero-length runs are not allowed")
            self.first_run = False
        self.count -= 1
        return self.last_value

    def skip_values(self, num_skip: int) -> None:
        while num_skip > 0 and not self.done:
            if self.count == 0:
                self.count = self.read_uint53()
                self.last_value = not self.last_value
                if self.count == 0 and not self.first_run:
                    raise DecodeError("Zero-length runs are not allowed")
                self.first_run = False
            consume = min(num_skip, self.count)
            num_skip -= consume
            self.count -= consume
