"""Column-level parity of the vectorised decode, the port against the JAX
package: twins of tests/test_decode_vectorized.py's ``TestColumnCodecs``
for the RLE (unsigned) and Delta columns, eight seeds each; the Boolean
and string-RLE columns and the bad run grammar are in
test_torch_decode_codecs_more.py.

Each scenario encodes the JAX test's generated run/literal/null mix with
one package's own encoder, expands it through that package's ``_Scan``
and vector expander, makes the JAX test's assertion (equal to the scalar
decoder) and records the column bytes and the expanded values;
``twin_pkgs`` holds the port's record equal to the JAX package's. The
tolerance is zero."""
import random

import pytest

from test_torch_faults_domain import twin_pkgs


def scalar_column(decoder):
    out = []
    while not decoder.done:
        out.append(decoder.read_value())
    return out


def with_nulls(P, got):
    return [None if x == P.native.NULL_SENTINEL else x for x in got.tolist()]


def expand(P, buf, expander, **kwargs):
    scan = P.decode._Scan([buf])
    lo, hi = scan.seg(0)
    return getattr(P.decode, expander)(scan, lo, hi, **kwargs)


@pytest.mark.parametrize("seed", range(8))
def test_rle_uint(seed, monkeypatch):
    def scenario(P, rec):
        rng = random.Random(seed)
        values = []
        for _ in range(rng.randrange(1, 30)):
            v = rng.choice([None, rng.randrange(0, 2**50)])
            values.extend([v] * rng.randrange(1, 6))
        enc = P.codecs.RLEEncoder("uint")
        for v in values:
            enc.append_value(v)
        buf = enc.buffer
        got = with_nulls(P, expand(P, buf, "_rle_expand", signed=False))
        assert got == scalar_column(P.codecs.RLEDecoder("uint", buf))
        rec.value((bytes(buf), got))

    twin_pkgs(scenario, monkeypatch)


@pytest.mark.parametrize("seed", range(8))
def test_delta(seed, monkeypatch):
    def scenario(P, rec):
        rng = random.Random(seed)
        values = []
        cur = 0
        for _ in range(rng.randrange(1, 40)):
            if rng.random() < 0.2:
                values.append(None)
            else:
                cur += rng.randrange(-50, 50)
                values.append(cur)
        enc = P.codecs.DeltaEncoder()
        for v in values:
            enc.append_value(v)
        buf = enc.buffer
        got = with_nulls(P, expand(P, buf, "_delta_expand"))
        assert got == scalar_column(P.codecs.DeltaDecoder(buf))
        rec.value((bytes(buf), got))

    twin_pkgs(scenario, monkeypatch)
