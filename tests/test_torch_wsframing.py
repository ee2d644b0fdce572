"""The port's wire bytes against the reference's: WebSocket handshakes and
frames (``core/wsframing.py``) and op-log records
(``checkpoint/serialize.py``) must be byte-equal for the same inputs, and
each package must read the other's files."""
from __future__ import annotations

import random

import numpy as np
import pytest

from repro.checkpoint import serialize as jser
from repro.core import wsframing as jwf
from repro_torch.checkpoint import serialize as tser
from repro_torch.core import wsframing as twf


def _payloads(seed):
    rng = random.Random(seed)
    # empty, small, the 125/126 and 65535/65536 length-encoding edges
    sizes = [0, 1, 125, 126, 127, 65535, 65536, rng.randint(2, 5000)]
    return [bytes(rng.getrandbits(8) for _ in range(n)) if n < 5000 else
            np.random.RandomState(seed).bytes(n) for n in sizes]


def _mask_source(seed):
    rng = random.Random(seed)
    return lambda n: bytes(rng.getrandbits(8) for _ in range(n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_client_frames_byte_equal(seed):
    jf = jwf.client_framer(mask_source=_mask_source(seed))
    tf = twf.client_framer(mask_source=_mask_source(seed))
    for payload in _payloads(seed):
        assert tf.send_message(payload) == jf.send_message(payload)
        assert tf.send_message(payload, fragment_size=7) == \
            jf.send_message(payload, fragment_size=7)
    assert tf.ping(b"hb") == jf.ping(b"hb")
    assert tf.pong(b"hb") == jf.pong(b"hb")
    assert tf.close(twf.CLOSE_NORMAL, b"bye") == jf.close(jwf.CLOSE_NORMAL,
                                                         b"bye")


@pytest.mark.parametrize("seed", [0, 1])
def test_server_frames_byte_equal_and_cross_decode(seed):
    js, ts = jwf.server_framer(), twf.server_framer()
    jc = jwf.client_framer(mask_source=_mask_source(seed))
    tc = twf.client_framer(mask_source=_mask_source(seed))
    for payload in _payloads(seed):
        wire = ts.send_message(payload)
        assert wire == js.send_message(payload)
        # each package's client decodes the other's server frames
        assert [e.data for e in jc.feed(wire)] == [payload]
        assert [e.data for e in tc.feed(js.send_message(payload))] == \
            [payload]
        # ... and each server the other's masked client frames
        assert [e.data for e in ts.feed(jc.send_message(payload,
                                                        fragment_size=50))] \
            == [payload]


@pytest.mark.parametrize("key", ["dGhlIHNhbXBsZSBub25jZQ==",
                                 "AAAAAAAAAAAAAAAAAAAAAA=="])
def test_handshakes_byte_equal(key):
    treq, tkey = twf.client_handshake_request("127.0.0.1:9", key=key)
    jreq, jkey = jwf.client_handshake_request("127.0.0.1:9", key=key)
    assert (treq, tkey) == (jreq, jkey)
    assert twf.accept_key(key) == jwf.accept_key(key)
    assert twf.handshake_response(key) == jwf.handshake_response(key)
    assert twf.bad_handshake_response("nope") == \
        jwf.bad_handshake_response("nope")
    ths, jhs = twf.ServerHandshake(), jwf.ServerHandshake()
    assert ths.feed(treq) == jhs.feed(jreq) == twf.handshake_response(key)


def _records(seed):
    rng = np.random.RandomState(seed)
    return [b"", b"x"] + [rng.bytes(int(rng.randint(1, 3000)))
                          for _ in range(6)]


@pytest.mark.parametrize("seed", [0, 5])
def test_records_byte_equal_and_cross_read(seed, tmp_path):
    recs = _records(seed)
    for r in recs:
        assert tser.pack_record(r) == jser.pack_record(r)
    tpath, jpath = str(tmp_path / "t.log"), str(tmp_path / "j.log")
    for r in recs:
        assert tser.append_record(tpath, r, fsync=False) == \
            jser.append_record(jpath, r, fsync=False)
    tdata, jdata = tser.read_bytes(tpath), jser.read_bytes(jpath)
    assert tdata == jdata
    assert list(jser.iter_records(tdata)) == recs    # reference reads port's
    assert list(tser.iter_records(jdata)) == recs    # port reads reference's
    # a torn tail ends both readers at the same intact prefix
    torn = tdata[:-3]
    assert list(tser.iter_records(torn)) == list(jser.iter_records(torn)) \
        == recs[:-1]


def test_blob_files_cross_read(tmp_path):
    """``dump_path`` / ``load_path`` / ``atomic_write``: each package loads
    the other's file, leaf for leaf."""
    rng = np.random.RandomState(3)
    tree = {"w": rng.randn(4, 3).astype(np.float32),
            "step": np.asarray(7, np.int32), "meta": [1, "a"]}
    tpath, jpath = str(tmp_path / "t.blob"), str(tmp_path / "j.blob")
    assert tser.dump_path(tree, tpath, codec="zlib") == \
        jser.dump_path(tree, jpath, codec="zlib")
    assert tser.read_bytes(tpath) == jser.read_bytes(jpath)
    for got in (jser.load_path(tpath), tser.load_path(jpath)):
        np.testing.assert_array_equal(got["w"], tree["w"])
        assert got["step"] == 7 and got["meta"] == [1, "a"]
    assert tser.atomic_write(tpath, b"raw") == 3
    assert jser.read_bytes(tpath) == b"raw"


def test_unknown_leaf_dtype_is_refused():
    """A leaf whose dtype name numpy does not know (an extension type the
    port has no reader for) is refused by name."""
    raw = jser.dumps({"x": {"__nd__": True, "d": "float99", "s": [2],
                            "b": b"\0" * 8}}, compress=False)
    with pytest.raises(ValueError, match="float99"):
        tser.loads(raw)
