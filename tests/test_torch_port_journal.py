"""The PyTorch port's write-ahead journal against the JAX package's, byte
for byte.

The router's journal (serving/journal.py) is a wire format: a file of
``b"DWJ1" + u32 version`` and frames ``u32 length | u32 crc32 | JSON``.
The same record sequence, written by each package's
``WriteAheadJournal`` (appends, a compaction with carried-over records,
a reopen that appends), gives identical bytes. Each package's
``read_records`` / ``recover_state`` / ``WriteAheadJournal`` reads the
other's file, intact or damaged (a torn frame, a bad CRC, an oversized
length, an undecodable payload, a bad magic or version), to equal
results and the same errors; a record past the frame bound is refused
by both. Standard library only on both sides: nothing here times
anything."""

import os
import zlib

import pytest

from deeplearning4j_tpu.serving import journal as jj

from deeplearning4j_tpu_torch.serving import journal as tj
from torch_port_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": jj, "torch": tj}

#: one of every record type the router writes, in a router's order:
#: the id binding, an open, its route, position-addressed progress
#: (one record duplicated, as a compaction carry-over can), warm and
#: cold beliefs (keyed and replica-wide), a tenant bucket, terminals
RECORDS = [
    {"t": "rep", "addr": "127.0.0.1:9001", "r": "rep-0"},
    {"t": "rep", "addr": "127.0.0.1:9002", "r": "rep-1"},
    {"t": "open", "rid": 0, "prompt": [1, 4, 7, 2],
     "params": {"max_new_tokens": 6, "temperature": 0.0},
     "wall": 1700000000.25},
    {"t": "route", "rid": 0, "replica": "127.0.0.1:9001"},
    {"t": "prog", "rid": 0, "toks": [5, 2], "at": 0},
    {"t": "prog", "rid": 0, "toks": [8], "at": 2},
    {"t": "prog", "rid": 0, "toks": [8], "at": 2},
    {"t": "warm", "k": "0a1b2c", "r": "rep-0", "wall": 1700000000.5},
    {"t": "warm", "k": "0a1b2c", "r": "rep-1", "wall": 1700000000.75},
    {"t": "open", "rid": 1, "prompt": [9, 3, 3],
     "params": {"max_new_tokens": 4, "tenant": "premium"},
     "wall": 1700000001.0},
    {"t": "route", "rid": 1, "replica": "127.0.0.1:9002"},
    {"t": "prog", "rid": 1, "toks": [3, 3, 1]},
    {"t": "bucket", "tenant": "premium", "tokens": 3.5,
     "capacity": 8.0, "rate": 2.0, "wall": 1700000001.5},
    {"t": "cold", "k": "0a1b2c", "r": "rep-1"},
    {"t": "done", "rid": 1, "reason": "length", "status": 200, "n": 3},
    {"t": "cold", "r": "rep-0"},
    {"t": "route", "rid": 0, "replica": "127.0.0.1:9002"},
    {"t": "prog", "rid": 0, "toks": [8, 1, 1], "at": 2},
    {"t": "future", "x": "an unknown type is skipped"},
    {"t": "unicode", "s": "é中 \"quoted\" \\ \n"},
]

#: the compaction snapshot a router would build from RECORDS[:9]
SNAP = {
    "entries": [{"rid": 0, "prompt": [1, 4, 7, 2],
                 "params": {"max_new_tokens": 6, "temperature": 0.0},
                 "tokens": [5, 2, 8], "replica": "127.0.0.1:9001",
                 "done": False, "finish_reason": None, "status": None,
                 "submit_wall": 1700000000.25}],
    "buckets": {}, "warm": {"0a1b2c": {"rep-0": 1700000000.5}},
    "replicas": {"127.0.0.1:9001": "rep-0"},
    "next_rid": 1, "wall": 1700000000.8,
}


def _write(pkg, path, scenario):
    """Drive one package's journal through a scenario; return the
    file's bytes."""
    mod = PKGS[pkg]
    wal = mod.WriteAheadJournal(str(path), fsync="off",
                                compact_bytes=1 << 30)
    if scenario == "appends":
        for rec in RECORDS:
            wal.append(rec)
    elif scenario == "compaction":
        for rec in RECORDS[:9]:
            wal.append(rec)
        wal.begin_compaction()
        for rec in RECORDS[9:12]:  # appended while the snap is built
            wal.append(rec)
        wal.compact(SNAP)
        for rec in RECORDS[12:]:
            wal.append(rec)
    elif scenario == "reopen":
        for rec in RECORDS[:10]:
            wal.append(rec)
        wal.close()
        wal = mod.WriteAheadJournal(str(path), fsync="per_record")
        assert len(wal.recovered) == 10 and wal.torn_tail_bytes == 0
        for rec in RECORDS[10:]:
            wal.append(rec)
    wal.close()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("scenario", ["appends", "compaction", "reopen"])
def test_same_records_give_identical_bytes(tmp_path, scenario):
    data = {pkg: _write(pkg, tmp_path / f"{pkg}.wal", scenario)
            for pkg in PKGS}
    assert data["torch"] == data["jax"]
    assert data["torch"][:8] == b"DWJ1" + (1).to_bytes(4, "little")
    assert not os.path.exists(str(tmp_path / "torch.wal") + ".compact")


def test_encode_is_jax_frame_for_frame():
    for rec in RECORDS + [dict(SNAP, t="snap")]:
        assert tj._encode(rec) == jj._encode(rec)


def _damage(data, kind):
    """One damaged copy of a journal file (the frames start at byte 8;
    the damage lands on the second-to-last frame)."""
    header = data[:8]
    frames, at = [], 8
    while at < len(data):
        n = int.from_bytes(data[at:at + 4], "little")
        frames.append(data[at:at + 8 + n])
        at += 8 + n
    good = header + b"".join(frames[:-2])
    tail = frames[-2]
    if kind == "intact":
        return data
    if kind == "torn_frame":      # the crash cut a frame header short
        return good + tail[:5]
    if kind == "torn_payload":    # ... or the payload after it
        return good + tail[:len(tail) - 3]
    if kind == "bad_crc":         # a flipped payload byte
        bad = bytearray(tail)
        bad[-2] ^= 0x40
        return good + bytes(bad) + frames[-1]
    if kind == "oversized":       # a length past MAX_RECORD_BYTES
        n = (jj.MAX_RECORD_BYTES + 1).to_bytes(4, "little")
        return good + n + tail[4:] + frames[-1]
    if kind == "bad_json":        # a CRC-valid frame of non-JSON
        payload = b"{not json"
        frame = (len(payload).to_bytes(4, "little")
                 + zlib.crc32(payload).to_bytes(4, "little") + payload)
        return good + frame + frames[-1]
    if kind == "bad_magic":
        return b"XWJ1" + data[4:]
    if kind == "bad_version":
        return data[:4] + (2).to_bytes(4, "little") + data[8:]
    if kind == "empty_header":
        return b"DWJ"
    raise ValueError(kind)


DAMAGE = ["intact", "torn_frame", "torn_payload", "bad_crc", "oversized",
          "bad_json", "bad_magic", "bad_version", "empty_header"]


def _read(mod, path):
    """``(records, torn, state)`` or ``("error", type name, message)``
    with the path stripped from the message."""
    try:
        records, torn = mod.read_records(str(path))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("error", type(e).__name__,
                str(e).replace(str(path), "<path>"))
    return records, torn, mod.recover_state(records)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", DAMAGE)
def test_each_package_recovers_the_others_file(tmp_path, writer, kind):
    data = _write(writer, tmp_path / "w.wal", "compaction")
    path = tmp_path / "damaged.wal"
    path.write_bytes(_damage(data, kind))
    got = {pkg: _read(mod, path) for pkg, mod in PKGS.items()}
    assert got["torch"] == got["jax"]
    if kind in ("bad_magic", "bad_version", "empty_header"):
        assert got["torch"][:2] == ("error", "JournalError")
        for pkg, mod in PKGS.items():
            with pytest.raises(mod.JournalError):
                mod.WriteAheadJournal(str(path))
        return
    records, torn, state = got["torch"]
    assert (torn > 0) == (kind != "intact")
    if kind == "intact":
        assert records[0]["t"] == "snap"
        assert state["entries"][0]["tokens"] == [5, 2, 8, 1, 1]
        assert state["entries"][1]["done"]
        # the snap replaced what came before it: rep-1's binding
        # was folded away, rep-0's belief was cooled after it
        assert state["replica_ids"] == {"127.0.0.1:9001": "rep-0"}
        assert state["warm"] == {}
        assert state["buckets"]["premium"]["tokens"] == 3.5
        assert state["next_rid"] == 2


@pytest.mark.parametrize("writer,opener", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("kind", ["torn_payload", "bad_crc"])
def test_open_truncates_the_others_torn_tail(tmp_path, writer, opener,
                                             kind):
    """The owner that opens a damaged file truncates the torn tail and
    appends after the intact records: the result is the bytes the
    writer's own package makes of the same steps."""
    data = _write(writer, tmp_path / "w.wal", "appends")
    damaged = _damage(data, kind)
    out = {}
    for pkg in (opener, writer):
        path = tmp_path / f"{pkg}-open.wal"
        path.write_bytes(damaged)
        wal = PKGS[pkg].WriteAheadJournal(str(path), fsync="off")
        out[pkg] = (wal.recovered, wal.torn_tail_bytes)
        wal.append({"t": "done", "rid": 0, "reason": "length",
                    "status": 200, "n": 5})
        wal.close()
        out[pkg] += (path.read_bytes(),)
    assert out[opener] == out[writer]
    assert out[opener][1] > 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_record_past_the_frame_bound_is_refused(tmp_path, pkg):
    mod = PKGS[pkg]
    wal = mod.WriteAheadJournal(str(tmp_path / "big.wal"), fsync="off")
    with pytest.raises(ValueError, match="journal frame bound"):
        wal.append({"t": "prog", "rid": 0,
                    "toks": [1] * (mod.MAX_RECORD_BYTES // 2)})
    with pytest.raises(ValueError, match="journal frame bound"):
        wal.compact({"entries": [], "pad": "x" * mod.MAX_RECORD_BYTES})
    wal.append(RECORDS[0])
    wal.close()
    assert mod.read_records(str(tmp_path / "big.wal")) == (
        [RECORDS[0]], 0)


def test_fsync_policies_and_bad_policy():
    assert tj.FSYNC_POLICIES == jj.FSYNC_POLICIES
    assert (tj.JOURNAL_MAGIC, tj.JOURNAL_VERSION, tj.MAX_RECORD_BYTES) \
        == (jj.JOURNAL_MAGIC, jj.JOURNAL_VERSION, jj.MAX_RECORD_BYTES)
    with pytest.raises(ValueError, match="fsync"):
        tj.WriteAheadJournal("unused.wal", fsync="sometimes")
