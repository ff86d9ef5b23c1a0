"""Artifact store + checkpoint tests (SURVEY §5 checkpoint/resume)."""

import numpy as np
import pytest

from tpu2048.config import AgentConfig
from tpu2048.store import checkpoint as ckpt
from tpu2048.store.artifacts import LocalStore, MemoryStore, open_store


def _fresh_s3_store(monkeypatch):
    """An ``S3Store`` wired to the in-process boto3 fake
    (tests/_fake_boto3.py) with a fresh empty bucket — the real
    adapter code runs end to end; only the wire is faked."""
    import sys

    from tests import _fake_boto3

    monkeypatch.setitem(sys.modules, "boto3", _fake_boto3)
    _fake_boto3.BUCKETS.clear()
    _fake_boto3.FAIL_NEXT_GET.clear()
    from tpu2048.store.artifacts import S3Store

    return S3Store("test-bucket")


@pytest.fixture(params=["local", "memory", "s3"])
def store(request, tmp_path, monkeypatch):
    if request.param == "local":
        return LocalStore(str(tmp_path / "store"))
    if request.param == "s3":
        return _fresh_s3_store(monkeypatch)
    return MemoryStore()


def test_json_roundtrip(store):
    store.save("c/cfg.json", {"n": 4, "alpha": 0.25})
    assert store.load("c/cfg.json") == {"n": 4, "alpha": 0.25}
    assert store.exists("c/cfg.json")
    store.delete("c/cfg.json")
    assert not store.exists("c/cfg.json")
    assert store.load("c/cfg.json") is None


def test_txt_append(store):
    store.save("l/log.txt", "hello\n")
    store.append_text("l/log.txt", "world\n")
    assert store.load("l/log.txt") == "hello\nworld\n"


def test_npz_roundtrip(store):
    w = np.random.default_rng(0).random(1000).astype(np.float32)
    store.save("weights/a.npz", {"weights": w})
    out = store.load("weights/a.npz")
    assert np.array_equal(out["weights"], w)


def test_list_and_copy(store):
    store.save("a/x.json", {"v": 1})
    store.save("a/y.json", {"v": 2})
    store.save("g/z.json", {"v": 3})
    assert store.list_keys("a/") == ["a/x.json", "a/y.json"]
    store.copy("a/x.json", "c/x.json")
    assert store.load("c/x.json") == {"v": 1}


def test_local_store_rejects_escaping_keys(tmp_path):
    s = LocalStore(str(tmp_path / "root"))
    with pytest.raises(ValueError):
        s.save("../evil.json", {})


def test_agent_checkpoint_roundtrip(store):
    acfg = AgentConfig(n=2, alpha=0.1)
    w = np.random.default_rng(1).random(6144).astype(np.float32)
    meta = {"episodes": 1234, "top_score": 5555, "alpha": 0.05,
            "train_history": [1, 2, 3]}
    ckpt.save_agent(store, "bob", acfg, w, meta)
    acfg2, w2, meta2 = ckpt.load_agent(store, "bob")
    assert acfg2 == acfg
    assert np.array_equal(w2, w)
    assert meta2["episodes"] == 1234
    assert meta2["train_history"] == [1, 2, 3]


def test_agent_config_with_removed_field_loads():
    """Configs stored while AgentConfig still had the actor's precision
    field (values "bf16" / "bf16x2") load: unknown keys are dropped, the
    rest is kept."""
    from tpu2048.config import agent_config_from_dict, to_dict

    removed = "_".join(("actor", "precision"))  # no live reference
    old = {**to_dict(AgentConfig(n=6, alpha=0.5)), removed: "bf16"}
    acfg = agent_config_from_dict(old)
    assert acfg == AgentConfig(n=6, alpha=0.5)
    assert not hasattr(acfg, removed)


def test_load_missing_agent_raises(store):
    with pytest.raises(FileNotFoundError):
        ckpt.load_agent(store, "ghost")


def test_game_record_roundtrip(store):
    rec = {
        "starting_position": np.zeros((4, 4), np.int8),
        "moves": np.asarray([0, 1, 2], np.int8),
        "tiles": np.asarray([[1, 0, 0], [2, 1, 1], [1, 2, 3]], np.int8),
        "score": 128,
        "odometer": 3,
        "final_board": np.ones((4, 4), np.int8),
    }
    ckpt.save_game(store, "g1", rec)
    out = ckpt.load_game(store, "g1")
    assert out["score"] == 128
    assert out["odometer"] == 3
    assert np.array_equal(out["moves"], rec["moves"])
    assert np.array_equal(out["tiles"], rec["tiles"])


def test_s3_read_errors_surface(monkeypatch, caplog):
    """Non-NoSuchKey read failures must raise (and log), never read as
    'no such artifact' — a silent None could e.g. make resume start
    from scratch over a transient outage (artifacts.py load_bytes)."""
    import logging

    from tests import _fake_boto3

    s = _fresh_s3_store(monkeypatch)
    s.save("a/x.json", {"v": 1})
    _fake_boto3.FAIL_NEXT_GET.append(ConnectionError("transient outage"))
    with caplog.at_level(logging.ERROR, logger="tpu2048.store"):
        with pytest.raises(ConnectionError):
            s.load("a/x.json")
    assert any("S3 read" in r.message for r in caplog.records)
    # the artifact is still there once the outage clears
    assert s.load("a/x.json") == {"v": 1}


def test_s3_missing_key_is_none(monkeypatch):
    s = _fresh_s3_store(monkeypatch)
    assert s.load("a/ghost.json") is None
    s.delete("a/ghost.json")  # idempotent, like real S3


def test_s3_without_boto3_raises(monkeypatch):
    """boto3 is genuinely absent in this image: the constructor must
    fail with a clear message, not an ImportError at first use."""
    import sys

    monkeypatch.delitem(sys.modules, "boto3", raising=False)
    from tpu2048.store.artifacts import S3Store

    with pytest.raises(RuntimeError, match="boto3"):
        S3Store("b")


def test_open_store_s3(monkeypatch):
    import sys

    from tests import _fake_boto3

    monkeypatch.setitem(sys.modules, "boto3", _fake_boto3)
    from tpu2048.store.artifacts import S3Store

    assert isinstance(open_store("s3", bucket="b"), S3Store)


def test_open_store(tmp_path):
    s = open_store("local", str(tmp_path / "x"))
    assert isinstance(s, LocalStore)
    assert isinstance(open_store("memory"), MemoryStore)
    with pytest.raises(ValueError):
        open_store("carrier-pigeon")
