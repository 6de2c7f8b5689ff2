"""Server: registry semantics, session tokens, load balancing."""


from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.server import tokens
from symmetry_tpu_torch.server.registry import Registry


def _add(reg, key, model="m1", maxc=10, conns=0):
    reg.upsert_provider(
        peer_key=key, discovery_key="d" + key, model_name=model,
        max_connections=maxc,
    )
    if conns:
        reg.set_connections(key, conns)


def test_upsert_and_select_least_loaded():
    reg = Registry()
    _add(reg, "p1", conns=5)
    _add(reg, "p2", conns=1)
    _add(reg, "p3", conns=9)
    pick = reg.select_provider("m1")
    assert pick.peer_key == "p2"  # least-loaded wins (readme.md "The Tower…")


def test_select_respects_model_and_capacity():
    reg = Registry()
    _add(reg, "p1", model="llama3:8b", maxc=2, conns=2)   # full
    _add(reg, "p2", model="mistral-7b")
    assert reg.select_provider("llama3:8b") is None        # at capacity
    assert reg.select_provider("mistral-7b").peer_key == "p2"
    assert reg.select_provider("nonexistent") is None


def test_offline_excluded_and_restart_resets():
    reg = Registry()
    _add(reg, "p1")
    reg.set_offline("p1")
    assert reg.select_provider("m1") is None
    # Rejoin brings it back.
    _add(reg, "p1")
    assert reg.select_provider("m1").peer_key == "p1"


def test_load_normalized_by_capacity():
    reg = Registry()
    _add(reg, "big", maxc=100, conns=10)    # 10% loaded
    _add(reg, "small", maxc=2, conns=1)     # 50% loaded
    assert reg.select_provider("m1").peer_key == "big"


def test_steering_prefers_smaller_reported_backlog():
    """A provider reporting engine backlog (queued) must stop receiving
    assignments while a less-backlogged one exists — the router-side half
    of overload shedding."""
    reg = Registry()
    _add(reg, "busy", conns=1)
    _add(reg, "idle", conns=3)   # more connections, but no backlog
    reg.set_metrics("busy", {"queued": 64, "shed": 12})
    reg.set_metrics("idle", {"queued": 0})
    assert reg.select_provider("m1").peer_key == "idle"
    # Backlog drains → connection-load order applies again.
    reg.set_metrics("busy", {"queued": 0})
    assert reg.select_provider("m1").peer_key == "busy"
    # A malformed report must not poison steering.
    reg.set_metrics("busy", {"queued": "garbage"})
    assert reg.select_provider("m1").peer_key == "busy"


def test_sessions_and_completions():
    reg = Registry()
    _add(reg, "p1")
    reg.create_session(session_id="s1", peer_key="p1", client_key="c1",
                       model_name="m1", ttl_s=60)
    assert reg.session_valid("s1")
    assert not reg.session_valid("nope")
    reg.create_session(session_id="s2", peer_key="p1", client_key="c1",
                       model_name="m1", ttl_s=-1)  # already expired
    assert not reg.session_valid("s2")
    reg.report_completion(peer_key="p1", session_id="s1", tokens=42)


def test_stale_provider_detection():
    reg = Registry()
    _add(reg, "p1")
    assert reg.stale_providers(older_than_s=60) == []
    assert reg.stale_providers(older_than_s=-1) == ["p1"]


def test_list_models_aggregates():
    reg = Registry()
    _add(reg, "p1", model="llama3:8b", maxc=10, conns=3)
    _add(reg, "p2", model="llama3:8b", maxc=10)
    _add(reg, "p3", model="mistral-7b")
    models = {m["model_name"]: m for m in reg.list_models()}
    assert models["llama3:8b"]["providers"] == 2
    assert models["llama3:8b"]["free_slots"] == 17


def test_session_tokens_offline_verification():
    server = Identity.from_name("srv")
    tok = tokens.mint(server, session_id="s1", client_key="c1",
                      model_name="llama3:8b", ttl_s=60)
    assert tokens.verify(tok, server.public_key) is not None
    assert tokens.verify(tok, server.public_key, client_key="c1",
                         model_name="llama3:8b") is not None
    # Wrong binding → rejected.
    assert tokens.verify(tok, server.public_key, client_key="other") is None
    assert tokens.verify(tok, server.public_key, model_name="other") is None
    # Wrong server key → rejected.
    assert tokens.verify(tok, Identity.from_name("fake").public_key) is None
    # Tampered payload → rejected.
    evil = {"payload": {**tok["payload"], "modelName": "gpt5"},
            "signature": tok["signature"]}
    assert tokens.verify(evil, server.public_key) is None
    # Expired → rejected.
    old = tokens.mint(server, session_id="s2", client_key="c1",
                      model_name="m", ttl_s=-1)
    assert tokens.verify(old, server.public_key) is None
    # Garbage shapes → rejected, no exception.
    for garbage in (None, "x", {}, {"payload": 1, "signature": "zz"},
                    {"payload": {}, "signature": "not-hex"}):
        assert tokens.verify(garbage, server.public_key) is None


def test_registry_migrates_pre_metrics_db(tmp_path):
    """A server DB created before the `metrics` column existed must be
    migrated in place (CREATE TABLE IF NOT EXISTS alone would leave it
    stale and break every provider row read)."""
    import sqlite3

    from symmetry_tpu_torch.server.registry import Registry

    path = str(tmp_path / "old.db")
    db = sqlite3.connect(path)
    db.execute("""CREATE TABLE peers (
        peer_key TEXT PRIMARY KEY, discovery_key TEXT NOT NULL, name TEXT,
        model_name TEXT NOT NULL, address TEXT,
        public INTEGER NOT NULL DEFAULT 1, online INTEGER NOT NULL DEFAULT 1,
        connections INTEGER NOT NULL DEFAULT 0,
        max_connections INTEGER NOT NULL DEFAULT 10,
        data_collection INTEGER NOT NULL DEFAULT 0, config TEXT,
        joined_at REAL NOT NULL, last_seen REAL NOT NULL)""")
    db.execute("INSERT INTO peers VALUES "
               "('pk','dk','n','m','a',1,1,0,10,0,NULL,1.0,1.0)")
    db.commit()
    db.close()

    reg = Registry(path)
    reg.set_metrics("pk", {"tok_s": 5})
    row = reg.get_provider("pk")
    assert row is not None and row.metrics == {"tok_s": 5}
    reg.close()
