"""Registry steering hygiene: reported backlog freshness and typing.

(Split from test_server.py so the sqlite data model is testable without
the broker's crypto stack.)
"""

import time

from symmetry_tpu_torch.server.registry import Registry


def add(reg: Registry, key: str) -> None:
    reg.upsert_provider(peer_key=key, discovery_key="d-" + key,
                        model_name="m", max_connections=10)


def queued_of(reg: Registry, key: str) -> int:
    row = reg._db.execute(
        "SELECT queued FROM peers WHERE peer_key = ?", (key,)).fetchone()
    return row["queued"]


def test_bool_queued_is_not_a_backlog():
    """isinstance(True, int) holds — a provider reporting queued=True
    must not be steered away from as if it had backlog 1."""
    reg = Registry()
    add(reg, "a")
    reg.set_metrics("a", {"queued": True})
    assert queued_of(reg, "a") == 0
    reg.set_metrics("a", {"queued": 3})
    assert queued_of(reg, "a") == 3
    reg.set_metrics("a", {"queued": False})
    assert queued_of(reg, "a") == 0


def test_fresh_backlog_steers_away():
    reg = Registry()
    add(reg, "busy")
    add(reg, "idle")
    reg.set_metrics("busy", {"queued": 64})
    reg.set_metrics("idle", {"queued": 0})
    # make `busy` otherwise preferable, so only the backlog steers
    reg.set_connections("idle", 5)
    assert reg.select_provider("m").peer_key == "idle"


def test_stale_backlog_decays_to_zero():
    """Shed-triggered METRICS pushes stop once the backlog drains; after
    ~2 report intervals without a fresh report the old reading must stop
    deprioritizing the (now idle) provider."""
    reg = Registry()
    add(reg, "busy")
    add(reg, "idle")
    reg.set_metrics("busy", {"queued": 64})
    reg.set_metrics("idle", {"queued": 0})
    reg.set_connections("idle", 5)  # `busy` wins on load once decayed
    # age the backlog report past the staleness horizon; liveness pings
    # (touch) keep last_seen fresh — only queued_at governs decay
    reg._db.execute("UPDATE peers SET queued_at = ? WHERE peer_key = ?",
                    (time.time() - Registry.QUEUED_STALE_S - 1, "busy"))
    reg._db.commit()
    reg.touch("busy")
    assert reg.select_provider("m").peer_key == "busy"


def test_fresh_report_resets_staleness():
    reg = Registry()
    add(reg, "busy")
    add(reg, "idle")
    reg.set_metrics("busy", {"queued": 64})
    reg._db.execute("UPDATE peers SET queued_at = ? WHERE peer_key = ?",
                    (time.time() - Registry.QUEUED_STALE_S - 1, "busy"))
    reg._db.commit()
    reg.set_metrics("busy", {"queued": 32})  # fresh shed report
    reg.set_metrics("idle", {"queued": 0})
    reg.set_connections("idle", 5)
    assert reg.select_provider("m").peer_key == "idle"
