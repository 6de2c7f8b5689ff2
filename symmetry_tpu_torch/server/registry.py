"""Peer/session registry: the server-side data model.

The reference repo ships only the provider, but its `src/types.ts:182-208`
preserves the server's SQLite schema as TypeScript types — `PeerUpsert`
(peer_key/discovery_key/config/model aliases), `Session`
(id/provider_id/created_at), `PeerWithSession` — and `sqlite3` remains a
declared dependency (package.json:17-19). This module implements that data
model: a sqlite-backed store of providers and sessions.

Load balancing rule ("The Tower ensures no single Provider bears too heavy a
burden", reference readme.md Architecture): selection = model match, online,
below max_connections, least-loaded first.
"""

from __future__ import annotations

import json
import sqlite3
import time
from dataclasses import dataclass
from typing import Any

from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

_SCHEMA = """
CREATE TABLE IF NOT EXISTS peers (
    peer_key        TEXT PRIMARY KEY,   -- hex Ed25519 public key
    discovery_key   TEXT NOT NULL,
    name            TEXT,
    model_name      TEXT NOT NULL,
    address         TEXT,               -- dialable address (tcp://host:port)
    public          INTEGER NOT NULL DEFAULT 1,
    online          INTEGER NOT NULL DEFAULT 1,
    connections     INTEGER NOT NULL DEFAULT 0,
    max_connections INTEGER NOT NULL DEFAULT 10,
    queued          INTEGER NOT NULL DEFAULT 0,  -- reported engine backlog
    queued_at       REAL NOT NULL DEFAULT 0,     -- when `queued` was reported

    data_collection INTEGER NOT NULL DEFAULT 0,
    config          TEXT,               -- sanitized config JSON (no secrets)
    metrics         TEXT,               -- latest load/latency report JSON
    joined_at       REAL NOT NULL,
    last_seen       REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_peers_model ON peers (model_name, online);
CREATE TABLE IF NOT EXISTS sessions (
    id          TEXT PRIMARY KEY,
    peer_key    TEXT NOT NULL,          -- provider
    client_key  TEXT,                   -- requesting client (hex)
    model_name  TEXT NOT NULL,
    created_at  REAL NOT NULL,
    expires_at  REAL NOT NULL,
    completed   INTEGER NOT NULL DEFAULT 0,
    tokens      INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS completions (
    id          INTEGER PRIMARY KEY AUTOINCREMENT,
    session_id  TEXT,
    peer_key    TEXT NOT NULL,
    tokens      INTEGER NOT NULL DEFAULT 0,
    reported_at REAL NOT NULL
);
"""


@dataclass(slots=True)
class ProviderRow:
    peer_key: str
    discovery_key: str
    name: str | None
    model_name: str
    address: str | None
    public: bool
    online: bool
    connections: int
    max_connections: int
    data_collection: bool
    config: dict[str, Any] | None
    metrics: dict[str, Any] | None      # latest METRICS report (tok/s, TTFT)
    joined_at: float
    last_seen: float


def _row_to_provider(row: sqlite3.Row) -> ProviderRow:
    return ProviderRow(
        peer_key=row["peer_key"],
        discovery_key=row["discovery_key"],
        name=row["name"],
        model_name=row["model_name"],
        address=row["address"],
        public=bool(row["public"]),
        online=bool(row["online"]),
        connections=row["connections"],
        max_connections=row["max_connections"],
        data_collection=bool(row["data_collection"]),
        config=json.loads(row["config"]) if row["config"] else None,
        metrics=json.loads(row["metrics"]) if row["metrics"] else None,
        joined_at=row["joined_at"],
        last_seen=row["last_seen"],
    )


class Registry:
    """sqlite peer/session store. ':memory:' for tests, file path for prod."""

    # A reported `queued` backlog steers selection only while fresh: shed-
    # triggered METRICS pushes stop once the backlog drains, so a stale
    # reading would keep deprioritizing a now-idle provider. Two provider
    # health-report intervals (provider.HEALTH_INTERVAL_S = 15 s) without
    # a fresh report → the backlog is treated as 0.
    QUEUED_STALE_S = 30.0

    def __init__(self, db_path: str = ":memory:") -> None:
        self._db = sqlite3.connect(db_path)
        self._db.row_factory = sqlite3.Row
        self._db.executescript(_SCHEMA)
        self._migrate()
        # Restart recovery: anything marked online in a previous run is stale.
        self._db.execute(
            "UPDATE peers SET online = 0, connections = 0, queued = 0,"
            " queued_at = 0")
        self._db.commit()
        # Server-side fleet telemetry (utils/metrics.py): the router's
        # steering inputs as always-on series — online count and each
        # provider's reported engine backlog (the `queued` column the
        # steering ORDER BY reads).
        self._m_online = METRICS.gauge(
            MetricName.SERVER_PROVIDERS_ONLINE,
            "providers currently online")
        self._m_queued = METRICS.gauge(
            MetricName.SERVER_PROVIDER_QUEUED,
            "per-provider reported engine backlog",
            labels=("provider", "model"))

    def _gauge_online(self) -> None:
        row = self._db.execute(
            "SELECT COUNT(*) AS n FROM peers WHERE online = 1").fetchone()
        self._m_online.set(int(row["n"]))

    def _migrate(self) -> None:
        """Columns added after a release: CREATE TABLE IF NOT EXISTS is a
        no-op on a pre-existing file DB, so bring it up to schema here."""
        have = {row["name"] for row in
                self._db.execute("PRAGMA table_info(peers)")}
        if "metrics" not in have:
            self._db.execute("ALTER TABLE peers ADD COLUMN metrics TEXT")
        if "queued" not in have:
            self._db.execute(
                "ALTER TABLE peers ADD COLUMN queued INTEGER NOT NULL "
                "DEFAULT 0")
        if "queued_at" not in have:
            self._db.execute(
                "ALTER TABLE peers ADD COLUMN queued_at REAL NOT NULL "
                "DEFAULT 0")
        self._db.commit()

    # --- providers (PeerUpsert semantics, reference src/types.ts:203-208) ---

    def upsert_provider(self, *, peer_key: str, discovery_key: str,
                        model_name: str, name: str | None = None,
                        address: str | None = None, public: bool = True,
                        max_connections: int = 10, data_collection: bool = False,
                        config: dict[str, Any] | None = None) -> None:
        now = time.time()
        self._db.execute(
            """INSERT INTO peers (peer_key, discovery_key, name, model_name, address,
                                  public, online, connections, max_connections,
                                  data_collection, config, joined_at, last_seen)
               VALUES (?,?,?,?,?,?,1,0,?,?,?,?,?)
               ON CONFLICT(peer_key) DO UPDATE SET
                   discovery_key=excluded.discovery_key, name=excluded.name,
                   model_name=excluded.model_name, address=excluded.address,
                   public=excluded.public, online=1, connections=0,
                   max_connections=excluded.max_connections,
                   data_collection=excluded.data_collection,
                   config=excluded.config, last_seen=excluded.last_seen""",
            (peer_key, discovery_key, name, model_name, address, int(public),
             max_connections, int(data_collection),
             json.dumps(config) if config else None, now, now),
        )
        self._db.commit()
        self._gauge_online()

    def set_offline(self, peer_key: str) -> None:
        row = self.get_provider(peer_key)
        self._db.execute(
            "UPDATE peers SET online = 0, connections = 0 WHERE peer_key = ?",
            (peer_key,),
        )
        self._db.commit()
        self._gauge_online()
        # Drop the departed provider's backlog series: a labeled gauge
        # otherwise exports its last value forever, and churn of
        # ephemeral providers would grow series without bound.
        if row is not None:
            self._m_queued.remove(provider=peer_key[:12],
                                  model=row.model_name)

    def touch(self, peer_key: str) -> None:
        self._db.execute(
            "UPDATE peers SET last_seen = ? WHERE peer_key = ?",
            (time.time(), peer_key),
        )
        self._db.commit()

    def set_metrics(self, peer_key: str, metrics: dict[str, Any]) -> None:
        """Latest provider load/latency report (`metrics` key): tok/s,
        in-flight, TTFT percentiles — the server-side view of provider
        health beyond liveness. The reported engine backlog (`queued`) is
        lifted into its own column so select_provider can steer away from
        overloaded providers without parsing JSON per candidate."""
        queued = metrics.get("queued")
        # bool is an int subclass: True would silently steer as backlog 1.
        if (not isinstance(queued, int) or isinstance(queued, bool)
                or queued < 0):
            queued = 0
        now = time.time()
        self._db.execute(
            "UPDATE peers SET metrics = ?, queued = ?, queued_at = ?,"
            " last_seen = ? WHERE peer_key = ?",
            (json.dumps(metrics), queued, now, now, peer_key),
        )
        self._db.commit()
        # Gauge only for a LIVE provider: a straggler METRICS heartbeat
        # processed after set_offline must not resurrect the series the
        # offline path just removed (it would then export its last
        # value forever — the churn leak the removal exists to stop).
        row = self.get_provider(peer_key)
        if row is not None and row.online:
            self._m_queued.set(queued, provider=peer_key[:12],
                               model=row.model_name)

    def set_connections(self, peer_key: str, count: int) -> None:
        """`conectionSize` reports (reference key, src/constants.ts:5)."""
        self._db.execute(
            "UPDATE peers SET connections = ?, last_seen = ? WHERE peer_key = ?",
            (count, time.time(), peer_key),
        )
        self._db.commit()

    def get_provider(self, peer_key: str) -> ProviderRow | None:
        row = self._db.execute(
            "SELECT * FROM peers WHERE peer_key = ?", (peer_key,)
        ).fetchone()
        return _row_to_provider(row) if row else None

    def select_provider(self, model_name: str | None = None,
                        exclude: tuple[str, ...] = ()) -> ProviderRow | None:
        """Model-matched, online, capacity-available, least-loaded provider.

        `exclude` drops specific peer keys — clients re-requesting after a
        provider died mid-stream must not be handed the same one back."""
        query = (
            "SELECT * FROM peers WHERE online = 1 AND public = 1"
            " AND connections < max_connections"
        )
        params: list = []
        if model_name:
            query += " AND model_name = ?"
            params.append(model_name)
        if exclude:
            query += (" AND peer_key NOT IN ("
                      + ",".join("?" * len(exclude)) + ")")
            params.extend(exclude)
        # Steering: reported engine backlog first (a provider shedding
        # load must stop receiving assignments while an idle one exists),
        # then the reference's least-loaded-by-connections order. A
        # backlog report older than QUEUED_STALE_S is decayed to 0 — the
        # provider stopped pushing METRICS because it stopped shedding.
        query += (" ORDER BY (CASE WHEN queued_at >= ? THEN queued"
                  " ELSE 0 END) ASC,"
                  " CAST(connections AS REAL) / max_connections ASC,"
                  " last_seen DESC LIMIT 1")
        params.append(time.time() - self.QUEUED_STALE_S)
        row = self._db.execute(query, tuple(params)).fetchone()
        return _row_to_provider(row) if row else None

    def list_providers(self, online_only: bool = True) -> list[ProviderRow]:
        q = "SELECT * FROM peers"
        if online_only:
            q += " WHERE online = 1"
        return [_row_to_provider(r) for r in self._db.execute(q)]

    def list_models(self) -> list[dict[str, Any]]:
        rows = self._db.execute(
            """SELECT model_name, COUNT(*) AS providers,
                      SUM(max_connections - connections) AS free_slots
               FROM peers WHERE online = 1 AND public = 1 GROUP BY model_name"""
        )
        return [dict(r) for r in rows]

    def stale_providers(self, older_than_s: float) -> list[str]:
        cutoff = time.time() - older_than_s
        rows = self._db.execute(
            "SELECT peer_key FROM peers WHERE online = 1 AND last_seen < ?",
            (cutoff,),
        )
        return [r["peer_key"] for r in rows]

    # --- sessions (reference src/types.ts:182-201) ---

    def create_session(self, *, session_id: str, peer_key: str,
                       client_key: str | None, model_name: str,
                       ttl_s: float = 3600.0) -> None:
        now = time.time()
        self._db.execute(
            """INSERT INTO sessions (id, peer_key, client_key, model_name,
                                     created_at, expires_at) VALUES (?,?,?,?,?,?)""",
            (session_id, peer_key, client_key, model_name, now, now + ttl_s),
        )
        self._db.commit()

    def invalidate_sessions_for(self, peer_key: str) -> int:
        """Expire every incomplete session assigned to a dead provider so
        verifySession reports them invalid and clients re-request
        (SURVEY §5.3: request requeue on provider loss). Returns the count
        invalidated."""
        cur = self._db.execute(
            "UPDATE sessions SET expires_at = 0"
            " WHERE peer_key = ? AND completed = 0 AND expires_at > ?",
            (peer_key, time.time()),
        )
        self._db.commit()
        return cur.rowcount

    def session_valid(self, session_id: str) -> bool:
        row = self._db.execute(
            "SELECT expires_at FROM sessions WHERE id = ?", (session_id,)
        ).fetchone()
        return bool(row and row["expires_at"] > time.time())

    def report_completion(self, *, peer_key: str, session_id: str | None,
                          tokens: int) -> None:
        self._db.execute(
            "INSERT INTO completions (session_id, peer_key, tokens, reported_at)"
            " VALUES (?,?,?,?)",
            (session_id, peer_key, tokens, time.time()),
        )
        if session_id:
            self._db.execute(
                "UPDATE sessions SET completed = 1, tokens = tokens + ? WHERE id = ?",
                (tokens, session_id),
            )
        self._db.commit()

    def close(self) -> None:
        self._db.close()
