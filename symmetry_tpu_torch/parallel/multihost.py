"""Serving from N ranks: one logical provider backed by N processes (port of
symmetry_tpu/parallel/multihost.py).

In the JAX package a one-host mesh is one process and only multi-host jobs
need this module. PyTorch has no single-controller mesh, so every mesh of N
ranks is N processes, on one host or several, and every rank must run the
same engine calls in the same order (each call's collectives pair up across
ranks). Three pieces, as in the JAX package:

  1. `init_distributed` -- torch.distributed bring-up: coordinator address,
     process count, rank, and this rank's device. Ranks swap their devices
     through the coordinator's store first, so the collective backend is
     chosen by a rule, not by trying: "nccl" when every rank has a card of
     its own, "gloo" when two ranks share a card (NCCL refuses that) or run
     on the CPU. Idempotent, with a timeout.
  2. `build_multihost_mesh` -- the mesh over every rank of the job, its
     `data` axis across hosts when `dcn_data` > 1.
  3. `CommandLoop` -- the rank-0 control plane: rank 0's scheduler decides
     every engine call; each is broadcast to all ranks and executed by
     every rank, rank 0 included, from the same decoded command.

Commands ride a fixed-shape int32 vector whose layout and milli-unit
quantisation are the JAX package's (`Command.encode` gives its vector
element for element), plus one trailing word: the length of a payload that
follows in a second broadcast when a call carries more than the vector
holds (a batch of prompts, a prefix hit's id, the drafts). Three changes
from the JAX package, each needed because a PyTorch rank is a process:

  - the broadcast is `torch.distributed.broadcast` on a CPU (gloo) control
    group (the mesh's `control`), whatever the data collectives' backend;
  - `CommandLoop` executes through the engine gate when one is given
    (engine/host.py GatedEngine), so a profiler capture that holds the gate
    never races the launches;
  - the loop covers every dispatching method the port's Scheduler calls --
    prefill_and_insert(_many, _cached), start/advance_chunked_prefill,
    decode_steps_dispatch, verify_step_dispatch, release_slot, warmup,
    idle_tick -- and prefix_lookup with its hit's release, because the
    radix tree's LRU and pins are host state every rank must evolve alike.
    Host-side reads (slot_length, bucket_for, prefix_cache_stats,
    weight_stream_bytes*) stay on rank 0. Followers keep rank 0's hits and
    chunked-prefill jobs under ids the commands carry; their engines make
    no decision rank 0 did not make.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
from symmetry_tpu_torch.utils.logging import logger as log

# Command kinds (slot 0 of the broadcast vector): the JAX package's ...
CMD_IDLE = 0      # no-op heartbeat (keeps workers in lockstep while empty)
CMD_PREFILL = 1   # prefill + insert one request
CMD_DECODE = 2    # advance all slots one decode block
CMD_STOP = 3      # shut down the loop
CMD_WARMUP = 4    # run the serving shapes once (pre-traffic)
# ... and the rest of the port's Scheduler surface.
CMD_PREFILL_MANY = 5     # coalesced prefill of a batch of prompts
CMD_PREFILL_CACHED = 6   # a group admitted from one prefix hit
CMD_CHUNK_START = 7      # begin a chunked prefill (optionally seeded)
CMD_CHUNK_ADVANCE = 8    # one chunk of the slot's job
CMD_VERIFY = 9           # one speculative verify
CMD_RELEASE_SLOT = 10    # a finished slot
CMD_LOOKUP = 11          # radix-cache lookup (touches the LRU, pins)
CMD_HIT_RELEASE = 12     # unpin a hit the scheduler did not dispatch

# Vector layout: [kind, slot, true_len, bucket, temp_milli, top_p_milli,
#                 top_k, seed_or_-1, tokens...(max_bucket)]
_HEADER = 8
# Words of one request's sampling in a payload: temperature and top_p in
# milli-units, top_k, seed or -1, rng_skip.
_SAMPLING_WORDS = 5

# A collective that waits longer than this fails (a follower whose leader
# died without closing its sockets); the leader's idle heartbeat keeps an
# idle loop well inside it.
PG_TIMEOUT_S = 1800.0


@dataclass(frozen=True)
class Layout:
    """Every rank's device, by rank, and the backend chosen from them."""

    devices: tuple[str, ...]
    backend: str
    rank: int


_layout: Layout | None = None


def layout() -> Layout | None:
    """The layout init_distributed recorded, or None."""
    return _layout


def _resolve_device(device: str | torch.device, local_rank: int
                    ) -> tuple[torch.device, bool]:
    """(this rank's device, whether the caller named it exactly). A bare
    "cuda" takes cuda:(local_rank % device_count)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        return (torch.device("cuda", local_rank % torch.cuda.device_count()),
                False)
    return device, True


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, *, device: str | torch.device = "cuda",
                     timeout_s: float = PG_TIMEOUT_S) -> Layout:
    """Join the torch.distributed job (idempotent per process: a provider
    restart re-enters this).

    `coordinator_address` is "host:port" (or "tcp://host:port"): rank 0
    serves the store there. Each rank resolves its device (a bare "cuda"
    takes cuda:(local_rank % device_count)), the ranks swap devices through
    the store, and the backend follows: "nccl" when every rank has a card
    of its own, else "gloo". Two ranks share a card only when both named
    it (e.g. device "cuda:0"): a bare "cuda" that would land two ranks on
    one card raises."""
    global _layout
    if dist.is_initialized():
        if _layout is None:
            raise RuntimeError("torch.distributed was initialized outside "
                               "init_distributed")
        return _layout
    host, _, port = coordinator_address.removeprefix("tcp://").rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    swap = dist.PrefixStore("symmetry_layout", store)
    me = socket.gethostname()
    swap.set(f"host/{process_id}", me)
    hosts = [swap.get(f"host/{r}").decode() for r in range(num_processes)]
    local_rank = sum(1 for r in range(process_id) if hosts[r] == me)
    dev, explicit = _resolve_device(device, local_rank)
    swap.set(f"device/{process_id}", f"{int(explicit)} {dev}")
    named = [swap.get(f"device/{r}").decode().split()
             for r in range(num_processes)]
    devices = tuple(d for _, d in named)
    cards = [(hosts[r], devices[r]) for r in range(num_processes)
             if devices[r].startswith("cuda")]
    shared = len(set(cards)) < len(cards)
    if shared:
        for r in range(num_processes):
            same = [s for s in range(num_processes)
                    if (hosts[s], devices[s]) == (hosts[r], devices[r])]
            if len(same) > 1 and named[r][0] == "0":
                raise ValueError(
                    f"ranks {same} would share {devices[r]} on {hosts[r]}: "
                    f"name the card (e.g. device 'cuda:0') on every rank "
                    f"to lay them out on one card")
    backend = ("nccl" if len(cards) == num_processes and not shared
               else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _layout = Layout(devices=devices, backend=backend, rank=process_id)
    log.info(f"torch.distributed up: rank {process_id}/{num_processes} on "
             f"{dev}, backend {backend}, devices {list(devices)}"
             + (" (ranks share a card)" if shared else ""))
    return _layout


def multihost_spec(ici: MeshSpec | dict, dcn_data: int = 1) -> MeshSpec:
    """The job's whole mesh shape: `ici` (one host's share) with its data
    axis times `dcn_data`, the hosts along it."""
    if isinstance(ici, dict):
        ici = MeshSpec.from_dict(ici)
    if dcn_data < 1:
        raise ValueError(f"dcn_data {dcn_data} must be >= 1")
    return dataclasses.replace(ici, data=ici.data * dcn_data)


def build_multihost_mesh(ici: MeshSpec | dict, dcn_data: int = 1) -> Mesh:
    """The mesh over every rank of the job: `ici` is one host's share of
    it and `dcn_data` the number of hosts along the data axis, the JAX
    hybrid mesh's layout with a process a granule. The mesh's data axis is
    dcn_data x ici.data, every other axis ici's. Ranks are host-major:
    host h runs ranks h * ici.size ... (h + 1) * ici.size - 1, which hold
    data indices h * ici.data ... (h + 1) * ici.data - 1, so every
    collective but the data axis's stays inside a host. A rank is one
    process with one device, so the job has dcn_data x ici.size ranks
    (num_processes counts ranks; in the JAX package a process is a host
    of several devices)."""
    if isinstance(ici, dict):
        ici = MeshSpec.from_dict(ici)
    spec = multihost_spec(ici, dcn_data)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spec.size != world:
        raise ValueError(
            f"multihost mesh ({dcn_data} hosts x ici {ici.shape()}) covers "
            f"{spec.size} ranks but the job has {world}: every global "
            f"device must be in the mesh")
    if dcn_data > 1 and ici.stage > 1:
        # A stage axis outside the data axis would interleave the hosts'
        # ranks; the engine refuses stage beside data anyway.
        raise ValueError("dcn_data > 1 with a stage axis: the data axis "
                         "spans hosts only in a mesh without stages")
    return build_mesh(spec)


@dataclass
class Command:
    kind: int
    slot: int = 0
    true_len: int = 0
    bucket: int = 0
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int | None = None
    tokens: np.ndarray | None = None  # [true_len] int32
    # The port's: words that ride after the vector (not part of encode).
    payload: np.ndarray | None = None

    def encode(self, max_bucket: int) -> np.ndarray:
        vec = np.zeros((_HEADER + max_bucket,), np.int32)
        vec[0] = self.kind
        vec[1] = self.slot
        vec[2] = self.true_len
        vec[3] = self.bucket
        vec[4] = int(self.temperature * 1000)
        vec[5] = int(self.top_p * 1000)
        vec[6] = self.top_k
        vec[7] = -1 if self.seed is None else self.seed
        if self.tokens is not None:
            vec[_HEADER:_HEADER + len(self.tokens)] = self.tokens
        return vec

    @classmethod
    def decode(cls, vec: np.ndarray) -> "Command":
        kind, slot, true_len, bucket = (int(vec[0]), int(vec[1]),
                                        int(vec[2]), int(vec[3]))
        seed = int(vec[7])
        return cls(
            kind=kind, slot=slot, true_len=true_len, bucket=bucket,
            temperature=vec[4] / 1000.0, top_p=vec[5] / 1000.0,
            top_k=int(vec[6]), seed=None if seed < 0 else seed,
            tokens=np.asarray(vec[_HEADER:_HEADER + true_len], np.int32),
        )


def _sampling_words(sampling) -> list[int]:
    seed = sampling.seed
    return [int(sampling.temperature * 1000), int(sampling.top_p * 1000),
            int(sampling.top_k), -1 if seed is None else int(seed),
            int(sampling.rng_skip or 0)]


def _sampling_from(words) -> Any:
    from symmetry_tpu_torch.engine.engine import SamplingParams

    temp, top_p, top_k, seed, skip = (int(w) for w in words)
    return SamplingParams(temperature=temp / 1000.0, top_p=top_p / 1000.0,
                          top_k=top_k, seed=None if seed < 0 else seed,
                          rng_skip=skip)


def _encode_assignments(assignments) -> list[int]:
    words = [len(assignments)]
    for slot, ids, sampling in assignments:
        words += [int(slot), len(ids), *_sampling_words(sampling)]
        words += [int(t) for t in ids]
    return words


def _decode_assignments(words: np.ndarray) -> list:
    out, at = [], 1
    for _ in range(int(words[0])):
        slot, n = int(words[at]), int(words[at + 1])
        sampling = _sampling_from(words[at + 2:at + 2 + _SAMPLING_WORDS])
        at += 2 + _SAMPLING_WORDS
        out.append((slot, [int(t) for t in words[at:at + n]], sampling))
        at += n
    return out


class CommandLoop:
    """Lockstep engine calls: rank 0 leads, all ranks follow.

    Rank 0 calls `lead(cmd)`; workers run `follow_forever()`. Both paths
    end in identical `InferenceEngine` method calls on the decoded command.
    With `gate` (a lock), every engine call runs through
    engine/host.py GatedEngine: it holds the gate, and so does the host
    copy of each dispatch's result."""

    def __init__(self, engine, *, is_coordinator: bool, gate=None) -> None:
        if gate is not None:
            from symmetry_tpu_torch.engine.host import GatedEngine

            engine = GatedEngine(engine, gate)
        self.engine = engine
        self.is_coordinator = is_coordinator
        self.max_bucket = max(engine.prefill_buckets)
        self.group = engine.mesh.control
        self._lead_lock = threading.Lock()
        # Rank 0's decisions that later commands refer to, kept alike on
        # every rank: prefix hits by lookup number, chunked jobs by slot.
        self._hits: dict[int, Any] = {}
        self._lookups = 0
        self._jobs: dict[int, Any] = {}

    # -------------------------------------------------------------- shared

    def _execute(self, cmd: Command):
        eng, k, words = self.engine, cmd.kind, cmd.payload
        if k == CMD_PREFILL:
            from symmetry_tpu_torch.engine.engine import SamplingParams

            sampling = SamplingParams(
                temperature=cmd.temperature, top_p=cmd.top_p,
                top_k=cmd.top_k, seed=cmd.seed,
                rng_skip=int(words[0]) if words is not None else 0)
            return eng.prefill_and_insert(
                cmd.slot, list(map(int, cmd.tokens)), sampling)
        if k == CMD_DECODE:
            return eng.decode_steps_dispatch()
        if k == CMD_WARMUP:
            return eng.warmup()
        if k == CMD_PREFILL_MANY:
            return eng.prefill_and_insert_many(_decode_assignments(words))
        if k == CMD_PREFILL_CACHED:
            return eng.prefill_and_insert_cached(
                _decode_assignments(words[1:]), self._hits[int(words[0])])
        if k == CMD_CHUNK_START:
            hid = int(words[0])
            ((slot, ids, sampling),) = _decode_assignments(words[1:])
            job = eng.start_chunked_prefill(
                slot, ids, sampling,
                hit=self._hits[hid] if hid >= 0 else None)
            self._jobs[slot] = job
            return job
        if k == CMD_CHUNK_ADVANCE:
            tok = eng.advance_chunked_prefill(self._jobs[cmd.slot])
            if tok is not None:
                self._jobs.pop(cmd.slot)
            return tok
        if k == CMD_VERIFY:
            B = eng.max_slots
            draft = np.asarray(words[:-B], np.int64).reshape(B, -1)
            return eng.verify_step_dispatch(draft,
                                            np.asarray(words[-B:], np.int32))
        if k == CMD_RELEASE_SLOT:
            return eng.release_slot(cmd.slot)
        if k == CMD_LOOKUP:
            # Hits released since the last lookup are done with: the
            # scheduler never dispatches a hit across admission rounds.
            for hid in [h for h, hit in self._hits.items() if hit._released]:
                del self._hits[hid]
            self._lookups += 1
            hit = eng.prefix_lookup([int(t) for t in (
                words if words is not None else ())])
            if hit is not None:
                self._hits[self._lookups] = hit
            return self._lookups, hit
        if k == CMD_HIT_RELEASE:
            hit = self._hits.pop(int(words[0]), None)
            if hit is not None:
                hit.release()
            return None
        return None

    def _broadcast(self, vec: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(vec, np.int32))
        dist.broadcast(t, src=0, group=self.group)
        return t.numpy()

    def _frame_size(self) -> int:
        return _HEADER + self.max_bucket + 1  # + the payload length word

    # -------------------------------------------------------------- rank 0

    def lead(self, cmd: Command):
        """Broadcast a command and execute it locally (rank 0 only).

        Executes the DECODED round-trip of the wire words, not the original
        command -- the milli-unit quantization of temperature/top_p must be
        identical on every rank or the replicated state diverges."""
        if not self.is_coordinator:
            raise RuntimeError("only rank 0 leads the command loop")
        payload = (np.zeros((0,), np.int32) if cmd.payload is None
                   else np.asarray(cmd.payload, np.int32))
        frame = np.concatenate([cmd.encode(self.max_bucket),
                                [len(payload)]]).astype(np.int32)
        with self._lead_lock:
            self._broadcast(frame)
            if len(payload):
                self._broadcast(payload)
            got = Command.decode(frame[:-1])
            got.payload = payload if len(payload) else None
            return self._execute(got)

    def idle_tick(self) -> None:
        """Heartbeat while no requests are active: workers sit inside the
        broadcast, and a collective that rank 0 never enters times out."""
        with self._lead_lock:
            self._broadcast(np.concatenate([
                Command(kind=CMD_IDLE).encode(self.max_bucket), [0]]))

    def stop(self) -> None:
        if self.is_coordinator:
            with self._lead_lock:
                self._broadcast(np.concatenate([
                    Command(kind=CMD_STOP).encode(self.max_bucket), [0]]))

    # -------------------------------------------------------------- workers

    def follow_forever(self) -> None:
        """Worker loop: receive and mirror rank 0's engine calls. A call
        that raises here raised on rank 0 too (the same call on the same
        state); it is logged and the loop goes on, as rank 0's scheduler
        does."""
        if self.is_coordinator:
            raise RuntimeError("rank 0 leads; it does not follow")
        while True:
            frame = self._broadcast(np.zeros((self._frame_size(),), np.int32))
            n = int(frame[-1])
            cmd = Command.decode(frame[:-1])
            if n:
                cmd.payload = self._broadcast(np.zeros((n,), np.int32))
            if cmd.kind == CMD_STOP:
                return
            if cmd.kind == CMD_IDLE:
                continue
            try:
                self._execute(cmd)
            except Exception as exc:  # noqa: BLE001 -- mirrors rank 0's
                log.warning(f"follower: command {cmd.kind} raised {exc!r}")


class _LedHit:
    """Rank 0's handle on a prefix hit that every rank holds under one id:
    reads go to rank 0's hit, release() is led through the loop."""

    def __init__(self, loop: CommandLoop, hid: int, hit) -> None:
        self._loop = loop
        self._hid = hid
        self._hit = hit

    def __getattr__(self, name: str):
        return getattr(self._hit, name)

    def release(self) -> None:
        if not self._hit._released:
            self._loop.lead(Command(kind=CMD_HIT_RELEASE,
                                    payload=[self._hid]))


def _pin_seed(sampling):
    """Pin per-request entropy on rank 0: each process has different local
    entropy, and an unseeded request executed per process would diverge
    the replicated state. Rank 0 chooses, all follow. Client-controlled
    seeds fold into the non-negative int32 range the wire carries."""
    import dataclasses

    seed = sampling.seed
    if seed is None:
        seed = int.from_bytes(os.urandom(3), "little")
    return dataclasses.replace(sampling, seed=seed % (2**31))


class MultihostEngine:
    """Engine facade for the scheduler on rank 0: every dispatching call is
    led through the CommandLoop so the other ranks stay in lockstep; every
    other attribute reads rank 0's engine, so the facade's surface is the
    engine's."""

    # Mutating calls no path through the loop serves: refused, never run
    # on rank 0 alone.
    _REFUSED = frozenset({"adopt_prefix", "extract_slot_kv", "decode_step"})

    def __init__(self, loop: CommandLoop) -> None:
        self._loop = loop

    def __getattr__(self, name: str):
        if name in self._REFUSED:
            raise AttributeError(f"{name} is not served on a mesh")
        return getattr(self._loop.engine, name)

    def _lead(self, kind: int, *, slot: int = 0, payload=None):
        return self._loop.lead(Command(kind=kind, slot=slot,
                                       payload=payload))

    def prefill_and_insert(self, slot: int, prompt_ids, sampling) -> int:
        n = len(prompt_ids)
        bucket = self._loop.engine.bucket_for(n)
        sampling = _pin_seed(sampling)
        cmd = Command(
            kind=CMD_PREFILL, slot=slot, true_len=n, bucket=bucket,
            temperature=sampling.temperature, top_p=sampling.top_p,
            top_k=sampling.top_k, seed=sampling.seed,
            tokens=np.asarray(prompt_ids, np.int32),
            payload=[sampling.rng_skip] if sampling.rng_skip else None)
        return self._loop.lead(cmd)

    def prefill_and_insert_many(self, assignments) -> list[int]:
        pinned = [(s, ids, _pin_seed(sp)) for s, ids, sp in assignments]
        return self._lead(CMD_PREFILL_MANY,
                          payload=_encode_assignments(pinned))

    def prefill_and_insert_cached(self, assignments, hit) -> list[int]:
        pinned = [(s, ids, _pin_seed(sp)) for s, ids, sp in assignments]
        return self._lead(CMD_PREFILL_CACHED, payload=[
            hit._hid, *_encode_assignments(pinned)])

    def start_chunked_prefill(self, slot: int, prompt_ids, sampling,
                              hit=None):
        hid = -1 if hit is None else hit._hid
        return self._lead(CMD_CHUNK_START, payload=[hid, *_encode_assignments(
            [(slot, prompt_ids, _pin_seed(sampling))])])

    def advance_chunked_prefill(self, job):
        return self._lead(CMD_CHUNK_ADVANCE, slot=job.slot)

    def decode_steps_dispatch(self):
        return self._lead(CMD_DECODE)

    def decode_steps(self) -> np.ndarray:
        return np.asarray(self.decode_steps_dispatch())

    def verify_step_dispatch(self, draft: np.ndarray, n_draft: np.ndarray):
        B = self._loop.engine.max_slots
        if draft.shape[0] != B or n_draft.shape != (B,):
            raise ValueError(f"draft {draft.shape} / n_draft {n_draft.shape} "
                             f"for {B} slots")
        return self._lead(CMD_VERIFY, payload=np.concatenate([
            np.asarray(draft, np.int32).ravel(),
            np.asarray(n_draft, np.int32)]))

    def verify_step(self, draft: np.ndarray, n_draft: np.ndarray):
        toks, n_emit = self.verify_step_dispatch(draft, n_draft)
        return np.asarray(toks), np.asarray(n_emit)

    def release_slot(self, slot: int) -> None:
        self._lead(CMD_RELEASE_SLOT, slot=slot)

    def warmup(self) -> None:
        self._lead(CMD_WARMUP)

    def idle_tick(self) -> None:
        self._loop.idle_tick()

    def prefix_lookup(self, prompt_ids):
        if self._loop.engine.prefix_index is None:
            return None
        hid, hit = self._lead(CMD_LOOKUP, payload=list(prompt_ids))
        return None if hit is None else _LedHit(self._loop, hid, hit)
