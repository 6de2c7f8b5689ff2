"""Versioned, length-prefixed KV-handoff frames.

Copied from symmetry_tpu/engine/disagg/frames.py with one change: numpy
has no bfloat16 type and the port does not use ml_dtypes, so a "bfloat16"
payload decodes as its raw uint16 words, viewed as `BFloat16Array` (a
uint16 ndarray subclass); the engine views them as torch.bfloat16
(engine/engine.py from_numpy_plane), as engine/safetensors_io.py does for
checkpoints. `encode_frame` writes a `BFloat16Array` under the wire name
"bfloat16", so a frame cut by either package decodes in the other, byte
for byte, and decoding then re-encoding a frame gives back its bytes.

The wire unit of disaggregated prefill/decode: the prefill tier
serializes a finished request's prefix KV (and, same format, a
prefix-cache entry's KV) into ONE self-describing binary frame; the
decode tier deserializes it and adopts the blocks into its radix tree
(`engine.adopt_prefix`). The format is deliberately dumb and
explicit — a handoff crosses process (and eventually chip/host)
boundaries, so every field that could silently corrupt a decode stream
is checked at parse time instead of trusted:

    magic   b"SYKV"                      wrong stream → FrameError
    u16     version (=2)                 unknown layout → FrameError
    u16     flags (bit 0: int8 KV)       quantization mismatch is loud
    u64     body length                  truncation → FrameError
    body    u32 header-JSON length, header JSON (meta: request id,
            prompt tokens, prefix length p, block size, the per-block
            digest MANIFEST, which block indices ship …), u16 array
            count, then per array: name, dtype name, shape, u64 payload
            length, raw row-major bytes
    u32     crc32(body)                  bit rot / torn write → FrameError

Version 2 (the radix/paged-KV round) makes the payload BLOCK-GRANULAR:
the prefix is cut into fixed-size token blocks, each block ships as its
own named arrays ("k:3", "v:3", …), and the meta carries a digest per
block (over the block's full causal token context). The sender may
OMIT blocks it has already shipped to this tier — the receiver adopts
omitted blocks by reference when its radix tree still holds them, or
shortens the adopted prefix when it doesn't (always causally sound).
That is what turns a warm multi-turn handoff from a full-prefix copy
into a few tail blocks on the wire. Version-1 frames (monolithic
slabs, no manifest) are REJECTED loudly, as any unknown version is.

Arrays are GQA-shaped per block ([layers, 1, bs, kv_heads, head_dim]
payloads; [layers, 1, kv_heads, bs] scale planes when the KV cache is
int8-quantized) but the codec itself is shape-agnostic — it round-trips
whatever named arrays it is given, so the same frames carry bf16/f32
caches, quantized caches, and future layouts without a version bump as
long as the meta describes them.

Host byte order is little-endian on every platform this runs on (x86,
TPU hosts, arm64); the format pins little-endian explicitly so a frame
written on one host parses on any other.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

MAGIC = b"SYKV"
VERSION = 2
FLAG_KV_INT8 = 1 << 0

# A frame is one request's prefix KV: even a 70B-scale cache slice is
# hundreds of MB, not GB. The bound exists so a corrupt length prefix
# fails parsing instead of driving a multi-GB allocation.
MAX_FRAME_BYTES = 4 << 30


class FrameError(ValueError):
    """Rejected handoff frame: truncated, corrupt, or wrong version."""


class BFloat16Array(np.ndarray):
    """uint16 words that hold bfloat16 values (numpy has no bfloat16
    type): written under the wire dtype name "bfloat16"."""


BFLOAT16 = "bfloat16"


def wire_dtype(arr: np.ndarray) -> str:
    """The dtype name an array travels under."""
    return BFLOAT16 if isinstance(arr, BFloat16Array) else arr.dtype.name


def _np_dtype(name: str) -> np.dtype:
    """Dtype from its serialized name; "bfloat16" payloads are read as
    their uint16 words."""
    if name == BFLOAT16:
        return np.dtype("<u2")
    try:
        return np.dtype(name)
    except TypeError:
        raise FrameError(
            f"unknown array dtype {name!r} in handoff frame") from None


def encode_frame(meta: dict, arrays: dict[str, np.ndarray],
                 *, flags: int = 0) -> bytes:
    """One meta dict + named arrays → a self-contained frame. `meta`
    must be JSON-serializable; arrays are written C-contiguous."""
    header = json.dumps(meta, separators=(",", ":")).encode()
    parts = [struct.pack("<I", len(header)), header,
             struct.pack("<H", len(arrays))]
    for name, arr in arrays.items():
        dtype_b = wire_dtype(arr).encode()
        arr = np.ascontiguousarray(arr)
        name_b = name.encode()
        parts.append(struct.pack("<H", len(name_b)))
        parts.append(name_b)
        parts.append(struct.pack("<H", len(dtype_b)))
        parts.append(dtype_b)
        parts.append(struct.pack("<H", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        data = arr.tobytes()
        parts.append(struct.pack("<Q", len(data)))
        parts.append(data)
    body = b"".join(parts)
    return b"".join([MAGIC, struct.pack("<HH", VERSION, flags),
                     struct.pack("<Q", len(body)), body,
                     struct.pack("<I", zlib.crc32(body))])


def decode_frame(buf: bytes) -> tuple[dict, dict[str, np.ndarray], int]:
    """Parse one frame → (meta, arrays, flags). Every structural check
    raises FrameError — a rejected frame must fail THIS request loudly,
    never adopt garbage KV into a live decode host."""
    if len(buf) < 16:
        raise FrameError(f"frame truncated: {len(buf)} bytes < 16-byte "
                         f"fixed header")
    if buf[:4] != MAGIC:
        raise FrameError(f"bad frame magic {buf[:4]!r}")
    version, flags = struct.unpack_from("<HH", buf, 4)
    if version != VERSION:
        raise FrameError(f"unsupported handoff frame version {version} "
                         f"(this build speaks {VERSION})")
    (body_len,) = struct.unpack_from("<Q", buf, 8)
    if body_len > MAX_FRAME_BYTES:
        raise FrameError(f"frame body length {body_len} exceeds the "
                         f"{MAX_FRAME_BYTES}-byte bound")
    if len(buf) != 16 + body_len + 4:
        raise FrameError(f"frame truncated: have {len(buf)} bytes, "
                         f"header promises {16 + body_len + 4}")
    body = buf[16:16 + body_len]
    (crc,) = struct.unpack_from("<I", buf, 16 + body_len)
    if zlib.crc32(body) != crc:
        raise FrameError("frame checksum mismatch (corrupt payload)")

    off = 0

    def take(n: int, what: str) -> bytes:
        nonlocal off
        if off + n > len(body):
            raise FrameError(f"frame body truncated reading {what}")
        out = body[off:off + n]
        off += n
        return out

    (header_len,) = struct.unpack("<I", take(4, "header length"))
    try:
        meta = json.loads(take(header_len, "header"))
    except ValueError as exc:
        raise FrameError(f"frame header is not valid JSON: {exc}") from exc
    if not isinstance(meta, dict):
        raise FrameError("frame header must be a JSON object")
    (n_arrays,) = struct.unpack("<H", take(2, "array count"))
    arrays: dict[str, np.ndarray] = {}
    for _ in range(n_arrays):
        (name_len,) = struct.unpack("<H", take(2, "array name length"))
        name = take(name_len, "array name").decode()
        (dtype_len,) = struct.unpack("<H", take(2, "dtype length"))
        dtype_name = take(dtype_len, "dtype name").decode()
        dtype = _np_dtype(dtype_name)
        (ndim,) = struct.unpack("<H", take(2, "rank"))
        shape = struct.unpack(f"<{ndim}I", take(4 * ndim, "shape"))
        (data_len,) = struct.unpack("<Q", take(8, "payload length"))
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if data_len != want:
            raise FrameError(
                f"array {name!r} payload is {data_len} bytes but shape "
                f"{shape} × {dtype.name} needs {want}")
        data = take(data_len, f"array {name!r} payload")
        arrays[name] = np.frombuffer(data, dtype=dtype).reshape(shape)
        if dtype_name == BFLOAT16:
            arrays[name] = arrays[name].view(BFloat16Array)
    if off != len(body):
        raise FrameError(f"{len(body) - off} trailing bytes after the "
                         f"last array")
    return meta, arrays, flags


# ---------------------------------------------------------------------
# The KV-handoff frame: the per-request block-granular payload the
# prefill tier ships to the decode tier.

_PLANE_KEYS = ("k", "v", "k_scale", "v_scale")
_PLANE_WIRE = {"k": "k", "v": "v", "k_scale": "ks", "v_scale": "vs"}
_WIRE_PLANE = {v: k for k, v in _PLANE_WIRE.items()}


@dataclass
class KVHandoff:
    """One decoded handoff: the full prompt's token ids, the prefix
    length `p` the manifest covers, the block size, the per-block
    digest manifest, and the GQA-shaped payloads of the blocks that
    actually shipped (a subset — the sender omits blocks it already
    shipped to this tier; `blocks` is empty when p == 0, the
    routing-only frame for prompts too short to hand off)."""

    request_id: str
    tokens: tuple[int, ...]        # FULL prompt (manifest covers [:p])
    p: int                         # prefix length covered by the manifest
    block_size: int = 0            # tokens per block (p // bs blocks)
    kv_quant: bool = False
    digests: tuple[str, ...] = ()  # hex digest per block, causal context
    # block index -> {"k", "v"[, "k_scale", "v_scale"]} per-block planes
    blocks: dict[int, dict[str, np.ndarray]] = field(default_factory=dict)

    @property
    def n_blocks(self) -> int:
        return self.p // self.block_size if self.block_size else 0

    @property
    def shipped(self) -> list[int]:
        return sorted(self.blocks)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for planes in self.blocks.values()
                   for a in planes.values())

    @property
    def arrays(self) -> dict[str, np.ndarray]:
        """Whole-prefix planes reassembled from the blocks — only valid
        when EVERY block shipped (tests and debugging; the engine adopts
        block-wise). Raises on a partial frame."""
        if self.p == 0:
            return {}
        if set(self.blocks) != set(range(self.n_blocks)):
            raise FrameError(
                f"cannot reassemble whole-prefix arrays: blocks "
                f"{self.shipped} of {self.n_blocks} shipped")
        out: dict[str, np.ndarray] = {}
        for key in _PLANE_KEYS:
            if key not in self.blocks[0]:
                continue
            axis = 3 if key.endswith("_scale") else 2
            out[key] = np.concatenate(
                [self.blocks[j][key] for j in range(self.n_blocks)],
                axis=axis)
        return out


def encode_kv_handoff(request_id: str, tokens, p: int,
                      arrays: dict[str, np.ndarray] | None,
                      *, kv_quant: bool = False, block_size: int = 0,
                      skip=(), digests: list[str] | None = None) -> bytes:
    """Serialize one request's prefix KV slice, blockwise. `arrays`
    holds the batch-1 cache planes sliced to `p` positions (k/v
    payloads, plus k_scale/v_scale when int8-quantized) — the codec
    cuts them into `block_size`-token blocks (0 → one block spanning
    the whole prefix) and ships each block as its own named arrays.
    `skip` names block indices to OMIT from the payload (already
    shipped to this tier — the receiver adopts them by reference or
    shortens the prefix); every block still appears in the digest
    manifest. A caller that already computed the manifest (the host's
    shipped-block ledger) passes it via `digests` instead of paying the
    hash twice. None/{} with p == 0 is the routing-only frame for
    prompts with no whole-block prefix."""
    from symmetry_tpu_torch.engine.prefix_cache import block_digests

    arrays = arrays or {}
    if p < 0 or p > len(tokens):
        raise ValueError(f"prefix length {p} outside prompt of "
                         f"{len(tokens)} tokens")
    if p == 0 and arrays:
        raise ValueError("p == 0 handoff must carry no KV arrays")
    bs = int(block_size) or int(p)
    out_arrays: dict[str, np.ndarray] = {}
    skip = set(skip)
    if p <= 0:
        digests = []
    if p > 0:
        missing = {"k", "v"} - set(arrays)
        if kv_quant:
            missing |= {"k_scale", "v_scale"} - set(arrays)
        if missing:
            raise ValueError(f"handoff missing KV planes: {sorted(missing)}")
        if bs < 1 or p % bs:
            raise ValueError(f"prefix length {p} is not a multiple of "
                             f"block size {bs}")
        if digests is None:
            digests = block_digests(list(tokens), p, bs)
        elif len(digests) != p // bs:
            raise ValueError(f"caller-supplied manifest has {len(digests)} "
                             f"digests for {p // bs} blocks")
        if not skip <= set(range(p // bs)):
            raise ValueError(f"skip indices {sorted(skip)} outside the "
                             f"{p // bs}-block manifest")
        for j in range(p // bs):
            if j in skip:
                continue
            for key, wire in _PLANE_WIRE.items():
                if key not in arrays:
                    continue
                axis = 3 if key.endswith("_scale") else 2
                sl = [slice(None)] * arrays[key].ndim
                sl[axis] = slice(j * bs, (j + 1) * bs)
                out_arrays[f"{wire}:{j}"] = arrays[key][tuple(sl)]
    meta = {"id": str(request_id), "tokens": list(map(int, tokens)),
            "p": int(p), "kv_quant": bool(kv_quant), "bs": bs,
            "digests": digests,
            "shipped": sorted(set(range(p // bs)) - skip) if p else []}
    return encode_frame(meta, out_arrays,
                        flags=FLAG_KV_INT8 if kv_quant else 0)


def decode_kv_handoff(buf: bytes) -> KVHandoff:
    """Parse + validate one handoff frame. Structural KV checks (shapes
    against the decode engine's model config, block size against its
    pool) belong to the adopting engine — this layer only guarantees
    the frame is internally consistent."""
    meta, arrays, flags = decode_frame(buf)
    try:
        tokens = tuple(int(t) for t in meta["tokens"])
        p = int(meta["p"])
        req_id = str(meta["id"])
        bs = int(meta.get("bs", p))
        digests = tuple(str(d) for d in meta.get("digests", ()))
        shipped = [int(j) for j in meta.get("shipped", ())]
    except (KeyError, TypeError, ValueError) as exc:
        raise FrameError(f"handoff meta malformed: {exc!r}") from exc
    kv_quant = bool(meta.get("kv_quant", False))
    if kv_quant != bool(flags & FLAG_KV_INT8):
        raise FrameError("handoff flags disagree with meta on KV "
                         "quantization")
    if not 0 <= p <= len(tokens):
        raise FrameError(f"handoff prefix length {p} outside prompt of "
                         f"{len(tokens)} tokens")
    if p == 0:
        if arrays:
            raise FrameError("p == 0 handoff carries KV arrays")
        return KVHandoff(request_id=req_id, tokens=tokens, p=0)
    if bs < 1 or p % bs:
        raise FrameError(f"handoff prefix length {p} is not a multiple "
                         f"of its block size {bs}")
    n_blocks = p // bs
    if len(digests) != n_blocks:
        raise FrameError(f"handoff manifest has {len(digests)} digests "
                         f"for {n_blocks} blocks")
    shipped_set = set(shipped)
    if not shipped_set <= set(range(n_blocks)):
        raise FrameError(f"handoff ships blocks {shipped} outside the "
                         f"{n_blocks}-block manifest")
    want_planes = {"k", "v"} | ({"k_scale", "v_scale"} if kv_quant
                                else set())
    blocks: dict[int, dict[str, np.ndarray]] = {}
    for name, arr in arrays.items():
        wire, _, idx = name.partition(":")
        key = _WIRE_PLANE.get(wire)
        if key is None or not idx.isdigit():
            raise FrameError(f"unknown handoff array {name!r}")
        j = int(idx)
        if j not in shipped_set:
            raise FrameError(f"handoff array {name!r} for a block the "
                             f"manifest says was not shipped")
        blocks.setdefault(j, {})[key] = arr
    if set(blocks) != shipped_set:
        raise FrameError(f"handoff shipped-block payloads {sorted(blocks)} "
                         f"disagree with manifest {sorted(shipped_set)}")
    for j, planes in blocks.items():
        if set(planes) != want_planes:
            raise FrameError(
                f"handoff block {j} planes {sorted(planes)} != expected "
                f"{sorted(want_planes)}")
        for name in ("k", "v"):
            a = planes[name]
            if a.ndim != 5 or a.shape[1] != 1 or a.shape[2] != bs:
                raise FrameError(
                    f"handoff block {j} {name} shape {a.shape} is not "
                    f"[layers, 1, bs={bs}, kv_heads, head_dim]")
        if planes["k"].shape != planes["v"].shape:
            raise FrameError(f"handoff block {j} k/v shapes disagree")
        if kv_quant:
            for name in ("k_scale", "v_scale"):
                a = planes[name]
                if a.ndim != 4 or a.shape[1] != 1 or a.shape[3] != bs:
                    raise FrameError(
                        f"handoff block {j} {name} shape {a.shape} is "
                        f"not [layers, 1, kv_heads, bs={bs}]")
    return KVHandoff(request_id=req_id, tokens=tokens, p=p,
                     block_size=bs, kv_quant=kv_quant, digests=digests,
                     blocks=blocks)
