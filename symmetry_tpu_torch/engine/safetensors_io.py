"""The safetensors format, read and written with numpy and torch alone.

A file holds an 8-byte little-endian length N, then N bytes of JSON (padded
with spaces to a multiple of 8), then the data. The JSON maps each tensor
name to {"dtype", "shape", "data_offsets": [begin, end]} (byte offsets into
the data, C order, little endian) and may carry a "__metadata__" map of
strings, which is read past. A checkpoint directory holds one such file,
or several with a `model.safetensors.index.json` whose "weight_map" names
each tensor's file.

Reads map each tensor's bytes with numpy.memmap when it is asked for: the
tensor is a view of the mapping, read from disk when it is copied (to the
card, or into a stacked leaf), and unmapped when the caller drops it, so a
loader holds one tensor at a time, never the model. bfloat16 has no
numpy dtype: its bytes are read as uint16 and viewed as torch.bfloat16,
never converted through float32. Writes stream one tensor at a time to the
file. Files written here read bit-equal through `safetensors.safe_open`,
and its files read here.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Mapping

import numpy as np
import torch

INDEX_NAME = "model.safetensors.index.json"

# safetensors dtype code -> (numpy dtype of the bytes, torch dtype)
DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I32": (np.dtype("<i4"), torch.int32),
    "I8": (np.dtype("i1"), torch.int8),
    "U16": (np.dtype("<u2"), torch.uint16),
}
_CODES = {tdt: code for code, (_, tdt) in DTYPES.items()}
# Headers above this are refused as corrupt (safetensors' own limit).
_MAX_HEADER = 100_000_000


class CheckpointError(RuntimeError):
    pass


class SafetensorsFile:
    """One .safetensors file's header, parsed and checked. `get` maps one
    tensor's bytes and returns a CPU tensor viewing them."""

    def __init__(self, path: str) -> None:
        self.path = path
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                head = fh.read(8)
                if len(head) != 8:
                    raise CheckpointError(f"{path}: shorter than a header")
                (n,) = struct.unpack("<Q", head)
                if n > min(_MAX_HEADER, size - 8):
                    raise CheckpointError(f"{path}: header length {n} "
                                          f"exceeds the file")
                header = json.loads(fh.read(n))
        except (OSError, ValueError, UnicodeDecodeError) as exc:
            raise CheckpointError(f"{path}: unreadable safetensors file: "
                                  f"{exc}") from exc
        if not isinstance(header, dict):
            raise CheckpointError(f"{path}: header is not a JSON object")
        header.pop("__metadata__", None)
        self._entries: dict[str, tuple[str, tuple[int, ...], int, int]] = {}
        data_len = size - 8 - n
        for name, entry in header.items():
            try:
                code, shape = entry["dtype"], tuple(int(d) for d in
                                                    entry["shape"])
                begin, end = (int(o) for o in entry["data_offsets"])
            except (KeyError, TypeError, ValueError) as exc:
                raise CheckpointError(f"{path}: malformed entry {name!r}"
                                      ) from exc
            if code not in DTYPES:
                raise CheckpointError(
                    f"{path}: tensor {name!r} has dtype {code}; supported: "
                    f"{sorted(DTYPES)}")
            nbytes = int(np.prod(shape, dtype=np.int64)) * DTYPES[code][
                0].itemsize
            if not 0 <= begin <= end <= data_len or end - begin != nbytes:
                raise CheckpointError(
                    f"{path}: tensor {name!r} bytes [{begin}, {end}) do not "
                    f"fit shape {list(shape)} {code} in {data_len} data "
                    f"bytes (truncated file?)")
            self._entries[name] = (code, shape, begin, end)
        self._data_start = 8 + n

    def keys(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name` as a CPU tensor over its mapped bytes
        (copy-on-write: the file is never written; a copy only when its
        offset is not aligned to its element size)."""
        code, shape, begin, end = self._entries[name]
        np_dtype = DTYPES[code][0]
        if end == begin:
            arr = np.zeros(shape, np_dtype)
        else:
            arr = np.memmap(self.path, dtype=np_dtype, mode="c",
                            offset=self._data_start + begin, shape=shape)
            if begin % np_dtype.itemsize:
                arr = np.array(arr)
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if code == "BF16" else t


class SafetensorsDir:
    """Every tensor of an HF checkpoint directory: one file, several
    files, or a sharded set under `model.safetensors.index.json`."""

    def __init__(self, path: str) -> None:
        self._where: dict[str, str] = {}     # tensor name -> file path
        self._files: dict[str, SafetensorsFile] = {}
        index_path = os.path.join(path, INDEX_NAME)
        if os.path.exists(index_path):
            try:
                with open(index_path, "r", encoding="utf-8") as fh:
                    weight_map = json.load(fh)["weight_map"]
            except (OSError, ValueError, KeyError) as exc:
                raise CheckpointError(f"{index_path}: unreadable index: "
                                      f"{exc}") from exc
            for name, fname in weight_map.items():
                self._where[name] = os.path.join(path, fname)
        else:
            try:
                single = [f for f in sorted(os.listdir(path))
                          if f.endswith(".safetensors")]
            except OSError as exc:
                raise CheckpointError(f"cannot list {path}: {exc}") from exc
            if not single:
                raise CheckpointError(f"no .safetensors files under {path}")
            for fname in single:
                for name in self._open(os.path.join(path, fname)).keys():
                    self._where[name] = os.path.join(path, fname)

    def _open(self, fpath: str) -> SafetensorsFile:
        if fpath not in self._files:
            self._files[fpath] = SafetensorsFile(fpath)
        return self._files[fpath]

    def names(self) -> list[str]:
        return list(self._where)

    def get(self, name: str) -> torch.Tensor:
        if name not in self._where:
            raise CheckpointError(f"tensor {name!r} not in checkpoint")
        tensor_file = self._open(self._where[name])
        if name not in tensor_file:
            raise CheckpointError(f"tensor {name!r} not in "
                                  f"{tensor_file.path} (index says so)")
        return tensor_file.get(name)


def _entry_dtype(t: torch.Tensor, dtype: torch.dtype | None) -> torch.dtype:
    out = dtype if dtype is not None and t.is_floating_point() else t.dtype
    if out not in _CODES:
        raise CheckpointError(f"cannot write dtype {out}; supported: "
                              f"{sorted(str(d) for d in _CODES)}")
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str, *,
              dtype: torch.dtype | None = None,
              bf16_code: str = "BF16") -> None:
    """Write `tensors` (on any device) as one safetensors file, in name
    order, moving one tensor at a time to the host. `dtype`, when given,
    is what floating-point tensors are cast to as they are written.
    bf16_code="U16" labels bfloat16 bytes as uint16 (the warm cache's
    format, which numpy readers take)."""
    names = sorted(tensors)
    header: dict = {}
    offset = 0
    for name in names:
        t = tensors[name]
        out = _entry_dtype(t, dtype)
        nbytes = t.numel() * torch.empty((), dtype=out).element_size()
        code = bf16_code if out == torch.bfloat16 else _CODES[out]
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for name in names:
            t = tensors[name].detach()
            host = t.cpu().to(_entry_dtype(t, dtype)).contiguous()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.uint16)
            host.numpy().tofile(fh)


def save_sharded(tensors: Mapping[str, torch.Tensor], directory: str,
                 shards: int, *, dtype: torch.dtype | None = None) -> None:
    """Write `tensors` as `shards` files of about equal size, named as HF
    names them (model-00001-of-0000N.safetensors), with the index json."""
    names = sorted(tensors)
    sizes = [tensors[n].numel() * torch.empty(
        (), dtype=_entry_dtype(tensors[n], dtype)).element_size()
        for n in names]
    total = sum(sizes)
    groups: list[list[str]] = [[] for _ in range(shards)]
    acc = 0
    for name, size in zip(names, sizes):
        # the shard whose equal share of the bytes this tensor starts in
        groups[min(shards - 1, acc * shards // max(total, 1))].append(name)
        acc += size
    os.makedirs(directory, exist_ok=True)
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({n: tensors[n] for n in group},
                  os.path.join(directory, fname), dtype=dtype)
        weight_map.update({n: fname for n in group})
    with open(os.path.join(directory, INDEX_NAME), "w",
              encoding="utf-8") as fh:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, fh, indent=2)

