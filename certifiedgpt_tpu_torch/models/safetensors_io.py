"""A reader of the safetensors format, with no dependency beyond torch.

A file is an 8-byte little-endian header length, a JSON header (for each
tensor its ``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the
data that follows; ``__metadata__`` a string map), then the raw
little-endian tensor bytes. ``SafetensorsFile`` reads one tensor at a time
from the file into a tensor of its own, so host memory stays near one
tensor (a memory map would keep every page it touched resident).
``SafetensorsDir`` is the state dict of a sharded checkpoint directory (an
HF model directory): its keys come from ``model.safetensors.index.json``'s
``weight_map`` when the directory has one, else from every ``*.safetensors``
file in it, and a tensor is read when it is looked up.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, List

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I64": torch.int64}
INDEX_FILE = "model.safetensors.index.json"


class SafetensorsFile:
    """One ``.safetensors`` file: ``keys()``, ``metadata()`` and
    ``get_tensor(key)`` (a CPU tensor that owns its memory)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._handle = open(self.path, "rb")
        try:
            self._read_header()
        except BaseException:
            self._handle.close()
            raise

    def _read_header(self) -> None:
        head = self._handle.read(8)
        if len(head) != 8:
            raise ValueError(f"{self.path}: not a safetensors file (shorter than 8 bytes)")
        (length,) = struct.unpack("<Q", head)
        size = os.fstat(self._handle.fileno()).st_size
        if length > size - 8:
            raise ValueError(f"{self.path}: header length {length} exceeds the file")
        header = json.loads(self._handle.read(length))
        self._base = 8 + length
        self._metadata = header.pop("__metadata__", None) or {}
        self._entries = header
        for key, entry in header.items():
            if entry["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: tensor {key} has dtype {entry['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")
            begin, end = entry["data_offsets"]
            want = DTYPES[entry["dtype"]].itemsize * _numel(entry["shape"])
            if end - begin != want or self._base + end > size:
                raise ValueError(f"{self.path}: tensor {key} has data_offsets {begin}..{end} "
                                 f"for {want} bytes in a {size}-byte file")

    def keys(self) -> List[str]:
        return list(self._entries)

    def metadata(self) -> Dict[str, str]:
        return dict(self._metadata)

    def get_tensor(self, key: str) -> torch.Tensor:
        entry = self._entries[key]
        dtype, shape = DTYPES[entry["dtype"]], entry["shape"]
        begin, end = entry["data_offsets"]
        raw = torch.empty((end - begin,), dtype=torch.uint8)
        self._handle.seek(self._base + begin)
        if self._handle.readinto(raw.numpy()) != end - begin:
            raise ValueError(f"{self.path}: tensor {key} is cut short")
        return raw.view(dtype).reshape(shape)

    def close(self) -> None:
        self._handle.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _numel(shape) -> int:
    n = 1
    for dim in shape:
        n *= int(dim)
    return n


class SafetensorsDir(Mapping):
    """The state dict of a directory of safetensors shards, read lazily: a
    lookup reads that one tensor from its shard."""

    def __init__(self, path: str):
        self.path = str(path)
        index = os.path.join(self.path, INDEX_FILE)
        if os.path.exists(index):
            with open(index) as handle:
                weight_map = json.load(handle)["weight_map"]
            names = sorted(set(weight_map.values()))
        else:
            names = sorted(os.path.basename(f)
                           for f in glob.glob(os.path.join(self.path, "*.safetensors")))
        if not names:
            raise FileNotFoundError(f"{self.path} holds no .safetensors file")
        self._files = {name: SafetensorsFile(os.path.join(self.path, name)) for name in names}
        self._where = {}
        for name, shard in self._files.items():
            for key in shard.keys():
                self._where[key] = shard
        if os.path.exists(index):
            missing = sorted(set(weight_map) - set(self._where))
            if missing:
                raise ValueError(f"{index} names tensors its shards lack: {missing[:5]}")

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._where[key].get_tensor(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        for shard in self._files.values():
            shard.close()

