"""A plain reader of the checkpoint store, frozen here so that a change to
the program cannot change how its saves are judged.

The store is a directory: ``store.json`` holds ``datasets`` (name ->
rows, row_shape, dtype) and ``attrs``; each dataset is one row-major file
``<name with / as __>.bin``.  A committed step of the series is the entry
``attrs["series/manifest"]["series"]["steps"][step]``, mapping each logical
dataset name to the file that holds it (a store without series maps every
name to itself).  The tensor state's attrs: ``layout`` (per array its name,
shape, dtype and chunk shape) and ``meta`` (``steps[step][array]``: the
array's ownership epoch; ``section/<array>/e<epoch>``: its rank counts).
Per array and epoch, ``<array>/e<epoch>/G`` lists the chunk ordinals in the
order the savers wrote them, ``DOF`` their sizes and ``OFF`` their offsets
into ``<array>/e<epoch>/s<step>/vec``, which holds each chunk's elements
row-major within its box; ``.../crc`` holds each chunk's crc32.  Ordinals
number the chunk grid row-major; bfloat16 travels as 16-bit words.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

_WORDS = {"bfloat16": np.dtype(np.uint16)}


def _np_dtype(name: str) -> np.dtype:
    return _WORDS[name] if name in _WORDS else np.dtype(name)


class StoreReader:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "store.json")) as f:
            meta = json.load(f)
        self.datasets = meta["datasets"]
        self.attrs = meta["attrs"]

    def steps(self) -> list[int]:
        return sorted(int(s) for s in self.attrs["meta"]["steps"])

    def _dataset(self, logical: str, step: int) -> np.ndarray:
        series = self.attrs.get("series/manifest", {}).get("series")
        name = logical
        if series is not None:
            name = series["steps"][str(step)].get(logical, logical)
        info = self.datasets[name]
        path = os.path.join(self.root, name.replace("/", "__") + ".bin")
        data = np.fromfile(path, dtype=_np_dtype(info["dtype"]))
        return data.reshape(int(info["rows"]), *info["row_shape"])

    def read(self, step: int) -> dict[str, tuple[np.ndarray, str]]:
        """name -> (array as stored, dtype name) of committed step
        ``step``; raises if a chunk's crc32 does not match its bytes."""
        tmeta = self.attrs["meta"]
        epochs = tmeta["steps"][str(step)]
        out = {}
        for spec in self.attrs["layout"]:
            name, shape = spec["name"], tuple(spec["shape"])
            chunk, dtype = tuple(spec["chunk_shape"]), spec["dtype"]
            key = f"{name}/e{epochs[name]}"
            ords = self._dataset(f"{key}/G", step)
            sizes = self._dataset(f"{key}/DOF", step)
            offs = self._dataset(f"{key}/OFF", step)
            vec = self._dataset(f"{key}/s{step}/vec", step)
            crc = self._dataset(f"{key}/s{step}/crc", step)
            arr = np.zeros(shape, dtype=_np_dtype(dtype))
            counts = [-(-n // c) for n, c in zip(shape, chunk)] or [1]
            for i, o in enumerate(ords):
                block = vec[int(offs[i]):int(offs[i]) + int(sizes[i])]
                if zlib.crc32(block.tobytes()) != int(crc[i]):
                    raise ValueError(f"{name}: chunk {int(o)} fails its crc")
                idx = np.unravel_index(int(o), counts)
                box = tuple(slice(j * c, min((j + 1) * c, n))
                            for j, c, n in zip(idx, chunk, shape))
                arr[box] = block.reshape(arr[box].shape)
            out[name] = (arr, dtype)
        return out
