"""A Hugging Face checkpoint's weight files, read and written with torch alone.

The JAX package reads a checkpoint through `transformers`
(`AutoModelForObjectDetection.from_pretrained`), which the port does not
import. A checkpoint directory holds its weights in one of three layouts,
looked for in this order:

- `model.safetensors`;
- `model.safetensors.index.json`, whose `weight_map` names the shard that
  holds each key;
- `pytorch_model.bin` (a pickled state dict).

The safetensors format is an 8-byte little-endian header length, a JSON
header mapping each key to its `dtype`, `shape` and `data_offsets` (begin
and end, relative to the end of the header; an optional `__metadata__`
entry holds strings), then the raw little-endian tensors. The reader maps
the file and views each tensor in place with `torch.frombuffer`; the
`safetensors` package is not needed. `write_safetensors` writes the same
format (the checkpoint fixture in tools/hf_checkpoint.py uses it).

The files are not the model's `state_dict`: `save_pretrained` leaves out
one of each pair of tied weights. convert/loader.py resolves those.
"""

import json
import mmap
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"
WEIGHT_FILES = (SAFETENSORS, SAFETENSORS_INDEX, TORCH_BIN)

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over a private
    (copy-on-write) map of the file. Raises ValueError on a dtype other than
    F32, F16, BF16 and I64, and on a header that does not fit the file."""
    path = Path(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    if len(mm) < 8:
        raise ValueError(f"{path}: {len(mm)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", mm[:8])
    if 8 + n > len(mm):
        raise ValueError(f"{path}: header of {n} bytes runs past the file's {len(mm)}")
    header = json.loads(mm[8:8 + n])
    start = 8 + n
    tensors = {}
    for key, entry in header.items():
        if key == "__metadata__":
            continue
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {key} has dtype {entry['dtype']}; the reader takes "
                             f"{sorted(DTYPES)}")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or start + end > len(mm):
            raise ValueError(f"{path}: {key}'s offsets {begin}..{end} do not hold "
                             f"{entry['dtype']} {list(shape)}")
        if count == 0:
            tensors[key] = torch.empty(shape, dtype=dtype)
            continue
        if (start + begin) % dtype.itemsize:  # a misaligned view: copy it out
            buf = bytearray(mm[start + begin:start + end])
            tensors[key] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
        else:
            tensors[key] = torch.frombuffer(mm, dtype=dtype, count=count,
                                            offset=start + begin).reshape(shape)
    return tensors


def write_safetensors(path, tensors: Mapping[str, torch.Tensor],
                      metadata: Mapping[str, str] | None = None) -> int:
    """Write `tensors` (F32, F16, BF16 or I64) as one safetensors file, the
    header padded with spaces to a multiple of 8 bytes and the data ordered
    by element size, then key, as `safetensors` orders it (so every tensor
    starts aligned to its element). Returns the file's size in bytes."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    blobs = []
    for key in sorted(tensors, key=lambda k: (-tensors[k].element_size(), k)):
        t = tensors[key].detach().to("cpu").contiguous()
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"{key}: dtype {t.dtype} has no safetensors name here")
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[key] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
    return 8 + len(text) + offset


def read_safetensors_index(path) -> dict[str, torch.Tensor]:
    """The tensors of a sharded checkpoint: each shard the index names, once."""
    path = Path(path)
    weight_map = json.loads(path.read_text())["weight_map"]
    tensors = {}
    for shard in sorted(set(weight_map.values())):
        tensors.update(read_safetensors(path.parent / shard))
    missing = sorted(set(weight_map) - set(tensors))
    if missing:
        raise KeyError(f"{path}: keys its shards do not hold: {missing[:10]} "
                       f"({len(missing)} total)")
    return {k: tensors[k] for k in weight_map}


def read_checkpoint(directory) -> dict[str, torch.Tensor]:
    """The tensors of the checkpoint in `directory` (the first of
    WEIGHT_FILES it holds), keyed as on disk; FileNotFoundError if none.
    `pytorch_model.bin` loads with `weights_only=True` onto the CPU."""
    directory = Path(directory)
    readers = (read_safetensors, read_safetensors_index,
               lambda p: torch.load(p, map_location="cpu", weights_only=True))
    for name, read in zip(WEIGHT_FILES, readers):
        if (directory / name).is_file():
            return read(directory / name)
    raise FileNotFoundError(f"{directory} holds no weights: none of {list(WEIGHT_FILES)}")
