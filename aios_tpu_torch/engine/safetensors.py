"""The safetensors layout, read and written with the standard library and torch.

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin, end)
into the data that follows (an optional ``__metadata__`` entry maps strings
to strings), then the raw little-endian bytes of every tensor.

``load_file`` maps the file and returns CPU tensors that view the map
(``torch.frombuffer``, so bf16 needs no numpy); a tensor whose offset is not
a multiple of its element size is copied out instead. The map is private
(copy on write), so nothing written to a tensor reaches the file. ``load_dir``
reads every ``*.safetensors`` of a directory in sorted order, as an HF
checkpoint's shards are globbed. ``save_file`` writes the tensors one at a
time (a CUDA tensor comes to the host alone), sorted by element size and
then name so that every tensor stays aligned, with the header padded with
spaces to a multiple of 8 bytes, as HF's writer pads it; the file appears
under its name only once it is whole (``checkpoint`` makes its files
durable).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Dict, Optional, Union

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64}
CODES = {v: k for k, v in DTYPES.items()}
MAX_HEADER_BYTES = 100 << 20  # the limit HF's reader sets

PathLike = Union[str, os.PathLike]


def read_header(path: PathLike) -> tuple:
    """(the header's tensor entries, the data's start offset, the file's
    size); ``__metadata__`` is dropped."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        n = struct.unpack("<Q", head)[0]
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n, size


def load_file(path: PathLike) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over a private
    memory map of it."""
    header, start, size = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        code = info.get("dtype")
        if code not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {code}, which the port "
                             f"does not read (it reads {', '.join(DTYPES)})")
        dtype, shape = DTYPES[code], [int(d) for d in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size - start or end - begin != numel * itemsize:
            raise ValueError(f"{path}: tensor {name} {code}{shape} has data offsets "
                             f"[{begin}, {end}) in {size - start} bytes of data")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + begin) % itemsize:
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                                   offset=start + begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=numel,
                                         offset=start + begin).reshape(shape)
    return out


def load_dir(directory: PathLike) -> Dict[str, torch.Tensor]:
    """The tensors of every ``*.safetensors`` in ``directory``, the files
    read in sorted order (a later file's name wins, as in the JAX
    manager's loop)."""
    out: Dict[str, torch.Tensor] = {}
    for path in sorted(Path(directory).glob("*.safetensors")):
        out.update(load_file(path))
    return out


def _raw(t: torch.Tensor):
    return memoryview(t.detach().contiguous().to("cpu").reshape(-1).view(torch.uint8).numpy())


def save_file(tensors: Dict[str, torch.Tensor], path: PathLike,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (on any device) as one safetensors file at ``path``
    through a temporary name in the same directory; returns the bytes
    written."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    offset = 0
    for name, t in items:
        if t.dtype not in CODES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors code "
                             f"the port writes")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for _, t in items:
                if t.numel():
                    f.write(_raw(t))
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return 8 + len(raw) + offset
