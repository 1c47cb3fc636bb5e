"""GGUF file reader with vectorized numpy dequantization.

The port's own copy of ``aios_tpu/engine/gguf.py`` (numpy only): the GGUF
v2/v3 container over ``np.memmap``, the block dequantizers (F32, F16, BF16,
F64, the integer types, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K, Q5_K, Q6_K)
with the same arithmetic, so every value comes out bit for bit as the JAX
package reads it, the Q8_0/Q4_0 quantizers and the writer. Q2_K, Q3_K and
the IQ types raise ``NotImplementedError``, as there.

Beside the copied ``write_gguf``, ``write_gguf_stream`` writes the same
bytes from a callback that yields one tensor's bytes at a time, so a file
larger than the host's memory can be written; both build their header with
``_header``.

Format notes (GGUF spec + ggml block layouts):
  * header: magic "GGUF", u32 version, u64 tensor_count, u64 kv_count
  * metadata values are typed (u8..f64, bool, string, array)
  * tensor dims are stored innermost-first; we return numpy arrays with the
    outermost-first (row-major) shape, i.e. ``dims[::-1]``
  * the tensor data section is aligned to `general.alignment` (default 32)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO, Callable, Dict, List

import numpy as np

GGUF_MAGIC = b"GGUF"
DEFAULT_ALIGNMENT = 32

# ---- metadata value types --------------------------------------------------

_VT_UINT8, _VT_INT8, _VT_UINT16, _VT_INT16 = 0, 1, 2, 3
_VT_UINT32, _VT_INT32, _VT_FLOAT32, _VT_BOOL = 4, 5, 6, 7
_VT_STRING, _VT_ARRAY, _VT_UINT64, _VT_INT64, _VT_FLOAT64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _VT_UINT8: "<B",
    _VT_INT8: "<b",
    _VT_UINT16: "<H",
    _VT_INT16: "<h",
    _VT_UINT32: "<I",
    _VT_INT32: "<i",
    _VT_FLOAT32: "<f",
    _VT_UINT64: "<Q",
    _VT_INT64: "<q",
    _VT_FLOAT64: "<d",
}

# ---- ggml tensor dtypes ----------------------------------------------------

F32, F16 = 0, 1
Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 = 2, 3, 6, 7, 8
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_K = 10, 11, 12, 13, 14, 15
I8, I16, I32, I64, F64 = 24, 25, 26, 27, 28
BF16 = 30

GGML_TYPE_NAMES = {
    F32: "F32",
    F16: "F16",
    BF16: "BF16",
    Q4_0: "Q4_0",
    Q4_1: "Q4_1",
    Q5_0: "Q5_0",
    Q5_1: "Q5_1",
    Q8_0: "Q8_0",
    Q2_K: "Q2_K",
    Q3_K: "Q3_K",
    Q4_K: "Q4_K",
    Q5_K: "Q5_K",
    Q6_K: "Q6_K",
    I8: "I8",
    I32: "I32",
    F64: "F64",
}

# (elements per block, bytes per block)
BLOCK_LAYOUT = {
    F32: (1, 4),
    F16: (1, 2),
    BF16: (1, 2),
    F64: (1, 8),
    I8: (1, 1),
    I16: (1, 2),
    I32: (1, 4),
    I64: (1, 8),
    Q4_0: (32, 18),
    Q4_1: (32, 20),
    Q5_0: (32, 22),
    Q5_1: (32, 24),
    Q8_0: (32, 34),
    Q4_K: (256, 144),
    Q5_K: (256, 176),
    Q6_K: (256, 210),
}


@dataclass
class TensorInfo:
    name: str
    shape: tuple  # row-major (outermost first)
    ggml_type: int
    offset: int  # relative to data section start

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def n_bytes(self) -> int:
        elems, nbytes = BLOCK_LAYOUT[self.ggml_type]
        assert self.n_elements % elems == 0, (self.name, self.shape, self.ggml_type)
        return self.n_elements // elems * nbytes


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))[0]


def _read_string(f: BinaryIO) -> str:
    n = _read(f, "<Q")
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        return _read(f, _SCALAR_FMT[vtype])
    if vtype == _VT_BOOL:
        return bool(_read(f, "<B"))
    if vtype == _VT_STRING:
        return _read_string(f)
    if vtype == _VT_ARRAY:
        elem_type = _read(f, "<I")
        count = _read(f, "<Q")
        if elem_type in _SCALAR_FMT and elem_type != _VT_FLOAT64:
            # bulk-read homogeneous scalar arrays (token tables can be huge)
            fmt = _SCALAR_FMT[elem_type]
            itemsize = struct.calcsize(fmt)
            raw = f.read(itemsize * count)
            return np.frombuffer(raw, dtype=np.dtype(fmt[1:]).newbyteorder("<")).tolist()
        return [_read_value(f, elem_type) for _ in range(count)]
    raise ValueError(f"unknown GGUF metadata value type {vtype}")


class GGUFFile:
    """Parsed GGUF container: metadata dict + lazy tensor access."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, TensorInfo] = {}
        with open(self.path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            self.version = _read(f, "<I")
            if self.version < 2:
                raise ValueError(f"{path}: GGUF v{self.version} unsupported (need >=2)")
            n_tensors = _read(f, "<Q")
            n_kv = _read(f, "<Q")
            for _ in range(n_kv):
                key = _read_string(f)
                vtype = _read(f, "<I")
                self.metadata[key] = _read_value(f, vtype)
            infos: List[TensorInfo] = []
            for _ in range(n_tensors):
                name = _read_string(f)
                n_dims = _read(f, "<I")
                dims = [_read(f, "<Q") for _ in range(n_dims)]
                ggml_type = _read(f, "<I")
                offset = _read(f, "<Q")
                # GGUF stores dims innermost-first; numpy wants outermost-first
                infos.append(TensorInfo(name, tuple(reversed(dims)), ggml_type, offset))
            alignment = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))
            pos = f.tell()
            self.data_offset = (pos + alignment - 1) // alignment * alignment
            for info in infos:
                self.tensors[info.name] = info
        self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "")

    def tensor_bytes(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return np.asarray(self._mmap[start : start + info.n_bytes])

    def load_tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantize a tensor to ``dtype`` with its row-major shape."""
        info = self.tensors[name]
        flat = dequantize(self.tensor_bytes(name), info.ggml_type, info.n_elements)
        return flat.reshape(info.shape).astype(dtype, copy=False)

    def load_all(self, dtype=np.float32) -> Dict[str, np.ndarray]:
        return {name: self.load_tensor(name, dtype) for name in self.tensors}


# ---------------------------------------------------------------------------
# Dequantization (vectorized numpy; block layouts per ggml)
# ---------------------------------------------------------------------------


def _f16(raw: np.ndarray) -> np.ndarray:
    return raw.view(np.float16).astype(np.float32)


def _deq_q4_0(blocks: np.ndarray) -> np.ndarray:
    # block: d f16 | 16B nibbles. elem i in [0,16) = low nibble of qs[i],
    # elem i+16 = high nibble of qs[i]; value = d * (q - 8)
    d = _f16(blocks[:, 0:2].reshape(-1).view(np.uint8)).reshape(-1, 1)
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (d * q).reshape(-1)


def _deq_q4_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2]).reshape(-1, 1)
    m = _f16(blocks[:, 2:4]).reshape(-1, 1)
    qs = blocks[:, 4:20]
    q = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.float32)
    return (d * q + m).reshape(-1)


def _q5_high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """Expand the packed u32 of per-element 5th bits -> (nblocks, 32) in {0,1}."""
    qh = qh_bytes.reshape(-1, 4).view(np.uint32).reshape(-1, 1)  # little-endian
    shifts = np.arange(32, dtype=np.uint32).reshape(1, -1)
    return ((qh >> shifts) & 1).astype(np.uint8)


def _deq_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2]).reshape(-1, 1)
    xh = _q5_high_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.concatenate([lo, hi], axis=1)
    q = (q | (xh.astype(np.int16) << 4)) - 16
    return (d * q.astype(np.float32)).reshape(-1)


def _deq_q5_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2]).reshape(-1, 1)
    m = _f16(blocks[:, 2:4]).reshape(-1, 1)
    xh = _q5_high_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    q = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.uint16)
    q = q | (xh.astype(np.uint16) << 4)
    return (d * q.astype(np.float32) + m).reshape(-1)


def _deq_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2]).reshape(-1, 1)
    q = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return (d * q).reshape(-1)


def _k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scales/mins of Q4_K/Q5_K -> 8 each per block.

    For sub-block j < 4:  sc = s[j] & 63,            m = s[j+4] & 63
    for j >= 4:           sc = (s[j+4] & 0xF) | ((s[j-4] >> 6) << 4)
                          m  = (s[j+4] >> 4)  | ((s[j]   >> 6) << 4)
    """
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = (s[..., j] & 63).astype(np.float32)
        mn[..., j] = (s[..., j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[..., j] = ((s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)).astype(
            np.float32
        )
        mn[..., j] = ((s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _deq_q4_k(blocks: np.ndarray) -> np.ndarray:
    # super-block of 256: d f16 | dmin f16 | scales[12] | qs[128]
    # elements come in 4 chunks of 64: chunk c uses qs[32c:32c+32],
    # low nibbles = first 32 (sub-block 2c), high = next 32 (sub-block 2c+1)
    n = blocks.shape[0]
    d = _f16(blocks[:, 0:2]).reshape(-1, 1)
    dmin = _f16(blocks[:, 2:4]).reshape(-1, 1)
    sc, mn = _k_scale_min(blocks[:, 4:16])
    qs = blocks[:, 16:144].reshape(n, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2).reshape(n, 8, 32)  # sub-block major
    scale = (d * sc).reshape(n, 8, 1)
    offset = (dmin * mn).reshape(n, 8, 1)
    return (scale * q - offset).reshape(-1)


def _deq_q5_k(blocks: np.ndarray) -> np.ndarray:
    # d f16 | dmin f16 | scales[12] | qh[32] | qs[128]
    n = blocks.shape[0]
    d = _f16(blocks[:, 0:2]).reshape(-1, 1)
    dmin = _f16(blocks[:, 2:4]).reshape(-1, 1)
    sc, mn = _k_scale_min(blocks[:, 4:16])
    qh = blocks[:, 16:48]  # (n, 32): bit j of qh[l] is the 5th bit of
    # element l within sub-block j
    qs = blocks[:, 48:176].reshape(n, 4, 32)
    lo = (qs & 0x0F).astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16)
    q4 = np.stack([lo, hi], axis=2).reshape(n, 8, 32)
    jbits = (
        (qh.reshape(n, 1, 32) >> np.arange(8, dtype=np.uint8).reshape(1, 8, 1)) & 1
    ).astype(np.uint16)
    q = q4 | (jbits << 4)
    scale = (d * sc).reshape(n, 8, 1)
    offset = (dmin * mn).reshape(n, 8, 1)
    return (scale * q.astype(np.float32) - offset).reshape(-1)


def _deq_q6_k(blocks: np.ndarray) -> np.ndarray:
    # ql[128] | qh[64] | scales[16] i8 | d f16; two half-blocks of 128.
    # In each half (ql 64B, qh 32B, sc 8):
    #   q1 = (ql[l]    & 0xF) | ((qh[l] >> 0 & 3) << 4) - 32 -> y[l],    sc[l/16]
    #   q2 = (ql[l+32] & 0xF) | ((qh[l] >> 2 & 3) << 4) - 32 -> y[l+32], sc[2+l/16]
    #   q3 = (ql[l]    >> 4)  | ((qh[l] >> 4 & 3) << 4) - 32 -> y[l+64], sc[4+l/16]
    #   q4 = (ql[l+32] >> 4)  | ((qh[l] >> 6 & 3) << 4) - 32 -> y[l+96], sc[6+l/16]
    n = blocks.shape[0]
    ql = blocks[:, 0:128].reshape(n, 2, 2, 32)  # [half, (l<32 | l>=32), l]
    qh = blocks[:, 128:192].reshape(n, 2, 32)
    scales = blocks[:, 192:208].view(np.int8).reshape(n, 2, 8).astype(np.float32)
    d = _f16(blocks[:, 208:210]).reshape(n, 1, 1, 1)

    lo1 = (ql[:, :, 0, :] & 0x0F).astype(np.int16)
    lo2 = (ql[:, :, 1, :] & 0x0F).astype(np.int16)
    hi1 = (ql[:, :, 0, :] >> 4).astype(np.int16)
    hi2 = (ql[:, :, 1, :] >> 4).astype(np.int16)
    b = qh.astype(np.int16)
    q1 = (lo1 | ((b >> 0 & 3) << 4)) - 32
    q2 = (lo2 | ((b >> 2 & 3) << 4)) - 32
    q3 = (hi1 | ((b >> 4 & 3) << 4)) - 32
    q4 = (hi2 | ((b >> 6 & 3) << 4)) - 32
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.float32)  # (n, 2, 4, 32)

    # scale index within a half: group g of 4 (one per 32-run), sub l//16
    sidx = scales.reshape(n, 2, 4, 2)  # sc[g*2 + l//16]
    sel = np.repeat(sidx, 16, axis=3)  # (n, 2, 4, 32)
    return (d * sel * q).reshape(-1)


_DEQUANT = {
    Q4_0: _deq_q4_0,
    Q4_1: _deq_q4_1,
    Q5_0: _deq_q5_0,
    Q5_1: _deq_q5_1,
    Q8_0: _deq_q8_0,
    Q4_K: _deq_q4_k,
    Q5_K: _deq_q5_k,
    Q6_K: _deq_q6_k,
}


def dequantize(raw: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    """Dequantize a flat byte buffer of ``n_elements`` values to float32."""
    raw = np.asarray(raw, dtype=np.uint8)
    if ggml_type == F32:
        return raw.view(np.float32)[:n_elements]
    if ggml_type == F16:
        return raw.view(np.float16)[:n_elements].astype(np.float32)
    if ggml_type == BF16:
        as_u16 = raw.view(np.uint16)[:n_elements].astype(np.uint32) << 16
        return as_u16.view(np.float32)
    if ggml_type == F64:
        return raw.view(np.float64)[:n_elements].astype(np.float32)
    if ggml_type in (I8, I16, I32, I64):
        dt = {I8: np.int8, I16: np.int16, I32: np.int32, I64: np.int64}[ggml_type]
        return raw.view(dt)[:n_elements].astype(np.float32)
    fn = _DEQUANT.get(ggml_type)
    if fn is None:
        name = GGML_TYPE_NAMES.get(ggml_type, ggml_type)
        raise NotImplementedError(f"dequantization for ggml type {name}")
    elems, nbytes = BLOCK_LAYOUT[ggml_type]
    n_blocks = n_elements // elems
    out = fn(raw[: n_blocks * nbytes].reshape(n_blocks, nbytes))
    return out[:n_elements]


# ---------------------------------------------------------------------------
# Quantization (test support and synthetic files)
# ---------------------------------------------------------------------------


def quantize_q8_0(values: np.ndarray) -> np.ndarray:
    """Quantize float32 -> Q8_0 block bytes (round-trip testing support)."""
    v = values.reshape(-1, 32).astype(np.float32)
    amax = np.abs(v).max(axis=1, keepdims=True)
    d = (amax / 127.0).astype(np.float16)
    scale = np.where(amax == 0, 1.0, amax / 127.0)
    q = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
    blocks = np.empty((v.shape[0], 34), dtype=np.uint8)
    blocks[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:34] = q.view(np.uint8)
    return blocks.reshape(-1)


def quantize_q4_0(values: np.ndarray) -> np.ndarray:
    """Quantize float32 -> Q4_0 block bytes (round-trip testing support)."""
    v = values.reshape(-1, 32).astype(np.float32)
    idx_absmax = np.abs(v).argmax(axis=1)
    maxv = v[np.arange(v.shape[0]), idx_absmax]
    d = maxv / -8.0
    scale = np.where(d == 0, 1.0, d)
    q = np.clip(np.round(v / scale[:, None]) + 8, 0, 15).astype(np.uint8)
    blocks = np.empty((v.shape[0], 18), dtype=np.uint8)
    blocks[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    blocks[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return blocks.reshape(-1)


# ---------------------------------------------------------------------------
# Writer (synthetic files for tests and the smoke run)
# ---------------------------------------------------------------------------


def _write_value(out: list, value: Any) -> int:
    """Append encoded metadata value; returns its type tag."""
    if isinstance(value, bool):
        out.append(struct.pack("<B", int(value)))
        return _VT_BOOL
    if isinstance(value, int):
        out.append(struct.pack("<q", value))
        return _VT_INT64
    if isinstance(value, float):
        out.append(struct.pack("<f", value))
        return _VT_FLOAT32
    if isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(struct.pack("<Q", len(raw)) + raw)
        return _VT_STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        items = list(value)
        probe: list = []
        elem_type = _write_value(probe, items[0]) if items else _VT_INT64
        out.append(struct.pack("<IQ", elem_type, len(items)))
        for item in items:
            sub: list = []
            t = _write_value(sub, item)
            assert t == elem_type, "heterogeneous GGUF arrays unsupported"
            out.extend(sub)
        return _VT_ARRAY
    raise TypeError(f"cannot encode GGUF metadata value {value!r}")


def _header(metadata: Dict[str, Any], entries: List[tuple], alignment: int) -> bytes:
    """The header and tensor infos, padded to ``alignment``. ``entries`` are
    (name, shape, ggml_type, n_bytes) in file order."""
    header = [GGUF_MAGIC, struct.pack("<IQQ", 3, len(entries), len(metadata))]
    for key, value in metadata.items():
        kraw = key.encode("utf-8")
        body: list = []
        vtype = _write_value(body, value)
        header.append(struct.pack("<Q", len(kraw)) + kraw + struct.pack("<I", vtype))
        header.extend(body)

    offset = 0
    for name, shape, ggml_type, n_bytes in entries:
        nraw = name.encode("utf-8")
        dims = tuple(reversed(shape))  # innermost-first on disk
        header.append(struct.pack("<Q", len(nraw)) + nraw)
        header.append(struct.pack("<I", len(dims)))
        header.append(struct.pack(f"<{len(dims)}Q", *dims))
        header.append(struct.pack("<IQ", ggml_type, offset))
        offset += n_bytes + (-n_bytes) % alignment

    head = b"".join(bytes(h) for h in header)
    return head + b"\x00" * ((-len(head)) % alignment)


def write_gguf(
    path: str | Path,
    metadata: Dict[str, Any],
    tensors: Dict[str, tuple],
    alignment: int = DEFAULT_ALIGNMENT,
) -> None:
    """Write a GGUF v3 file. ``tensors`` maps name -> (shape, ggml_type, raw_bytes)."""
    entries, data_parts = [], []
    for name, (shape, ggml_type, raw) in tensors.items():
        raw = bytes(raw)
        entries.append((name, shape, ggml_type, len(raw)))
        data_parts.append(raw + b"\x00" * ((-len(raw)) % alignment))
    with open(path, "wb") as f:
        f.write(_header(metadata, entries, alignment))
        for part in data_parts:
            f.write(part)


def write_gguf_stream(
    path: str | Path,
    metadata: Dict[str, Any],
    tensors: Dict[str, tuple],
    produce: Callable[[str], Any],
    alignment: int = DEFAULT_ALIGNMENT,
) -> None:
    """``write_gguf`` with one tensor's bytes in memory at a time: ``tensors``
    maps name -> (shape, ggml_type), and ``produce(name)`` returns that
    tensor's raw bytes when the writer reaches it. The same bytes as
    ``write_gguf`` for the same tensors."""
    entries = [(name, shape, ggml_type, TensorInfo(name, shape, ggml_type, 0).n_bytes)
               for name, (shape, ggml_type) in tensors.items()]
    with open(path, "wb") as f:
        f.write(_header(metadata, entries, alignment))
        for name, _, _, n_bytes in entries:
            raw = memoryview(produce(name)).cast("B")
            if raw.nbytes != n_bytes:
                raise ValueError(f"{name}: {raw.nbytes} bytes, expected {n_bytes}")
            f.write(raw)
            f.write(b"\x00" * ((-n_bytes) % alignment))
