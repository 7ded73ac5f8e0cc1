"""A safetensors reader and writer over torch tensors.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end) in the byte buffer that follows, with an optional ``__metadata__`` map
of strings, then the raw little-endian bytes.  The port carries its own
copy so that it reads and writes checkpoints where the ``safetensors``
package is not installed; files are byte-compatible with it both ways.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U16": torch.uint16,
    "U8": torch.uint8,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_ALIGN = 8  # the header is padded with spaces to a multiple of this


def read_header(path: str) -> tuple[dict, int]:
    """``(header, offset of the byte buffer)`` of a safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)), 8 + n


def load_file(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Every tensor of a file, as torch tensors on ``device``."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        f.seek(start)
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        b, e = info["data_offsets"]
        dtype = DTYPES[info["dtype"]]
        t = torch.frombuffer(buf, dtype=torch.uint8, count=e - b, offset=b) if e > b else (
            torch.empty(0, dtype=torch.uint8))
        out[name] = t.view(dtype).reshape(info["shape"]).to(device)
    return out


def metadata(path: str) -> dict[str, str]:
    """The file's ``__metadata__`` (empty when it has none)."""
    return read_header(path)[0].get("__metadata__", {})


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: Optional[dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host contiguous), wider
    types first and then by name, as the ``safetensors`` package orders them
    (every tensor starts at a multiple of its element size), with
    ``metadata`` as ``__metadata__``."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs, offset = [], 0
    for name in sorted(tensors, key=lambda k: (-tensors[k].element_size(), k)):
        t = tensors[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
