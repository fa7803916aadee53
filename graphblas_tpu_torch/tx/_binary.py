"""Binary serialization codec for collections (GBTX).

The port's own copy of ``graphblas_tpu/tx/_binary.py``: the two packages
write the same bytes for the same arrays and meta (the JSON header's key
order, ``arr.dtype.str``, zstd level 3) and read each other's.  The fast
analogue of python-graphblas's GxB_Matrix_serialize (core/ss/matrix.py:
4050-4168): a structured binary format — not pickle — with optional zstd
compression.  Layout:

    b"GBTX" | u8 version | u32 header_len | header(JSON, utf-8) | blocks...

The header describes kind/dtype/dims/meta and each block's (name, dtype,
shape, nbytes); blocks are the raw little-endian array bytes in order.
"""

import json

import numpy as np

MAGIC = b"GBTX"
VERSION = 1


def pack(kind, dtype_str, dims, arrays, meta=None):
    """Build the uncompressed GBTX body."""
    blocks = []
    payload = bytearray()
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        blocks.append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "nbytes": int(arr.nbytes),
            }
        )
        payload += arr.tobytes()
    header = json.dumps(
        {
            "kind": kind,
            "dtype": dtype_str,
            "dims": list(dims),
            "meta": meta or {},
            "blocks": blocks,
        }
    ).encode()
    out = bytearray()
    out += MAGIC
    out += bytes([VERSION])
    out += len(header).to_bytes(4, "little")
    out += header
    out += payload
    return bytes(out)


def unpack(body):
    """Parse a GBTX body -> (header dict, {name: np.ndarray})."""
    if body[:4] != MAGIC:
        raise ValueError("not a GBTX payload")
    version = body[4]
    if version > VERSION:
        raise ValueError(f"unsupported GBTX version {version}")
    hlen = int.from_bytes(body[5:9], "little")
    header = json.loads(body[9 : 9 + hlen].decode())
    arrays = {}
    off = 9 + hlen
    for blk in header["blocks"]:
        n = blk["nbytes"]
        arr = np.frombuffer(body[off : off + n], dtype=np.dtype(blk["dtype"]))
        arrays[blk["name"]] = arr.reshape(blk["shape"])
        off += n
    return header, arrays


def compress(body, compression, level):
    """Apply the outer compression envelope (tag + payload)."""
    if compression in {"default", "zstd"}:
        try:
            import zstandard
        except ImportError:
            if compression == "zstd":
                raise
            return b"RAW0" + body
        return b"ZSTD" + zstandard.ZstdCompressor(level=level or 3).compress(body)
    if compression in {None, "none"}:
        return b"RAW0" + body
    raise ValueError(
        f"unsupported compression {compression!r}; supported: none, zstd, default"
    )


def decompress(data):
    """Strip the envelope -> raw body bytes."""
    tag, raw = bytes(data[:4]), data[4:]
    if tag == b"ZSTD":
        import zstandard  # only required for compressed payloads

        return zstandard.ZstdDecompressor().decompress(raw)
    if tag == b"RAW0":
        return bytes(raw)
    raise ValueError(f"unknown serialization tag: {tag!r}")
