"""First-party Caffe model IO: the prototxt text parser and the caffemodel
(binary protobuf) reader and writer, in numpy.

The port's own copy of ``neuralstyletransferv1_tpu/io/caffe.py``: the
prototxt (protobuf text format) is parsed into nested ``Message`` dicts and
the ``.caffemodel`` into name → blob arrays, which ``models/caffe_ssd.py``
executes. Only the protobuf subset Caffe NetParameter files use is read:
varint and length-delimited wire types, packed and unpacked repeated
floats, the legacy num/channels/height/width blob dims, both the ``layer``
(field 100) and legacy ``layers`` (field 2) encodings. The writer lets tests
and the chip smoke synthesize caffemodels.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# prototxt (protobuf text format)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:(?P<comment>\#[^\n]*)|(?P<brace>[{}])|(?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*:?\s*"""
    r"""|(?P<string>"(?:[^"\\]|\\.)*")|(?P<value>[^\s{}\#"]+))""",
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            break
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        yield m.lastgroup, m.group(m.lastgroup)


class Message(dict):
    """Parsed text-format message: key → list of values (str or Message)."""

    def one(self, key, default=None):
        v = self.get(key)
        return v[0] if v else default

    def many(self, key):
        return self.get(key, [])


def _coerce(s: str):
    if s.startswith('"'):
        return s[1:-1]
    return s


def parse_prototxt(text: str) -> Message:
    """Parse protobuf text format into nested Message dicts."""
    root = Message()
    stack = [root]
    pending_key = None
    for kind, tok in _tokenize(text):
        if kind == "key":
            if pending_key is not None:
                # bare enum value after a key (e.g. "phase: TEST") shows up
                # as a key token because enums look like identifiers
                stack[-1].setdefault(pending_key, []).append(tok)
                pending_key = None
            else:
                pending_key = tok
        elif kind == "brace":
            if tok == "{":
                child = Message()
                stack[-1].setdefault(pending_key, []).append(child)
                stack.append(child)
                pending_key = None
            else:
                stack.pop()
        else:  # string or value
            stack[-1].setdefault(pending_key, []).append(_coerce(tok))
            pending_key = None
    return root


def load_prototxt(path: str | Path) -> Message:
    return parse_prototxt(Path(path).read_text())


# ---------------------------------------------------------------------------
# caffemodel (binary protobuf) — reader
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value-or-bytes) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_blob(buf: bytes) -> np.ndarray:
    """BlobProto → float32 ndarray (modern shape field or legacy NCHW)."""
    dims: list[int] = []
    legacy = {}
    floats: list[np.ndarray] = []
    for field, wire, val in _iter_fields(buf):
        if field == 7 and wire == 2:  # shape: BlobShape{ dim=1 repeated int64 }
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            dims.append(d)
                    else:
                        dims.append(v2)
        elif field == 5:  # data: repeated float
            if wire == 2:  # packed
                floats.append(np.frombuffer(val, dtype="<f4"))
            else:
                floats.append(np.frombuffer(val, dtype="<f4"))
        elif field in (1, 2, 3, 4) and wire == 0:  # legacy num/ch/h/w
            legacy[field] = val
    data = np.concatenate(floats) if floats else np.zeros(0, np.float32)
    if not dims and legacy:
        dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if dims and int(np.prod(dims)) == data.size:
        data = data.reshape(dims)
    return data.astype(np.float32)


def load_caffemodel(path: str | Path) -> dict[str, list[np.ndarray]]:
    """name → [blob, ...] for every layer carrying weights.

    Handles both the modern ``layer`` (field 100) and legacy ``layers``
    (field 2) encodings.
    """
    buf = Path(path).read_bytes()
    out: dict[str, list[np.ndarray]] = {}
    for field, wire, val in _iter_fields(buf):
        if field in (100, 2) and wire == 2:  # LayerParameter / V1LayerParameter
            name = None
            blobs: list[np.ndarray] = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode("utf-8", "replace")
                elif f2 in (7, 6) and w2 == 2:
                    # blobs: field 7 in LayerParameter, 6 in V1LayerParameter
                    blobs.append(_parse_blob(v2))
            if name and blobs:
                out[name] = blobs
    return out


# ---------------------------------------------------------------------------
# caffemodel — writer (test/tool support; also readable by cv2.dnn)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _encode_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape = b"".join(_field(1, 0) + _varint(int(d)) for d in arr.shape)
    data = arr.ravel().astype("<f4").tobytes()
    return _len_delim(7, shape) + _len_delim(5, data)


def write_caffemodel(path: str | Path, layer_blobs: dict[str, list[np.ndarray]],
                     layer_types: dict[str, str] | None = None) -> None:
    """Serialize name → blobs as a NetParameter cv2.dnn can read."""
    msg = bytearray()
    msg += _len_delim(1, b"net")  # NetParameter.name
    for name, blobs in layer_blobs.items():
        layer = bytearray()
        layer += _len_delim(1, name.encode())
        ltype = (layer_types or {}).get(name)
        if ltype:
            layer += _len_delim(2, ltype.encode())
        for b in blobs:
            layer += _len_delim(7, _encode_blob(b))
        msg += _len_delim(100, bytes(layer))
    Path(path).write_bytes(bytes(msg))
