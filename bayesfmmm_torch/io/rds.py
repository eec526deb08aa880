"""Minimal reader for R's RDS serialization (version 2/3, XDR format).

The reference ships its simulated datasets as .RDS fixtures
(inst/test-data/{Sim_data,MVSim_data,HDSim_data,time,HDtime}.RDS) consumed
by the roxygen example pipelines (UserFunctions.cpp:101-113).  No R runtime
or pyreadr exists in this image, so this module implements the small subset
of the R serialization grammar those fixtures need: numeric/integer/logical
vectors, strings, lists (with names/attributes), and matrices (dim attr).

Format reference: R Internals §'Serialization Formats' (public spec).

The port's own copy of ``bayesfmmm_tpu/io/rds.py`` (NumPy only);
``tests/test_torch_post.py`` holds the two equal on byte streams built
there.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

__all__ = ["read_rds"]

# SEXP type codes (R Internals)
NILSXP, SYMSXP, LISTSXP = 0, 1, 2
LGLSXP, INTSXP, REALSXP, CPLXSXP, STRSXP, VECSXP = 10, 13, 14, 15, 16, 19
CHARSXP = 9
NILVALUE_SXP, REFSXP = 254, 255
ATTRLISTSXP = 240  # unused marker


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs = []

    def _read(self, n):
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack(">I", self._read(4))[0]

    def i32(self):
        return struct.unpack(">i", self._read(4))[0]

    def f64(self, n):
        return np.frombuffer(self._read(8 * n), dtype=">f8").astype(np.float64)

    def i32s(self, n):
        return np.frombuffer(self._read(4 * n), dtype=">i4").astype(np.int64)

    def read_object(self):
        flags = self.u32()
        ptype = flags & 0xFF
        has_attr = bool(flags & (1 << 9))
        has_tag = bool(flags & (1 << 10))

        if ptype == NILVALUE_SXP or ptype == NILSXP:
            return None
        if ptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if ptype == SYMSXP:
            sym = self.read_object()
            self.refs.append(sym)
            return sym
        if ptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return None
            return self._read(n).decode("utf-8", "replace")
        if ptype == LGLSXP:
            n = self.i32()
            vals = self.i32s(n).astype(float)
            vals[vals == -2147483648] = np.nan
            return self._finish(vals != 0 if not np.isnan(vals).any()
                                else vals, has_attr)
        if ptype == INTSXP:
            n = self.i32()
            return self._finish(self.i32s(n), has_attr)
        if ptype == REALSXP:
            n = self.i32()
            return self._finish(self.f64(n), has_attr)
        if ptype == STRSXP:
            n = self.i32()
            return self._finish([self.read_object() for _ in range(n)],
                                has_attr)
        if ptype == VECSXP:
            n = self.i32()
            items = [self.read_object() for _ in range(n)]
            return self._finish(items, has_attr)
        if ptype == LISTSXP:  # pairlist (attributes)
            attrs = {}
            while True:
                tag = self.read_object() if has_tag else None
                val = self.read_object()
                attrs[tag] = val
                nxt = self.u32()
                ntype = nxt & 0xFF
                if ntype == NILVALUE_SXP or ntype == NILSXP:
                    break
                if ntype != LISTSXP:
                    raise ValueError(f"unexpected pairlist cdr type {ntype}")
                has_tag = bool(nxt & (1 << 10))
            return attrs
        raise ValueError(f"unsupported SEXP type {ptype} at {self.pos}")

    def _finish(self, value, has_attr):
        if not has_attr:
            return value
        attrs = self.read_object()  # pairlist dict
        if isinstance(attrs, dict):
            names = attrs.get("names")
            dim = attrs.get("dim")
            if dim is not None and isinstance(value, np.ndarray):
                value = value.reshape(tuple(int(d) for d in dim), order="F")
            if names is not None and isinstance(value, list):
                return dict(zip(names, value))
        return value


def read_rds(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if raw[:2] not in (b"X\n",):
        raise ValueError("only XDR-format RDS supported")
    r = _Reader(raw[2:])
    version = r.u32()
    r.u32()  # writer version
    r.u32()  # min reader version
    if version >= 3:
        n = r.u32()  # native encoding string length
        r._read(n)
    return r.read_object()
