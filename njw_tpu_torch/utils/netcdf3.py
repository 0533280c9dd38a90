"""Minimal pure-Python NetCDF-3 (classic, CDF-1) writer and reader.

The port's own copy of ``njw_tpu/utils/netcdf3.py`` (NumPy and the
standard library only; the port imports nothing of the JAX package). The
on-disk format is the classic one: magic 'CDF\\x01', the dimension,
attribute and variable lists, big-endian typed payloads. Scope:
fixed-size (non-record) int8/int16/int32/float32/float64 variables, named
dimensions, global and per-variable attributes: enough for field
snapshots that ncdump, xarray or ``scipy.io.netcdf_file`` read. For the
same arrays both packages write the same bytes.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_ABSENT = b"\x00" * 8

_NC_TYPES = {
    np.dtype(np.int8): (1, 1), np.dtype("S1"): (2, 1),
    np.dtype(np.int16): (3, 2), np.dtype(np.int32): (4, 4),
    np.dtype(np.float32): (5, 4), np.dtype(np.float64): (6, 8),
}
_TYPE_NP = {1: np.int8, 2: np.dtype("S1"), 3: ">i2", 4: ">i4",
            5: ">f4", 6: ">f8"}


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


def _name(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + _pad4(b)


def _attr_bytes(name: str, value) -> bytes:
    if isinstance(value, str):
        b = value.encode()
        return _name(name) + struct.pack(">ii", 2, len(b)) + _pad4(b)
    arr = np.atleast_1d(np.asarray(value))
    if arr.dtype.kind == "i":
        arr = arr.astype(np.int32)
    elif arr.dtype.kind == "f":
        arr = arr.astype(np.float64)
    nc_type, size = _NC_TYPES[arr.dtype]
    payload = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    return _name(name) + struct.pack(">ii", nc_type, arr.size) \
        + _pad4(payload)


def _attr_list(attrs: Optional[dict]) -> bytes:
    if not attrs:
        return _ABSENT
    body = b"".join(_attr_bytes(k, v) for k, v in attrs.items())
    return struct.pack(">ii", _NC_ATTRIBUTE, len(attrs)) + body


def write_netcdf(path: str, variables: dict, dims: dict,
                 global_attrs: Optional[dict] = None,
                 var_attrs: Optional[dict] = None) -> str:
    """Write a classic NetCDF-3 file.

    variables: {name: (dim_names tuple, ndarray)}
    dims: {dim_name: length}
    """
    dim_names = list(dims)
    dim_index = {n: i for i, n in enumerate(dim_names)}
    var_attrs = var_attrs or {}

    # normalize variable dtypes to netcdf-supported ones
    norm = {}
    for name, (vdims, arr) in variables.items():
        arr = np.asarray(arr)
        if arr.dtype not in _NC_TYPES:
            arr = arr.astype(np.float32 if arr.dtype.kind == "f"
                             else np.int32)
        expect = tuple(dims[d] for d in vdims)
        if arr.shape != expect:
            raise ValueError(f"{name}: shape {arr.shape} != dims {expect}")
        norm[name] = (tuple(vdims), arr)

    header = b"CDF\x01" + struct.pack(">i", 0)  # numrecs = 0
    dim_body = b"".join(_name(n) + struct.pack(">i", dims[n])
                        for n in dim_names)
    header += struct.pack(">ii", _NC_DIMENSION, len(dim_names)) + dim_body
    header += _attr_list(global_attrs)

    # var list needs begin offsets -> two passes
    def var_entry(name, vdims, arr, begin):
        nc_type, size = _NC_TYPES[arr.dtype]
        vsize = arr.size * size
        vsize += -vsize % 4
        e = _name(name)
        e += struct.pack(">i", len(vdims))
        e += b"".join(struct.pack(">i", dim_index[d]) for d in vdims)
        e += _attr_list(var_attrs.get(name))
        e += struct.pack(">iii", nc_type, vsize, begin)
        return e, vsize

    items = list(norm.items())
    # pass 1: compute header length with dummy offsets
    trial = b"".join(var_entry(n, d, a, 0)[0] for n, (d, a) in items)
    var_hdr_prefix = struct.pack(">ii", _NC_VARIABLE, len(items)) \
        if items else _ABSENT
    header_len = len(header) + len(var_hdr_prefix) + len(trial)

    begins, offset = [], header_len
    for _, (_, arr) in items:
        begins.append(offset)
        vsize = arr.size * _NC_TYPES[arr.dtype][1]
        offset += vsize + (-vsize % 4)

    entries = b"".join(
        var_entry(n, d, a, b)[0]
        for (n, (d, a)), b in zip(items, begins))
    with open(path, "wb") as fh:
        fh.write(header + var_hdr_prefix + entries)
        for _, (_, arr) in items:
            fh.write(_pad4(arr.astype(arr.dtype.newbyteorder(">"))
                           .tobytes()))
    return path


def read_netcdf(path: str):
    """Read back (variables, dims, global_attrs) from a classic file."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != b"CDF\x01":
        raise ValueError("not a classic NetCDF-3 (CDF-1) file")
    pos = 8

    def i4():
        nonlocal pos
        v = struct.unpack_from(">i", buf, pos)[0]
        pos += 4
        return v

    def name():
        nonlocal pos
        n = i4()
        s = buf[pos:pos + n].decode()
        pos += n + (-n % 4)
        return s

    def attr_list():
        nonlocal pos
        tag, cnt = i4(), i4()
        out = {}
        for _ in range(cnt):
            k = name()
            t, ne = i4(), i4()
            if t == 2:
                v = buf[pos:pos + ne].decode()
                pos += ne + (-ne % 4)
            else:
                dt = np.dtype(_TYPE_NP[t])
                nbytes = ne * dt.itemsize
                v = np.frombuffer(buf, dt, ne, pos).copy()
                pos += nbytes + (-nbytes % 4)
                if ne == 1:
                    v = v[0]
            out[k] = v
        return out

    tag, ndims = i4(), i4()
    dims = {}
    dim_names = []
    for _ in range(ndims if tag == _NC_DIMENSION else 0):
        n = name()
        dims[n] = i4()
        dim_names.append(n)
    gatts = attr_list()
    tag, nvars = i4(), i4()
    variables = {}
    for _ in range(nvars if tag == _NC_VARIABLE else 0):
        vname = name()
        nd = i4()
        vdims = tuple(dim_names[i4()] for i in range(nd))
        _vatts = attr_list()
        t, _vsize, begin = i4(), i4(), i4()
        shape = tuple(dims[d] for d in vdims)
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(buf, np.dtype(_TYPE_NP[t]), count,
                            begin).reshape(shape).copy()
        variables[vname] = (vdims, arr)
    return variables, dims, gatts
