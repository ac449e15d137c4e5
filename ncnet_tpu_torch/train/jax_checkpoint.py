"""Read the JAX package's msgpack checkpoints
(``ncnet_tpu/train/checkpoint.py``) with neither ``msgpack`` nor ``flax``,
and write the msgpack bytes ``flax.serialization.msgpack_serialize`` makes
of a param tree (`msgpack_serialize`, which the feature store's
``trunk_digest`` hashes).

The file is ``flax.serialization.msgpack_serialize`` of the payload that
``serialize_checkpoint`` builds: ``config`` (a dict), ``params`` and the
optax ``opt_state`` (``to_state_dict`` trees: lists become dicts keyed
``'0'``, ``'1'``, ...), ``step``, ``epoch``, ``train_loss``, ``val_loss``,
``best_val_loss``, ``train_fe``, ``fe_finetune_blocks`` and the loader
``cursor``. Arrays are msgpack ext records: type 1 an ndarray, type 3 a
numpy scalar, each holding a msgpack ``(shape, dtype name, raw bytes)``;
type 2 a complex number; an array past flax's chunk size is a dict
``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``.
A ``<path>.sha256`` sidecar, where there is one, holds the file's SHA-256
and is checked first, as the JAX package's ``load_checkpoint`` does.

`msgpack_serialize(tree)` follows flax: the tree goes through
``to_state_dict`` (a list becomes a dict keyed ``'0'``, ``'1'``, ...) and
``jax.tree.map``, which rebuilds every dict with its keys in sorted string
order, at every level (``'10'`` sorts before ``'2'``); an array is ext type
1 holding ``packb((shape, dtype name, raw bytes))``. Each value takes
msgpack-python's smallest encoding, so the bytes are flax's.

`load_jax_checkpoint` gives the port's `CheckpointData`: the params as the
JAX tree (numpy), and the Adam state (optax ``scale_by_adam``'s ``mu``,
``nu`` and ``count``) as ``exp_avg``, ``exp_avg_sq`` and ``step`` keyed by
each trainable tensor's path in the JAX trainable tree, in the port's
layout (trunk conv weights OIHW): `restore` matches them to the
optimizer's tensors by path.
"""

import math
import struct

import numpy as np

from ncnet_tpu_torch.bridge import from_jax_layout
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
# IntegrityError: what a bad sidecar digest raises, importable from here
from ncnet_tpu_torch.resilience.durable import (  # noqa: F401
    IntegrityError,
    read_verified_bytes,
)

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax chunks arrays past this many bytes


class _Ext:
    def __init__(self, code, data):
        self.code, self.data = code, data


def _ext_value(code, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    return _Ext(code, data)


def _ndarray(data):
    shape, dtype, raw = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":  # numpy has no bfloat16: widen exactly
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


class _Unpacker:
    """A msgpack decoder of one buffer (the subset flax writes: nil, bool,
    ints, floats, str, bin, array, map, ext)."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.num("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.num(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.num(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.num("b")  # ext
            return _ext_value(code, bytes(self.take(n)))
        if b in _FIXEXT:
            code = self.num("b")
            return _ext_value(code, bytes(self.take(_FIXEXT[b])))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n):
        return [self.read() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_SIZED = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
          0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"),
          0xDE: ("map", "H"), 0xDF: ("map", "I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(data):
    """Decode one msgpack object from ``data`` (flax's ext records become
    numpy arrays, numpy scalars and complex numbers)."""
    u = _Unpacker(data)
    out = u.read()
    if u.pos != len(u.buf):
        raise ValueError(f"{len(u.buf) - u.pos} trailing bytes after msgpack data")
    return out


def _sized(out, n, small, formats):
    """A length header: ``small`` (a fixed-size base byte or None) below
    its limit, else the first of ``formats`` ``(byte, struct code, limit)``
    that holds ``n``."""
    if small is not None and n < small[1]:
        out.append(bytes([small[0] | n]))
        return
    for byte, fmt, limit in formats:
        if n <= limit:
            out.append(bytes([byte]) + struct.pack(">" + fmt, n))
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out, v):
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    for byte, fmt, lo, hi in ((0xCC, "B", 0, 0xFF), (0xD0, "b", -0x80, -1),
                              (0xCD, "H", 0, 0xFFFF), (0xD1, "h", -0x8000, -1),
                              (0xCE, "I", 0, 0xFFFFFFFF),
                              (0xD2, "i", -0x80000000, -1),
                              (0xCF, "Q", 0, 2 ** 64 - 1),
                              (0xD3, "q", -2 ** 63, -1)):
        if lo <= v <= hi:
            out.append(bytes([byte]) + struct.pack(">" + fmt, v))
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _sized(out, n, None, ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF),
                              (0xC9, "I", 0xFFFFFFFF)))
    out.append(struct.pack(">b", code))
    out.append(data)


def _pack_ndarray(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out, obj):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(out, obj)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _sized(out, len(raw), (0xA0, 32), ((0xD9, "B", 0xFF),
                                           (0xDA, "H", 0xFFFF),
                                           (0xDB, "I", 0xFFFFFFFF)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _sized(out, len(raw), None, ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF),
                                     (0xC6, "I", 0xFFFFFFFF)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), ((0xDC, "H", 0xFFFF),
                                           (0xDD, "I", 0xFFFFFFFF)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), ((0xDE, "H", 0xFFFF),
                                           (0xDF, "I", 0xFFFFFFFF)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _pack_ndarray(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _pack_ndarray(np.asarray(obj)))
    elif isinstance(obj, complex):
        _pack_ext(out, EXT_COMPLEX, packb([obj.real, obj.imag]))
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj):
    """msgpack bytes of ``obj`` (None, bool, int, float, str, bytes, list,
    tuple, dict in its own order, numpy arrays and scalars as flax's ext
    records), each value in msgpack-python's smallest encoding."""
    out = []
    _pack(out, obj)
    return b"".join(out)


def to_state_dict(tree):
    """flax's ``to_state_dict`` after ``jax.tree.map``: lists become dicts
    keyed ``'0'``, ``'1'``, ...; every dict's keys are sorted as strings;
    leaves become numpy arrays."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): to_state_dict(tree[k]) for k in sorted(tree, key=str)}
    return np.asarray(tree)


def msgpack_serialize(tree):
    """``flax.serialization.msgpack_serialize(to_state_dict(jax.tree.map(
    np.asarray, tree)))`` for a tree of dicts, lists and arrays (no array
    past flax's chunk size)."""
    state = to_state_dict(tree)

    def check(node):
        if isinstance(node, dict):
            for v in node.values():
                check(v)
        elif node.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(
                f"an array of {node.nbytes} bytes: flax would chunk it, and "
                "chunked arrays are not written here")

    check(state)
    return packb(state)


def _ordered(d):
    return [d[k] for k in sorted(d, key=int)]


def _unchunk(tree):
    """flax's chunked arrays back into arrays, anywhere in the tree."""
    if isinstance(tree, dict):
        if tree.get(CHUNKED):
            shape = tuple(_ordered(tree["shape"]))
            return np.concatenate(_ordered(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def relistify(tree):
    """Invert ``to_state_dict``'s list -> ``{'0': ...}`` conversion."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            keys = sorted(tree, key=int)
            if [int(k) for k in keys] == list(range(len(keys))):
                return [relistify(tree[k]) for k in keys]
        return {k: relistify(v) for k, v in tree.items()}
    return tree


def read_payload(path):
    """The checkpoint's payload dict, digest-checked, arrays unchunked."""
    return _unchunk(unpackb(read_verified_bytes(path)))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def adam_state(opt_state):
    """optax ``adam``'s state dict (``{'0': {'count', 'mu', 'nu'}, '1':
    {}}``) -> ``{path: {'exp_avg', 'exp_avg_sq', 'step'}}`` in the port's
    layout, or None when it holds no Adam moments."""
    if not opt_state:
        return None
    adam = next((v for v in (opt_state.values() if isinstance(opt_state, dict)
                             else opt_state)
                 if isinstance(v, dict) and "mu" in v), None)
    if adam is None:
        raise ValueError("the checkpoint's opt_state holds no Adam moments "
                         "(mu / nu / count)")
    step = float(np.asarray(adam["count"]))
    mu, nu = dict(_leaves(relistify(adam["mu"]))), dict(_leaves(relistify(adam["nu"])))
    if mu.keys() != nu.keys():
        raise ValueError("Adam's mu and nu trees differ")

    def layout(path, arr):
        arr = np.asarray(arr, np.float32)
        return arr if path[0] == "neigh_consensus" else from_jax_layout(arr)

    return {p: {"exp_avg": np.ascontiguousarray(layout(p, mu[p])),
                "exp_avg_sq": np.ascontiguousarray(layout(p, nu[p])),
                "step": step} for p in mu}


def _cursor(payload):
    cur = payload.get("cursor") or None
    if not cur:
        return None
    return {
        "epoch": int(cur.get("epoch", 0)),
        "batch_index": int(cur.get("batch_index", 0)),
        "shuffle_seed": int(cur.get("shuffle_seed", 0)),
        "epoch_losses": [float(v) for v in
                         np.asarray(cur.get("epoch_losses", [])).ravel()],
    }


def load_jax_checkpoint(path):
    """A JAX package checkpoint (``.msgpack``) -> the port's
    `ncnet_tpu_torch.train.checkpoint.CheckpointData`."""
    from ncnet_tpu_torch.train.checkpoint import CheckpointData

    payload = read_payload(path)
    best = payload.get("best_val_loss")
    best = float("inf") if best is None else float(best)

    def floats(key):
        return [float(v) for v in np.asarray(payload.get(key, [])).ravel()]

    return CheckpointData(
        config=ImMatchNetConfig.from_dict(payload["config"]),
        params=relistify(payload["params"]),
        opt_state=adam_state(payload.get("opt_state")),
        step=int(payload.get("step", 0)),
        epoch=int(payload.get("epoch", 0)),
        train_loss=floats("train_loss"),
        val_loss=floats("val_loss"),
        best_val_loss=best if not math.isnan(best) else float("inf"),
        optimizer={},
        cursor=_cursor(payload),
        train_fe=bool(payload.get("train_fe", False)),
        fe_finetune_blocks=int(payload.get("fe_finetune_blocks", 0)),
    )
