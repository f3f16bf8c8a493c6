"""Checkpoint generations with atomic commits and per-leaf checksums.

Counterpart of the JAX package's `checkpoint/checkpoint.py`, in the same
format, so that either package reads the other's generations of the same
tree:

  <dir>/ckpt_<step:08d>/
      manifest.msgpack   step, leaf count, a tree description, and each
                         leaf's shape, logical dtype and crc32
      leaf_<i:05d>.npy   one array per leaf

  * atomic: a generation is written into ckpt_<step>.tmp, each leaf and
    the manifest fsync'd, then renamed into place and the parent directory
    fsync'd, so a crash never leaves a half-written newest generation;
  * integrity: each leaf's crc32 is checked on restore, and
    `restore_latest` skips a corrupt generation for the one before it;
  * `keep` generations survive each save, older ones are deleted.

Leaves are taken in JAX's flatten order: dict keys sorted, lists and
tuples (NamedTuples too) in order, `None` skipped; dataclasses (the
port's cache records) by field.  A leaf is a torch tensor (moved to the
host), a numpy array or a Python scalar; bfloat16 is stored as its uint16
bits under the logical dtype "bfloat16".  The manifest is MessagePack,
written and read by the small codec below, byte for byte what
`msgpack.packb` gives for the types a manifest holds.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import struct
import zlib
from typing import Any, List, Tuple

import numpy as np
import torch

MANIFEST = "manifest.msgpack"


# ---------------------------------------------------------------------------
# MessagePack: maps, arrays, str, int, bool and None (what a manifest holds)
# ---------------------------------------------------------------------------
def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        n = int(obj)
        if 0 <= n < 0x80:
            out.append(n)
        elif -32 <= n < 0:
            out.append(n & 0xFF)
        elif n >= 0:
            for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                  (0xCE, ">I", 0xFFFFFFFF),
                                  (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if n <= top:
                    out.append(tag)
                    out += struct.pack(fmt, n)
                    return
            raise OverflowError(f"integer {n} does not fit 64 bits")
        else:
            for tag, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                  (0xD2, ">i", -0x80000000),
                                  (0xD3, ">q", -0x8000000000000000)):
                if n >= low:
                    out.append(tag)
                    out += struct.pack(fmt, n)
                    return
            raise OverflowError(f"integer {n} does not fit 64 bits")
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 0xDC)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 0xDE)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _header(out: bytearray, n: int, fix: int, tag16: int) -> None:
    """Array or map header: fix form up to 15, then 16- and 32-bit."""
    if n < 16:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(tag16)
        out += struct.pack(">H", n)
    else:
        out.append(tag16 + 1)
        out += struct.pack(">I", n)


def packb(obj) -> bytes:
    """MessagePack bytes of `obj`, equal to `msgpack.packb(obj)`."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
         0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STRS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}


def _unpack(buf: bytes, i: int):
    t = buf[i]
    i += 1
    if t < 0x80:
        return t, i
    if t >= 0xE0:
        return t - 0x100, i
    if 0xA0 <= t <= 0xBF:
        n = t & 0x1F
        return buf[i:i + n].decode("utf-8"), i + n
    if 0x90 <= t <= 0x9F:
        return _items(buf, i, t & 0x0F)
    if 0x80 <= t <= 0x8F:
        return _pairs(buf, i, t & 0x0F)
    if t in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[t], i
    if t in _INTS:
        fmt = _INTS[t]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if t in _STRS:
        fmt = _STRS[t]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        return buf[i:i + n].decode("utf-8"), i + n
    if t in (0xDC, 0xDD, 0xDE, 0xDF):
        fmt = ">H" if t in (0xDC, 0xDE) else ">I"
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        return (_items if t in (0xDC, 0xDD) else _pairs)(buf, i, n)
    raise ValueError(f"unsupported MessagePack type byte 0x{t:02x}")


def _items(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _pairs(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    """The object of MessagePack `data` (arrays as lists, as
    `msgpack.unpackb` gives them)."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes past the MessagePack "
                         "object")
    return obj


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def _is_node(node) -> bool:
    return (node is None or isinstance(node, (dict, list, tuple))
            or (dataclasses.is_dataclass(node) and not isinstance(node, type)))


def _children(node) -> list:
    if node is None:
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return [getattr(node, f.name) for f in dataclasses.fields(node)]


def flatten(tree) -> List[Any]:
    """The leaves of `tree` in JAX's flatten order (see the module
    docstring)."""
    if not _is_node(tree):
        return [tree]
    return [leaf for c in _children(tree) for leaf in flatten(c)]


def unflatten(like, leaves) -> Any:
    """`like`'s structure with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return type(node)((k, new[k]) for k in node)
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if hasattr(node, "_fields"):                 # NamedTuple
                return type(node)(*vals)
            return type(node)(vals)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def describe(tree) -> str:
    """A one-line description of `tree`'s structure, '*' for each leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(v) for v in tree)
        name = type(tree).__name__
        return ("[" + inner + "]" if isinstance(tree, list)
                else f"{name}(" + inner + ")")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f.name}={describe(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    return "*"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, logical dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


# ---------------------------------------------------------------------------
# generations
# ---------------------------------------------------------------------------
def _gen_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}")


def save(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write `tree` as generation `step` of `directory` and return its
    path; only the newest `keep` generations stay (0 keeps all)."""
    os.makedirs(directory, exist_ok=True)
    final = _gen_path(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = flatten(tree)
    manifest = {"step": int(step), "num_leaves": len(leaves),
                "treedef": describe(tree), "leaves": []}
    for i, leaf in enumerate(leaves):
        store, dtype = _host(leaf)
        _fsync_write(os.path.join(tmp, f"leaf_{i:05d}.npy"),
                     lambda f, a=store: np.save(f, a))
        manifest["leaves"].append({
            "i": i, "shape": list(store.shape), "dtype": dtype,
            "crc": zlib.crc32(store.tobytes())})
    _fsync_write(os.path.join(tmp, MANIFEST),
                 lambda f: f.write(packb(manifest)))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # the rename is durable only once the directory entry is
    dirfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    _gc(directory, keep)
    return final


def list_generations(directory: str) -> List[int]:
    """The steps of the generations in `directory`, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"ckpt_(\d+)", n) for n in os.listdir(directory))
                  if m)


def latest_step(directory: str) -> int:
    """The newest generation's step, or -1 when there is none."""
    gens = list_generations(directory)
    return gens[-1] if gens else -1


def _gc(directory: str, keep: int) -> None:
    gens = list_generations(directory)
    for step in (gens[:-keep] if keep > 0 else []):
        shutil.rmtree(_gen_path(directory, step), ignore_errors=True)


def _leaf_tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def load_generation(path: str, like: Any) -> Tuple[Any, int]:
    """(tree, step) of the generation at `path`, shaped like `like`; each
    leaf a torch tensor (on the device of `like`'s leaf where that is a
    tensor, else on the host).  Raises on a leaf count that differs from
    `like`'s or a crc mismatch."""
    with open(os.path.join(path, MANIFEST), "rb") as f:
        manifest = unpackb(f.read())
    leaves_like = flatten(like)
    if manifest["num_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"expected {len(leaves_like)}")
    new = []
    for info, ref in zip(manifest["leaves"], leaves_like):
        arr = np.load(os.path.join(path, f"leaf_{info['i']:05d}.npy"))
        if zlib.crc32(arr.tobytes()) != info["crc"]:
            raise IOError(f"crc mismatch in {path} leaf {info['i']}")
        new.append(_leaf_tensor(arr, info["dtype"], ref))
    return unflatten(like, new), manifest["step"]


def restore_latest(directory: str, like: Any):
    """(tree, step) of the newest intact generation, skipping corrupt ones
    (each skip is printed); (None, -1) when none can be read."""
    for step in reversed(list_generations(directory)):
        path = _gen_path(directory, step)
        try:
            return load_generation(path, like)
        except Exception as e:          # corrupt: fall back to the previous
            print(f"[checkpoint] skipping {path}: {e}")
    return None, -1
