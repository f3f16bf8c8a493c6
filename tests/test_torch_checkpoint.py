"""The port's checkpoint generations against the JAX package's, on the CPU.

Either package reads the other's generations of one tree (bfloat16,
float32, int8 and int32 leaves, None skipped), bit for bit; the manifest
is the bytes `msgpack.packb` gives (msgpack is imported here only: the
port writes and reads MessagePack with its own codec); a corrupt newest
generation is skipped for the one before it, and `keep` generations
survive a save.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import attention as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        w=rng.randn(3, 5).astype(np.float32).astype(ml_dtypes.bfloat16),
        b=rng.randn(5).astype(np.float32),
        q=rng.randint(-128, 128, (2, 4, 3)).astype(np.int8),
        n=np.asarray([7, -2**31, 2**31 - 1], np.int32),
        s=rng.rand(2, 2).astype(np.float32))


def _jax_tree(a):
    """A tree of every node kind: dicts (unsorted keys), tuples, a list,
    None."""
    return {"params": {"w": jnp.asarray(a["w"]), "b": a["b"]},
            "opt": (a["q"], None, [a["s"], a["n"]]), "empty": None}


def _to_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.asarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(x).copy())


def _port_tree(a):
    t = {k: _to_torch(v) for k, v in a.items()}
    return {"params": {"w": t["w"], "b": t["b"]},
            "opt": (t["q"], None, [t["s"], t["n"]]), "empty": None}


def _bits(x):
    """(dtype name, shape, raw bytes) of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        name = "bfloat16" if x.dtype == torch.bfloat16 else str(x.numpy().dtype)
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
        return name, tuple(x.shape), raw.tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _leaves_equal(port_tree, jax_tree):
    a, b = tckpt.flatten(port_tree), tckpt.flatten(jax_tree)
    assert len(a) == len(b) == 5
    assert [_bits(x) for x in a] == [_bits(x) for x in b]


def test_flatten_order_is_jax_order():
    import jax
    a = _arrays()
    got = [_bits(x) for x in tckpt.flatten(_port_tree(a))]
    want = [_bits(x) for x in jax.tree.leaves(_jax_tree(a))]
    assert got == want


def test_round_trip_in_the_port(tmp_path):
    """A port tree with a cache record (dataclass) round-trips bit for
    bit, each leaf back in its dtype and structure."""
    pool = TA.init_paged_kv_cache(3, 4, 2, 8, kv_bits=4)
    pool.k_q.copy_(torch.randint(-128, 128, pool.k_q.shape, dtype=torch.int8))
    pool.v_scale.copy_(torch.rand(pool.v_scale.shape))
    tree = dict(_port_tree(_arrays(1)), cache={"blocks": (pool,), "tail": ()})
    path = tckpt.save(str(tmp_path), 3, tree)
    assert os.path.basename(path) == "ckpt_00000003"
    like = dict(_port_tree(_arrays(2)),
                cache={"blocks": (TA.init_paged_kv_cache(3, 4, 2, 8, kv_bits=4),),
                       "tail": ()})
    got, step = tckpt.restore_latest(str(tmp_path), like)
    assert step == 3
    assert isinstance(got["cache"]["blocks"][0], TA.PagedKVCache)
    assert isinstance(got["opt"], tuple) and isinstance(got["opt"][2], list)
    assert got["opt"][1] is None and got["empty"] is None
    assert got["params"]["w"].dtype == torch.bfloat16
    assert [_bits(x) for x in tckpt.flatten(got)] == \
        [_bits(x) for x in tckpt.flatten(tree)]


def test_jax_generation_read_by_the_port(tmp_path):
    a = _arrays(3)
    jckpt.save(str(tmp_path), 11, _jax_tree(a))
    got, step = tckpt.restore_latest(str(tmp_path), _port_tree(_arrays(4)))
    assert step == 11
    _leaves_equal(got, _jax_tree(a))
    assert got["params"]["w"].dtype == torch.bfloat16


def test_port_generation_read_by_jax(tmp_path):
    a = _arrays(5)
    tckpt.save(str(tmp_path), 12, _port_tree(a))
    got, step = jckpt.restore_latest(str(tmp_path), _jax_tree(_arrays(6)))
    assert step == 12
    _leaves_equal(_port_tree(a), got)
    assert got["params"]["w"].dtype == ml_dtypes.bfloat16


def _manifest(directory, step):
    with open(os.path.join(directory, f"ckpt_{step:08d}",
                           "manifest.msgpack"), "rb") as f:
        return f.read()


def test_manifest_bytes_equal_msgpack(tmp_path):
    """The port's manifest is `msgpack.packb` of its content, and equal to
    JAX's manifest of the same tree but for the tree description."""
    a = _arrays(7)
    tckpt.save(str(tmp_path / "t"), 2**33, _port_tree(a))
    jckpt.save(str(tmp_path / "j"), 2**33, _jax_tree(a))
    t = _manifest(str(tmp_path / "t"), 2**33)
    j = msgpack.unpackb(_manifest(str(tmp_path / "j"), 2**33))
    assert t == msgpack.packb(msgpack.unpackb(t))
    assert tckpt.unpackb(t) == msgpack.unpackb(t)
    j["treedef"] = msgpack.unpackb(t)["treedef"]
    assert t == msgpack.packb(j)


_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
          2**64 - 1, -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31,
          -2**31 - 1, -2**63]


@pytest.mark.parametrize("obj", [
    _EDGES, {"i": _EDGES, "b": [True, False, None]},
    ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000, "a" * 65536],
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i, {"x": None}] for i in range(16)},
    {"nested": [[[]], {}, [{"a": (1, 2)}]]}])
def test_codec_equals_msgpack(obj):
    want = msgpack.packb(obj)
    assert tckpt.packb(obj) == want
    assert tckpt.unpackb(want) == msgpack.unpackb(want)


def test_corrupt_newest_generation_is_skipped(tmp_path, capsys):
    """A flipped byte in the newest generation's leaf fails its crc: the
    restore falls back to the generation before it, in both packages."""
    d = str(tmp_path)
    old, new = _arrays(8), _arrays(9)
    tckpt.save(d, 1, _port_tree(old))
    tckpt.save(d, 2, _port_tree(new))
    leaf = os.path.join(d, "ckpt_00000002", "leaf_00002.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    got, step = tckpt.restore_latest(d, _port_tree(_arrays(10)))
    assert step == 1 and "skipping" in capsys.readouterr().out
    _leaves_equal(got, _jax_tree(old))
    jgot, jstep = jckpt.restore_latest(d, _jax_tree(_arrays(10)))
    assert jstep == 1
    _leaves_equal(got, jgot)
    assert tckpt.restore_latest(str(tmp_path / "none"), _port_tree(old)) == (None, -1)


def test_keep_generations(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        tckpt.save(d, step, {"x": torch.tensor([step])}, keep=2)
    assert tckpt.list_generations(d) == [4, 5] == jckpt.list_generations(d)
    assert tckpt.latest_step(d) == 5 == jckpt.latest_step(d)
    tckpt.save(d, 6, {"x": torch.tensor([6])}, keep=0)
    assert tckpt.list_generations(d) == [4, 5, 6]
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert tckpt.latest_step(str(tmp_path / "none")) == -1


def test_leaf_count_mismatch_is_refused(tmp_path):
    tckpt.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_generation(os.path.join(str(tmp_path), "ckpt_00000001"),
                              {"x": torch.zeros(2), "y": torch.zeros(2)})


def test_port_imports_no_msgpack():
    """The port's package, the checkpoint module included, loads without
    msgpack (the card's machine has none)."""
    code = ("import pkgutil, importlib, sys\n"
            "sys.modules['msgpack'] = None\n"        # an import would raise
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.checkpoint import checkpoint as c\n"
            "import tempfile, torch\n"
            "d = tempfile.mkdtemp()\n"
            "c.save(d, 1, {'a': torch.ones(2)})\n"
            "assert c.restore_latest(d, {'a': torch.zeros(2)})[1] == 1\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_dataclass_leaves_follow_field_order():
    @dataclasses.dataclass
    class Rec:
        b: torch.Tensor
        a: torch.Tensor

    rec = Rec(torch.tensor([1]), torch.tensor([2]))
    assert [int(x) for x in tckpt.flatten({"r": rec})] == [1, 2]
    back = tckpt.unflatten({"r": rec}, [torch.tensor([3]), torch.tensor([4])])
    assert isinstance(back["r"], Rec) and int(back["r"].a) == 4
