"""The networks' weight files between the two packages, on the CPU.

The JAX package saves parameters with flax (``serialization.to_bytes``,
msgpack) and reads the production ASTA U-Net from a keras HDF5 file
through h5py.  The port reads and writes the same files with code of
its own (``io/flaxmsgpack.py``, ``io/hdf5.py``), because the card's
machine has neither flax nor h5py.  Every test runs twice:
as is, and with ``sys.modules["flax"]``, ``["msgpack"]`` and
``["h5py"]`` set to None around the port's calls (the JAX side and
h5py write and read their files outside that block).

What is held:
- files the JAX package's ``save_params`` writes load in the port as
  the state dicts ``from_jax_params`` gives in memory, bit for bit, and
  give flax's logits at rtol/atol 1e-5;
- files the port writes load with the JAX package's ``load_params``,
  leaves bit-equal, and their bytes are ``flax.serialization.to_bytes``'s
  for the same tree;
- the codec writes msgpack's bytes and reads back what msgpack reads,
  over every type of flax's subset;
- files of the port's earlier format (``torch.save``) still load;
- truncated files, wrong trees and flax's chunked arrays raise
  ``ValueError``;
- each file h5py writes here reads through the port's HDF5 reader
  equal to h5py's own read (every dataset and attribute, in
  ``visititems`` order), and the keras conversion gives the JAX
  package's; the formats it refuses raise ``ValueError`` naming the
  structure.
"""

import contextlib
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import torch  # noqa: E402

import torch_parity  # noqa: E402,F401  (pins torch threads)
from torch_parity import assert_close, assert_exact  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from blackbox_tpu.models import trailnet as JT  # noqa: E402
from blackbox_tpu.models import vetnet as JV  # noqa: E402
from blackbox_tpu_torch.io import flaxmsgpack, hdf5  # noqa: E402
from blackbox_tpu_torch.models import trailnet as TT  # noqa: E402
from blackbox_tpu_torch.models import vetnet as TV  # noqa: E402
from test_torch_models import _keras_file  # noqa: E402

BLOCKED = ("flax", "msgpack", "h5py")


@pytest.fixture(params=[False, True], ids=["as_is", "blocked"])
def port(request):
    """A context for the port's calls: as is, or with flax, msgpack and
    h5py unimportable."""
    @contextlib.contextmanager
    def side():
        if not request.param:
            yield
            return
        with pytest.MonkeyPatch.context() as mp:
            for m in BLOCKED:
                mp.setitem(sys.modules, m, None)
            yield
    return side


NETS = {"trailnet": (JT, TT, {"tile": 32}), "trailnet256": (JT, TT,
                                                           {"tile": 256}),
        "vetnet": (JV, TV, {})}


def _jax_params(name, key=3):
    J, _, kw = NETS[name]
    return J.init_params(jax.random.PRNGKey(key), **kw)


def _logits(name, params, state):
    """(flax logits, port logits) of one input from a seed."""
    J, T, kw = NETS[name]
    rng = np.random.default_rng(0)
    if T is TT:
        tile = kw["tile"]
        x = rng.normal(0, 1, (1, tile, tile)).astype(np.float32)
        want = J.TrailUNet().apply(params, jnp.asarray(x)[..., None])
        model = TT.model_from(state, "cpu")
    else:
        x = rng.normal(0, 1, (3, JV.STAMP, JV.STAMP, 4)).astype(np.float32)
        want = J.VetNet().apply(params, jnp.asarray(x))
        model = TV.VetNet()
        model.load_state_dict(state)
        model.eval()
    with torch.no_grad():
        return want, model(torch.from_numpy(x))


# --------------------------------------------------- flax msgpack files

@pytest.mark.parametrize("name", sorted(NETS))
def test_jax_file_loads_in_the_port(name, port, tmp_path):
    J, T, _ = NETS[name]
    params = _jax_params(name)
    path = str(tmp_path / "net.msgpack")
    J.save_params(path, params)
    with port():
        got = T.load_params(path)
    want = T.from_jax_params(params)
    assert list(got) == list(T.init_params(torch.Generator()))
    for k in want:
        assert_exact(got[k], want[k], k)
    jl, tl = _logits(name, params, got)
    assert_close(tl, jl, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["trailnet", "vetnet"])
def test_port_file_loads_in_jax(name, port, tmp_path):
    J, T, kw = NETS[name]
    params = T.init_params(torch.Generator().manual_seed(7))
    path = str(tmp_path / "net.msgpack")
    with port():
        T.save_params(path, params)
    back = J.load_params(path, **kw)
    want = TT.to_jax_params(params)
    got_leaves = jax.tree_util.tree_leaves_with_path(back)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, g), (_, w) in zip(got_leaves, want_leaves):
        assert_exact(np.asarray(g), w, jax.tree_util.keystr(p))
    again = T.from_jax_params(back)
    for k in params:
        assert_exact(again[k], params[k], k)


@pytest.mark.parametrize("name", ["trailnet", "vetnet"])
def test_port_file_bytes_are_flax_bytes(name, port, tmp_path):
    """A trained tree's keys are sorted (jax.tree_util rebuilds every
    dict sorted), as the port writes them: the bytes are flax's."""
    J, T, _ = NETS[name]
    params = jax.tree_util.tree_map(np.asarray, _jax_params(name, key=5))
    path = str(tmp_path / "net.msgpack")
    with port():
        T.save_params(path, T.from_jax_params(params))
    with open(path, "rb") as fh:
        assert fh.read() == serialization.to_bytes(params)


def _codec_trees():
    rng = np.random.default_rng(1)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        "scalars": {"none": None, "t": True, "f": False, "x": 1.5,
                    "nan": float("nan"), "c": 3 - 4j,
                    **{f"i{j}": v for j, v in enumerate(ints)}},
        "strings": {"s0": "", "s31": "a" * 31, "s32": "b" * 32,
                    "s255": "c" * 255, "s256": "d" * 256,
                    "s65536": "e" * 65536, "utf8": "é漢",
                    "b0": b"", "b255": b"\x01" * 255, "b256": b"\x02" * 256,
                    "b65536": b"\x03" * 65536},
        "maps": {"m15": {str(i): i for i in range(15)},
                 "m16": {str(i): {"k": i} for i in range(16)},
                 "m65536": {f"{i:05d}": i for i in range(65536)},
                 "deep": {"a": {"b": {"c": {"d": np.float32(1.0)}}}}},
        "arrays": {
            # payloads of ext 8, 16 and 32 (a float32 scalar's is
            # fixext 16; flax's payloads are never 1, 2, 4 or 8 bytes)
            **{f"u8_{n}": np.arange(n, dtype=np.uint8)
               for n in (0, 1, 5, 300, 70000)},
            "f32": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "f64": rng.normal(size=(7,)),
            "i64": rng.integers(-9, 9, (2, 3)),
            "bool": rng.random((4, 4)) < 0.5,
            "c64": (rng.normal(size=3) + 1j).astype(np.complex64),
            "f16": np.float16([1.0, -2.5]),
            "zero_d": np.array(2.0, np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "fortran": np.asfortranarray(rng.normal(size=(3, 5))),
            "npscalars": {"f32": np.float32(2.5), "i8": np.int8(-3),
                          "b": np.bool_(True), "f64": np.float64(0.25)}},
    }


@pytest.mark.parametrize("case", sorted(_codec_trees()))
def test_codec_is_msgpack(case, port):
    """The codec against msgpack through flax: the same bytes, and the
    same tree back (types, key order, dtypes and values)."""
    tree = _codec_trees()[case]
    # in place: a copy would rebuild every dict with sorted keys
    want_bytes = serialization.msgpack_serialize(_codec_trees()[case],
                                                 in_place=True)
    want = serialization.msgpack_restore(want_bytes)
    with port():
        got_bytes = flaxmsgpack.encode(tree)
        got = flaxmsgpack.decode(want_bytes)
    assert got_bytes == want_bytes

    def same(g, w, where):
        assert type(g) is type(w) or (isinstance(g, np.generic)
                                      and type(g) is type(w)), where
        if isinstance(w, dict):
            assert list(g) == list(w), where
            for k in w:
                same(g[k], w[k], f"{where}/{k}")
        elif isinstance(w, np.ndarray):
            assert_exact(g, w, where)
        elif isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), where
        else:
            assert g == w and np.asarray(g).dtype == np.asarray(w).dtype, \
                where
    same(got, want, case)


def test_codec_lists_differ_from_to_bytes(port):
    """The stated difference: to_bytes makes a list into a map keyed
    "0", "1", ...; the codec writes it as an array, as msgpack does."""
    tree = {"a": [1, np.float32(2.0)]}
    with port():
        got = flaxmsgpack.encode(tree)
        as_map = flaxmsgpack.encode({"a": {"0": 1, "1": np.float32(2.0)}})
    assert got == serialization.msgpack_serialize(tree, in_place=True)
    assert got != serialization.to_bytes(tree)
    assert as_map == serialization.to_bytes(tree)


@pytest.mark.parametrize("name", ["trailnet", "vetnet"])
def test_torch_save_file_still_loads(name, port, tmp_path):
    _, T, _ = NETS[name]
    params = T.init_params(torch.Generator().manual_seed(2))
    path = str(tmp_path / "net.pt")
    torch.save(params, path)
    with port():
        got = T.load_params(path)
    assert list(got) == list(params)
    for k in params:
        assert_exact(got[k], params[k], k)


def _bad_file(what, path):
    """Write the file ``what`` to ``path``; returns (the port's module
    that loads it, the regex its ValueError matches)."""
    params = jax.tree_util.tree_map(np.asarray, _jax_params("trailnet"))
    good = serialization.to_bytes(params)
    inner = params["params"]
    head = b"\x81\xa6params"
    mod = TT
    if what.startswith("truncated_"):
        frac = float(what.split("_")[1])
        data, match = good[:max(1, int(frac * len(good)))], "truncated"
    elif what == "trailing_bytes":
        data, match = good + b"\xc0", "after the object"
    elif what == "empty":
        data, match = b"", "neither"
    elif what == "not_msgpack":
        data, match = b"\x00\x01\x02", "neither"
    elif what == "vetnet_into_trailnet":
        data = serialization.to_bytes(jax.tree_util.tree_map(
            np.asarray, _jax_params("vetnet")))
        match = "missing"
    elif what == "trailnet_into_vetnet":
        data, mod, match = good, TV, "missing"
    elif what == "missing_leaf":
        data = serialization.to_bytes({"params": {
            k: v for k, v in inner.items() if k != "Conv_0"}})
        match = "missing"
    elif what == "extra_leaf":
        data = serialization.to_bytes({"params": dict(
            inner, Dense_9={"kernel": np.zeros((2, 2), np.float32)})})
        match = "extra"
    elif what == "wrong_shape":
        inner["Conv_0"]["kernel"] = np.zeros((1, 1, 16, 2), np.float32)
        data, match = serialization.to_bytes(params), "expected"
    elif what == "no_params_key":
        data, match = serialization.to_bytes(inner), "params"
    elif what == "extra_top_key":
        data = serialization.to_bytes({"params": inner, "batch_stats": {}})
        match = "params"
    elif what == "chunked_marker":
        data = flaxmsgpack.encode({"params": {"Conv_0": {"kernel": {
            flaxmsgpack.CHUNK_MARKER: True, "shape": {"0": 2},
            "chunks": {"0": np.zeros(2, np.float32)}}}}})
        match = "chunked"
    elif what == "unknown_ext":
        data, match = head + b"\xd4\x05\x00", "extension type 5"
    elif what == "reserved_byte":
        data, match = head + b"\xc1", "0xc1"
    elif what == "bad_dtype":
        data = head + flaxmsgpack._ext(1, flaxmsgpack.encode(
            ((2,), "float99", b"\0" * 8)))
        match = "dtype"
    elif what == "short_buffer":
        data = head + flaxmsgpack._ext(1, flaxmsgpack.encode(
            ((4,), "float32", b"\0" * 8)))
        match = "holds 8 bytes"
    else:
        raise KeyError(what)
    with open(path, "wb") as fh:
        fh.write(data)
    return mod, match


BAD_FILES = ["truncated_0.0", "truncated_0.001", "truncated_0.5",
             "truncated_0.999", "trailing_bytes", "empty", "not_msgpack",
             "vetnet_into_trailnet", "trailnet_into_vetnet", "missing_leaf",
             "extra_leaf", "wrong_shape", "no_params_key", "extra_top_key",
             "chunked_marker", "unknown_ext", "reserved_byte", "bad_dtype",
             "short_buffer"]


@pytest.mark.parametrize("what", BAD_FILES)
def test_bad_files_raise(what, port, tmp_path):
    path = str(tmp_path / "net.msgpack")
    mod, match = _bad_file(what, path)
    with port(), pytest.raises(ValueError, match=match):
        mod.load_params(path)


def test_oversized_array_refused_on_write(port):
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32),
                                          (2 ** 28 + 1,), (0,))
    with port(), pytest.raises(ValueError, match="chunked"):
        flaxmsgpack.encode({"params": {"x": big}})


# ------------------------------------------------------------ HDF5 files

def _same_value(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (what, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (what, got.dtype, want.dtype, got.shape, want.shape)
        if want.dtype == object:
            assert [type(x) for x in got.ravel()] == \
                [type(x) for x in want.ravel()], what
            assert list(got.ravel()) == list(want.ravel()), what
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert type(got) is type(want), (what, type(got), type(want))
        assert got == want, (what, got, want)


def _h5py_read(path):
    """[(path, kind, {attr: value}, data)] of the root and every object
    below it in visititems order, as h5py reads them."""
    out = []
    with h5py.File(path, "r") as f:
        def add(p, o):
            data = np.asarray(o) if isinstance(o, h5py.Dataset) else list(o)
            kind = "Dataset" if isinstance(o, h5py.Dataset) else "Group"
            out.append((p, kind, dict(o.attrs), data))
        add("/", f)
        f.visititems(add)
    return out


def _port_read(path):
    out = []
    root = hdf5.open(path)

    def add(p, o):
        kind = "Dataset" if isinstance(o, hdf5.Dataset) else "Group"
        data = np.asarray(o) if kind == "Dataset" else list(o)
        out.append((p, kind, dict(o.attrs), data))
    add("/", root)
    root.visititems(add)
    return out


def _keras_names(f, fixed):
    if fixed:
        root = f["model_weights"]
        names = [n.encode() for n in root.attrs["layer_names"]]
        root.attrs["layer_names"] = np.array(names)   # keras 2's own 'S'


def _write_h5(kind, path):
    rng = np.random.default_rng(4)
    if kind in ("keras_vlen", "keras_fixed"):
        _keras_file(path, _jax_params("trailnet"))
        with h5py.File(path, "a") as f:
            _keras_names(f, kind == "keras_fixed")
            f.attrs["keras_version"] = b"2.15.0"
            f.attrs["backend"] = "tensorflow"
        return
    with h5py.File(path, "w") as f:
        if kind == "many_layers":
            root = f.create_group("model_weights")
            names = []
            for i in range(33):
                name = f"dense_{i}"
                names.append(name.encode())
                g = root.create_group(name).create_group(name)
                root[name].attrs["weight_names"] = np.array(
                    [f"{name}/kernel:0".encode(), f"{name}/bias:0".encode()])
                g.create_dataset("kernel:0", data=rng.normal(
                    size=(4, 3)).astype(np.float32))
                g.create_dataset("bias:0", data=rng.normal(
                    size=3).astype(np.float32))
            root.attrs["layer_names"] = np.array(names)
        elif kind == "many_attrs":
            g = f.create_group("g")
            for i in range(44):
                g.attrs[f"attr_{i:02d}"] = rng.normal(size=i + 1)
            g.attrs["text"] = "x" * 300
            g.attrs["count"] = np.int32(7)
            g.attrs["empty"] = np.zeros(0)
            g.create_dataset("d", data=np.arange(3.0))
        elif kind == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            f.create_dataset("c", data=rng.integers(-5, 5, (3, 4)).astype(
                np.int16), dcpl=dcpl)
            f.create_dataset("scalar", data=np.float64(2.5))
        elif kind == "chunked":
            f.create_dataset("c", data=rng.normal(size=(10, 7, 3)),
                             chunks=(4, 3, 2))
            f.create_dataset("never_written", shape=(5, 5), dtype="f4",
                             chunks=(2, 2))
            f.create_dataset("unallocated", shape=(4,), dtype="i8")
        elif kind == "big_endian":
            f.create_dataset("be", data=rng.normal(size=(6, 5)).astype(">f4"))
            f.create_dataset("be_i", data=np.arange(6, dtype=">i4"))
            f["be"].attrs["scale"] = np.array([1.5, 2.5], ">f8")


H5_KINDS = ["keras_vlen", "keras_fixed", "many_layers", "many_attrs",
            "compact", "chunked", "big_endian"]


@pytest.mark.parametrize("kind", H5_KINDS)
def test_hdf5_reads_as_h5py(kind, port, tmp_path):
    path = str(tmp_path / f"{kind}.h5")
    _write_h5(kind, path)
    want = _h5py_read(path)
    with port():
        got = _port_read(path)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (p, _, ga, gd), (_, _, wa, wd) in zip(got, want):
        assert list(ga) == list(wa), p
        for k in wa:
            _same_value(ga[k], wa[k], f"{p}@{k}")
        if isinstance(wd, np.ndarray):
            _same_value(gd, wd, p)
        else:
            assert gd == wd, p
    if kind == "many_attrs":
        assert len(want[1][2]) >= 40
    if kind == "many_layers":
        assert sum(1 for w in want if w[0].count("/") == 1) >= 30


@pytest.mark.parametrize("kind", ["keras_vlen", "keras_fixed"])
def test_keras_conversion_without_h5py(kind, port, tmp_path):
    """The conversion through the port's reader is the JAX package's
    (through h5py) carried across, bit for bit."""
    path = str(tmp_path / "asta.h5")
    _write_h5(kind, path)
    want = TT.from_jax_params(JT.convert_keras_weights(path, tile=32))
    with port():
        got = TT.convert_keras_weights(path)
    assert got.keys() == want.keys()
    for k in want:
        assert_exact(got[k], want[k], k)


def _refused(kind, path):
    if kind == "libver_latest":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("x", data=np.arange(3.0))
        return "superblock version 3"
    if kind == "gzip":
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(300.0), compression="gzip")
        return "filter pipeline"
    if kind == "track_order":
        with h5py.File(path, "w") as f:
            f.create_group("g", track_order=True)
        return "OHDR"
    if kind == "keras3_zip":
        import zipfile
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("config.json", "{}")
        return "zip archive"
    if kind == "enum":
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.array([True, False]))
        return "enum"
    if kind == "truncated":
        _write_h5("keras_vlen", path)
        with open(path, "rb") as fh:
            data = fh.read()
        with open(path, "wb") as fh:
            fh.write(data[:3000])
        return "end of the file"
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["libver_latest", "gzip", "track_order",
                                  "keras3_zip", "enum", "truncated"])
def test_hdf5_refuses(kind, port, tmp_path):
    path = str(tmp_path / f"{kind}.h5")
    match = _refused(kind, path)
    with port(), pytest.raises(ValueError, match=match):
        root = hdf5.open(path)
        root.visititems(lambda p, o: np.asarray(o)
                        if isinstance(o, hdf5.Dataset) else None)


def test_save_refuses_another_network(port, tmp_path):
    params = TV.init_params(torch.Generator().manual_seed(1))
    with port(), pytest.raises(ValueError, match="not a TrailUNet"):
        TT.save_params(str(tmp_path / "net.msgpack"), params)
