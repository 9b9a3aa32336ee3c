"""The port's HDF5 subset (``mural_tpu_torch.data.h5lite``) against h5py,
the library the JAX package's cache uses: files the port writes read
back in h5py, and files h5py writes (default and small chunks, deep
chunk B-trees, 2-D arrays, bool, variable-length string attributes, more
datasets than one symbol-table node holds, attributes in continuation
blocks) read in the port.  Arrays, dtypes and shapes must be exactly
equal; the parts of HDF5 outside the subset raise an ``OSError`` naming
the feature."""
import threading

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mural_tpu_torch.data import h5lite

DTYPES = [np.int8, np.uint8, np.int32, np.int64, np.float32, np.float64,
          bool]


def _arrays(rng):
    return {
        "chrom_id": rng.integers(0, 3, 5000).astype(np.int32),
        "start": rng.integers(0, 2 ** 40, 5000),
        "strand_neg": rng.random(5000) < 0.5,
        "local1": rng.integers(-4, 4, (5000, 11)).astype(np.int8),
        "codes": rng.integers(0, 255, (300, 7)).astype(np.uint8),
        "cont": rng.normal(size=(5000, 2)).astype(np.float32),
        "f64": rng.normal(size=777),
        "seg_offsets": np.arange(0, 5001, 500, dtype=np.int64),
        "y": rng.integers(0, 4, 5000).astype(np.int32),
        "z_empty": np.zeros((0, 3), np.float32),
    }


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_port_written_reads_in_h5py(tmp_path):
    arrays = _arrays(np.random.default_rng(0))
    attrs = {"n_sites": 5000, "model_type": "snv",
             "chrom_names": np.array(["chr1", "chr22", "chrX"], dtype="S"),
             "n_files": 1, "shard_rows": np.array([3, 4], np.int64),
             "scale": 0.25}
    path = str(tmp_path / "port.h5")
    h5lite.write(path, attrs, arrays)
    with h5py.File(path, "r") as hf:
        assert sorted(hf) == sorted(arrays)
        for name, want in arrays.items():
            _assert_same(hf[name][()], want)
            if want.size:
                assert hf[name].compression == "gzip"
                assert hf[name].compression_opts == 1
        assert hf.attrs["n_sites"] == 5000
        assert hf.attrs["n_sites"].dtype == np.int64
        # string attributes are fixed-length byte strings: the JAX loader
        # decodes them
        assert hf.attrs["model_type"] == b"snv"
        _assert_same(hf.attrs["chrom_names"], attrs["chrom_names"])
        _assert_same(hf.attrs["shard_rows"], attrs["shard_rows"])
        assert hf.attrs["scale"] == 0.25
    got_attrs, got = h5lite.read(path)
    for name, want in arrays.items():
        _assert_same(got[name], want)
    assert got_attrs["model_type"] == b"snv"
    assert list(got_attrs) == list(attrs)


def test_h5py_written_reads_in_port(tmp_path):
    rng = np.random.default_rng(1)
    arrays = _arrays(rng)
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as hf:
        # h5py's own chunking (as the JAX cache writes), explicit small
        # chunks whose B-tree is several levels deep, and contiguous
        for i, (name, data) in enumerate(sorted(arrays.items())):
            if data.size == 0 or i % 3 == 2:
                hf.create_dataset(name, data=data)
            elif i % 3 == 0:
                hf.create_dataset(name, data=data, compression="gzip",
                                  compression_opts=1)
            else:
                hf.create_dataset(name, data=data, compression="gzip",
                                  chunks=tuple(max(1, s // 97)
                                               for s in data.shape))
        hf.create_dataset("deep", data=np.arange(40_000), chunks=(7,),
                          compression="gzip")
        hf.create_dataset("compact", data=np.arange(5, dtype=np.int16),
                          dcpl=_compact_dcpl())
        hf.attrs["model_type"] = "snv"
        hf.attrs["names"] = np.array(["a", "bé", ""],
                                     dtype=h5py.string_dtype())
        hf.attrs["chrom_names"] = np.array(["chr1", "chr22"], dtype="S")
        for i in range(40):                 # into continuation blocks
            hf.attrs[f"a{i:02d}"] = i
    attrs, got = h5lite.read(path)
    for name, want in arrays.items():
        _assert_same(got[name], want)
    _assert_same(got["deep"], np.arange(40_000))
    _assert_same(got["compact"], np.arange(5, dtype=np.int16))
    assert attrs["model_type"] == "snv"
    assert list(attrs["names"]) == ["a", "bé", ""]
    _assert_same(attrs["chrom_names"], np.array(["chr1", "chr22"], "S"))
    assert [attrs[f"a{i:02d}"] for i in range(40)] == list(range(40))
    # a named subset: every dataset listed, only those named read
    _, some = h5lite.read(path, names=["y"])
    assert sorted(some) == sorted(got)
    _assert_same(some["y"], arrays["y"])
    assert all(v is None for k, v in some.items() if k != "y")


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_jax_cache_file_reads_in_port(tmp_path):
    """A cache file the JAX package's writer made, 9 datasets (two
    symbol-table nodes) and a variable-length ``model_type``."""
    from types import SimpleNamespace

    from mural_tpu.data.cache import save_dataset_cache
    rng = np.random.default_rng(2)
    a = _arrays(rng)
    ds = SimpleNamespace(
        n_sites=5000, model_type="snv", chrom_names=["chr1", "chr2", "c3"],
        chrom_id=a["chrom_id"], start=a["start"], stop=a["start"] + 1,
        strand_neg=a["strand_neg"], y=a["y"], local1=a["local1"],
        cat=a["chrom_id"].reshape(-1, 1) * 7, cont=a["cont"],
        seg_offsets=a["seg_offsets"])
    path = str(tmp_path / "jax.sites.h5")
    save_dataset_cache(ds, path)
    attrs, got = h5lite.read(path)
    assert attrs["model_type"] == "snv" and attrs["n_sites"] == 5000
    assert len(got) == 9
    for name in got:
        _assert_same(got[name], getattr(ds, name))


@settings(max_examples=40, deadline=None)
@given(dtype=st.sampled_from(DTYPES),
       shape=st.lists(st.integers(0, 40), min_size=1, max_size=3),
       chunk_div=st.integers(1, 9), seed=st.integers(0, 2 ** 31))
def test_roundtrip_property(tmp_path_factory, dtype, shape, chunk_div,
                            seed):
    """Any dtype, shape and chunking: h5py -> port and port -> h5py."""
    rng = np.random.default_rng(seed)
    shape = tuple(shape)
    if np.dtype(dtype) == np.dtype(bool):
        data = rng.random(shape) < 0.5
    elif np.dtype(dtype).kind == "f":
        data = rng.normal(size=shape).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, shape, dtype=dtype,
                            endpoint=True)
    base = tmp_path_factory.mktemp("prop")
    with h5py.File(base / "a.h5", "w") as hf:
        if data.size:
            hf.create_dataset("x", data=data, compression="gzip",
                              chunks=tuple(max(1, -(-s // chunk_div))
                                           for s in shape))
        else:
            hf.create_dataset("x", data=data)
    _assert_same(h5lite.read(str(base / "a.h5"))[1]["x"], data)
    h5lite.write(str(base / "b.h5"), {"n": chunk_div}, {"x": data})
    with h5py.File(base / "b.h5", "r") as hf:
        _assert_same(hf["x"][()], data)
        assert hf.attrs["n"] == chunk_div


@pytest.mark.parametrize("case,feature", [
    ("shuffle", "shuffle filter"),
    ("latest", "superblock version"),
    ("big_endian", "big-endian"),
    ("fletcher32", "fletcher32 filter")])
def test_unsupported_features_raise_oserror(tmp_path, case, feature):
    path = tmp_path / f"{case}.h5"
    kw = {"libver": "latest"} if case == "latest" else {}
    with h5py.File(path, "w", **kw) as hf:
        data = np.arange(100, dtype=">i4" if case == "big_endian" else "<i4")
        hf.create_dataset("x", data=data, chunks=(10,),
                          shuffle=case == "shuffle",
                          fletcher32=case == "fletcher32")
    with pytest.raises(h5lite.UnsupportedFeature, match=feature) as err:
        h5lite.read(str(path))
    assert isinstance(err.value, OSError)


def test_damaged_files_raise_oserror(tmp_path):
    h5lite.write(str(tmp_path / "ok.h5"), {}, {"x": np.arange(1000)})
    blob = (tmp_path / "ok.h5").read_bytes()
    for name, data in (("empty", b""), ("junk", b"not an hdf5 file"),
                       ("cut", blob[:len(blob) // 2])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(h5lite.FormatError):
            h5lite.read(str(tmp_path / name))
    with pytest.raises(h5lite.UnsupportedFeature, match="big-endian"):
        h5lite.write(str(tmp_path / "be.h5"), {},
                     {"x": np.arange(3, dtype=">i8")})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "cut", "empty", "junk", "ok.h5"]


def test_concurrent_writers_leave_a_complete_file(tmp_path):
    """Writers of one path, each through its own temporary name: the
    file left is one writer's whole file, and no temporary remains."""
    path = str(tmp_path / "c.h5")
    arrays = [{"x": np.full(20_000, k, np.int64)} for k in range(6)]
    threads = [threading.Thread(target=h5lite.write,
                                args=(path, {"k": k}, arrays[k]))
               for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    attrs, got = h5lite.read(path)
    _assert_same(got["x"], arrays[int(attrs["k"])]["x"])
    assert [p.name for p in tmp_path.iterdir()] == ["c.h5"]
