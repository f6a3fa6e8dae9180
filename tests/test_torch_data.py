"""The port's data layer (``gpsig_tpu_torch/data/synthetic.py``,
``data/uea.py``, ``data/_native.py`` with its own copy of the native
parser) against ``gpsig_tpu.data``, bitwise:

- ``sits_sequences``, ``ragged_classification_sequences`` and
  ``train_test_split`` (on arrays and on lists) from the same seeds;
- .ts files (equal-length, ragged, with missing values) and a
  multivariate relational .arff written under ``tmp_path``, loaded by both
  packages, and by both of the port's .ts parsers (the native library and
  the Python fallback); values written with ``repr`` read back exactly.
"""

import os

import numpy as np
import pytest

from gpsig_tpu.data import synthetic as jsyn
from gpsig_tpu.data import uea as juea
from gpsig_tpu_torch.data import _native
from gpsig_tpu_torch.data import synthetic as tsyn
from gpsig_tpu_torch.data import uea as tuea


def assert_same(got, want):
    """Arrays, lists of arrays and tuples of them: equal bitwise, with the
    same dtypes."""
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_sets_are_bitwise_equal(seed):
    assert_same(tsyn.sits_sequences(seed, N=500, L=24, num_classes=7),
                jsyn.sits_sequences(seed, N=500, L=24, num_classes=7))
    assert_same(tsyn.ragged_classification_sequences(seed, N=30),
                jsyn.ragged_classification_sequences(seed, N=30))
    X, y = jsyn.classification_sequences(seed, N=40, L=9)
    assert_same(tsyn.train_test_split(X, y, 0.25, seed),
                jsyn.train_test_split(X, y, 0.25, seed))
    seqs, ys = jsyn.ragged_classification_sequences(seed, N=20)
    got = tsyn.train_test_split(seqs, ys, 0.3, seed)
    want = jsyn.train_test_split(seqs, ys, 0.3, seed)
    assert isinstance(got[0], list) and len(got[2]) == 6
    assert_same(got, want)


# -- archive files --------------------------------------------------------------

def ts_line(rng, L, d, label, missing):
    dims = []
    for _ in range(d):
        vals = ["?" if rng.random() < missing else repr(float(v))
                for v in rng.standard_normal(L)]
        dims.append(",".join(vals))
    return ":".join(dims) + f":{label}"


def write_ts(path, rng, n, lengths, d, missing):
    lines = ["# written by the test", f"@problemName {path.stem}",
             "@timeStamps false", "@univariate false", "@data"]
    lines += [ts_line(rng, int(rng.integers(*lengths)), d, f"c{i % 3}",
                      missing) for i in range(n)]
    path.write_text("\n".join(lines) + "\n")


def write_arff(path, rng, n, L, d):
    lines = ["% written by the test", f"@relation {path.stem}",
             "@attribute series relational", "@attribute t0 numeric",
             "@end series", "@attribute target {a,b}", "@data"]
    for i in range(n):
        rows = ["\\n".join(",".join(repr(float(v)) if rng.random() > 0.1
                                    else "?" for v in rng.standard_normal(L))
                           for _ in range(d))]
        lines.append(f"'{rows[0]}',{'ab'[i % 2]}")
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture
def archive(tmp_path):
    """Three datasets: equal-length .ts, ragged .ts with missing values,
    a multivariate .arff."""
    rng = np.random.default_rng(0)
    for name, kw in (("Equal", dict(lengths=(12, 13), d=3, missing=0.0)),
                     ("Ragged", dict(lengths=(5, 17), d=2, missing=0.2))):
        (tmp_path / name).mkdir()
        for split, n in (("TRAIN", 14), ("TEST", 9)):
            write_ts(tmp_path / name / f"{name}_{split}.ts", rng, n, **kw)
    (tmp_path / "Rel").mkdir()
    for split, n in (("TRAIN", 6), ("TEST", 4)):
        write_arff(tmp_path / "Rel" / f"Rel_{split}.arff", rng, n, 8, 3)
    return tmp_path


def test_archives_load_bitwise_as_the_jax_package(archive):
    assert tuea.available_datasets(str(archive)) == \
        juea.available_datasets(str(archive)) == ["Equal", "Ragged", "Rel"]
    for name in ("Equal", "Ragged", "Rel"):
        got = tuea.load_dataset(name, root=str(archive))
        want = juea.load_dataset(name, root=str(archive))
        assert_same(got, want)
        assert not any(np.isnan(x).any() for x in got[0] + got[2])
    assert {x.shape for x in tuea.load_dataset(
        "Equal", root=str(archive))[0]} == {(12, 3)}
    with pytest.raises(FileNotFoundError, match="no Missing_TRAIN"):
        tuea.load_dataset("Missing", root=str(archive))


def test_both_ts_parsers_read_the_values_written(archive):
    """The native library (built from the port's copy into the port's
    build folder) and the Python parser give the same arrays and labels,
    and a file written with repr reads back exactly."""
    assert _native.loaded()
    assert _native._lib._name.startswith(str(_native.BUILD_DIR))
    for name in ("Equal", "Ragged"):
        path = str(archive / name / f"{name}_TRAIN.ts")
        native, python = _native.parse_ts(path), tuea._parse_ts_py(path)
        assert native is not None
        assert native[1] == python[1]
        assert_same(native[0], python[0])
        assert_same(tuea._parse_ts(path)[0], python[0])
    rng = np.random.default_rng(5)
    X = rng.standard_normal((3, 7, 2))
    lines = ["@data"] + [":".join(",".join(repr(float(v)) for v in x[:, k])
                                  for k in range(2)) + ":z" for x in X]
    path = archive / "exact.ts"
    path.write_text("\n".join(lines) + "\n")
    for seqs, labels in (_native.parse_ts(str(path)),
                         tuea._parse_ts_py(str(path))):
        assert labels == ["z"] * 3
        np.testing.assert_array_equal(np.stack(seqs), X)


def test_no_native_switch_takes_the_python_parser(archive, monkeypatch):
    """GPSIG_TPU_NO_NATIVE=1 (the JAX package's switch) keeps the library
    unloaded; the Python parser then reads the same values."""
    monkeypatch.setenv("GPSIG_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "_lib", None)
    assert not _native.loaded()
    path = str(archive / "Ragged" / "Ragged_TEST.ts")
    assert _native.parse_ts(path) is None
    got = tuea._parse_ts(path)
    monkeypatch.delenv("GPSIG_TPU_NO_NATIVE")
    assert_same(got[0], juea._parse_ts_py(path)[0])


def test_data_dir_reads_the_shared_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("GPSIG_TPU_DATA_DIR", str(tmp_path))
    assert tuea.data_dir() == juea.data_dir() == str(tmp_path)
    assert tuea.data_dir("elsewhere") == "elsewhere"
    monkeypatch.delenv("GPSIG_TPU_DATA_DIR")
    assert os.path.isabs(tuea.data_dir())
    assert tuea.data_dir().endswith(os.path.join("data", "UEA"))
