"""The port's numpy-only copies of the data layer
(``gpsig_tpu_torch/data/uea_like.py``, ``data/preprocessing.py``) against
``gpsig_tpu.data``'s: every frozen dataset bitwise equal, the same
fingerprints, and the preprocessing functions equal on the same inputs.
"""

import numpy as np
import pytest

from gpsig_tpu.data import preprocessing as jprep
from gpsig_tpu.data import uea_like as juea
from gpsig_tpu_torch.data import preprocessing as tprep
from gpsig_tpu_torch.data import uea_like as tuea


def test_the_same_datasets_are_available():
    assert tuea.available_datasets() == juea.available_datasets()
    assert len(tuea.available_datasets()) == 5
    with pytest.raises(KeyError, match="unknown synthetic dataset"):
        tuea.load_dataset("GunPoint")


@pytest.mark.parametrize("name", juea.available_datasets())
def test_datasets_are_bitwise_equal(name):
    got, want = tuea.load_dataset(name), juea.load_dataset(name)
    for g_split, w_split in zip(got, want):
        assert len(g_split) == len(w_split)
        for g, w in zip(g_split, w_split):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert tuea.dataset_fingerprint(name) == juea.dataset_fingerprint(name)


def test_synth_gunpoint_shapes():
    Xtr, ytr, Xte, yte = tuea.load_dataset("SynthGunPoint")
    assert (len(Xtr), len(Xte)) == (50, 150)
    assert {x.shape for x in Xtr + Xte} == {(150, 1)}
    assert set(ytr) | set(yte) == {0, 1}


def test_preprocessing_functions_are_equal():
    rng = np.random.default_rng(0)
    seqs = [rng.standard_normal((L, 3)) for L in (5, 9, 7)]
    for mod_out in (tprep.tabulate_list_of_sequences(seqs),
                    tprep.tabulate_list_of_sequences(seqs, 6)):
        assert mod_out.shape[0] == 3
    np.testing.assert_array_equal(tprep.tabulate_list_of_sequences(seqs),
                                  jprep.tabulate_list_of_sequences(seqs))
    np.testing.assert_array_equal(tprep.tabulate_list_of_sequences(seqs, 6),
                                  jprep.tabulate_list_of_sequences(seqs, 6))
    for g, w in zip(tprep.add_time_to_list(seqs),
                    jprep.add_time_to_list(seqs)):
        np.testing.assert_array_equal(g, w)
    table = jprep.tabulate_list_of_sequences(seqs)
    np.testing.assert_array_equal(tprep.add_time_to_table(table),
                                  jprep.add_time_to_table(table))
    np.testing.assert_array_equal(tprep.flatten_sequences(table),
                                  jprep.flatten_sequences(table))
    for data in (seqs, table):
        ts, js = tprep.SequenceScaler().fit(data), jprep.SequenceScaler().fit(
            data)
        np.testing.assert_array_equal(ts.mean_, js.mean_)
        np.testing.assert_array_equal(ts.std_, js.std_)
        got, want = ts.transform(data), js.transform(data)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            np.concatenate(list(tprep.SequenceScaler().fit_transform(data))),
            np.concatenate(list(jprep.SequenceScaler().fit_transform(data))))
