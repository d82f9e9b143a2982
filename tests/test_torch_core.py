"""The port's copy of the design flow gives the reference's arrays: every
registered function's ``cached_table`` and the default pack's layout are
equal, array for array, to ``repro.core``'s."""

import dataclasses

import numpy as np
import pytest

from repro.approx.activations import DEFAULT_PACK_FUNCTIONS as J_DEFAULT
from repro.core import function_names as j_names
from repro.core.flow import cached_table as j_cached
from repro.core.packing import pack_layout as j_pack_layout
from repro_torch.approx.activations import DEFAULT_PACK_FUNCTIONS
from repro_torch.core import function_names
from repro_torch.core.flow import cached_table
from repro_torch.core.packing import pack_layout

TABLE_FIELDS = ("boundaries", "inv_delta", "delta", "base", "seg_count", "values")


def test_same_registry():
    assert function_names() == j_names()
    assert len(function_names()) == 18
    assert DEFAULT_PACK_FUNCTIONS == J_DEFAULT


@pytest.mark.parametrize("name", j_names())
def test_cached_table_equal(name):
    want = j_cached(name, 1e-4)
    got = cached_table(name, 1e-4)
    assert (got.name, got.lo, got.hi, got.e_a, got.algorithm) == \
        (want.name, want.lo, want.hi, want.e_a, want.algorithm)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("algorithm", ["binary", "hierarchical", "sequential",
                                       "reference"])
def test_algorithms_equal(algorithm):
    want = j_cached("gelu", 1e-4, algorithm=algorithm, omega=0.2)
    got = cached_table("gelu", 1e-4, algorithm=algorithm, omega=0.2)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("e_a", [1e-4, 1e-6])
def test_default_pack_layout_equal(e_a):
    names = DEFAULT_PACK_FUNCTIONS
    want = j_pack_layout([j_cached(n, e_a, algorithm="hierarchical", omega=0.2)
                          for n in names])
    got = pack_layout([cached_table(n, e_a, algorithm="hierarchical", omega=0.2)
                       for n in names])
    assert (got.names, got.n_intervals, got.n_max) == \
        (want.names, want.n_intervals, want.n_max)
    for f in dataclasses.fields(got):
        if f.name in ("names", "specs", "n_intervals", "n_max"):
            continue
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f.name)
    if e_a == 1e-4:  # stablelm-3b's pack: the one the chip smoke run serves
        assert got.footprint == 894 and got.n_intervals == (6, 5, 3, 5, 5, 6)


def test_pack_layout_rejects_bad_input():
    with pytest.raises(ValueError):
        pack_layout([])
    s = cached_table("silu", 1e-4)
    with pytest.raises(ValueError, match="duplicate"):
        pack_layout([s, s])
    with pytest.raises(KeyError, match="not in pack"):
        pack_layout([s]).fn_id("gelu")
