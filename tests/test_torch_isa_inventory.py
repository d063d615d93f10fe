"""The port's pair inventory against the reference's, key by key.

``repro_torch.core.isa.PairInventory`` partitions the row-major pair
indices by decoder category in one sort; the reference collects Python
tuples per category.  Every key must hold the same pairs in the same
order, on every module of the zoo: N:2N-capable modules, modules whose
N:2N categories merge onto N:N keys and whose widest ones drop out, the
sequential Samsung modules and the Micron module with no activation.
"""
import numpy as np
import pytest

from repro.core.isa import PairInventory as RefInventory
from repro_torch.core.device import MODULE_ZOO
from repro_torch.core.isa import PairInventory

SEEDS = (0, 7, 2**31 + 5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("module", sorted(MODULE_ZOO))
def test_inventory_equals_reference(module, seed):
    mod = MODULE_ZOO[module]
    ref = RefInventory(mod, seed=seed)
    port = PairInventory(mod, seed=seed)
    assert port._pairs.keys() == ref._pairs.keys()
    for key, want in ref._pairs.items():
        got = port.pairs(*key)
        assert len(got) == len(want), key
        if len(want):
            assert got.dtype == want.dtype == np.int64, key
            assert got.shape == want.shape, key
            assert np.array_equal(got, want), key
        else:
            assert got.shape == (0, 2), key
        assert port.coverage(*key) == ref.coverage(*key), key
        for k in (0, 1, 37, 10**6 + 3) if len(want) else ():
            assert port.choose(*key, k) == ref.choose(*key, k), (key, k)
