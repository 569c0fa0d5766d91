"""The full-suite pin `tests/fixtures/torch_engine_sweep.json` against the
JAX reference.

`chip_smoke.py` holds E1's 27-workload x 10-row sweep at 20,000 events
against this fixture.  Here the reference's own `sweep`, run by the
fixture's recipe on the CPU, recomputes some of its workloads (all 10
rows each) and must give the stored stats exactly, so the fixture is the
reference's and not the port's.  The recipe itself is checked to name the
rows, workloads, events, seed and config the file records.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import schemes as ref_schemes
from repro.core.batchsim import sweep as ref_sweep
from repro.core.engine import STAT_NAMES, SimConfig
from repro.core.traces import all_workload_names, build_workload

torch.set_num_threads(1)

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_engine_sweep.json")
# the reference's built-in rows, in registration order (a test of the
# reference may register more rows in its process-wide registry)
BUILTIN_ROWS = (*ref_schemes.BASE_SCHEMES, "cram-nollp",
                *ref_schemes.LCT_SENSITIVITY)


@pytest.fixture(scope="module")
def pin():
    return json.loads(FIXTURE.read_text())


def test_fixture_records_its_recipe(pin):
    assert pin["rows"] == list(BUILTIN_ROWS)
    assert pin["workloads"] == list(all_workload_names())
    assert pin["stat_names"] == list(STAT_NAMES)
    assert (pin["n_events"], pin["seed"], pin["config"]) == (
        20_000, 0, "SimConfig()")
    assert np.asarray(pin["stats"]).shape == (
        len(pin["rows"]), len(pin["workloads"]), len(STAT_NAMES))
    recipe = "\n".join(pin["recipe"])
    assert "N_EVENTS, SEED = 20_000, 0" in recipe
    assert "sweep(ROWS, *stacked, SimConfig(), shard=False)" in recipe


@pytest.mark.parametrize("name", ["libq", "pr_twi", "mix3", "mcf17"])
def test_reference_sweep_reproduces_the_fixture(pin, name):
    """The reference's sweep of one workload, all 10 rows, equals the
    fixture's column for it on every counter."""
    wl = build_workload(name, pin["n_events"], pin["seed"])
    stacked = [np.stack([wl[i]]) for i in range(1, 6)]
    stats = np.asarray(ref_sweep(pin["rows"], *stacked, SimConfig(),
                                 shard=False))
    wi = pin["workloads"].index(name)
    np.testing.assert_array_equal(stats[:, 0],
                                  np.asarray(pin["stats"])[:, wi])
