"""Port parity for the training launcher and its pure-numpy parts: the
synthetic data pipeline, the straggler detector, the reference's initial
weights drawn without JAX, and the end-to-end recipe of
`tests/test_e2e.py` (fault at step 8, restart from a committed
checkpoint) on both launchers, per-step losses within 1e-4."""

import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLM as RSyntheticLM
from repro.launch import train as r_train
from repro.models import build as r_build
from repro.runtime.straggler import StragglerDetector as RDetector
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticLM, make_batch_iterator
from repro_torch.launch import train as t_train
from repro_torch.models import init_lm_reference
from repro_torch.models.threefry import key, normal, split
from repro_torch.runtime.straggler import StragglerDetector

torch.set_num_threads(1)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_synthetic_batches_equal_reference(family):
    kw = dict(vocab=1000, seq_len=24, global_batch=6, seed=5, family=family,
              d_model=16, n_image_tokens=3 if family == "vlm" else 0)
    ref, ours = RSyntheticLM(RDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 7):
        for sl in (None, slice(2, 5)):
            a, b = ref.batch(step, sl), ours.batch(step, sl)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), (step, sl, k)
    it = make_batch_iterator(DataConfig(**kw), start_step=7,
                             host_slice=slice(2, 5))
    step, batch = next(it)
    it.close()
    assert step == 7
    assert np.array_equal(batch["tokens"], ref.batch(7, slice(2, 5))["tokens"])


def test_straggler_flags_equal_reference():
    rng = np.random.default_rng(0)
    dets = [RDetector(n_hosts=4, min_samples=4),
            StragglerDetector(n_hosts=4, min_samples=4)]
    flags = [[], []]
    for step in range(40):
        d = rng.normal(1.0, 0.01, 4)
        if step > 10:
            d[2] *= 2.5
        for det, out in zip(dets, flags):
            out.append(det.record(step, d))
    assert flags[0] == flags[1]
    assert any(2 in f for f in flags[1])
    assert dets[0].persistent_stragglers() == dets[1].persistent_stragglers()


def test_threefry_draws_equal_jax_random():
    k_r, k_t = jax.random.key(3), key(3)
    for _ in range(3):
        k_r, sub_r = jax.random.split(k_r)
        k_t, sub_t = split(k_t)
        assert tuple(int(x) for x in jax.random.key_data(sub_r)) == sub_t
    want = np.asarray(jax.random.normal(sub_r, (70, 33)))
    got = normal(sub_t, (70, 33)).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3 and (ulps == 0).mean() > 0.95


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_2_7b",
                                  "llama_3_2_vision_90b"])
def test_reference_init_equals_reference(arch):
    tree = r_build(r_configs.get_smoke(arch)).init(jax.random.key(3))[0]
    want = params_from_jax(jax.tree.map(np.asarray, tree))
    got = init_lm_reference(t_configs.get_smoke(arch), 3, "cpu")
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=2.5e-7,
                                   msg=k)


def test_e2e_recipe_matches_reference_launcher(tmp_path):
    argv = ["--preset", "lm2m", "--steps", "14", "--batch", "2",
            "--ckpt-every", "5", "--inject-fault", "8", "--seed", "3"]
    ref = r_train.main(argv + ["--ckpt-dir", str(tmp_path / "r"),
                               "--json-out", str(tmp_path / "r.json")])
    ours = t_train.main(argv + ["--device", "cpu",
                                "--json-out", str(tmp_path / "t.json")])
    assert ours.keys() == ref.keys()
    assert ours["steps"] == ref["steps"] == 14
    assert ours["restarts"] == ref["restarts"] == 1
    losses_r = json.loads((tmp_path / "r.json").read_text())["losses"]
    losses_t = json.loads((tmp_path / "t.json").read_text())["losses"]
    # the port keeps one loss a step; the reference keeps the steps from
    # where its restart began (step 0, or 5 if its save of step 5 was
    # committed before it looked)
    assert len(losses_t) == 14 and len(losses_r) in (9, 14)
    np.testing.assert_allclose(losses_t[-len(losses_r):], losses_r,
                               rtol=0, atol=1e-4)


def test_train_launcher_defaults_to_the_card():
    assert t_train.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--preset", "lm2m", "--steps", "1"])
