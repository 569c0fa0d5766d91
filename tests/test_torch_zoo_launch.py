"""Port parity for the serve launcher on the model zoo's families: the
reference's launcher and the port's (on the reference's weights) at the
smoke size of olmoe-1b-7b (moe), zamba2-2.7b (hybrid: the serve tier
reads the shared block's cache), llama-3.2-vision-90b (vlm, no image
embeddings, as the reference's launcher runs it) and mamba2-130m (ssm: no
attention cache, so no serve tier).

The reports carry the same keys, the serve tier's counts and the traffic
rows are equal (they depend only on shapes and on which page groups
pack), and so are the greedy samples."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch import serve as r_serve
from repro.models import build as r_build
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as t_serve

torch.set_num_threads(1)

ARGV = ["--batch", "2", "--prompt-len", "12", "--gen", "6"]


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_2_7b",
                                  "llama_3_2_vision_90b", "mamba2_130m"])
def test_launcher_report_matches_reference(capsys, arch):
    argv = ["--arch", arch] + ARGV
    ref = r_serve.main(argv)
    params, _ = r_build(r_configs.get_smoke(arch)).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    got = t_serve.main(argv + ["--device", "cpu"],
                       params=params_from_jax(tree))
    capsys.readouterr()
    assert got.keys() == ref.keys()
    assert got["sample"] == ref["sample"]
    assert got["traffic"] == ref["traffic"]
    assert got["tokens_per_s"] > 0 and got["prefill_tokens_per_s"] > 0
    if arch == "mamba2_130m":
        assert got["serve_tier"] is None and ref["serve_tier"] is None
        assert got["traffic"] == {}
        return
    st_r, st_t = ref["serve_tier"], got["serve_tier"]
    assert st_t.keys() == st_r.keys()
    assert st_t["admitted"] == st_t["retired"] == 2
    for key, want in st_r.items():
        assert st_t[key] == want, key
    assert got["traffic"]["kv"]


def test_serve_step_passes_image_embeds_to_the_vlm_only():
    """`make_serve_step` hands `image_embeds` to a vlm's decode step (the
    reference's launch/steps.py:77-88), and a dense model's step ignores
    it."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build

    rng = np.random.default_rng(4)
    for arch in ("llama_3_2_vision_90b", "qwen3_8b"):
        cfg = configs.get_smoke(arch)
        params = build(cfg, device="cpu", seed=1).state_dict()
        if cfg.family == "vlm":         # open the cross block's gate
            params["blocks.4.gate"] = torch.tensor(0.7)
        model = build(cfg, device="cpu", params=params)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)))
        img = torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
        with_img = model.decode_step(tok, model.init_cache(2, 4), 0,
                                     image_embeds=img)
        without = model.decode_step(tok, model.init_cache(2, 4), 0)
        got, _ = make_serve_step(model)(tok, model.init_cache(2, 4), 0,
                                        image_embeds=img)
        want = with_img if cfg.family == "vlm" else without
        assert torch.equal(got[:, 0], torch.argmax(want, -1).int())
        if cfg.family == "vlm":
            assert not torch.allclose(with_img, without)
