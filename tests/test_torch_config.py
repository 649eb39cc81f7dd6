"""The port's config copy agrees with the JAX package's, preset for preset, and
reads its JSON unchanged."""

import pytest

from vaegan_tpu import config as jc
from vaegan_tpu_torch import config as tc

PRESETS = ["notebook", "notebook_vae", "vae_96", "gan_only", "vaegan_paper",
           "vaegan_infer", "vaegan_256_dp"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name):
    assert tc.preset(name).to_dict() == jc.preset(name).to_dict()


@pytest.mark.parametrize("name", ["notebook", "vaegan_paper"])
def test_json_written_by_jax_round_trips(tmp_path, name):
    path = tmp_path / "cfg.json"
    jc.preset(name).to_json(str(path))
    cfg = tc.Config.from_json(str(path))
    assert cfg == tc.preset(name)
    assert cfg.to_json() == jc.preset(name).to_json()


@pytest.mark.parametrize("value,mode", [(True, "all"), (False, "off"), (None, "off"),
                                        ("losses", "losses")])
def test_pallas_mode(value, mode):
    assert tc.pallas_mode(value) == mode == jc.pallas_mode(value)


def test_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        tc.preset("no-such-preset")
    with pytest.raises(ValueError):
        tc.TrainConfig(use_pallas="sometimes")
    with pytest.raises(ValueError):
        tc.Config(data=tc.DataConfig(image_size=30))   # not divisible by 2**depth
