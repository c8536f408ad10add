"""The port's options registry and the options its engine reads (CPU).

Only the options the port reads are registered, with forge_tpu's defaults;
reading, setting or overriding any other key raises KeyError.
`disable_nan_check` lets a NaN latent through `decode_finish`; `vae_dtype`
"float32" on a bf16 engine decodes within 1e-5 of an f32 engine's decode of
the same latent (the tiny SD1.5 checkpoint of tests/fixtures.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_sd15_checkpoint  # noqa: E402

KEYS = ("eta_ancestral", "eta_ddim", "s_churn", "s_noise", "eta_noise_seed_delta",
        "CLIP_stop_at_last_layers", "initial_noise_multiplier", "beta_dist_alpha",
        "beta_dist_beta", "disable_nan_check", "vae_dtype", "emphasis", "s_min_uncond",
        "save_write_params_txt", "add_model_name_to_info",
        "add_model_hash_to_info", "add_version_to_infotext", "infotext_styles")


def test_registered_keys_carry_the_reference_defaults():
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.runtime.options import opts

    assert set(opts._registry) == set(KEYS)
    for key in KEYS:  # the registered defaults (tests/conftest.py sets forge_tpu's params.txt off)
        assert opts._registry[key].default == jopts._registry[key].default, key
        assert opts._registry[key].choices == jopts._registry[key].choices, key


def test_unregistered_key_raises():
    from forge_tpu_torch.runtime.options import opts

    for key in ("textual_inversion_add_hashes_to_infotext", "s_min_uncond_all", "cfg_rescale",
                "no_such_option"):
        with pytest.raises(KeyError, match="not ported"):
            opts.set(key, 1.0)
        with pytest.raises(KeyError, match="not ported"):
            opts.get(key)
        with pytest.raises(KeyError, match="not ported"):
            with opts.override({key: 1.0}):
                pass
    assert "textual_inversion_add_hashes_to_infotext" not in opts._values
    assert "s_min_uncond_all" not in opts._values


def test_set_and_override():
    from forge_tpu_torch.runtime.options import opts

    assert opts.get("s_noise") == 1.0
    try:
        opts.set("s_noise", 0.9)
        assert opts.get("s_noise") == 0.9
        with opts.override({"s_noise": 0.5}):
            assert opts.get("s_noise") == 0.5
        assert opts.get("s_noise") == 0.9
    finally:
        opts.set("s_noise", 1.0)


def test_option_defaults_fill_the_request():
    """Fields left at their defaults take the options' values; an explicit
    value wins (the reference's `_apply_option_defaults`)."""
    from forge_tpu_torch.pipeline.processing import Processing, _apply_option_defaults
    from forge_tpu_torch.runtime.options import opts

    values = {"s_churn": 0.3, "s_noise": 0.9, "eta_ancestral": 0.6, "eta_ddim": 0.2,
              "eta_noise_seed_delta": 31337, "CLIP_stop_at_last_layers": 2,
              "initial_noise_multiplier": 0.8}
    with opts.override(values):
        p = Processing()
        _apply_option_defaults(p)
        q = Processing(eta=0.5, s_noise=0.7, init_images=[np.zeros((8, 8, 3), np.uint8)])
        _apply_option_defaults(q)
    assert (p.s_churn, p.s_noise, p.eta, p.eta_ddim, p.eta_noise_seed_delta, p.clip_skip,
            p.initial_noise_multiplier) == (0.3, 0.9, 0.6, 0.2, 31337, 2, 1.0)
    assert (q.eta, q.s_noise, q.initial_noise_multiplier) == (0.5, 0.7, 0.8)


def test_disable_nan_check_lets_a_nan_latent_through():
    from forge_tpu_torch.pipeline.engine import NansException, load_engine
    from forge_tpu_torch.runtime.options import opts

    eng = load_engine(make_sd15_checkpoint(0), device="cpu")
    latent = torch.zeros((1, 4, 8, 8))
    latent[0, 0, 0, 0] = float("nan")
    with pytest.raises(NansException, match="UNet"):
        eng.decode_finish(eng.decode_dispatch(latent))
    with opts.override({"disable_nan_check": True}):
        images = eng.decode_finish(eng.decode_dispatch(latent))
    assert images.shape == (1, 64, 64, 3) and images.dtype == np.uint8


def test_vae_dtype_float32_on_a_bf16_engine():
    """The VAE's weights are loaded (cast once) in float32 at engine
    construction; the decode of a bf16 engine then equals an f32 engine's."""
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.runtime.options import opts

    sd = make_sd15_checkpoint(0)
    latent = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 8, 8))
                              .astype(np.float32))
    want = load_engine(sd, device="cpu").decode_first_stage(latent)
    with opts.override({"vae_dtype": "float32"}):
        eng = load_engine(sd, device="cpu", dtype=torch.bfloat16)
    leaves = [eng.loaded.vae["decoder"]["conv_in"]["weight"], eng.loaded.vae["encoder"]["conv_in"]["weight"]]
    assert eng.vae_dtype == torch.float32 and all(t.dtype == torch.float32 for t in leaves)
    assert eng.loaded.unet["out"]["2"]["weight"].dtype == torch.bfloat16
    got = eng.decode_first_stage(latent)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    bf16 = load_engine(sd, device="cpu", dtype=torch.bfloat16)  # "auto": the compute dtype
    assert bf16.vae_dtype == torch.bfloat16
    assert (bf16.decode_first_stage(latent) - want).abs().max() > 1e-5 * want.abs().max()
