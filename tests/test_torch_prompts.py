"""The port's prompt surface, module by module, against forge_tpu (CPU, f32).

`_select_cond` picks a prompt-editing cond's row from the host σ: held
against forge_tpu's (jnp.searchsorted on the traced σ) at every σ of 20
Karras steps and the midpoints second-order samplers call at, on DPM2's
schedule with the penultimate σ discarded, on an img2img tail and on a hires
pass with more steps than the per-step array has rows (JAX clamps the
index; the port clamps the same way). The multi-branch CFG function (AND
weights, regional masks, `cfg_rescale` on both paths, the CFG++ pair under
branches, per-step conds under branches) runs a stub model on seeded inputs
through both packages: ≤ 1e-6 of the largest value. `_region_mult_map` is
bit-equal to forge_tpu's (Pillow's BILINEAR for masks). `get_schedule` and
`split_composable` agree on the reference's prompt cases. The cond cache's
key, hit and size, the `emphasis` option, and the loader's device.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import make_sd15_checkpoint  # noqa: E402

STEPS = 20


def _pred():
    from forge_tpu_torch.sampling.prediction import DiscretePrediction

    return DiscretePrediction()


def _schedules():
    """name → (σ table the pass runs, rows of the per-step array)."""
    from forge_tpu_torch.sampling.schedules import get_sigmas

    pred = _pred()
    full = get_sigmas("karras", STEPS, pred)
    t_enc = min(int(0.6 * STEPS), STEPS - 1)
    hires_steps = 30  # hr_second_pass_steps above the request's steps
    hires = get_sigmas("karras", hires_steps, pred)
    return {
        "karras 20": (full, STEPS),
        "dpm2 discarded penultimate": (get_sigmas("karras", STEPS, pred,
                                                  discard_next_to_last=True), STEPS),
        "img2img tail": (full[STEPS - t_enc - 1:], STEPS),
        "hires past the rows (clamp)": (hires[hires_steps - 21 - 1:], STEPS),
    }


@pytest.mark.parametrize("name", list(_schedules()))
def test_select_cond_matches_forge_tpu(name):
    from forge_tpu.sampling import cfg as jcfg
    from forge_tpu_torch.sampling import cfg as tcfg

    sigmas, rows = _schedules()[name]
    marks = np.arange(rows, dtype=np.float32)[:, None, None] * np.ones((1, 1, 3), np.float32)
    jcond = {"context": jcfg.PerStep(jnp.asarray(marks)), "y": jnp.ones((1, 2))}
    tcond = {"context": tcfg.PerStep(torch.from_numpy(marks)), "y": torch.ones((1, 2))}
    s32 = np.asarray(sigmas, np.float32)
    probes = list(s32[:-1]) + [float(np.sqrt(a * b)) for a, b in zip(s32[:-2], s32[1:-1])]
    probes += [float(s32[0]) * 1.5, float(s32[-2]) * 0.5]  # past each end of the table
    picked = []
    for sigma in probes:
        want = float(jcfg._select_cond(jcond, jnp.float32(sigma), sigmas)["context"][0, 0])
        got = tcfg._select_cond(tcond, sigma, sigmas)
        assert float(got["context"][0, 0]) == want, (name, sigma)
        assert got["y"] is tcond["y"]
        picked.append(want)
    if "clamp" in name:  # 21 σ intervals over a 20-row array: the last rows clamp
        assert len(sigmas) - 1 > rows and max(picked) == rows - 1
    # without a σ table every value is row 0
    assert float(tcfg._select_cond(tcond, probes[3], None)["context"][0, 0]) == 0.0


def _stub_model(jax_side: bool):
    """A deterministic nonlinear 'denoiser' of (x, σ, cond) in either layout,
    from products and sums only (no reduction, whose order would differ
    between the libraries): each batch row mixes x with its own cond."""
    def apply(x, sigma, cond):
        s = cond["context"][:, 0, 0][:, None, None, None]
        y = cond["y"][:, 0][:, None, None, None]
        return x * (1.0 + 0.5 * s) + (0.1 * float(sigma)) * y - 0.05 * x * x

    return apply


CFG_CASES = {  # name: (cfg, weights or None, masks?, branches, rescale, return_uncond, per-step)
    "single, rescale 0.7": (7.0, None, False, 0, 0.7, False, False),
    "single, per-step conds": (7.0, None, False, 0, 0.0, False, True),
    "AND weights": (7.0, [1.0, 0.8, 0.5], False, 2, 0.0, False, False),
    "AND, rescale 0.5": (7.0, [1.0, 0.8], False, 1, 0.5, False, False),
    "AND at CFG 1 (no uncond)": (1.0, [1.0, 0.6], False, 1, 0.0, False, False),
    "regional masks": (7.0, [1.0, 1.0, 0.7], True, 2, 0.0, False, False),
    "regional, rescale 0.7": (7.0, [1.0, 0.9, 0.7], True, 2, 0.7, False, False),
    "CFG++ pair under branches": (7.0 / 12.5, [1.0, 0.8], False, 1, 0.0, True, False),
    "CFG++ pair, regional": (7.0 / 12.5, [1.0, 0.8], True, 1, 0.0, True, False),
    "AND with per-step conds": (7.0, [1.0, 0.8], False, 1, 0.0, False, True),
}


@pytest.mark.parametrize("case", list(CFG_CASES))
def test_multi_branch_cfg_matches_forge_tpu(case):
    from forge_tpu.sampling import cfg as jcfg
    from forge_tpu_torch.sampling import cfg as tcfg

    cfg, weights, masked, n_br, rescale, pair, per_step = CFG_CASES[case]
    rng = np.random.default_rng(7)
    b, c, h, w = 2, 4, 8, 6
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    sigmas = np.asarray([14.6, 6.0, 2.5, 0.9, 0.0], np.float32)

    def cond_np():
        shape = (len(sigmas) - 1, b, 5, 3) if per_step else (b, 5, 3)
        return {"context": rng.standard_normal(shape).astype(np.float32),
                "y": rng.standard_normal((b, 2)).astype(np.float32)}

    conds = [cond_np() for _ in range(1 + n_br)]
    uncond = None if cfg == 1.0 else cond_np()
    maps = None
    if masked:
        maps = [None] + [rng.random((h, w)).astype(np.float32) for _ in range(n_br)]

    def side(cfg_mod, to, wrap_mask):
        def conv(d):
            if d is None:
                return None
            out = {}
            for k, v in d.items():
                v = to(v)
                out[k] = cfg_mod.PerStep(v) if (per_step and k == "context") else v
            if per_step:  # y too, so every key goes through the selection
                out["y"] = cfg_mod.PerStep(to(np.stack([d["y"]] * (len(sigmas) - 1))))
            return out

        ms = None if maps is None else [None if m is None else wrap_mask(m) for m in maps]
        return cfg_mod.make_cfg_model_fn(
            _stub_model(cfg_mod is jcfg), conv(conds[0]), conv(uncond), cfg,
            cfg_rescale=rescale, sigmas_np=sigmas,
            cond_branches=[conv(cd) for cd in conds[1:]] or None, branch_weights=weights,
            branch_masks=ms, return_uncond=pair)

    jfn = side(jcfg, jnp.asarray, lambda m: jnp.asarray(m)[..., None])
    tfn = side(tcfg, torch.from_numpy, lambda m: torch.from_numpy(m)[None, None])
    for sigma in (14.6, 2.5, 1.7):
        want = jfn(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.float32(sigma))
        got = tfn(torch.from_numpy(x), sigma)
        wants = want if pair else (want,)
        gots = got if pair else (got,)
        assert len(wants) == len(gots)
        for wv, gv in zip(wants, gots):
            wv = np.asarray(wv).transpose(0, 3, 1, 2)
            gv = gv.numpy()
            assert gv.shape == wv.shape
            assert np.abs(gv - wv).max() <= 1e-6 * np.abs(wv).max(), (case, sigma)


def test_rescale_moves_the_result_and_needs_the_uncond():
    from forge_tpu_torch.sampling import cfg as tcfg

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32))
    cond = {"context": torch.from_numpy(rng.standard_normal((1, 5, 3)).astype(np.float32)),
            "y": torch.ones((1, 2))}
    uncond = {"context": torch.zeros((1, 5, 3)), "y": torch.zeros((1, 2))}
    stub = _stub_model(False)
    plain = tcfg.make_cfg_model_fn(stub, cond, uncond, 7.0)(x, 3.0)
    rescaled = tcfg.make_cfg_model_fn(stub, cond, uncond, 7.0, cfg_rescale=0.7)(x, 3.0)
    assert not torch.equal(plain, rescaled)
    # no uncond (CFG 1): nothing to rescale against
    alone = tcfg.make_cfg_model_fn(stub, cond, None, 1.0, cfg_rescale=0.7)(x, 3.0)
    assert torch.equal(alone, stub(x, 3.0, cond))


AREAS = [
    {"area": (0.0, 0.0, 0.5, 1.0), "feather": 8},
    {"area": (0.5, 0.0, 0.5, 1.0), "feather": 8},
    {"area": (0.25, 0.1, 0.4, 0.6), "feather": 3},
    {"area": (0.0, 0.0, 1.0, 1.0)},
    {"area": (0.9, 0.9, 0.5, 0.5), "feather": 20},
    {},
]


@pytest.mark.parametrize("lh, lw", [(8, 8), (16, 24), (128, 128)])
def test_region_mult_map_matches_forge_tpu(lh, lw):
    from forge_tpu.pipeline.processing import _region_mult_map as jmap
    from forge_tpu_torch.pipeline.processing import _region_mult_map as tmap

    rng = np.random.default_rng(lh + lw)
    masks = [
        {"mask": rng.random((64, 64)).astype(np.float32)},
        {"mask": (rng.random((100, 37)) * 255).astype(np.float32), "mask_strength": 0.6},
        {"mask": rng.random((5, 9, 3)).astype(np.float32), "mask_strength": 1.3},
        {"mask": np.ones((1024, 1024), np.float32)},
    ]
    for spec in AREAS + masks:
        want = jmap(spec, lh, lw)
        got = tmap(spec, lh, lw)
        assert got.dtype == want.dtype == np.float32 and got.shape == (lh, lw)
        assert np.array_equal(got, want), spec.keys()


PROMPTS = [
    "plain prompt", "a [cat:dog:0.5] x", "[from:to:3]", "a [cat:dog:12] on a mat",
    "a [hat:] cat", "a [hat::0.25] cat", "[cat|dog|fox] in snow",
    "[a:[b:c:0.7]:0.3] d", "(a [cat:dog:0.5]:1.2), [bright]", "a \\[literal\\] bracket",
    "a photo of a [cat:dog:0.5] wearing forgeemb", "a cat AND a red hat :0.8",
    "x AND y AND z:1.5", "a AND b :-0.4 AND c", "ANDROID robot", "a cat AND [hat:cap:0.5]:0.7",
    "BREAK alone", "",
]


@pytest.mark.parametrize("steps", [1, 5, 20, 37])
def test_schedule_and_composable_match_forge_tpu(steps):
    from forge_tpu.text import schedule as jsched
    from forge_tpu_torch.text import schedule as tsched

    for prompt in PROMPTS:
        assert tsched.get_schedule(prompt, steps) == jsched.get_schedule(prompt, steps), prompt
        assert tsched.split_composable(prompt) == jsched.split_composable(prompt), prompt


def test_scheduled_cond_stacks_each_step_once():
    """`[cat:dog:0.5]` over 5 steps: two encodes, a [5, B, L, D] PerStep whose
    rows are the variants, in the order of the schedule."""
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.sampling.cfg import PerStep

    eng = load_engine(make_sd15_checkpoint(0), device="cpu")
    p = proc.Processing(steps=5, width=64, height=64)
    cond, branches, weights = proc._build_scheduled_cond(eng, p, ["a [cat:dog:0.5] x"])
    assert branches is None and weights is None
    ctx = cond["context"]
    assert isinstance(ctx, PerStep) and tuple(ctx.array.shape)[:2] == (5, 1)
    cat = eng.get_learned_conditioning(["a cat x"], 64, 64)["context"]
    dog = eng.get_learned_conditioning(["a dog x"], 64, 64)["context"]
    for row, want in zip(ctx.array, (cat, cat, dog, dog, dog)):
        assert torch.equal(row, want)
    cond, branches, weights = proc._build_scheduled_cond(eng, p, ["a cat AND a hat :0.8"])
    assert len(branches) == 1 and weights == [1.0, 0.8]
    only, none, _ = proc._build_scheduled_cond(eng, p, ["a cat AND a hat :0.8"], allow_and=False)
    assert none is None and not torch.equal(only["context"], cond["context"])


def test_cond_cache_key_hit_and_size(monkeypatch):
    """The cache keys on the engine, prompts, steps, size, clip skip, chunks,
    the emphasis mode and the embeddings' version; a hit hands back the
    same tensors; four entries at most, least recently used out first."""
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.runtime.options import opts

    eng = load_engine(make_sd15_checkpoint(0), device="cpu")
    calls = []
    real = eng.get_learned_conditioning
    monkeypatch.setattr(eng, "get_learned_conditioning",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))

    def cond(prompt, **fields):
        p = proc.Processing(**dict(dict(prompt=prompt, negative_prompt="blurry", steps=4,
                                        width=64, height=64), **fields))
        return proc._conditioning(eng, p, {})

    first = cond("a cat")
    assert len(calls) == 2
    again = cond("a cat")
    assert len(calls) == 2 and again[0]["context"] is first[0]["context"]
    for fields in (dict(steps=5), dict(width=72), dict(height=72), dict(clip_skip=2)):
        cond("a cat", **fields)
    assert len(calls) == 10 and len(eng._cond_cache) == 4
    cond("a cat")  # evicted: the oldest of five
    assert len(calls) == 12
    with opts.override({"emphasis": "None"}):
        cond("a cat")
    assert len(calls) == 14
    eng.embedding_db.register("zzz", np.zeros((1, 64), np.float32))
    cond("a cat")
    assert len(calls) == 16  # a new embedding: the version moved
    regional = dict(regional_prompts=[{"prompt": "a hat", "area": (0, 0, 0.5, 1)}])
    cond("a dog", **regional)
    cond("a dog", **regional)
    assert len(calls) == 16 + 2 * 3  # regional requests are not cached


def test_emphasis_option_reaches_the_encoder():
    """The port encodes under the `emphasis` option; forge_tpu registers the
    option and its text engine keeps "Original" whatever it says (the tiny
    SDXL: its positional embeddings keep the renormalisation well posed)."""
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.runtime.options import opts
    from test_torch_sdxl import _jax_engine, _port_engine, _tiny_sdxl_checkpoint

    prompt, bare = ["a (cat:1.5) on a [mat]"], ["a cat on a mat"]
    sd = _tiny_sdxl_checkpoint()
    eng, jeng = _port_engine(sd), _jax_engine(sd)
    original = eng.get_learned_conditioning(prompt, 64, 64)["context"]
    with opts.override({"emphasis": "None"}):
        ignored = eng.get_learned_conditioning(prompt, 64, 64)["context"]
    assert not torch.equal(original, ignored)
    assert torch.equal(ignored, eng.get_learned_conditioning(bare, 64, 64)["context"])
    jwant = np.asarray(jeng.get_learned_conditioning(prompt, 64, 64)["context"])
    with jopts.override({"emphasis": "None"}):
        jgot = np.asarray(jeng.get_learned_conditioning(prompt, 64, 64)["context"])
    assert np.array_equal(jwant, jgot)
    assert np.abs(original.numpy() - jwant).max() <= 1e-5 * np.abs(jwant).max()


def test_load_checkpoint_parts_without_a_device_raises():
    """Named no device, the loader takes the card and raises where there is
    none; the CPU is taken when asked for."""
    from forge_tpu_torch.core.loader import load_checkpoint_parts

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the loader takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint_parts(make_sd15_checkpoint(0))
    loaded = load_checkpoint_parts(make_sd15_checkpoint(0), device="cpu")
    assert loaded.unet["out"]["2"]["weight"].device.type == "cpu"
    assert loaded.unet["out"]["2"]["weight"].dtype == torch.float32
