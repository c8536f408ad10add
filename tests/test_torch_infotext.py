"""The port's infotext and styles against forge_tpu (CPU).

`create_infotext` is string-equal to forge_tpu's over txt2img, hires,
refiner, img2img and inpainting, Lora-hash, NGMS, tiled, sampler-option,
variation-seed and Flux requests, each recorded by both packages'
`_record_generation_params`; `parse_generation_parameters` and
`infotext_to_processing_args` give equal dicts on those and on hand-written
infotexts; `write_params_txt` writes the same file. The styles: apply and
extract on the reference's cases, and a `StyleDatabase` CSV (legacy `text`
column, a glob of files) loaded, applied, extracted and saved by both.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import make_sd15_checkpoint, make_tiny_engine  # noqa: E402


class _Engine:
    def __init__(self, family="sd15"):
        self.family = family
        self.checkpoint_name = "tiny-sd15.safetensors"
        self.checkpoint_hash = "abc123def0"


INIT = [np.zeros((64, 64, 3), np.uint8)]
MASK = np.ones((64, 64), np.float32)
REQUESTS = {  # name: (Processing fields, extra keys set as a stage would, engine family)
    "txt2img": (dict(prompt="a cat", steps=25, sampler_name="DPM++ 2M", scheduler="karras",
                     cfg_scale=6.5, width=640, height=512, clip_skip=2,
                     eta_noise_seed_delta=31337, negative_prompt="ugly, bad anatomy"), {}, "sd15"),
    "automatic schedule, multi-line prompt": (dict(prompt="a cat\non two lines: yes",
                                                   sampler_name="Euler a"), {}, "sd15"),
    "hires": (dict(prompt="a castle", enable_hr=True, hr_scale=2.0, hr_second_pass_steps=12,
                   hr_upscaler="Lanczos", hr_denoising_strength=0.55, hr_resize_x=1216,
                   hr_resize_y=832, hr_prompt="a castle, detailed", hr_negative_prompt="blur",
                   hr_cfg_scale=5.0, hr_checkpoint_name="other"), {}, "sdxl"),
    "refiner": (dict(prompt="a fox", refiner_checkpoint="sdxl_refiner", refiner_switch_at=0.8,
                     sampler_name="DPM++ 2M", scheduler="karras"), {}, "sdxl"),
    "img2img": (dict(prompt="a fox", init_images=INIT, denoising_strength=0.6,
                     initial_noise_multiplier=0.9), {}, "sd15"),
    "inpaint": (dict(prompt="a fox", init_images=INIT, inpaint_mask=MASK, mask_blur=4.0,
                     inpainting_mask_invert=True, inpaint_full_res=True,
                     inpaint_full_res_padding=48, inpainting_fill="latent_noise"), {}, "sd15"),
    "inpaint, no blur": (dict(prompt="a fox", init_images=INIT, inpaint_mask=MASK, mask_blur=0.0,
                              inpainting_fill="fill"), {}, "sd15"),
    "lora hashes": (dict(prompt="a cat <lora:style:0.8>"),
                    {"Lora hashes": "style: 1a2b3c4d5e, detail: f6e5d4c3b2"}, "sd15"),
    "ngms": (dict(prompt="a cat", sampler_name="DPM++ 2M", scheduler="karras"),
             {"NGMS": 3.0}, "sd15"),
    "tiled": (dict(prompt="a cat", tiled_diffusion={"tile": 96, "overlap": 16}),
              {"Tiled Diffusion": "MultiDiffusion tile 96"}, "sdxl"),
    "sampler options": (dict(prompt="a cat", sampler_name="DPM2 a", eta=0.7, s_churn=0.2,
                             s_noise=0.98, scheduler="exponential"), {}, "sd15"),
    "ddim eta": (dict(prompt="a cat", sampler_name="DDIM", eta_ddim=0.5), {}, "sd15"),
    "discarded sigma": (dict(prompt="a cat", sampler_name="DPM2", scheduler="karras"), {}, "sd15"),
    "variation seed": (dict(prompt="a cat", subseed=77, subseed_strength=0.3,
                            seed_resize_from_w=512, seed_resize_from_h=768), {}, "sd15"),
    "flux": (dict(prompt="a cat", sampler_name="Euler", scheduler="simple", cfg_scale=1.0,
                  distilled_cfg_scale=3.5), {}, "flux"),
    "named model": (dict(prompt="a cat", sd_model_name="mine", sd_model_hash="0123456789"), {},
                    "sd15"),
}


def _pair(name):
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.pipeline import processing as tproc

    fields, extra, family = REQUESTS[name]
    out = []
    for proc in (jproc, tproc):
        p = proc.Processing(**fields)
        proc._record_generation_params(_Engine(family), p)
        p.extra_generation_params.update(extra)
        out.append(p)
    return out


@pytest.mark.parametrize("name", list(REQUESTS))
def test_create_infotext_matches_forge_tpu(name):
    from forge_tpu.pipeline import infotext as jinfo
    from forge_tpu_torch.pipeline import infotext as tinfo

    jp, tp = _pair(name)
    assert tp.extra_generation_params == jp.extra_generation_params
    for seed, subseed in ((1, 0), (4294967295, 77)):
        want = jinfo.create_infotext(jp, seed, subseed)
        got = tinfo.create_infotext(tp, seed, subseed)
        assert got == want
        assert tinfo.parse_generation_parameters(got) == jinfo.parse_generation_parameters(want)
        assert tinfo.infotext_to_processing_args(got) == jinfo.infotext_to_processing_args(want)
    assert "Version: forge-tpu 0.1.0" in got


HAND_WRITTEN = [
    "",
    "a cat\nSteps: 20, Sampler: Euler a, CFG scale: 7, Seed: 1",
    "only a prompt, no params",
    'a "quoted" cat\nNegative prompt: dog\nmore negative\nSteps: 30, Sampler: DPM++ 2M, '
    'Schedule type: Karras, CFG scale: 5.5, Seed: 9, Size: 1024x768, Lora hashes: "a: 1, b: 2", '
    "Hires upscale: 2, Hires resize: 2048x1536, Denoising strength: 0.45, Refiner: ref, "
    "Mask mode: Inpaint not masked, Inpaint area: Only masked, Masked content: latent noise",
    "x\nSteps: 5, Sampler: UniPC, CFG scale: 3, Seed: 2, Schedule type: Align Your Steps GITS, "
    "Clip skip: 2, Tiling: True, Face restoration: CodeFormer, Seed resize from: 64x96",
    "x\nSteps: five, Sampler: Euler, CFG scale: high, Seed: -, Size: axb",
]


@pytest.mark.parametrize("index", range(len(HAND_WRITTEN)))
def test_parse_matches_forge_tpu(index):
    from forge_tpu.pipeline import infotext as jinfo
    from forge_tpu_torch.pipeline import infotext as tinfo

    text = HAND_WRITTEN[index]
    assert tinfo.parse_generation_parameters(text) == jinfo.parse_generation_parameters(text)
    assert tinfo.infotext_to_processing_args(text) == jinfo.infotext_to_processing_args(text)
    for value in (text, "a, b", "k: v", "line\nbreak", 3.5, "plain"):
        assert tinfo.quote(value) == jinfo.quote(value)
        assert tinfo.unquote(str(tinfo.quote(value))) == jinfo.unquote(str(jinfo.quote(value)))


def test_params_txt_and_infotext_options(tmp_path):
    from forge_tpu.pipeline import infotext as jinfo
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import infotext as tinfo
    from forge_tpu_torch.runtime.options import opts

    jp, tp = _pair("txt2img")
    keys = {"add_model_name_to_info": False, "add_model_hash_to_info": False,
            "add_version_to_infotext": False}
    with jopts.override(keys), opts.override(keys):
        want, got = jinfo.create_infotext(jp, 1, 0), tinfo.create_infotext(tp, 1, 0)
    assert got == want and "Model" not in got and "Version" not in got
    jinfo.write_params_txt(want, str(tmp_path / "j.txt"))
    tinfo.write_params_txt(got, str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    tinfo.write_params_txt(got, str(tmp_path / "missing" / "t.txt"))  # an unwritable path: quiet


def test_lora_hashes_recorded_as_forge_tpu_records_them(tmp_path):
    """Both packages' `activate` hash the LoRA files a prompt names into the
    "Lora hashes" key."""
    from forge_tpu.pipeline import extra_networks as jnet
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.pipeline import extra_networks as tnet
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.pipeline.engine import load_engine

    for name, seed in (("style", 1), ("detail", 2)):
        save_safetensors({"lora_unet_nothing.alpha": np.full((), float(seed), np.float32)},
                         str(tmp_path / f"{name}.safetensors"))
    prompt = "a cat <lora:style:0.8> <lora:detail:0.5>"
    jp, tp = jproc.Processing(prompt=prompt), tproc.Processing(prompt=prompt)
    jnet.activate(make_tiny_engine(0), [prompt], registry=jnet.LoraRegistry([str(tmp_path)]), p=jp)
    tnet.activate(load_engine(make_sd15_checkpoint(0), device="cpu"), [prompt],
                  registry=tnet.LoraRegistry([str(tmp_path)]), p=tp)
    assert tp.extra_generation_params == jp.extra_generation_params
    assert tp.extra_generation_params["Lora hashes"].startswith("style: ")


STYLE_CASES = [
    ("a cat", ["{prompt}, dramatic lighting"]), ("a cat", ["oil painting"]),
    ("", ["oil painting", "{prompt} by an artist"]), ("  a dog  ", ["", "  sharp  "]),
    ("a cat", ["moody, {prompt}, film grain", "4k"]), (None, ["x"]),
]


def test_apply_and_extract_styles_match_forge_tpu():
    from forge_tpu.runtime import styles as jst
    from forge_tpu_torch.runtime import styles as tst

    for prompt, texts in STYLE_CASES:
        styled = tst.apply_styles_to_prompt(prompt, texts)
        assert styled == jst.apply_styles_to_prompt(prompt, texts)
        for text in texts:
            assert (tst.extract_style_text_from_prompt(text, styled)
                    == jst.extract_style_text_from_prompt(text, styled))
    for style in (("s", "{prompt}, lit", "blurry"), ("t", "oil", ""), ("u", "", "")):
        for pos, neg in (("a cat, lit", "ugly, blurry"), ("oil", ""), ("a, oil", "x")):
            assert (tst.extract_original_prompts(tst.PromptStyle(*style), pos, neg)
                    == jst.extract_original_prompts(jst.PromptStyle(*style), pos, neg))


def test_style_database_csv_matches_forge_tpu(tmp_path):
    from forge_tpu.runtime import styles as jst
    from forge_tpu_torch.runtime import styles as tst

    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "styles.csv").write_text(
        "name,prompt,negative_prompt\nmoody,\"{prompt}, dramatic lighting\",lowres\n"
        "oil,oil painting,\n#comment,x,y\n", encoding="utf-8-sig")
    (tmp_path / "a" / "more.csv").write_text("name,text\nlegacy,old style text\n",
                                             encoding="utf-8")
    pattern = str(tmp_path / "a" / "*.csv")
    jdb, tdb = jst.StyleDatabase([pattern]), tst.StyleDatabase([pattern])
    assert tdb.default_path == jdb.default_path
    assert {k: v[:3] for k, v in tdb.styles.items()} == {k: v[:3] for k, v in jdb.styles.items()}
    assert set(tdb.styles) == {"moody", "oil", "legacy"}
    names = ["moody", "oil", "legacy", "absent"]
    pos = tdb.apply_styles_to_prompt("a cat", names)
    neg = tdb.apply_negative_styles_to_prompt("ugly", names)
    assert pos == jdb.apply_styles_to_prompt("a cat", names)
    assert neg == jdb.apply_negative_styles_to_prompt("ugly", names)
    assert tdb.extract_styles_from_prompt(pos, neg) == jdb.extract_styles_from_prompt(pos, neg)
    for db, d in ((jdb, "j"), (tdb, "t")):
        db.styles["new"] = type(db.styles["oil"])("new", "new prompt", "new negative")
        del db.styles["legacy"]
        db.save(str(tmp_path / d / "styles.csv"))
    written = [(tmp_path / d / "styles.csv").read_bytes() for d in ("t", "j")]
    assert written[0] == written[1]
    assert not os.path.exists(str(tmp_path / "t" / "styles.csv.bak"))
