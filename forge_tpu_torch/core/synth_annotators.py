"""Synthetic ControlNet annotator checkpoints: each network's state dict in
its released file's key space and torch layout, at the published widths by
default, with weights made from a seed (core/synth.py `_Net`: N(0,
(gain/√fan_in)²) kernels, zero biases, BatchNorm at weight 1, bias 0, mean
0, variance 1; the plain VGG stacks of OpenPose and HED at gain √2, the
residual and normalized nets at 1, so that activations keep their scale).
`fill` is "random" (numpy) or a `DeviceFill` (made on the
card, one tensor at a time, when the file is written).

The published configurations: Depth Anything V2 ViT-L/14 (24 blocks, 1024
wide, DPT features 256, out channels 256/512/1024/1024, a 37² position
grid); MiDaS dpt_large-midas (ViT-L/16 at 384², readout "project");
OpenPose's body_pose_model, hand_pose_model and facenet; ControlNetHED
(Apache-2); PiDiNet table5 (carv4, 60 channels, CDCM 24, CSAM); TEED;
the lineart Generator(3, 1, 3); lineart_anime's UnetGenerator(3, 1, 8,
64); manga line's res_skip; MobileV2_MLSD_Large; NormalBAE's NNET on
tf_efficientnet_b5_ap (width ×1.6, depth ×2.2). For interrogation: BLIP's
base caption model (ViT-B/16 at 384², BERT-base with cross-attention) with
a seeded 30,522-line `vocab.txt` (`synth_wordpieces`), openai's CLIP
ViT-L/14 (both towers, projection 768) with seeded category files, and
DeepDanbooru's resnet_custom_v3 (179 convs, 9176 tags, seeded names some of
them `rating:`). And LeReS's res101 (ResNeXt101-32x8d), ZoeD_M12_N
(BEiT-L/16), Marigold (SD2's UNet on 8 channels, its VAE, OpenCLIP-H's
text tower), UniFormer-S with UPerHead, the anime-face MobileNetV2 UNet
and big-lama's FFC generator. For OneFormer, DensePose and the Spaces:
OneFormer Swin-L (ADE20K and COCO heads), DensePose R50-FPN DeepLab (its
RPN head and box predictor at detectron2's initialization), the full
U²-Net and Sapiens-1B's normal estimator. `scaled` multiplies a made weight
(numpy or lazy) by a factor.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from .synth import FillSpec, LazyTensor, _Net

RELU_GAIN = math.sqrt(2.0)


def scaled(v, factor: float):
    """A made weight (numpy or a `LazyTensor`) times `factor`."""
    if isinstance(v, LazyTensor):
        return LazyTensor(v.shape, lambda: v.materialize() * factor, v.dtype)
    return v * np.float32(factor)


def synth_depth_anything_sd(width: int = 1024, depth: int = 24, features: int = 256,
                            out_channels: Sequence[int] = (256, 512, 1024, 1024),
                            grid: int = 37, fill: FillSpec = "random",
                            seed: int = 22) -> Dict[str, object]:
    """depth_anything_v2_vitl.safetensors's keys (DINOv2 + DPT head)."""
    n = _Net(fill, seed)
    n.table("pretrained.cls_token", 1, 1, width)
    n.table("pretrained.pos_embed", 1, grid * grid + 1, width)
    n.table("pretrained.mask_token", 1, width)
    n.conv("pretrained.patch_embed.proj", width, 3, k=14)
    for i in range(depth):
        b = f"pretrained.blocks.{i}."
        n.norm(b + "norm1", width)
        n.linear(b + "attn.qkv", 3 * width, width)
        n.linear(b + "attn.proj", width, width)
        n.sd[b + "ls1.gamma"] = n.f.ones(width)
        n.norm(b + "norm2", width)
        n.linear(b + "mlp.fc1", 4 * width, width)
        n.linear(b + "mlp.fc2", width, 4 * width)
        n.sd[b + "ls2.gamma"] = n.f.ones(width)
    n.norm("pretrained.norm", width)
    h = "depth_head."
    oc = list(out_channels)
    for i in range(4):
        n.conv(h + f"projects.{i}", oc[i], width, k=1)
    n.sd[h + "resize_layers.0.weight"] = n.w(oc[0], oc[0], 4, 4)
    n.sd[h + "resize_layers.0.bias"] = n.f.zeros(oc[0])
    n.sd[h + "resize_layers.1.weight"] = n.w(oc[1], oc[1], 2, 2)
    n.sd[h + "resize_layers.1.bias"] = n.f.zeros(oc[1])
    n.conv(h + "resize_layers.3", oc[3], oc[3])
    for i in range(4):
        n.conv(h + f"scratch.layer{i + 1}_rn", features, oc[i], bias=False)
    for i in range(1, 5):
        r = h + f"scratch.refinenet{i}."
        for u in (1, 2):
            for c in (1, 2):
                n.conv(r + f"resConfUnit{u}.conv{c}", features, features)
        n.conv(r + "out_conv", features, features, k=1)
    n.conv(h + "scratch.output_conv1", features // 2, features)
    n.conv(h + "scratch.output_conv2.0", 32, features // 2)
    n.conv(h + "scratch.output_conv2.2", 1, 32, k=1)
    return n.sd


def synth_midas_sd(width: int = 1024, depth: int = 24, features: int = 256,
                   out_channels: Sequence[int] = (256, 512, 1024, 1024), grid: int = 24,
                   fill: FillSpec = "random", seed: int = 23) -> Dict[str, object]:
    """dpt_large-midas's keys (ViT-L/16, readout "project")."""
    n = _Net(fill, seed)
    m = "pretrained.model."
    n.table(m + "cls_token", 1, 1, width)
    n.table(m + "pos_embed", 1, grid * grid + 1, width)
    n.conv(m + "patch_embed.proj", width, 3, k=16)
    for i in range(depth):
        b = m + f"blocks.{i}."
        n.norm(b + "norm1", width)
        n.linear(b + "attn.qkv", 3 * width, width)
        n.linear(b + "attn.proj", width, width)
        n.norm(b + "norm2", width)
        n.linear(b + "mlp.fc1", 4 * width, width)
        n.linear(b + "mlp.fc2", width, 4 * width)
    n.norm(m + "norm", width)
    oc = list(out_channels)
    for i in range(1, 5):
        a = f"pretrained.act_postprocess{i}."
        n.linear(a + "0.project.0", width, 2 * width)
        n.conv(a + "3", oc[i - 1], width, k=1)
    n.sd["pretrained.act_postprocess1.4.weight"] = n.w(oc[0], oc[0], 4, 4)
    n.sd["pretrained.act_postprocess1.4.bias"] = n.f.zeros(oc[0])
    n.sd["pretrained.act_postprocess2.4.weight"] = n.w(oc[1], oc[1], 2, 2)
    n.sd["pretrained.act_postprocess2.4.bias"] = n.f.zeros(oc[1])
    n.conv("pretrained.act_postprocess4.4", oc[3], oc[3])
    for i in range(4):
        n.conv(f"scratch.layer{i + 1}_rn", features, oc[i], bias=False)
    for i in range(1, 5):
        r = f"scratch.refinenet{i}."
        for u in (1, 2):
            for c in (1, 2):
                n.conv(r + f"resConfUnit{u}.conv{c}", features, features)
        n.conv(r + "out_conv", features, features, k=1)
    n.conv("scratch.output_conv.0", features // 2, features)
    n.conv("scratch.output_conv.2", 32, features // 2)
    n.conv("scratch.output_conv.4", 1, 32, k=1)
    return n.sd


def _vgg(n: _Net, prefix: str, layers, cin: int) -> int:
    for name, cout, k in layers:
        n.conv(prefix + name, cout, cin, k=k)
        cin = cout
    return cin


def _cpm_trunk(scale: float):
    c = [max(int(v * scale), 2) for v in (64, 128, 256, 512, 128)]
    return [("conv1_1", c[0], 3), ("conv1_2", c[0], 3), ("conv2_1", c[1], 3),
            ("conv2_2", c[1], 3), ("conv3_1", c[2], 3), ("conv3_2", c[2], 3),
            ("conv3_3", c[2], 3), ("conv3_4", c[2], 3), ("conv4_1", c[3], 3),
            ("conv4_2", c[3], 3), ("conv4_3", c[3], 3), ("conv4_4", c[3], 3),
            ("conv5_1", c[3], 3), ("conv5_2", c[3], 3), ("conv5_3_CPM", c[4], 3)]


def _cpm_stages(n: _Net, prefixes, trunk: int, outs: int, scale: float):
    """conv6 and the five refinement stages of the hand and face nets."""
    mid, wide = max(int(128 * scale), 2), max(int(512 * scale), 2)
    _vgg(n, prefixes[0], [("conv6_1_CPM", wide, 1), ("conv6_2_CPM", outs, 1)], trunk)
    for s in range(2, 7):
        layers = [(f"Mconv{i}_stage{s}", mid, 7) for i in range(1, 6)]
        layers += [(f"Mconv6_stage{s}", mid, 1), (f"Mconv7_stage{s}", outs, 1)]
        _vgg(n, prefixes[s - 1], layers, outs + trunk)


def synth_openpose_body_sd(scale: float = 1.0, fill: FillSpec = "random",
                           seed: int = 24) -> Dict[str, object]:
    """body_pose_model.pth's keys (model0, model1_1 … model6_2); `scale` narrows every width."""
    n = _Net(fill, seed, gain=RELU_GAIN)
    c = [max(int(v * scale), 2) for v in (64, 128, 256, 512, 256, 128)]
    trunk = _vgg(n, "model0.", [("conv1_1", c[0], 3), ("conv1_2", c[0], 3), ("conv2_1", c[1], 3),
                                ("conv2_2", c[1], 3), ("conv3_1", c[2], 3), ("conv3_2", c[2], 3),
                                ("conv3_3", c[2], 3), ("conv3_4", c[2], 3), ("conv4_1", c[3], 3),
                                ("conv4_2", c[3], 3), ("conv4_3_CPM", c[4], 3),
                                ("conv4_4_CPM", c[5], 3)], 3)
    mid, wide = max(int(128 * scale), 2), max(int(512 * scale), 2)
    for branch, outs in ((1, 38), (2, 19)):
        _vgg(n, f"model1_{branch}.", [(f"conv5_{i}_CPM_L{branch}", mid, 3) for i in (1, 2, 3)]
             + [(f"conv5_4_CPM_L{branch}", wide, 1), (f"conv5_5_CPM_L{branch}", outs, 1)], trunk)
    for s in range(2, 7):
        for branch, outs in ((1, 38), (2, 19)):
            layers = [(f"Mconv{i}_stage{s}_L{branch}", mid, 7) for i in range(1, 6)]
            layers += [(f"Mconv6_stage{s}_L{branch}", mid, 1),
                       (f"Mconv7_stage{s}_L{branch}", outs, 1)]
            _vgg(n, f"model{s}_{branch}.", layers, 38 + 19 + trunk)
    return n.sd


def synth_openpose_hand_sd(scale: float = 1.0, fill: FillSpec = "random",
                           seed: int = 25) -> Dict[str, object]:
    """hand_pose_model.pth's keys (model1_0, model1_1, model2 … model6), 22 maps."""
    n = _Net(fill, seed, gain=RELU_GAIN)
    trunk = _vgg(n, "model1_0.", _cpm_trunk(scale), 3)
    _cpm_stages(n, ["model1_1."] + [f"model{s}." for s in range(2, 7)], trunk, 22, scale)
    return n.sd


def synth_openpose_face_sd(scale: float = 1.0, fill: FillSpec = "random",
                           seed: int = 26) -> Dict[str, object]:
    """facenet.pth's keys (flat: conv1_1 … Mconv7_stage6), 71 maps."""
    n = _Net(fill, seed, gain=RELU_GAIN)
    trunk = _vgg(n, "", _cpm_trunk(scale), 3)
    _cpm_stages(n, [""] * 6, trunk, 71, scale)
    return n.sd


def synth_hed_sd(widths: Sequence[int] = (64, 128, 256, 512, 512), fill: FillSpec = "random",
                 seed: int = 27) -> Dict[str, object]:
    """ControlNetHED.pth's keys (norm, block{1..5}.convs.N, block{1..5}.projection)."""
    n = _Net(fill, seed, gain=RELU_GAIN)
    n.sd["norm"] = n.f.w(1, 3, 1, 1, scale=1.0)
    cin = 3
    for b, (w, layers) in enumerate(zip(widths, (2, 2, 3, 3, 3)), start=1):
        for i in range(layers):
            n.conv(f"block{b}.convs.{i}", w, cin)
            cin = w
        n.conv(f"block{b}.projection", 1, w, k=1)
    return n.sd


_CARV4 = ["cd", "ad", "rd", "cv"] * 4


def synth_pidinet_sd(inplane: int = 60, dil: int = 24, fill: FillSpec = "random",
                     seed: int = 28) -> Dict[str, object]:
    """table5_pidinet.pth's keys (carv4 with CDCM and CSAM), pdc kernels as trained (3×3)."""
    n = _Net(fill, seed)
    n.conv("init_block", inplane, 3, bias=False)
    c = inplane
    for s in range(1, 5):
        cout = inplane * min(2 ** (s - 1), 4)
        for j in range(1, 4 + (s > 1)):
            b = f"block{s}_{j}."
            cin = c if j == 1 else cout
            n.sd[b + "conv1.weight"] = n.w(cin, 1, 3, 3)
            n.conv(b + "conv2", cout, cin, k=1, bias=False)
            if s > 1 and j == 1:
                n.conv(b + "shortcut", cout, cin, k=1)
        c = cout
    for i, ch in enumerate((inplane, 2 * inplane, 4 * inplane, 4 * inplane)):
        n.conv(f"dilations.{i}.conv1", dil, ch, k=1)
        for k in range(1, 5):
            n.conv(f"dilations.{i}.conv2_{k}", dil, dil, bias=False)
        n.conv(f"attentions.{i}.conv1", 4, dil, k=1)
        n.conv(f"attentions.{i}.conv2", 1, 4, bias=False)
        n.conv(f"conv_reduces.{i}.conv", 1, dil, k=1)
    n.conv("classifier", 1, 4, k=1)
    return n.sd


def synth_teed_sd(fill: FillSpec = "random", seed: int = 29) -> Dict[str, object]:
    """TEED's 7_model.pth keys (TED(): 16/32/48 channels)."""
    n = _Net(fill, seed)
    n.conv("block_1.conv1", 16, 3)
    n.conv("block_1.conv2", 16, 16)
    n.conv("block_2.conv1", 32, 16)
    n.conv("block_2.conv2", 32, 32)
    n.conv("dblock_3.denselayer1.conv1", 48, 32)
    n.conv("dblock_3.denselayer1.conv2", 48, 48)
    n.conv("side_1.conv", 32, 16, k=1)
    n.conv("pre_dense_3.conv", 48, 32, k=1)
    for name, cin, up in (("up_block_1", 16, 1), ("up_block_2", 32, 1), ("up_block_3", 48, 2)):
        for i in range(up):
            cout = 1 if i == up - 1 else 16
            n.conv(f"{name}.features.{3 * i}", cout, cin, k=1)
            k = 2 ** up
            n.sd[f"{name}.features.{3 * i + 2}.weight"] = n.w(cout, cout, k, k)
            n.sd[f"{name}.features.{3 * i + 2}.bias"] = n.f.zeros(cout)
            cin = cout
    n.conv("block_cat.DWconv1", 24, 1)
    n.conv("block_cat.DWconv2", 24, 1)
    return n.sd


def synth_lineart_sd(n_residual: int = 3, ngf: int = 64, fill: FillSpec = "random",
                     seed: int = 30) -> Dict[str, object]:
    """sk_model.pth's keys (Generator(3, 1, n_residual))."""
    n = _Net(fill, seed)
    n.conv("model0.1", ngf, 3, k=7)
    n.conv("model1.0", 2 * ngf, ngf)
    n.conv("model1.3", 4 * ngf, 2 * ngf)
    for i in range(n_residual):
        n.conv(f"model2.{i}.conv_block.1", 4 * ngf, 4 * ngf)
        n.conv(f"model2.{i}.conv_block.5", 4 * ngf, 4 * ngf)
    for key, cin, cout in (("model3.0", 4 * ngf, 2 * ngf), ("model3.3", 2 * ngf, ngf)):
        n.sd[key + ".weight"] = n.w(cin, cout, 3, 3)
        n.sd[key + ".bias"] = n.f.zeros(cout)
    n.conv("model4.1", 1, ngf, k=7)
    return n.sd


def synth_lineart_anime_sd(ngf: int = 64, num_downs: int = 8, fill: FillSpec = "random",
                           seed: int = 31) -> Dict[str, object]:
    """netG.pth's keys (UnetGenerator(3, 1, num_downs, ngf), InstanceNorm: biased convs)."""
    n = _Net(fill, seed)
    # (outer, inner) channels from the outermost block inwards
    chans = [(ngf, ngf * 2), (ngf * 2, ngf * 4), (ngf * 4, ngf * 8)]
    chans += [(ngf * 8, ngf * 8)] * (num_downs - 5)
    p = "model.model."
    n.conv(p + "0", ngf, 3, k=4)
    n.sd[p + "3.weight"] = n.w(ngf * 2, 1, 4, 4)
    n.sd[p + "3.bias"] = n.f.zeros(1)
    p += "1.model."
    for outer, inner in chans:  # the middle blocks
        n.conv(p + "1", inner, outer, k=4)
        n.sd[p + "5.weight"] = n.w(inner * 2, outer, 4, 4)
        n.sd[p + "5.bias"] = n.f.zeros(outer)
        p += "3.model."
    n.conv(p + "1", ngf * 8, ngf * 8, k=4)  # the innermost
    n.sd[p + "3.weight"] = n.w(ngf * 8, ngf * 8, 4, 4)
    n.sd[p + "3.bias"] = n.f.zeros(ngf * 8)
    return n.sd


def synth_manga_line_sd(widths: Sequence[int] = (24, 48, 96, 192, 384, 16),
                        reps: Sequence[int] = (2, 3, 5, 7, 12), fill: FillSpec = "random",
                        seed: int = 32) -> Dict[str, object]:
    """erika.pth's keys (res_skip)."""
    n = _Net(fill, seed)

    def brc(key, cin, cout, k=3):
        n.bn(key + ".0", cin)
        n.conv(key + ".2", cout, cin, k=k)

    def res_block(key, cin, cout, stride):
        brc(key + ".conv1.model", cin, cout)
        brc(key + ".residual.model", cout, cout)
        if cin != cout or stride != 1:
            n.conv(key + ".shortcut.model.0", cout, cin, k=1)

    def up_block(key, cin, cout):
        brc(key + ".conv1.model", cin, cout)
        brc(key + ".residual.model", cout, cout)
        if cin != cout:
            n.conv(key + ".shortcut.model.0", cout, cin, k=1)

    w = list(widths)
    cin = 1
    for b, (cout, r) in enumerate(zip(w[:5], reps)):
        for i in range(r):
            res_block(f"block{b}.model.{i}", cin if i == 0 else cout, cout,
                      2 if (i == r - 1 and b > 0) else 1)
        cin = cout
    for b, (cout, r) in enumerate(zip(w[3::-1], reps[3::-1]), start=5):
        up_block(f"block{b}.model.0", cin, cout)
        for i in range(1, r):
            res_block(f"block{b}.model.{i}", cout, cout, 1)
        cin = cout
    for i in range(2):
        res_block(f"block9.model.{i}", cin if i == 0 else w[5], w[5], 1)
    brc("conv15.model", w[5], 1, k=1)
    return n.sd


def synth_mlsd_sd(fill: FillSpec = "random", seed: int = 33) -> Dict[str, object]:
    """mlsd_large_512_fp32.pth's keys (MobileV2_MLSD_Large)."""
    n = _Net(fill, seed)
    f = "backbone.features."
    n.conv(f + "0.0", 32, 4, bias=False)
    n.bn(f + "0.1", 32)
    cin, idx = 32, 1
    for t, c, reps, _s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                           (6, 96, 3, 1)):
        for _ in range(reps):
            hidden = int(round(cin * t))
            p, i = f"{f}{idx}.conv.", 0
            if t != 1:
                n.conv(p + "0.0", hidden, cin, k=1, bias=False)
                n.bn(p + "0.1", hidden)
                i = 1
            n.conv(p + f"{i}.0", hidden, 1, bias=False)
            n.bn(p + f"{i}.1", hidden)
            n.conv(p + f"{i + 1}", c, hidden, k=1, bias=False)
            n.bn(p + f"{i + 2}", c)
            cin, idx = c, idx + 1

    def conv_bn(key, cout, cin, k=1):
        n.conv(key + ".0", cout, cin, k=k)
        n.bn(key + ".1", cout)

    for blk, (c1, c2) in zip((15, 17, 19, 21), ((64, 96), (32, 64), (24, 64), (16, 64))):
        conv_bn(f"block{blk}.conv1", 64, c2)
        conv_bn(f"block{blk}.conv2", 64, c1)
        conv_bn(f"block{blk + 1}.conv1", 128, 128, k=3)
        conv_bn(f"block{blk + 1}.conv2", 64, 128, k=3)
    conv_bn("block23.conv1", 64, 64, k=3)
    conv_bn("block23.conv2", 64, 64, k=3)
    n.conv("block23.conv3", 16, 64, k=1)
    return n.sd


def _round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return new + divisor if new < 0.9 * c else new


# EfficientNet-B0's stages: (kind, repeats, kernel, stride, expansion, channels)
_EFFNET = [("ds", 1, 3, 1, 1, 16), ("ir", 2, 3, 2, 6, 24), ("ir", 2, 5, 2, 6, 40),
           ("ir", 3, 3, 2, 6, 80), ("ir", 3, 5, 1, 6, 112), ("ir", 4, 5, 2, 6, 192),
           ("ir", 1, 3, 1, 6, 320)]


def synth_normalbae_sd(width_mult: float = 1.6, depth_mult: float = 2.2,
                       decoder_features: int = 2048, fill: FillSpec = "random",
                       seed: int = 34) -> Dict[str, object]:
    """scannet.pt's NNET keys (encoder.original_model.* of geffnet's
    tf_efficientnet_b5_ap at the defaults, decoder.*)."""
    n = _Net(fill, seed)
    e = "encoder.original_model."
    stem = _round_channels(32, width_mult)
    n.conv(e + "conv_stem", stem, 3, bias=False)
    n.bn(e + "bn1", stem)
    cin, stage_out = stem, []
    for s, (kind, reps, k, _stride, exp, c) in enumerate(_EFFNET):
        cout = _round_channels(c, width_mult)
        for i in range(int(math.ceil(reps * depth_mult))):
            b = f"{e}blocks.{s}.{i}."
            se = max(1, int(cin * 0.25))
            if kind == "ds":
                n.conv(b + "conv_dw", cin, 1, k=k, bias=False)
                n.bn(b + "bn1", cin)
                n.conv(b + "se.conv_reduce", se, cin, k=1)
                n.conv(b + "se.conv_expand", cin, se, k=1)
                n.conv(b + "conv_pw", cout, cin, k=1, bias=False)
                n.bn(b + "bn2", cout)
            else:
                mid = cin * exp
                n.conv(b + "conv_pw", mid, cin, k=1, bias=False)
                n.bn(b + "bn1", mid)
                n.conv(b + "conv_dw", mid, 1, k=k, bias=False)
                n.bn(b + "bn2", mid)
                n.conv(b + "se.conv_reduce", se, mid, k=1)
                n.conv(b + "se.conv_expand", mid, se, k=1)
                n.conv(b + "conv_pwl", cout, mid, k=1, bias=False)
                n.bn(b + "bn3", cout)
            cin = cout
        stage_out.append(cout)
    head = _round_channels(1280, width_mult)
    n.conv(e + "conv_head", head, cin, k=1, bias=False)
    n.bn(e + "bn2", head)
    n.linear(e + "classifier", 1000, head)
    f = decoder_features
    d = "decoder."
    n.conv(d + "conv2", f, head, k=1)
    for i, (cin_up, skip, cout) in enumerate(((f, stage_out[4], f // 2),
                                              (f // 2, stage_out[2], f // 4),
                                              (f // 4, stage_out[1], f // 8),
                                              (f // 8, stage_out[0], f // 16)), start=1):
        u = f"{d}up{i}._net."
        n.conv(u + "0", cout, cin_up + skip)
        n.bn(u + "1", cout)
        n.conv(u + "3", cout, cout)
        n.bn(u + "4", cout)
    n.conv(d + "out_conv_res8", 4, f // 4)
    for name, feat in (("out_conv_res4", f // 4), ("out_conv_res2", f // 8),
                       ("out_conv_res1", f // 16)):
        cin = feat + 4
        for j, cout in enumerate((128, 128, 128, 4)):
            n.sd[f"{d}{name}.{2 * j}.weight"] = n.w(cout, cin, 1)
            n.sd[f"{d}{name}.{2 * j}.bias"] = n.f.zeros(cout)
            cin = cout
    return n.sd


# -- interrogation -----------------------------------------------------------------------


def synth_wordpieces(n: int = 30522, seed: int = 23) -> List[str]:
    """A seeded `vocab.txt` in BERT's bert-base-uncased layout: [PAD], 99
    [unusedN], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, "a", "picture",
    "of", then made-up words and "##" continuations, `n` lines in all."""
    rng = np.random.default_rng(seed)
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                               "[MASK]", "a", "picture", "of"]
    letters = np.asarray(list("abcdefghijklmnopqrstuvwxyz"))
    seen = set(words)
    while len(words) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        w = "##" + w if rng.random() < 0.2 else w
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def synth_blip_sd(width: int = 768, depth: int = 12, layers: int = 12, mlp: int = 3072,
                  image: int = 384, patch: int = 16, vocab: int = 30524, positions: int = 512,
                  fill: FillSpec = "random", seed: int = 40) -> Dict[str, object]:
    """BLIP's base caption model (model_base_caption_capfilt_large: the
    ViT-B/16 `visual_encoder` at 384² and the BERT-base `text_decoder` with
    cross-attention, its vocabulary BERT's 30522 and [DEC], [ENC])."""
    n = _Net(fill, seed)
    v = "visual_encoder."
    n.table(v + "cls_token", 1, 1, width)
    n.table(v + "pos_embed", 1, (image // patch) ** 2 + 1, width)
    n.conv(v + "patch_embed.proj", width, 3, k=patch)
    for i in range(depth):
        b = v + f"blocks.{i}."
        n.norm(b + "norm1", width)
        n.linear(b + "attn.qkv", 3 * width, width)
        n.linear(b + "attn.proj", width, width)
        n.norm(b + "norm2", width)
        n.linear(b + "mlp.fc1", mlp, width)
        n.linear(b + "mlp.fc2", width, mlp)
    n.norm(v + "norm", width)
    t = "text_decoder.bert."
    n.table(t + "embeddings.word_embeddings.weight", vocab, width, scale=1.0)
    n.table(t + "embeddings.position_embeddings.weight", positions, width, scale=1.0)
    n.norm(t + "embeddings.LayerNorm", width)
    for i in range(layers):
        b = t + f"encoder.layer.{i}."
        for att in ("attention.", "crossattention."):
            for name in ("query", "key", "value"):
                n.linear(b + att + "self." + name, width, width)
            n.linear(b + att + "output.dense", width, width)
            n.norm(b + att + "output.LayerNorm", width)
        n.linear(b + "intermediate.dense", mlp, width)
        n.linear(b + "output.dense", width, mlp)
        n.norm(b + "output.LayerNorm", width)
    c = "text_decoder.cls.predictions."
    n.linear(c + "transform.dense", width, width)
    n.norm(c + "transform.LayerNorm", width)
    n.linear(c + "decoder", vocab, width, bias=False)
    n.sd[c + "bias"] = n.f.zeros(vocab)
    return n.sd


def synth_clip_interrogator_sd(text_width: int = 768, text_layers: int = 12,
                               vision_width: int = 1024, vision_layers: int = 24,
                               patch: int = 14, image: int = 224, projection: int = 768,
                               vocab: int = 49408, fill: FillSpec = "random",
                               seed: int = 41) -> Dict[str, object]:
    """openai/clip-vit-large-patch14 in HF CLIPModel's keys: the text tower
    (`text_model.*`, 77 positions), the vision tower (`vision_model.*`, the
    patch conv without bias, `pre_layrnorm`), `text_projection` and
    `visual_projection` (no bias)."""
    n = _Net(fill, seed)
    tm = "text_model."
    n.table(tm + "embeddings.token_embedding.weight", vocab, text_width)
    n.table(tm + "embeddings.position_embedding.weight", 77, text_width, scale=0.01)
    vm = "vision_model."
    n.sd[vm + "embeddings.patch_embedding.weight"] = n.w(vision_width, 3, patch, patch)
    n.table(vm + "embeddings.class_embedding", vision_width)
    n.table(vm + "embeddings.position_embedding.weight", (image // patch) ** 2 + 1,
            vision_width)
    n.norm(vm + "pre_layrnorm", vision_width)
    for prefix, width, count in ((tm, text_width, text_layers), (vm, vision_width, vision_layers)):
        for i in range(count):
            b = f"{prefix}encoder.layers.{i}."
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                n.linear(b + "self_attn." + name, width, width)
            n.norm(b + "layer_norm1", width)
            n.norm(b + "layer_norm2", width)
            n.linear(b + "mlp.fc1", 4 * width, width)
            n.linear(b + "mlp.fc2", width, 4 * width)
    n.norm(tm + "final_layer_norm", text_width)
    n.norm(vm + "post_layernorm", vision_width)
    n.linear("text_projection", projection, text_width, bias=False)
    n.linear("visual_projection", projection, vision_width, bias=False)
    return n.sd


def synth_interrogate_categories(terms: int = 1500, seed: int = 42) -> Dict[str, List[str]]:
    """The four category files of models/interrogate (mediums, artists,
    movements, flavors), `terms` seeded made-up phrases each."""
    rng = np.random.default_rng(seed)
    letters = np.asarray(list("abcdefghijklmnopqrstuvwxyz"))
    out = {}
    for name in ("mediums", "artists", "movements", "flavors"):
        seen, rows = set(), []
        while len(rows) < terms:
            t = " ".join("".join(rng.choice(letters, int(rng.integers(3, 9))))
                         for _ in range(int(rng.integers(1, 4))))
            if t not in seen:
                seen.add(t)
                rows.append(t)
        out[name] = rows
    return out


# DeepDanbooru resnet_custom_v3's stages: bottleneck width, blocks, and the block (in the stage)
# that is the mid-stage stride-2 downsample with its projection last (n_Conv_97..100)
_DEEPBOORU_STAGES = ((64, 3, None), (128, 8, None), (256, 40, 20), (512, 3, None),
                     (1024, 3, None))


def synth_deepbooru_tags(n: int = 9176, seed: int = 43) -> List[str]:
    """Seeded tag names: the three rating tags first, then made-up
    underscore-joined words, some with brackets (escaped by `tag`)."""
    rng = np.random.default_rng(seed)
    letters = np.asarray(list("abcdefghijklmnopqrstuvwxyz"))
    tags = ["rating:safe", "rating:questionable", "rating:explicit"]
    seen = set(tags)
    while len(tags) < n:
        t = "_".join("".join(rng.choice(letters, int(rng.integers(2, 8))))
                     for _ in range(int(rng.integers(1, 4))))
        if rng.random() < 0.05:
            t += "_(" + "".join(rng.choice(letters, 5)) + ")"
        if t not in seen:
            seen.add(t)
            tags.append(t)
    return tags


def synth_deepbooru_sd(stages=_DEEPBOORU_STAGES, tags: int = 9176, fill: FillSpec = "random",
                       seed: int = 44) -> Dict[str, object]:
    """model-resnet_custom_v3.pt's tensors: `n_Conv_{i}` in the generated
    graph's order (the 7×7 stem to 64; per stage a projection-first head
    block, identity bottlenecks of width w to 4w, and in stage 3 one
    projection-last stride-2 block; the 1×1 head to the tags), 179
    convs at the published widths."""
    n = _Net(fill, seed)  # gain 1: no BatchNorm, the residuals add up
    i = 0

    def conv(o, c, k, bias=True):
        nonlocal i
        n.conv(f"n_Conv_{i}", o, c, k=k, bias=bias)
        i += 1

    conv(64, 3, 7)
    trunk = 64
    for width, blocks, mid in stages:
        out = 4 * width
        conv(out, trunk, 1)  # the projection, then the bottleneck
        conv(width, trunk, 1)
        conv(width, width, 3)
        conv(out, width, 1)
        trunk = out
        for b in range(1, blocks):
            conv(width, trunk, 1)
            conv(width, width, 3)
            conv(out, width, 1)
            if b == mid:  # the projection last
                conv(out, trunk, 1)
    n.conv(f"n_Conv_{i}", tags, trunk, k=1)
    return n.sd


# -- the remaining annotators ----------------------------------------------------------


def synth_leres_sd(layers: Sequence[int] = (3, 4, 23, 3), groups: int = 32, group_width: int = 8,
                   planes: Sequence[int] = (64, 128, 256, 512),
                   mids: Sequence[int] = (256, 256, 256, 512), stem: int = 64,
                   fill: FillSpec = "random", seed: int = 45) -> Dict[str, object]:
    """res101.pth's depth model (flat `depth_model.*` keys): torchvision's
    ResNeXt101-32x8d and the FTB/FFM/AO decoder (network_auxi.py Decoder:
    in 256/512/1024/2048, mid 256/256/256/512)."""
    n = _Net(fill, seed)
    e = "depth_model.encoder_modules.encoder."
    n.conv(e + "conv1", stem, 3, k=7, bias=False)
    n.bn(e + "bn1", stem)
    inplanes = stem
    for li, (planes_i, count) in enumerate(zip(planes, layers), start=1):
        width, out = planes_i * group_width // 64 * groups, planes_i * 4
        for b in range(count):
            p = f"{e}layer{li}.{b}."
            n.conv(p + "conv1", width, inplanes, k=1, bias=False)
            n.bn(p + "bn1", width)
            n.sd[p + "conv2.weight"] = n.w(width, width // groups, 3, 3)
            n.bn(p + "bn2", width)
            n.conv(p + "conv3", out, width, k=1, bias=False)
            n.bn(p + "bn3", out)
            if b == 0:
                n.conv(p + "downsample.0", out, inplanes, k=1, bias=False)
                n.bn(p + "downsample.1", out)
            inplanes = out
    d = "depth_model.decoder_modules."

    def ftb(key, cin, mid):
        n.conv(key + "conv1", mid, cin)
        n.conv(key + "conv_branch.1", mid, mid)
        n.bn(key + "conv_branch.2", mid)
        n.conv(key + "conv_branch.4", mid, mid)

    ftb(d + "conv.", 4 * planes[3], mids[3])
    n.conv(d + "conv1", mids[2], mids[3])
    for j, name in ((2, "ffm2"), (1, "ffm1"), (0, "ffm0")):
        ftb(f"{d}{name}.ftb1.", 4 * planes[j], mids[j])
        ftb(f"{d}{name}.ftb2.", mids[j], mids[j])
    n.conv(d + "outconv.adapt_conv.0", mids[0] // 2, mids[0])
    n.bn(d + "outconv.adapt_conv.1", mids[0] // 2)
    n.conv(d + "outconv.adapt_conv.3", 1, mids[0] // 2)
    return n.sd


def synth_zoe_sd(width: int = 1024, depth: int = 24, heads: int = 16, grid: int = 24,
                 features: int = 256, out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 n_bins: int = 64, attractors: Sequence[int] = (16, 8, 4, 1), embed: int = 128,
                 bin_mlp: int = 256, fill: FillSpec = "random",
                 seed: int = 46) -> Dict[str, object]:
    """ZoeD_M12_N.pt's model (`core.core.*`: MiDaS 3.1 DPT-BEiT-L/16 at
    384², relative position tables for a 24² window, readout "project";
    the ZoeDepth-N metric-bins head: bins 64, attractors 16/8/4/1, bin
    embedding 128, the conditional log-binomial on 32 + 1 channels)."""
    n = _Net(fill, seed)
    m = "core.core.pretrained.model."
    n.table(m + "cls_token", 1, 1, width)
    n.conv(m + "patch_embed.proj", width, 3, k=16)
    rows = (2 * grid - 1) ** 2 + 3
    for i in range(depth):
        b = m + f"blocks.{i}."
        n.norm(b + "norm1", width)
        n.sd[b + "attn.qkv.weight"] = n.w(3 * width, width)
        n.sd[b + "attn.q_bias"] = n.f.zeros(width)
        n.sd[b + "attn.v_bias"] = n.f.zeros(width)
        n.table(b + "attn.relative_position_bias_table", rows, heads)
        n.linear(b + "attn.proj", width, width)
        n.sd[b + "gamma_1"] = n.f.ones(width)
        n.sd[b + "gamma_2"] = n.f.ones(width)
        n.norm(b + "norm2", width)
        n.linear(b + "mlp.fc1", 4 * width, width)
        n.linear(b + "mlp.fc2", width, 4 * width)
    c = "core.core."
    oc = list(out_channels)
    for i in range(1, 5):
        a = f"{c}pretrained.act_postprocess{i}."
        n.linear(a + "0.project.0", width, 2 * width)
        n.conv(a + "3", oc[i - 1], width, k=1)
    n.sd[c + "pretrained.act_postprocess1.4.weight"] = n.w(oc[0], oc[0], 4, 4)
    n.sd[c + "pretrained.act_postprocess1.4.bias"] = n.f.zeros(oc[0])
    n.sd[c + "pretrained.act_postprocess2.4.weight"] = n.w(oc[1], oc[1], 2, 2)
    n.sd[c + "pretrained.act_postprocess2.4.bias"] = n.f.zeros(oc[1])
    n.conv(c + "pretrained.act_postprocess4.4", oc[3], oc[3])
    for i in range(4):
        n.conv(c + f"scratch.layer{i + 1}_rn", features, oc[i], bias=False)
    for i in range(1, 5):
        r = c + f"scratch.refinenet{i}."
        for u in (1, 2):
            for k in (1, 2):
                n.conv(r + f"resConfUnit{u}.conv{k}", features, features)
        n.conv(r + "out_conv", features, features, k=1)
    n.conv(c + "scratch.output_conv.0", features // 2, features)
    n.conv(c + "scratch.output_conv.2", 32, features // 2)
    n.conv(c + "scratch.output_conv.4", 1, 32, k=1)

    def mlp2(key, cin, hidden, out):
        n.conv(key + "_net.0", hidden, cin, k=1)
        n.conv(key + "_net.2", out, hidden, k=1)

    n.conv("conv2", features, features, k=1)
    mlp2("seed_bin_regressor.", features, bin_mlp, n_bins)
    mlp2("seed_projector.", features, embed, embed)
    for i, na in enumerate(attractors):
        mlp2(f"projectors.{i}.", features, embed, embed)
        mlp2(f"attractors.{i}.", embed, embed, na)
    last = 32 + 1 + embed
    n.conv("conditional_log_binomial.mlp.0", last // 2, last, k=1)
    n.conv("conditional_log_binomial.mlp.2", 4, last // 2, k=1)
    return n.sd


def synth_marigold_sd(fill: FillSpec = "random", seed: int = 47, text_width: int = 1024,
                      text_layers: int = 23, vae_ch: int = 128, **unet) -> Dict[str, object]:
    """Marigold v1.0 as one file: `unet.` (SD2's UNet in ldm keys, conv_in
    on 8 channels: the RGB latent and the depth latent; `unet` overrides
    core/synth.py `synth_unet_sd`'s geometry), `vae.` (SD2's 4-channel VAE)
    and `text_encoder.` (OpenCLIP-H's text tower in HF's keys, 23 layers as
    stable-diffusion-2's text_encoder)."""
    from .synth import synth_clip_sd, synth_unet_sd, synth_vae_sd

    sd: Dict[str, object] = {}
    sd.update(synth_unet_sd(context_dim=text_width, in_channels=8, fill=fill, seed=seed,
                            prefix="unet.", **unet))
    sd.update(synth_vae_sd(ch=vae_ch, fill=fill, seed=seed + 1, prefix="vae."))
    sd.update(synth_clip_sd(width=text_width, layers=text_layers, fill=fill, seed=seed + 2,
                            prefix="text_encoder."))
    return sd


def synth_uniformer_sd(dims: Sequence[int] = (64, 128, 320, 512), layers: Sequence[int] = (3, 4, 8, 3),
                       channels: int = 512, classes: int = 150, fill: FillSpec = "random",
                       seed: int = 48) -> Dict[str, object]:
    """upernet_global_small.pth's `state_dict`: UniFormer-S (patch embeds
    4, 2, 2, 2 with LayerNorm; CBlocks in stages 1-2, SABlocks in 3-4, MLP
    ×4, the stage norms) and UPerHead (channels 512, pyramid pooling 1, 2, 3,
    6, 150 classes), with the auxiliary FCN head the detector leaves out."""
    n = _Net(fill, seed)
    cin = 3
    for s, (dim, count) in enumerate(zip(dims, layers), start=1):
        k = 4 if s == 1 else 2
        n.conv(f"backbone.patch_embed{s}.proj", dim, cin, k=k)
        n.norm(f"backbone.patch_embed{s}.norm", dim)
        for i in range(count):
            b = f"backbone.blocks{s}.{i}."
            n.sd[b + "pos_embed.weight"] = n.w(dim, 1, 3, 3)
            n.sd[b + "pos_embed.bias"] = n.f.zeros(dim)
            if s <= 2:
                n.bn(b + "norm1", dim)
                n.conv(b + "conv1", dim, dim, k=1)
                n.sd[b + "attn.weight"] = n.w(dim, 1, 5, 5)
                n.sd[b + "attn.bias"] = n.f.zeros(dim)
                n.conv(b + "conv2", dim, dim, k=1)
                n.bn(b + "norm2", dim)
                n.conv(b + "mlp.fc1", 4 * dim, dim, k=1)
                n.conv(b + "mlp.fc2", dim, 4 * dim, k=1)
            else:
                n.norm(b + "norm1", dim)
                n.linear(b + "attn.qkv", 3 * dim, dim)
                n.linear(b + "attn.proj", dim, dim)
                n.norm(b + "norm2", dim)
                n.linear(b + "mlp.fc1", 4 * dim, dim)
                n.linear(b + "mlp.fc2", dim, 4 * dim)
        n.norm(f"backbone.norm{s}", dim)
        cin = dim
    h = "decode_head."

    def conv_module(key, o, c, k):
        n.conv(key + ".conv", o, c, k=k, bias=False)
        n.bn(key + ".bn", o)

    for i in range(4):
        conv_module(f"{h}psp_modules.{i}.1", channels, dims[-1], 1)
    conv_module(h + "bottleneck", channels, dims[-1] + 4 * channels, 3)
    for i in range(3):
        conv_module(f"{h}lateral_convs.{i}", channels, dims[i], 1)
        conv_module(f"{h}fpn_convs.{i}", channels, channels, 3)
    conv_module(h + "fpn_bottleneck", channels, 4 * channels, 3)
    n.conv(h + "conv_seg", classes, channels, k=1)
    conv_module("auxiliary_head.convs.0", 256, dims[2], 3)
    n.conv("auxiliary_head.conv_seg", classes, 256, k=1)
    return n.sd


# torchvision MobileNetV2's features 0-16: (expand ratio, in, out); 0 is the stem
_MOBILENET_V2 = {0: ("stem", 3, 32), 1: (1, 32, 16), 2: (6, 16, 24), 3: (6, 24, 24),
                 4: (6, 24, 32), 5: (6, 32, 32), 6: (6, 32, 32), 7: (6, 32, 64),
                 8: (6, 64, 64), 9: (6, 64, 64), 10: (6, 64, 64), 11: (6, 64, 96),
                 12: (6, 96, 96), 13: (6, 96, 96), 14: (6, 96, 160), 15: (6, 160, 160),
                 16: (6, 160, 160)}
_ANIME_BLOCKS = {0: (0, 1), 1: (2, 3), 2: (4, 6), 3: (7, 13), 4: (14, 16)}


def synth_anime_face_sd(fill: FillSpec = "random", seed: int = 49) -> Dict[str, object]:
    """anime_face_segment's UNet.pth: five slices of torchvision's
    MobileNetV2 features (`en_block0-4`) and the decoder (`de_block4-0`:
    160→96, 192→32, 64→24, 48→16, 32→7)."""
    n = _Net(fill, seed, gain=RELU_GAIN)
    for blk, (lo, hi) in _ANIME_BLOCKS.items():
        for seq_i, feat_i in enumerate(range(lo, hi + 1)):
            base = f"en_block{blk}.{seq_i}."
            t, cin, cout = _MOBILENET_V2[feat_i]
            if t == "stem":
                n.conv(base + "0", cout, cin, bias=False)
                n.bn(base + "1", cout)
                continue
            hidden, i = cin * t, 0
            if t != 1:
                n.conv(base + "conv.0.0", hidden, cin, k=1, bias=False)
                n.bn(base + "conv.0.1", hidden)
                i = 1
            n.sd[f"{base}conv.{i}.0.weight"] = n.w(hidden, 1, 3, 3)
            n.bn(f"{base}conv.{i}.1", hidden)
            n.conv(f"{base}conv.{i + 1}", cout, hidden, k=1, bias=False)
            n.bn(f"{base}conv.{i + 2}", cout)
    for name, (cin, cout) in (("de_block4", (160, 96)), ("de_block3", (192, 32)),
                              ("de_block2", (64, 24)), ("de_block1", (48, 16)),
                              ("de_block0", (32, 7))):
        n.conv(name + ".1", cout, cin)
    return n.sd


def synth_lama_sd(ngf: int = 64, downs: int = 3, blocks: int = 18, ratio: float = 0.75,
                  fill: FillSpec = "random", seed: int = 50) -> Dict[str, object]:
    """big-lama's generator (ControlNetLama.pth, `model.*`): the 7×7 FFC
    stem on 4 channels, three stride-2 FFC downsamples (the last splitting
    into local and global channels at `ratio`), `blocks` FFC resnet blocks
    with spectral transforms (no LFU), three transpose-conv upsamples with
    BatchNorm, and the 7×7 head to 3 channels."""
    n = _Net(fill, seed, gain=RELU_GAIN)

    def ffc_bn_act(key, cin, cout, k, gin, gout):
        in_g, out_g = int(cin * gin), int(cout * gout)
        in_l, out_l = cin - in_g, cout - out_g
        for name, o, c in (("convl2l", out_l, in_l), ("convl2g", out_g, in_l),
                           ("convg2l", out_l, in_g)):
            if o and c:
                n.conv(f"{key}ffc.{name}", o, c, k=k, bias=False)
        if out_g and in_g:
            s = f"{key}ffc.convg2g."
            n.conv(s + "conv1.0", out_g // 2, in_g, k=1, bias=False)
            n.bn(s + "conv1.1", out_g // 2)
            n.conv(s + "fu.conv_layer", out_g, out_g, k=1, bias=False)
            n.bn(s + "fu.bn", out_g)
            n.conv(s + "conv2", out_g, out_g // 2, k=1, bias=False)
        if out_l:
            n.bn(key + "bn_l", out_l)
        if out_g:
            n.bn(key + "bn_g", out_g)

    ffc_bn_act("model.1.", 4, ngf, 7, 0.0, 0.0)
    idx = 2
    for i in range(downs):
        c = ngf * 2 ** i
        ffc_bn_act(f"model.{idx}.", c, 2 * c, 3, 0.0, ratio if i == downs - 1 else 0.0)
        idx += 1
    c = ngf * 2 ** downs
    for _ in range(blocks):
        ffc_bn_act(f"model.{idx}.conv1.", c, c, 3, ratio, ratio)
        ffc_bn_act(f"model.{idx}.conv2.", c, c, 3, ratio, ratio)
        idx += 1
    idx += 1  # the ConcatTupleLayer
    for _ in range(downs):
        n.sd[f"model.{idx}.weight"] = n.w(c, c // 2, 3, 3)
        n.sd[f"model.{idx}.bias"] = n.f.zeros(c // 2)
        n.bn(f"model.{idx + 1}", c // 2)
        idx += 3  # the ReLU
        c //= 2
    n.conv(f"model.{idx + 1}", 3, ngf, k=7)  # after the ReflectionPad2d
    return n.sd


def _mha_sd(n: _Net, key: str, dim: int):
    """torch's nn.MultiheadAttention: the fused in_proj and out_proj."""
    n.sd[key + ".in_proj_weight"] = n.w(3 * dim, dim)
    n.sd[key + ".in_proj_bias"] = n.f.zeros(3 * dim)
    n.linear(key + ".out_proj", dim, dim)


def synth_oneformer_sd(embed: int = 192, depths: Sequence[int] = (2, 2, 18, 2),
                       heads: Sequence[int] = (6, 12, 24, 48), window: int = 12,
                       conv_dim: int = 256, mask_dim: int = 256, enc_layers: int = 6,
                       enc_ffn: int = 1024, points: int = 4, hidden: int = 256,
                       dec_layers: int = 9, class_dec_layers: int = 2, ffn: int = 2048,
                       queries: int = 250, classes: int = 150, task_len: int = 77,
                       n_ctx: int = 16, fill: FillSpec = "random",
                       seed: int = 51) -> Dict[str, object]:
    """A OneFormer Swin-L detectron2 checkpoint's `model` (oneformer_swin_large
    configs: embed 192, depths 2-2-18-2, heads 6-12-24-48, window 12; the
    MSDeformAttn pixel decoder at conv and mask dim 256 with 6 encoder layers
    of FFN 1024, 8 heads, 4 points on 3 levels; the decoder at hidden 256,
    FFN 2048, 8 heads, the config's DEC_LAYERS 10 less one as Mask2Former's
    from_config takes it, the class transformer's 2 layers, task_mlp on the
    77 task ids). ADE20K: 250 queries, 150 classes; COCO: 150, 133. The
    Swin blocks carry their `relative_position_index` buffers and the file a
    `prompt_ctx` of the text branch, both of which the loaders drop."""
    from .synth import _swin_index

    n = _Net(fill, seed)
    bb = "backbone."
    n.conv(bb + "patch_embed.proj", embed, 3, k=4)
    n.norm(bb + "patch_embed.norm", embed)
    dims = [embed * 2 ** i for i in range(len(depths))]
    for i, (dim, depth, h) in enumerate(zip(dims, depths, heads)):
        for j in range(depth):
            b = f"{bb}layers.{i}.blocks.{j}."
            n.norm(b + "norm1", dim)
            n.table(b + "attn.relative_position_bias_table", (2 * window - 1) ** 2, h)
            n.sd[b + "attn.relative_position_index"] = _swin_index(window)
            n.linear(b + "attn.qkv", 3 * dim, dim)
            n.linear(b + "attn.proj", dim, dim)
            n.norm(b + "norm2", dim)
            n.linear(b + "mlp.fc1", 4 * dim, dim)
            n.linear(b + "mlp.fc2", dim, 4 * dim)
        if i < len(depths) - 1:
            n.linear(f"{bb}layers.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            n.norm(f"{bb}layers.{i}.downsample.norm", 4 * dim)
        n.norm(f"{bb}norm{i}", dim)
    pd = "sem_seg_head.pixel_decoder."
    for i, dim in enumerate(dims[:0:-1]):  # res5, res4, res3
        n.conv(f"{pd}input_proj.{i}.0", conv_dim, dim, k=1)
        n.norm(f"{pd}input_proj.{i}.1", conv_dim)
    levels = len(dims) - 1
    n.table(pd + "transformer.level_embed", levels, conv_dim, scale=1.0)
    for i in range(enc_layers):
        e = f"{pd}transformer.encoder.layers.{i}."
        n.linear(e + "self_attn.sampling_offsets", 8 * levels * points * 2, conv_dim)
        n.linear(e + "self_attn.attention_weights", 8 * levels * points, conv_dim)
        n.linear(e + "self_attn.value_proj", conv_dim, conv_dim)
        n.linear(e + "self_attn.output_proj", conv_dim, conv_dim)
        n.norm(e + "norm1", conv_dim)
        n.linear(e + "linear1", enc_ffn, conv_dim)
        n.linear(e + "linear2", conv_dim, enc_ffn)
        n.norm(e + "norm2", conv_dim)
    n.conv(pd + "adapter_1", conv_dim, dims[0], k=1, bias=False)
    n.norm(pd + "adapter_1.norm", conv_dim)
    n.conv(pd + "layer_1", conv_dim, conv_dim, bias=False)
    n.norm(pd + "layer_1.norm", conv_dim)
    n.conv(pd + "mask_features", mask_dim, conv_dim, k=1)
    pr = "sem_seg_head.predictor."
    n.conv(pr + "class_input_proj", hidden, mask_dim, k=1)
    for i in range(class_dec_layers):
        c = f"{pr}class_transformer.decoder.layers.{i}."
        _mha_sd(n, c + "self_attn", hidden)
        _mha_sd(n, c + "multihead_attn", hidden)
        n.linear(c + "linear1", ffn, hidden)
        n.linear(c + "linear2", hidden, ffn)
        for k in (1, 2, 3):
            n.norm(f"{c}norm{k}", hidden)
    n.norm(pr + "class_transformer.decoder.norm", hidden)
    for i in range(dec_layers):
        _mha_sd(n, f"{pr}transformer_self_attention_layers.{i}.self_attn", hidden)
        n.norm(f"{pr}transformer_self_attention_layers.{i}.norm", hidden)
        _mha_sd(n, f"{pr}transformer_cross_attention_layers.{i}.multihead_attn", hidden)
        n.norm(f"{pr}transformer_cross_attention_layers.{i}.norm", hidden)
        n.linear(f"{pr}transformer_ffn_layers.{i}.linear1", ffn, hidden)
        n.linear(f"{pr}transformer_ffn_layers.{i}.linear2", hidden, ffn)
        n.norm(f"{pr}transformer_ffn_layers.{i}.norm", hidden)
    n.norm(pr + "decoder_norm", hidden)
    n.table(pr + "query_embed.weight", queries, hidden, scale=1.0)
    n.table(pr + "level_embed.weight", levels, hidden, scale=1.0)
    n.linear(pr + "class_embed", classes + 1, hidden)
    for i in range(3):
        n.linear(f"{pr}mask_embed.layers.{i}", hidden if i < 2 else mask_dim, hidden)
    n.linear("task_mlp.layers.0", hidden, task_len)
    n.linear("task_mlp.layers.1", hidden, hidden)
    n.table("prompt_ctx.weight", n_ctx, hidden)
    return n.sd


def synth_densepose_sd(layers: Sequence[int] = (3, 4, 6, 3), stem: int = 64, fpn: int = 256,
                       box_fc: int = 1024, head: int = 512, head_convs: int = 8,
                       aspp: int = 256, pool: int = 7, fine: int = 25, coarse: int = 2,
                       fill: FillSpec = "random", seed: int = 52) -> Dict[str, object]:
    """densepose_rcnn_R_50_FPN_DL_s1x in detectron2's keys: ResNet-50 with
    frozen BatchNorm (`backbone.bottom_up.stem`, `res2`-`res5` of 3, 4, 6, 3
    bottlenecks, widths 64→256 … 512→2048), the FPN at 256
    (`fpn_lateral2-5`, `fpn_output2-5`), the RPN head (3 anchors), the box
    head's two FCs of 1024 on 7×7 pools and its person/background predictor,
    and the DeepLab head of 512 (8 stacked 3×3 convs, CONV_HEAD_DIM 512) with
    its four 4×4 transpose-conv predictors (coarse 2, fine 25, u and v 25)
    at 28×28 pools. The head's ASPP is written as forge_tpu reads it (its
    branches ASPP1-ASPP4 and ASPP_pool at the input's 256, then `project`)
    and its convs with biases: detectron2's `ASPP.convs.N` with GroupNorm is
    a layout the reference cannot read."""
    n = _Net(fill, seed)

    def conv_bn(key, o, i, k):
        n.conv(key, o, i, k=k, bias=False)
        n.bn(key + ".norm", o)

    bu = "backbone.bottom_up."
    conv_bn(bu + "stem.conv1", stem, 3, 7)
    # the stem's statistics scaled to the caffe-style input (BGR minus the mean, std 1), as a
    # trained stem's running variance scales it
    n.sd[bu + "stem.conv1.norm.running_var"] = scaled(n.f.ones(stem), 64.0 ** 2)
    cin = stem
    for s, count in enumerate(layers):
        mid, out = stem * 2 ** s, stem * 4 * 2 ** s
        for b in range(count):
            key = f"{bu}res{s + 2}.{b}."
            conv_bn(key + "conv1", mid, cin, 1)
            conv_bn(key + "conv2", mid, mid, 3)
            conv_bn(key + "conv3", out, mid, 1)
            if b == 0:
                conv_bn(key + "shortcut", out, cin, 1)
            cin = out
    for lvl in (2, 3, 4, 5):
        n.conv(f"backbone.fpn_lateral{lvl}", fpn, stem * 4 * 2 ** (lvl - 2), k=1)
        n.conv(f"backbone.fpn_output{lvl}", fpn, fpn)
    # the RPN head and the box predictor at detectron2's initialization: N(0, 0.01²) and, the
    # box deltas, N(0, 0.001²)
    for key, o, k, std in (("conv", fpn, 3, 0.01), ("objectness_logits", 3, 1, 0.01),
                           ("anchor_deltas", 12, 1, 0.01)):
        n.sd[f"proposal_generator.rpn_head.{key}.weight"] = n.f.w(o, fpn, k, k, scale=std)
        n.sd[f"proposal_generator.rpn_head.{key}.bias"] = n.f.zeros(o)
    n.linear("roi_heads.box_head.fc1", box_fc, fpn * pool * pool)
    n.linear("roi_heads.box_head.fc2", box_fc, box_fc)
    for key, o, std in (("cls_score", 2, 0.01), ("bbox_pred", 4, 0.001)):
        n.sd[f"roi_heads.box_predictor.{key}.weight"] = n.f.w(o, box_fc, scale=std)
        n.sd[f"roi_heads.box_predictor.{key}.bias"] = n.f.zeros(o)
    dh = "roi_heads.densepose_head."
    n.conv(dh + "ASPP.ASPP1", aspp, fpn, k=1)
    for i in (2, 3, 4):
        n.conv(f"{dh}ASPP.ASPP{i}", aspp, fpn)
    n.conv(dh + "ASPP.ASPP_pool", aspp, fpn, k=1)
    n.conv(dh + "project", aspp, 5 * aspp, k=1)
    c = aspp
    for i in range(1, head_convs + 1):
        n.conv(f"{dh}body_conv_fcn{i}", head, c)
        c = head
    for name, o in (("ann_index_lowres", coarse), ("index_uv_lowres", fine), ("u_lowres", fine),
                    ("v_lowres", fine)):
        n.sd[f"roi_heads.densepose_predictor.{name}.weight"] = n.w(head, o, 4, 4)
        n.sd[f"roi_heads.densepose_predictor.{name}.bias"] = n.f.zeros(o)
    return n.sd


# U²-Net's RSU stages: (name, depth L, in, mid, out); L 4 on stage5/stage6/stage5d is RSU-4F
_U2NET_FULL = (("stage1", 7, 3, 32, 64), ("stage2", 6, 64, 32, 128), ("stage3", 5, 128, 64, 256),
               ("stage4", 4, 256, 128, 512), ("stage5", 4, 512, 256, 512),
               ("stage6", 4, 512, 256, 512), ("stage5d", 4, 1024, 256, 512),
               ("stage4d", 4, 1024, 128, 256), ("stage3d", 5, 512, 64, 128),
               ("stage2d", 6, 256, 32, 64), ("stage1d", 7, 128, 16, 64))


def synth_u2net_sd(stages=_U2NET_FULL, sides=(64, 64, 128, 256, 512, 512),
                   fill: FillSpec = "random", seed: int = 53) -> Dict[str, object]:
    """u2net.pth (xuebinqin/U-2-Net's full U2NET, as rembg ships it): the
    eleven RSU stages (`rebnconvin`, `rebnconv1..L`, `rebnconv{L-1..1}d`,
    each `conv_s1` and `bn_s1`), the six 3×3 side convs to one channel and
    the 1×1 `outconv` over the six."""
    n = _Net(fill, seed, gain=RELU_GAIN)

    def rebn(key, o, i):
        n.conv(key + ".conv_s1", o, i)
        n.bn(key + ".bn_s1", o)

    for name, depth, cin, mid, out in stages:
        rebn(f"{name}.rebnconvin", out, cin)
        rebn(f"{name}.rebnconv1", mid, out)
        for i in range(2, depth + 1):
            rebn(f"{name}.rebnconv{i}", mid, mid)
        for i in range(depth - 1, 1, -1):
            rebn(f"{name}.rebnconv{i}d", mid, 2 * mid)
        rebn(f"{name}.rebnconv1d", out, 2 * mid)
    for i, c in enumerate(sides, start=1):
        n.conv(f"side{i}", 1, c)
    n.conv("outconv", 1, len(sides), k=1)
    return n.sd


def synth_sapiens_sd(width: int = 1536, depth: int = 40, mlp: int = 6144, patch: int = 16,
                     grid=(64, 48), deconvs: Sequence[int] = (768, 768), out: int = 3,
                     final_k: int = 1, fill: FillSpec = "random",
                     seed: int = 54) -> Dict[str, object]:
    """Sapiens-1B normal estimation (sapiens_1b_normal_render_people: ViT
    width 1536, 40 blocks, 24 heads of 64, MLP 6144, patch 16, no class
    token, trained at 1024×768 so a 64×48 position grid; the VitHead's
    deconv_out_channels (768, 768) with 4×4 kernels and the final 1×1 conv to
    3 normals) in forge_tpu/models/sapiens.py's key layout, whose head has
    no slot for the VitHead's two 1×1 convs between them."""
    n = _Net(fill, seed)
    n.conv("patch_embed.proj", width, 3, k=patch)
    n.table("pos_embed", 1, grid[0] * grid[1], width)
    for i in range(depth):
        b = f"blocks.{i}."
        n.norm(b + "norm1", width)
        n.linear(b + "attn.qkv", 3 * width, width)
        n.linear(b + "attn.proj", width, width)
        n.norm(b + "norm2", width)
        n.linear(b + "mlp.fc1", mlp, width)
        n.linear(b + "mlp.fc2", width, mlp)
    n.norm("norm", width)
    c = width
    for j, o in enumerate(deconvs):
        n.sd[f"head.deconv.{j}.weight"] = n.w(c, o, 4, 4)
        n.sd[f"head.deconv.{j}.bias"] = n.f.zeros(o)
        c = o
    n.conv("head.conv", out, c, k=final_k)
    return n.sd
