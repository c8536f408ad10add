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
tf_efficientnet_b5_ap (width ×1.6, depth ×2.2).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

from .synth import FillSpec, _Net

RELU_GAIN = math.sqrt(2.0)


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
