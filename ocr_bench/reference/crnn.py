"""TPS-ResNet-BiLSTM-Attn (Baek et al., ICCV 2019;
github.com/clovaai/deep-text-recognition-benchmark), plain PyTorch in float32
on a state dict with that repository's key names.

* TPS (RARE): a localization network of four [3x3 conv (no bias), BN, ReLU,
  2x2 max pool] units (64/128/256/512), the mean over the map, fc 512->256,
  ReLU, fc 256->2F, then the thin-plate-spline grid of the published
  GridGenerator and ``grid_sample`` (bilinear, border, ``align_corners``).
  The deep-text-recognition-benchmark network has no pool after the fourth
  unit; the system measured here has one (its reference, lightly-ocr's
  ``TPS_STN.py``), and this reference follows the system.
* ResNet feature extractor (FAN, blocks [1, 2, 5, 3], the asymmetric pools
  and the 2x2 convs of stride (2, 1)), the mean over the height.
* Two BiLSTMs, each followed by a linear 2H -> H.
* Bahdanau attention decoder: ``e = score(tanh(i2h(H) + h2h(h)))``, the
  softmax over the sequence, the context, an LSTM cell on [context;
  one-hot(previous token)], ``generator(h)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ocr_bench.reference.common import FP32, Precision, bn_eval, bn_train, conv, linear, lstm_cell

TPS_UNITS = (("0", "1", 64), ("4", "5", 128), ("8", "9", 256), ("12", "13", 512))
BLOCKS = (1, 2, 5, 3)


def _conv_spec(key, cin, cout, k, bias=False):
    kh, kw = (k, k) if isinstance(k, int) else k
    out = [(key + ".weight", (cout, cin, kh, kw), "he")]
    return out + ([(key + ".bias", (cout,), "bias")] if bias else [])


def _bn_spec(key, n):
    return [(key + ".weight", (n,), "bn_weight"), (key + ".bias", (n,), "bn_bias"),
            (key + ".running_mean", (n,), "bn_mean"), (key + ".running_var", (n,), "bn_var")]


def _linear_spec(key, n_in, n_out, bias=True):
    out = [(key + ".weight", (n_out, n_in), "he")]
    return out + ([(key + ".bias", (n_out,), "bias")] if bias else [])


def _lstm_spec(key, n_in, hidden, suffix=""):
    return [(f"{key}.weight_ih{suffix}", (4 * hidden, n_in), "lstm"),
            (f"{key}.weight_hh{suffix}", (4 * hidden, hidden), "lstm"),
            (f"{key}.bias_ih{suffix}", (4 * hidden,), "lstm"),
            (f"{key}.bias_hh{suffix}", (4 * hidden,), "lstm")]


def resnet_layout(oc: int):
    """[(block key, in, out)] of the four stages."""
    planes = [oc // 4, oc // 2, oc, oc]
    out, cin = [], oc // 8
    for s, (n, p) in enumerate(zip(BLOCKS, planes)):
        for b in range(n):
            out.append((f"layer{s + 1}.{b}", cin, p))
            cin = p
    return out


def param_spec(cfg: dict) -> list:
    """[(key, shape, kind)] of every tensor of the recognizer's state dict."""
    F_, cin, oc, hid = cfg["num_fiducial"], cfg["input_channel"], cfg["output_channel"], cfg["hidden_size"]
    C = cfg["num_classes"]
    spec = []
    t = "Transformation.LocalizationNetwork"
    c = cin
    for ci, bi, ch in TPS_UNITS:
        spec += _conv_spec(f"{t}.conv.{ci}", c, ch, 3) + _bn_spec(f"{t}.conv.{bi}", ch)
        c = ch
    spec += _linear_spec(f"{t}.localization_fc1.0", 512, 256)
    spec += [(f"{t}.localization_fc2.weight", (2 * F_, 256), "zeros"),
             (f"{t}.localization_fc2.bias", (2 * F_,), "fiducials")]
    r = "FeatureExtraction.ConvNet"
    spec += _conv_spec(f"{r}.conv0_1", cin, oc // 16, 3) + _bn_spec(f"{r}.bn0_1", oc // 16)
    spec += _conv_spec(f"{r}.conv0_2", oc // 16, oc // 8, 3) + _bn_spec(f"{r}.bn0_2", oc // 8)
    planes = [oc // 4, oc // 2, oc, oc]
    layout = resnet_layout(oc)
    for s in range(4):
        for key, bin_, p in layout:
            if not key.startswith(f"layer{s + 1}."):
                continue
            spec += _conv_spec(f"{r}.{key}.conv1", bin_, p, 3) + _bn_spec(f"{r}.{key}.bn1", p)
            spec += _conv_spec(f"{r}.{key}.conv2", p, p, 3) + _bn_spec(f"{r}.{key}.bn2", p)
            if bin_ != p:
                spec += _conv_spec(f"{r}.{key}.downsample.0", bin_, p, 1)
                spec += _bn_spec(f"{r}.{key}.downsample.1", p)
        if s < 3:
            spec += _conv_spec(f"{r}.conv{s + 1}", planes[s], planes[s], 3)
            spec += _bn_spec(f"{r}.bn{s + 1}", planes[s])
    spec += _conv_spec(f"{r}.conv4_1", oc, oc, 2) + _bn_spec(f"{r}.bn4_1", oc)
    spec += _conv_spec(f"{r}.conv4_2", oc, oc, 2) + _bn_spec(f"{r}.bn4_2", oc)
    n = oc
    for i in range(2):
        key = f"SequenceModeling.{i}"
        spec += _lstm_spec(f"{key}.rnn", n, hid, "_l0") + _lstm_spec(f"{key}.rnn", n, hid, "_l0_reverse")
        spec += _linear_spec(f"{key}.linear", 2 * hid, hid)
        n = hid
    a = "Prediction.attention_cell"
    spec += _linear_spec(f"{a}.i2h", n, hid, bias=False) + _linear_spec(f"{a}.h2h", hid, hid)
    spec += _linear_spec(f"{a}.score", hid, 1, bias=False)
    spec += [(f"{a}.rnn.weight_ih", (4 * hid, n + C), "lstm"), (f"{a}.rnn.weight_hh", (4 * hid, hid), "lstm"),
             (f"{a}.rnn.bias_ih", (4 * hid,), "lstm"), (f"{a}.rnn.bias_hh", (4 * hid,), "lstm")]
    spec += _linear_spec("Prediction.generator", hid, C)
    return spec


def fiducials(F_: int) -> np.ndarray:
    """RARE's initial fiducials (the localization head's bias): the top
    edge from y = 0 to -1, the bottom from 1 to 0, flattened (x, y)."""
    half = F_ // 2
    x = np.linspace(-1.0, 1.0, half)
    top = np.stack([x, np.linspace(0.0, -1.0, half)], axis=1)
    bottom = np.stack([x, np.linspace(1.0, 0.0, half)], axis=1)
    return np.concatenate([top, bottom]).reshape(-1).astype(np.float32)


def tps_grid_constants(F_: int, h: int, w: int, eps: float = 1e-6):
    """(inv_delta_C [F+3, F+3], P_hat [h*w, F+3]) of the GridGenerator,
    in float64."""
    half = F_ // 2
    x = np.linspace(-1.0, 1.0, half)
    C = np.concatenate([np.stack([x, -np.ones(half)], 1), np.stack([x, np.ones(half)], 1)])
    hat_C = np.linalg.norm(C[:, None] - C[None], axis=2)
    np.fill_diagonal(hat_C, 1.0)
    hat_C = hat_C ** 2 * np.log(hat_C)
    delta_C = np.block([
        [np.ones((F_, 1)), C, hat_C],
        [np.zeros((2, 3)), C.T],
        [np.zeros((1, 3)), np.ones((1, F_))],
    ])
    gx = (np.arange(-w, w, 2) + 1.0) / w
    gy = (np.arange(-h, h, 2) + 1.0) / h
    P = np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)
    r = np.linalg.norm(P[:, None] - C[None], axis=2)
    P_hat = np.concatenate([np.ones((len(P), 1)), P, r ** 2 * np.log(r + eps)], axis=1)
    return np.linalg.inv(delta_C), P_hat


class CRNN:
    """The recognizer on ``sd``; ``train`` normalises with the batch's
    statistics, else with the running ones."""

    def __init__(self, sd: dict, cfg: dict, p: Precision = FP32, train: bool = False):
        self.sd, self.cfg, self.p, self.train = sd, cfg, p, train
        w = sd["FeatureExtraction.ConvNet.conv0_1.weight"]
        self.dtype = w.dtype  # float32, or float64 for a witness
        inv, P_hat = tps_grid_constants(cfg["num_fiducial"], cfg["height"], cfg["width"])
        self.inv_delta_C = torch.tensor(inv, dtype=w.dtype, device=w.device)
        self.P_hat = torch.tensor(P_hat, dtype=w.dtype, device=w.device)

    def bn(self, key, x):
        return (bn_train if self.train else bn_eval)(self.sd, key, x)

    def cbr(self, key, bn_key, x, relu=True, **kw):
        y = self.bn(bn_key, conv(self.sd, key, x, self.p, **kw))
        return F.relu(y) if relu else y

    def tps(self, x):
        t = "Transformation.LocalizationNetwork"
        y = x
        for ci, bi, _ in TPS_UNITS:
            y = F.max_pool2d(self.cbr(f"{t}.conv.{ci}", f"{t}.conv.{bi}", y, padding=1), 2, 2)
        y = F.relu(linear(self.sd, f"{t}.localization_fc1.0", y.mean(dim=(2, 3)), self.p))
        c_prime = linear(self.sd, f"{t}.localization_fc2", y, self.p).view(x.shape[0], -1, 2)
        c_prime = torch.cat([c_prime, c_prime.new_zeros(x.shape[0], 3, 2)], 1)
        grid = self.P_hat @ (self.inv_delta_C @ c_prime)
        grid = grid.view(x.shape[0], self.cfg["height"], self.cfg["width"], 2)
        return F.grid_sample(x, grid, padding_mode="border", align_corners=True)

    def resnet(self, x):
        r = "FeatureExtraction.ConvNet"
        x = self.cbr(f"{r}.conv0_1", f"{r}.bn0_1", x, padding=1)
        x = self.cbr(f"{r}.conv0_2", f"{r}.bn0_2", x, padding=1)
        pools = [lambda v: F.max_pool2d(v, 2, 2), lambda v: F.max_pool2d(v, 2, 2),
                 lambda v: F.max_pool2d(v, 2, (2, 1), (0, 1)), lambda v: v]
        for s in range(4):
            x = pools[s](x)
            for key, cin, planes in resnet_layout(self.cfg["output_channel"]):
                if not key.startswith(f"layer{s + 1}."):
                    continue
                k = f"{r}.{key}"
                y = self.cbr(f"{k}.conv1", f"{k}.bn1", x, padding=1)
                y = self.cbr(f"{k}.conv2", f"{k}.bn2", y, relu=False, padding=1)
                res = x if cin == planes else self.cbr(f"{k}.downsample.0", f"{k}.downsample.1", x, relu=False)
                x = F.relu(y + res)
            if s < 3:
                x = self.cbr(f"{r}.conv{s + 1}", f"{r}.bn{s + 1}", x, padding=1)
        x = self.cbr(f"{r}.conv4_1", f"{r}.bn4_1", x, stride=(2, 1), padding=(0, 1))
        return self.cbr(f"{r}.conv4_2", f"{r}.bn4_2", x)

    def bilstm(self, key, x):
        sd, p = self.sd, self.p
        B, T, _ = x.shape
        hid = self.cfg["hidden_size"]
        outs = []
        for suffix, steps in (("_l0", range(T)), ("_l0_reverse", range(T - 1, -1, -1))):
            w = [sd[f"{key}.rnn.{n}{suffix}"] for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            h = x.new_zeros(B, hid)
            c = x.new_zeros(B, hid)
            seq = [None] * T
            for t in steps:
                h, c = lstm_cell(x[:, t], h, c, *w, p=p)
                seq[t] = h
            outs.append(torch.stack(seq, 1))
        return linear(sd, f"{key}.linear", torch.cat(outs, -1), p)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 1] in [-1, 1] -> the decoder's [B, T, hidden] states."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = self.resnet(self.tps(x))
        x = x.mean(dim=2).transpose(1, 2)
        for i in range(2):
            x = self.bilstm(f"SequenceModeling.{i}", x)
        return x

    def decode_forced(self, feats: torch.Tensor, fed: torch.Tensor) -> torch.Tensor:
        """Teacher forcing: step s is fed token ``fed[:, s]`` ([GO] = 0 at
        step 0) -> logits [B, S, classes] for S = ``fed.shape[1]``."""
        sd, p = self.sd, self.p
        a = "Prediction.attention_cell"
        C = self.cfg["num_classes"]
        B = feats.shape[0]
        proj = linear(sd, f"{a}.i2h", feats, p)
        w = [sd[f"{a}.rnn.{n}"] for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h = feats.new_zeros(B, self.cfg["hidden_size"])
        c = feats.new_zeros(B, self.cfg["hidden_size"])
        hs = []
        for s in range(fed.shape[1]):
            e = linear(sd, f"{a}.score", torch.tanh(proj + linear(sd, f"{a}.h2h", h, p)[:, None]), p)
            context = (torch.softmax(e, dim=1) * feats).sum(1)
            x = torch.cat([context, F.one_hot(fed[:, s].long(), C).to(feats.dtype)], -1)
            h, c = lstm_cell(x, h, c, *w, p=p)
            hs.append(h)
        return linear(sd, "Prediction.generator", torch.stack(hs, 1), p)

    def forced_logits(self, images: torch.Tensor, fed: torch.Tensor) -> torch.Tensor:
        return self.decode_forced(self.encode(images), fed)


def attention_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``CrossEntropyLoss(ignore_index=0)`` of the attention head."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
                           ignore_index=0)
