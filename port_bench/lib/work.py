"""The work a scoring call needs, in operations and bytes, from shapes.

What the mathematics needs, not what a plan issues, so the count is the
same whichever plan or split the program runs: an FFT of n points is
5 n log2 n operations; the mel counts its filters' nonzero taps; the
contrast tails count as selections (a pass over the band's bins for each
tail); a transcendental counts as one operation. Each input byte is read
once and each output byte written once. Launch A: framing, window, FFT,
power, mel (pre-emphasis too where on). Launch B: the mel branch (dB or
PCEN), MFCCs and their deltas. Launch C: the contrast rows of both
windows' spectra. The classifier: its convolutions, norms, activations,
pools and dense layers from the layer shapes, its input, weights and
logits as bytes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from ..reference import frontend as ref
from ..reference.models import ARCHITECTURES, _res_layers, param_shapes

Work = Tuple[float, float]  # (operations, bytes)


def fft_ops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def frontend_launches(cfg: Dict, batch: int) -> Dict[str, Work]:
    """{"A", "B"[, "C"]} -> (operations, bytes) for `batch` clips of the
    feature configuration `cfg`."""
    s = int(cfg["sample_rate"] * cfg["segment_duration"])
    t = ref.num_frames(cfg)
    n, m, c = cfg["n_fft"], cfg["n_mels"], cfg["n_mfcc"]
    nf = n // 2 + 1
    taps = int(np.count_nonzero(ref.mel_bank(nf, m, cfg["sample_rate"], cfg["f_min"], cfg["f_max"])))
    a_ops = t * (cfg["win_length"] + fft_ops(n) + 3 * nf + 2 * taps)
    if cfg["use_pre_emphasis"]:
        a_ops += 2 * s
    a_bytes = 4 * (s + t * m)

    b_ops = t * m * (21 if cfg["use_pcen"] else 7)
    rows = m
    if cfg["use_mfcc"]:
        orders = 3 if cfg["use_delta_delta"] else 2
        b_ops += t * (2 * m + 2 * m * c) + 6 * t * c + 2 * (orders - 1) * t * c
        rows += orders * c
    b_bytes = 4 * (t * m + t * rows)
    out = {"A": (batch * a_ops, batch * a_bytes), "B": (batch * b_ops, batch * b_bytes)}

    if cfg["use_spectral_contrast"]:
        k = cfg["n_contrast_bands"]
        edges = ref.band_edges(nf, k)
        widths = [min(max(int(edges[i + 1]), int(edges[i]) + 1), nf) - int(edges[i]) for i in range(k)]
        per_frame = (cfg["win_length"] + n + 2 * fft_ops(n) + 3 * nf + 4 * nf
                     + sum(2 * w + 3 for w in widths) + 3 * nf + 2)
        c_ops = t * per_frame + 6 * t * (k + 1)
        out["C"] = (batch * c_ops, batch * 4 * (s + t * (k + 1)))
    return out


def feature_shape(cfg: Dict) -> Tuple[int, int]:
    h = cfg["n_mels"]
    if cfg["use_mfcc"]:
        h += cfg["n_mfcc"] * (3 if cfg["use_delta_delta"] else 2)
    if cfg["use_spectral_contrast"]:
        h += cfg["n_contrast_bands"] + 1
    return h, ref.num_frames(cfg)


def _conv_out(h: int, w: int, k: int, stride: int, pad: int) -> Tuple[int, int]:
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def classifier_ops(model_type: str, h: int, w: int) -> float:
    """Operations of one clip's forward pass at a (h, w) feature image."""
    ops, ch = 0.0, 1

    def conv(args, h, w):
        cin, cout, k, stride, pad, groups = args
        ho, wo = _conv_out(h, w, k, stride, pad)
        return (2 * cin // groups * k * k + 1) * cout * ho * wo, cout, ho, wo

    for op, key, args in ARCHITECTURES[model_type]:
        if op == "conv":
            n, ch, h, w = conv(args, h, w)
            ops += n
        elif op == "bn":
            ops += 2 * ch * h * w
        elif op == "relu":
            ops += ch * (h * w if h else 1)
        elif op == "pool":
            h, w = h // 2, w // 2
            ops += 3 * ch * h * w
        elif op == "res":
            c1, b1, c2, b2, s0, s1 = _res_layers(key, *args)
            n1, ch1, h1, w1 = conv(c1[2], h, w)
            n2, _, _, _ = conv(c2[2], h1, w1)
            n3, _, _, _ = conv(s0[2], h, w)
            ch, h, w = ch1, h1, w1
            ops += n1 + n2 + n3 + 3 * 2 * ch * h * w + 3 * ch * h * w
        elif op == "gap":
            ops += ch * h * w
            h = w = 0
        elif op == "linear":
            fin, fout = args
            ops += 2 * fin * fout + fout
            ch = fout
    return float(ops)


def classifier(model_type: str, cfg: Dict, batch: int) -> Work:
    """(operations, bytes) of the classifier over `batch` clips: the
    feature images read, the weights read once, the logits written."""
    h, w = feature_shape(cfg)
    params = sum(int(np.prod(s)) for kind, s, _ in param_shapes(model_type).values() if kind != "count")
    return batch * classifier_ops(model_type, h, w), 4.0 * (batch * (h * w + 2) + params)
