"""The operations a step needs, counted from a configuration's shapes.

A k x k convolution costs 2·k²·Cin·Cout multiply-adds' worth of FLOPs
per output pixel; a transposed one the same per input pixel; a dense
layer 2·in·out per row. The count is the model's, whatever implements
it: the space-to-depth forms regroup the same products and count as the
plain convolutions, and recomputation (remat) is not counted. A train
step's backward is twice its forward, but for the first convolution,
whose input needs no gradient (its weight gradient only).
"""

from __future__ import annotations

from typing import List, Tuple


def layers(model: dict) -> List[Tuple[str, float]]:
    """(name, forward FLOPs per image) of every conv and dense layer of
    the encoder and decoder."""
    s, c = model['image_size'], model['channels']
    out = []
    cin, h = c, s
    for i, f in enumerate(model['enc_features']):
        h //= 2
        out.append((f'encoder.conv{i + 1}', 2.0 * h * h * cin * f * 16))
        cin = f
    if h != 4:
        raise ValueError(f'the encoder ends at {h}x{h}, not 4x4')
    hid = model['enc_hidden']
    out.append((f'encoder.conv{len(model["enc_features"]) + 1}',
                2.0 * cin * hid * 16))
    z = model['z_dim']
    out.append(('encoder.heads', 2.0 * 2 * hid * z))
    dh = model.get('dec_hidden') or z
    out.append(('decoder.fc1', 2.0 * z * dh))
    feats = list(model['dec_features']) + [c]
    out.append(('decoder.conv1t', 2.0 * dh * feats[0] * 16))
    h = 4
    for i in range(1, len(feats)):
        out.append((f'decoder.conv{i + 1}t',
                    2.0 * h * h * feats[i - 1] * feats[i] * 16))
        h *= 2
    if h != s:
        raise ValueError(f'the decoder ends at {h}x{h}, not {s}x{s}')
    return out


def _heads(model: dict, supervised: bool, k: int) -> float:
    """The classifier (once, once detached and k times for the marginal
    when supervised) and the conditional prior's four products, per
    image."""
    y = model['y_dim']
    rows = (2 + k) if supervised else 1
    return 2.0 * y * y * rows + 4 * 2.0 * y * y


def train_step(model: dict, batch: int, supervised: bool, k: int) -> float:
    """FLOPs of one train step of `batch` images."""
    ls = layers(model)
    fwd = sum(f for _, f in ls) + _heads(model, supervised, k)
    return batch * (3.0 * fwd - ls[0][1])


def eval_image(model: dict) -> float:
    """FLOPs of one image of the stochastic eval: the encoder and one
    classifier product."""
    enc = sum(f for n, f in layers(model) if n.startswith('encoder'))
    return enc + 2.0 * model['y_dim'] ** 2
