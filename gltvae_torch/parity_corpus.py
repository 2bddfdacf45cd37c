"""Learnable-signal mini-CelebA corpus (counterpart of
tools/parity_corpus.py: the same bytes for the same n and seed).

Generates a CelebA-format on-disk dataset (178x218 JPEGs +
list_attr_celeba.csv in the comma format the reference parses) whose 18
'easy' attributes are VISIBLE in the pixels: attribute j controls a
colored block at a fixed grid position, so a classifier can genuinely
learn them (random-label fixtures cap accuracy at ~0.5).

Label structure: 6 latent binary factors; easy label j copies factor j%6
with 15% flip noise. That yields strong co-occurrence between labels
sharing a factor, so the 'inferred' gating init is far from identity and
the three gate schemes genuinely differ. The 22 non-easy attributes are
pure noise (the reference discards them). With 15% flip noise the
Bayes-optimal attribute accuracy (predict the factor) is 85%.

    python -m gltvae_torch.parity_corpus --out /tmp/h2h/data --n 2800

Host-only (numpy + PIL).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gltvae_torch.config import CELEBA_EASY_LABELS, CELEBA_LABELS

H, W = 218, 178
N_FACTORS = 6
FLIP_P = 0.15

# 18 visually distinct RGB colors, one per easy label
_COLORS = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180]], dtype=np.int32)


def _block_bounds(j):
    """Label j -> its block (6 rows x 3 cols grid over 218x178)."""
    r, c = divmod(j, 3)
    bh, bw = H // 6, W // 3
    return r * bh, (r + 1) * bh, c * bw, (c + 1) * bw


def render_image(y_easy, rng):
    """uint8 [H,W,3]: noisy gray background + a colored block per
    positive label (~36x59 px at full res, ~11x21 at 64x64)."""
    img = rng.randint(96, 160, (H, W, 3)).astype(np.int32)
    for j, on in enumerate(y_easy):
        if on:
            r0, r1, c0, c1 = _block_bounds(j)
            noise = rng.randint(-20, 20, (r1 - r0, c1 - c0, 3))
            img[r0:r1, c0:c1] = _COLORS[j] + noise
    return np.clip(img, 0, 255).astype(np.uint8)


def sample_labels(n, rng):
    """(easy [n,18] 0/1, full [n,40] -1/1 CSV rows)."""
    factors = rng.randint(0, 2, (n, N_FACTORS))
    flips = rng.rand(n, len(CELEBA_EASY_LABELS)) < FLIP_P
    easy = np.stack([factors[:, j % N_FACTORS]
                     for j in range(len(CELEBA_EASY_LABELS))], axis=1)
    easy = np.where(flips, 1 - easy, easy)
    easy_idx = {name: i for i, name in enumerate(CELEBA_EASY_LABELS)}
    full = rng.randint(0, 2, (n, len(CELEBA_LABELS)))
    for col, name in enumerate(CELEBA_LABELS):
        if name in easy_idx:
            full[:, col] = easy[:, easy_idx[name]]
    return easy, full * 2 - 1          # CSV uses -1/1


def generate_corpus(out_dir, n=2800, seed=0, quality=92):
    """Write img_align_celeba/*.jpg + list_attr_celeba.csv under out_dir.
    Deterministic in (n, seed). Returns (ids, easy_labels)."""
    import PIL.Image
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, 'img_align_celeba')
    os.makedirs(img_dir, exist_ok=True)
    easy, full = sample_labels(n, rng)
    lines = ['image_id,' + ','.join(CELEBA_LABELS)]
    ids = []
    for i in range(n):
        name = f'{i + 1:06d}.jpg'
        ids.append(name)
        PIL.Image.fromarray(render_image(easy[i], rng)).save(
            os.path.join(img_dir, name), quality=quality)
        lines.append(name + ',' + ','.join(map(str, full[i])))
    with open(os.path.join(out_dir, 'list_attr_celeba.csv'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ids, easy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--out', required=True)
    p.add_argument('--n', type=int, default=2800)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    ids, easy = generate_corpus(args.out, args.n, args.seed)
    print(f'{len(ids)} images -> {args.out} '
          f'(mean positive rate {easy.mean():.3f})')


if __name__ == '__main__':
    main()
