"""Render latent traversals, reconstructions and attribute-conditioned
samples as one tiled PNG (counterpart of tools/render.py).

    python -m gltvae_torch.render --mode traversal --out traversal.png \\
        [--checkpoint <port run folder> | --ref-checkpoint <.h5 folder>] \\
        [--anchor zeros|prior --labels Male,Smiling --seed 0] \\
        [--dims 27 28 ...] [--n-steps 8] [--lo -3 --hi 3] [--device cpu]
    python -m gltvae_torch.render --mode reconstruct --n 8 --out recon.png
    python -m gltvae_torch.render --mode conditional --labels Male,Smiling \\
        --n 8 --out samples.png

The model is a port run folder's (``--checkpoint``, its
``model_config.json`` when there is one), a reference-format .h5 folder's
(``--ref-checkpoint``, the CelebA-64 model) or a fresh init (seed 0).

- ``traversal``: one row per swept dimension (default: the z_classify
  dims), ``--n-steps`` columns from ``--lo`` to ``--hi``. The anchor is
  z = 0 (``zeros``, fine for a fresh init) or ``prior``: z_classify at the
  conditional prior mean p(z|y) for ``--labels`` with expected gates, and
  z_style 0 at ``--seed 0``, else drawn from N(0, I). Trained weights
  need ``prior``: their ReLU'd posterior means never visit z = 0.
- ``reconstruct``: ``--n`` images of ``synthetic_celeba(n, seed)``,
  dequantized in the divide form, over their reconstructions.
- ``conditional``: ``--n`` samples of ``sample_conditional`` at gate
  temperature 0.3.

The draws (the prior anchor's z_style, the conditional samples) come from
torch generators seeded by ``--seed``; they cannot replay the JAX
package's threefry draws, so the tests inject those instead. The grid is
tiled with numpy as ``tools/render.py``'s ``save_grid`` tiles it and saved
with PIL, one pixel per image pixel.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def save_grid(images: np.ndarray, path: str) -> None:
    """(rows, cols, H, W, C) float in [0, 1] -> one PNG of (rows·H,
    cols·W, C) pixels."""
    from PIL import Image
    r, c, h, w, ch = images.shape
    tile = images.transpose(0, 2, 1, 3, 4).reshape(r * h, c * w, ch)
    Image.fromarray(np.round(np.clip(tile, 0, 1) * 255).astype(np.uint8)
                    ).save(path)


def label_vector(y_dim: int, labels: Sequence[str], n: int) -> torch.Tensor:
    """(n, y_dim) float32 with the named attributes on."""
    from gltvae_torch.infer import attribute_names
    names = attribute_names(y_dim)
    y = torch.zeros((n, y_dim), dtype=torch.float32)
    for name in labels:
        y[:, names.index(name)] = 1.0
    return y


@torch.no_grad()
def prior_anchor(model, labels: Sequence[str], seed: int = 0,
                 eps_zs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(z_dim,) anchor: z_style, then z_classify at the conditional prior
    mean for `labels` with expected gates. z_style is `eps_zs` when given,
    else 0 at seed 0, else N(0, I) from a CPU generator seeded by `seed`
    (the same on every device)."""
    from gltvae_torch.ops.sampling import sample_gating_deterministic
    cfg, dev = model.cfg, model.mu.device
    y = label_vector(cfg.y_dim, labels, 1).to(dev)
    locs, _ = model.prior_zc(y, sample_gating_deterministic(model.mu))
    if eps_zs is None:
        eps_zs = (torch.zeros(cfg.z_style) if seed == 0 else
                  torch.randn(cfg.z_style,
                              generator=torch.Generator().manual_seed(seed)))
    return torch.cat([eps_zs.to(dev, torch.float32), locs[0]])


def traversal(model, dims: Optional[Sequence[int]] = None,
              anchor: str = 'zeros', labels: Sequence[str] = (),
              seed: int = 0, n_steps: int = 8, lo: float = -3.0,
              hi: float = 3.0) -> torch.Tensor:
    """The traversal mode's (D, S, H, W, C) grid."""
    from gltvae_torch.eval.traversal import latent_traversal
    cfg = model.cfg
    dims = list(dims) if dims else list(range(cfg.z_style, cfg.z_dim))
    z_base = prior_anchor(model, labels, seed) if anchor == 'prior' else None
    return latent_traversal(model, z_base=z_base, n_steps=n_steps, dims=dims,
                            lo=lo, hi=hi)


@torch.no_grad()
def reconstruct(model, n: int, seed: int = 0) -> torch.Tensor:
    """The reconstruct mode's (2, n, H, W, C) grid: inputs over their
    reconstructions."""
    from gltvae_torch.data.synthetic import synthetic_celeba
    from gltvae_torch.ops.preprocess import dequant
    ds = synthetic_celeba(n, image_size=model.cfg.image_size, seed=seed)
    x = dequant(torch.from_numpy(ds.images).to(model.mu.device), 'div')
    return torch.stack([x, model.reconstruct(x)])


@torch.no_grad()
def conditional(model, labels: Sequence[str], n: int, seed: int = 0,
                noise: Optional[dict] = None) -> torch.Tensor:
    """The conditional mode's (1, n, H, W, C) grid at gate temperature
    0.3; the draws come from `noise` (g1, g2, eps_zc, eps_zs) where given,
    else from a generator on the model's device seeded by `seed`."""
    from gltvae_torch.models.ccvae import Temps
    dev = model.mu.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    y = label_vector(model.cfg.y_dim, labels, n).to(dev)
    return model.sample_conditional(y, Temps(gating=0.3), noise=noise,
                                    generator=gen)[None]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--mode', default='traversal',
                   choices=['traversal', 'reconstruct', 'conditional'])
    p.add_argument('--out', required=True, help='PNG path')
    p.add_argument('--checkpoint', default=None,
                   help='port run folder (omit for a fresh init)')
    p.add_argument('--ref-checkpoint', default=None,
                   help='reference-format folder of *_best.h5 files')
    p.add_argument('--dims', type=int, nargs='*', default=None)
    p.add_argument('--n-steps', type=int, default=8)
    p.add_argument('--anchor', default='zeros', choices=['zeros', 'prior'],
                   help="traversal anchor: 'zeros' (z = 0) or 'prior' "
                        '(z_classify at the conditional prior mean for '
                        '--labels; needed for trained weights)')
    p.add_argument('--lo', type=float, default=-3.0)
    p.add_argument('--hi', type=float, default=3.0)
    p.add_argument('--labels', default='',
                   help='comma-separated attribute names to switch on')
    p.add_argument('--n', type=int, default=8)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def load(args, device):
    """The CCVAE to render: from --ref-checkpoint, --checkpoint or a fresh
    init (CelebA-64, seed 0)."""
    from gltvae_torch import infer
    from gltvae_torch.config import ModelConfig, apply_precision
    from gltvae_torch.models.ccvae import CCVAE
    folder = args.ref_checkpoint or args.checkpoint
    if folder is None:
        cfg = ModelConfig()
        apply_precision(cfg)
        model = CCVAE(cfg, mu_init=np.eye(cfg.z_classify, cfg.y_dim,
                                          dtype=np.float32),
                      generator=torch.Generator().manual_seed(0))
        return model.to(device).eval()
    ns = argparse.Namespace(checkpoint=folder, model_id='best',
                            image_size=None, gate_type=None,
                            gate_subtype=None, z_dim=None, mu=None)
    return infer.load_model(ns, infer.resolve_model_config(ns), device)


def main(argv=None):
    args = parse_args(argv)
    from gltvae_torch import resolve_device
    model = load(args, resolve_device(args.device))
    labels = [s for s in args.labels.split(',') if s]
    if args.mode == 'traversal':
        grid = traversal(model, args.dims, args.anchor, labels, args.seed,
                         args.n_steps, args.lo, args.hi)
    elif args.mode == 'reconstruct':
        grid = reconstruct(model, args.n, args.seed)
    else:
        grid = conditional(model, labels, args.n, args.seed)
    save_grid(grid.cpu().numpy(), args.out)
    print(f'wrote {args.out}')
    return args.out


if __name__ == '__main__':
    main()
