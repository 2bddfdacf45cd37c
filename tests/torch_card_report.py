"""The evidence behind chip_smoke.py's card-vs-CPU limits (phases 6 and 10).

    python tests/torch_card_report.py        (needs a CUDA card; no JAX)

It runs as a file, not with ``-m``: an installed package named ``tests``
would shadow this directory. For chip_smoke.py's plain and augmented
set-ups (the full-width CelebA-64 model, bs 256) it runs chip_smoke's own
``card_vs_cpu`` check REPEATS times with cuDNN's default algorithm choice
(which changes from run to run), once with ``cudnn.deterministic`` (one
fixed set), and once with TF32 on, as a control: TF32 rounds the inputs of
every conv and matmul to 10 mantissa bits, and the check must fail it.
Each run prints chip_smoke's line and the checks it failed. Exits non-zero
if an f32 run fails or the control passes.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke
from gltvae_torch.config import apply_precision, default_celeba64
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops import preprocess
from gltvae_torch.ops.gating import cooccurrence_gating_matrix

B = chip_smoke.BATCH
REPEATS = 4


def setups():
    """chip_smoke's phase 6 and phase 10 inputs."""
    model_cfg, train_cfg = default_celeba64(sup=0.5, n_epochs=2,
                                            batch_size=B)
    out = {}
    for name, pad in (('plain', 0), ('augmented', 4)):
        sp = synthetic_splits(n_train=2048, n_valid=512, n_test=512,
                              sup_frac=0.5, learnable_signal=True,
                              train_pad=pad)
        draws = None
        if pad:
            g = torch.Generator().manual_seed(2)
            size = model_cfg.image_size + 2 * pad
            draws = [torch.stack(v) for v in zip(*(
                preprocess.draw_crop_flip(g, B, size, size,
                                          model_cfg.image_size)
                for _ in range(2)))]
        out[name] = (model_cfg, train_cfg,
                     cooccurrence_gating_matrix(sp['sup'].labels),
                     [(sp[k].images[:B], sp[k].labels[:B])
                      for k in ('sup', 'unsup')], draws)
    return out


def main():
    if not torch.cuda.is_available():
        print('torch_card_report: needs a CUDA card', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    failed = []
    chip_smoke.check = lambda ok, msg: ok or failed.append(msg)
    print(f'card {torch.cuda.get_device_name(0)}, torch {torch.__version__}, '
          f'{torch.get_num_threads()} CPU threads', flush=True)
    runs = [('default', False, False)] * REPEATS + [
        ('deterministic', True, False), ('TF32 control', False, True)]
    bad = []
    for name, (model_cfg, train_cfg, mu, batches, draws) in setups().items():
        for mode, det, tf32 in runs:
            apply_precision(model_cfg)
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            del failed[:]
            chip_smoke.card_vs_cpu(f'{name}, {mode}', 'check', model_cfg,
                                   train_cfg, mu, batches, dev, lambda: None,
                                   draws=draws)
            print(f'  failed: {failed}', flush=True)
            if bool(failed) != tf32:
                bad.append(f'{name}, {mode}')
    apply_precision(model_cfg)
    torch.backends.cudnn.deterministic = False
    print(f'runs against expectation: {bad}', flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
