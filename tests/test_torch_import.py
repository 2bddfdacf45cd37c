"""gltvae_torch stands alone: no JAX, nothing of gltvae or of the JAX
package's tools and scripts (tools/, train.py, bench.py), no grain,
tensorflow or tensorboard (each imports JAX or tensorflow), and no silent
fall-back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'gltvae_torch'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gltvae', 'grain',
             'tensorflow', 'tensorboard', 'tools', 'train', 'bench'}

MODULES = sorted(
    '.'.join(p.relative_to(ROOT).with_suffix('').parts).replace(
        '.__init__', '')
    for p in PKG.rglob('*.py'))


def test_import_loads_no_jax_and_nothing_of_gltvae():
    code = (
        'import importlib, sys\n'
        f'for m in {MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f'{sorted(FORBIDDEN)!r})\n'
        'print(len(sys.modules)); assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(MODULES) >= 16


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py'))
                         + [ROOT / 'chip_smoke.py'],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imports(path) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


def test_entry_points_raise_without_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this checks a machine without a CUDA device')
    from gltvae_torch import resolve_device
    from gltvae_torch import cli
    from gltvae_torch.config import ModelConfig, TrainConfig
    from gltvae_torch.train.loop import Trainer
    cfg = ModelConfig(image_size=16, z_dim=8, y_dim=4, enc_features=(8, 8),
                      enc_hidden=16, dec_features=(16, 8), gate_type='fixed',
                      gate_subtype='one-one')
    for dev in (None, 'cuda'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, TrainConfig(), device=dev)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(['--synthetic', '--synthetic-n', '16', '--no-test',
                  '--sup', '1.0', '--output-dir', str(tmp_path)])
    assert Trainer(cfg, TrainConfig(), device='cpu').device.type == 'cpu'
    assert resolve_device('cpu') == torch.device('cpu')


@pytest.mark.parametrize('module', [
    'gltvae_torch.data.pipeline', 'gltvae_torch.data.celeba',
    'gltvae_torch.data.native_loader', 'gltvae_torch.ops.gating',
    'gltvae_torch.eval.analysis', 'gltvae_torch.infer', 'gltvae_torch.cli',
    'gltvae_torch.eval.traversal', 'gltvae_torch.utils.h5_import',
    'gltvae_torch.utils.h5_export', 'gltvae_torch.utils.serving',
    'gltvae_torch.render', 'gltvae_torch.export_h5',
    'gltvae_torch.export_serving', 'gltvae_torch.ops.preprocess',
    'gltvae_torch.data.grain_loader', 'gltvae_torch.utils.tb_events',
    'gltvae_torch.train.metrics', 'gltvae_torch.utils.debug_nans',
    'gltvae_torch.bench', 'gltvae_torch.gen_gating_matrix',
    'gltvae_torch.analyze_gating', 'gltvae_torch.metrics_summary',
    'gltvae_torch.eval_reference_checkpoints',
    'gltvae_torch.repro_reference', 'gltvae_torch.parity_corpus',
    'gltvae_torch.seed_panel', 'gltvae_torch.bench_data',
    'gltvae_torch.profile_step', 'gltvae_torch.config'])
def test_data_layer_and_infer_import_alone(module):
    """Each module of the data layer, batch inference, interchange,
    serving, metrics, the bench, the tools and the config, imported alone in a fresh interpreter
    with the forbidden packages blocked (importing them raises), loads none
    of them; nothing is built at import (the native pool builds on first
    use)."""
    assert module in MODULES
    block = ''.join(f'sys.modules[{m!r}] = None\n' for m in sorted(FORBIDDEN))
    code = ('import sys\n' + block +
            f'import importlib; importlib.import_module({module!r})\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f'{sorted(FORBIDDEN)!r} and sys.modules[m] is not None)\n'
            'from gltvae_torch.data import native_loader as n\n'
            'assert n._lib is None\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
