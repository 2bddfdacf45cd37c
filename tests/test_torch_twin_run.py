"""The port's whole training run against train.py's, given gltvae's draws.

``tests/torch_f2_twin.py`` trains the fixed/one-one cell through the port's
CLI from gltvae's initial parameters with gltvae's per-step noise and eval
draws injected, and through train.py in the same process. On a small
parity corpus the two runs agree epoch by epoch: the loaders' order, the
schedule, the step, the eval, the best-checkpoint choice and the test are
the same, so what the two frameworks' runs of the cell do not share is
their random draws and their rounding.
"""

import pytest

from tests import torch_f2_twin as twin


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp('twin')
    return twin.main(['--workdir', str(workdir), '--seeds', '0', '--n', '70',
                      '--epochs', '3', '--legs', 'twin', 'gltvae'])[0]


def test_twin_has_one_validation_a_epoch_and_a_test(runs):
    for leg in ('twin', 'gltvae'):
        assert len(runs[leg]['val']) == 3
        assert runs[leg]['test']['accuracy'] == runs[leg]['test_accuracy']


@pytest.mark.parametrize('epoch', range(3))
def test_twin_validation_follows_gltvae(runs, epoch):
    ours, theirs = runs['twin']['val'][epoch], runs['gltvae']['val'][epoch]
    assert ours['accuracy'] == pytest.approx(theirs['accuracy'], abs=1e-6)
    assert ours['dead'] == theirs['dead']


def test_twin_test_accuracy_equals_gltvae(runs):
    assert runs['twin']['test_accuracy'] == pytest.approx(
        runs['gltvae']['test_accuracy'], abs=1e-6)
