"""TensorBoard events of the port's MetricsLogger (gltvae_torch.utils.
tb_events, no tensorflow) against gltvae's (tf.summary): the same rows
read back through tensorboard's EventAccumulator give the same tags, steps
and f32 values (tolerance 0). Also: the records' CRCs, the reader against
TF's own file, and no writer without a directory."""

import numpy as np
import pytest
import torch

from gltvae_torch.train.metrics import MetricsLogger
from gltvae_torch.utils import tb_events

ROWS = [
    (0, {'loss': 1.5, 'elbo': -1.5, 'kl': 3e-9, 'c_sum': 17.0}, 0, 1),
    (3, {'loss': 2.75, 'elbo': -2.75e6, 'kl': -0.1, 'c_sum': 0.0}, 0, 0),
    (50, {'loss': 1 / 3, 'elbo': 123456.789, 'kl': 1e-30, 'c_sum': 5.5},
     1, 1),
]


def _log_port(logdir, flush_every=50):
    lg = MetricsLogger(None, flush_every=flush_every, tensorboard_dir=logdir)
    for step, met, epoch, sup in ROWS:
        lg.log(step, {k: torch.tensor(v, dtype=torch.float32)
                      for k, v in met.items()}, epoch=epoch, supervised=sup)
    lg.flush()
    return lg


def _accumulated(logdir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    from tensorboard.util import tensor_util
    ea = EventAccumulator(str(logdir), size_guidance={'tensors': 0})
    ea.Reload()
    return {tag: [(e.step, tensor_util.make_ndarray(e.tensor_proto).dtype,
                   float(tensor_util.make_ndarray(e.tensor_proto)))
                  for e in ea.Tensors(tag)]
            for tag in ea.Tags()['tensors']}


def test_events_equal_gltvae_through_event_accumulator(tmp_path):
    pytest.importorskip('tensorflow')
    pytest.importorskip('tensorboard')
    from gltvae.train.metrics import MetricsLogger as JLogger
    jl = JLogger(None, tensorboard_dir=str(tmp_path / 'gltvae'))
    for step, met, epoch, sup in ROWS:
        jl.log(step, {k: np.float32(v) for k, v in met.items()},
               epoch=epoch, supervised=sup)
    jl.flush()
    _log_port(str(tmp_path / 'port'), flush_every=2)    # two flushes
    got, want = (_accumulated(tmp_path / w) for w in ('port', 'gltvae'))
    assert set(want) == {'loss', 'elbo', 'kl', 'c_sum', 'epoch',
                         'supervised'}
    assert got == want
    for tag, evs in got.items():
        assert [s for s, _, _ in evs] == [r[0] for r in ROWS]
        assert all(dt == np.float32 for _, dt, _ in evs)
    # the port's reader reads TF's file as EventAccumulator does
    read = tb_events.read_scalars(str(tmp_path / 'gltvae'))
    assert read == {t: [(s, v) for s, _, v in evs] for t, evs in want.items()}


def test_port_file_records_pass_their_crcs(tmp_path):
    _log_port(str(tmp_path))
    path, = tmp_path.iterdir()
    name = path.name.split('.')
    assert name[:3] == ['events', 'out', 'tfevents'] and name[-2:] == [
        '0', 'v2'] and name[3].isdigit()
    events = tb_events.read_events(str(path))
    assert events[0]['file_version'] == tb_events.FILE_VERSION
    scalars = [e for e in events if e['scalars']]
    assert len(scalars) == 6 * len(ROWS)          # one event per tag
    assert all(len(e['scalars']) == 1 for e in scalars)
    assert tb_events.read_scalars(str(tmp_path))['kl'] == [
        (s, float(np.float32(m['kl']))) for s, m, _, _ in ROWS]
    data = bytearray(path.read_bytes())
    for at in (3, 9, len(data) - 9, len(data) - 2):   # length, payload, crc
        bad = tmp_path / f'bad{at}'
        bad.write_bytes(bytes(data[:at]) + bytes([data[at] ^ 1])
                        + bytes(data[at + 1:]))
        with pytest.raises(ValueError, match='CRC|truncated'):
            tb_events.read_events(str(bad))
    assert tb_events.crc32c(b'123456789') == 0xE3069283   # RFC 3720


def test_no_writer_without_a_directory(tmp_path, monkeypatch):
    made = []
    real = tb_events.EventFileWriter.__init__
    monkeypatch.setattr(tb_events.EventFileWriter, '__init__',
                        lambda self, d: (made.append(d), real(self, d))[1])
    lg = MetricsLogger(str(tmp_path / 'm.csv'))
    lg.log(0, {'loss': torch.tensor(1.0)})
    lg.flush()
    assert not made and lg._tb is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ['m.csv']
    # with a directory: made at construction, the writer at the first flush
    lg = MetricsLogger(None, tensorboard_dir=str(tmp_path / 'tb' / 'run'))
    assert (tmp_path / 'tb' / 'run').is_dir() and not made
    lg.log(0, {'loss': torch.tensor(1.0)})
    lg.flush()
    assert made == [str(tmp_path / 'tb' / 'run')]
    (tmp_path / 'file').write_text('')
    with pytest.raises(OSError):
        MetricsLogger(None, tensorboard_dir=str(tmp_path / 'file' / 'tb'))
