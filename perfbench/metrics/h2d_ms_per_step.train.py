"""Host-to-device copy time on the device in the traced train segment
over its train steps; the largest over the ranks."""


def read(rec):
    if rec['kind'] != 'train' or not rec['traces']:
        return None
    return max(t['h2d_ns'] / 1e6 / t['steps'] for t in rec['traces'])
