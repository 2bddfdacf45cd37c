"""CUDA runtime calls that enqueue work on the device (kernel and graph
launches, copies, sets), counted on the host side of the trace of the
train segment, over its train steps; the largest over the ranks."""


def read(rec):
    if rec['kind'] != 'train' or not rec['traces']:
        return None
    return max(t['launches'] / t['steps'] for t in rec['traces'])
