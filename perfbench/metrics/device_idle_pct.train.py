"""The share of the traced train segment in which no kernel, copy or set
runs on the device, the largest over the ranks (nothing where the trace
missed kernels)."""


def read(rec):
    if rec['kind'] != 'train' or not rec['traces'] or not rec['complete']:
        return None
    return max(100.0 * (1.0 - t['busy_ns'] / t['window_ns'])
               for t in rec['traces'])
