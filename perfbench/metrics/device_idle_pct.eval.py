"""The share of the traced test passes in which no kernel, copy or set
runs on the device (nothing where the trace missed kernels)."""


def read(rec):
    if rec['kind'] != 'eval' or not rec['traces'] or not rec['complete']:
        return None
    return max(100.0 * (1.0 - t['busy_ns'] / t['window_ns'])
               for t in rec['traces'])
