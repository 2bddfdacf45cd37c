"""The dequant kernel's share of its roofline in the traced train
segment: the least time its launches could take (``roofline.
dequant_floor_s`` of the elements they dequantized: the float32 written
at the HBM rate, the uint8 read back from L2) over their time on the
device, summed over the ranks (nothing where the trace missed kernels)."""

import roofline


def read(rec):
    if rec['kind'] != 'train' or not rec['traces'] or not rec['complete']:
        return None
    elements = sum(t['dequant_elements'] for t in rec['traces'])
    spent = sum(sum(t['dequant_ns']) for t in rec['traces']) / 1e9
    if elements == 0 or spent <= 0:
        return None
    return 100.0 * roofline.dequant_floor_s(elements) / spent
