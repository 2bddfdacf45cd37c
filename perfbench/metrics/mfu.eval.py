"""The test passes' share of the chip's peak: the FLOPs of every image
classified in the window (``flops.eval_image``) over the window's seconds
times the peak of the compute dtype."""

import roofline


def read(rec):
    if rec['kind'] != 'eval':
        return None
    peak = roofline.peak_flops(rec['model']['compute_dtype']) * rec['chips']
    return 100.0 * rec['eval_flops'] / (rec['window_s'] * peak)
