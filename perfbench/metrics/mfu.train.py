"""The train steps' share of the chips' peak: the FLOPs of every train
step of the window (``flops.train_step``, from the configuration's
shapes) over the window's seconds times the peak of the compute dtype
(``roofline.PEAK_FLOPS``) times the chips."""

import flops
import roofline


def read(rec):
    if rec['kind'] != 'train':
        return None
    m, t = rec['model'], rec['train']
    bs, k = t['batch_size'], t['classifier_mc_samples']
    work = (rec['steps']['sup'] * flops.train_step(m, bs, True, k)
            + rec['steps']['unsup'] * flops.train_step(m, bs, False, k))
    peak = roofline.peak_flops(m['compute_dtype']) * rec['chips']
    return 100.0 * work / (rec['window_s'] * peak)
