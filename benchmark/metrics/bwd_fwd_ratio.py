"""bwd_fwd_ratio: the device time of a gradient's backward over its
forward's, from CUDA events around the forward (the rollout and the loss)
and the backward (`torch.autograd.grad`) of each gradient of the traced
episode; the median over them."""

import numpy as np


def read(run):
    got = [b.elapsed_time(c) / a.elapsed_time(b)
           for a, b, c in run.entry.record or []]
    return float(np.median(got)) if got else None
