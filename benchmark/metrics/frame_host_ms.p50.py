"""frame_host_ms.p50: per frame of the traced episode, the host time of
the frame (the call and its readback) minus the device time of its
replay (CUDA events around `Compiled.replay`): the state load, the clone
out, the metrics, the readback and the launch. The median over frames."""

import numpy as np


def read(run):
    dev = {}
    for ms, _, c in run.spans.replay_ms():
        dev[c] = dev.get(c, 0.0) + ms
    got = [1e3 * s - dev[c] for c, s in enumerate(run.spans.call_s)
           if c in dev]
    return float(np.median(got)) if got else None
