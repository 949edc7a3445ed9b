"""chunk_step_ms.p50: the median device time of one step of one chunk,
from CUDA events around each chunk's replays (`Compiled.replay`) in the
traced episode, divided by the replay's steps."""

import numpy as np


def read(run):
    got = [ms / n for ms, n, _ in run.spans.replay_ms()]
    return float(np.median(got)) if got else None
