"""Median time of one Interface API evaluation (SetParameters on every
interface, LogLikelihood(), Gradient()) over all evaluations of the
measured window, by the harness's clock."""

import numpy as np


def read(r):
    if not r.latencies_ms:
        return None
    return float(np.percentile(r.latencies_ms, 50))
