"""AM301 clean fixture: a host-only module on numpy alone."""
# amlint: host-only
import numpy as np


def encode(rows):
    return np.asarray(rows, np.int64)
