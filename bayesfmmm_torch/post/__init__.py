"""Post-processing of traces: label switching, summaries, model selection,
predictive paths and the chi-integrated CPO.

The NumPy modules here take traces and data as host arrays or as tensors on
any device; ``host`` moves a tensor to the host first.
"""

import numpy as np
import torch


def host(a):
    """``a`` as a host NumPy array; a tensor on any device is copied off it."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
