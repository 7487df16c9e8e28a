"""Host-side code that reads nothing from the device, and one waived read.
Parsed, never run."""
import numpy as np
import torch


def plan(slots):
    lens = np.array([s.ctx_len for s in slots], np.int32)
    return int(lens.max()), lens.tolist()       # host arrays: no sync


def shapes(x):
    y = torch.exp(x)
    return int(y.shape[0]), y.dtype             # metadata: no sync


def first_draws(logits):
    toks = torch.argmax(logits, -1)
    # repro-analysis: disable=RA103 reason=admission reads its first tokens once
    return toks.cpu().numpy()
