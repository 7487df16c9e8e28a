"""Known-bad async snippets (RA6xx): blocking calls and device syncs on the
serving event loop. Parsed, never run."""
import time
from time import sleep

import torch


async def drive(engine):
    time.sleep(0.01)                    # expect: RA601
    toks = engine.buf.cpu()             # expect: RA103,RA602
    torch.cuda.synchronize()            # expect: RA104,RA602
    n = engine.count.item()             # expect: RA602
    rows = torch.stack(engine.rows).tolist()    # expect: RA103,RA602
    return toks, n, rows


def blocking():
    sleep(0.5)                          # expect: RA601
