"""Known-bad host-sync snippets. Lines marked `# expect: CODE` are asserted
exactly by tests/test_torch_analysis.py; this file is parsed, never run."""
import numpy as np
import torch


def step(engine, x):
    y = torch.softmax(x, dim=-1)
    a = float(y)                        # expect: RA101
    b = y.item()                        # expect: RA101
    c = np.asarray(y)                   # expect: RA102
    d = y.cpu()                         # expect: RA103
    e = y.numpy()                       # expect: RA102
    torch.cuda.synchronize()            # expect: RA104
    f = y.tolist()                      # expect: RA103
    g = y.to("cpu")                     # expect: RA103
    return a, b, c, d, e, f, g


def loop(engine, xs):
    outs = [engine._decode_run(x) for x in xs]
    return [int(v) for v in outs]       # expect: RA101


def events(stream, ev):
    ev.synchronize()                    # expect: RA104
    stream.synchronize()                # expect: RA104


def host_values(x):
    host = torch.exp(x).cpu().numpy()[:4]   # expect: RA103
    y = torch.exp(x)
    n = int(host[0])            # a read's rows are host values: no RA101
    rows = int(y.shape[0])      # metadata: no sync
    return n, rows


def waived_step(x):
    y = torch.exp(x)
    return float(y)  # repro-analysis: disable=RA101 reason=fixture waiver is counted, not reported
