"""What the ingest-graph tests share (CPU and card; no JAX import): a spy
that holds every batched ragged ingest a warmed engine replays to the eager
call at the rows' bucketed live width, and a request stream whose ingest
calls cover every row bucket of a 6-slot engine.

`IngestSpy` wraps `engine._replay_ingest`. Before each replay it runs
`transformer.prefill_ragged_paged` over a copy of the cache, at the live
width the eager path would use. After the replay it compares the rows'
logits (sentinel padding rows' logits are unspecified and left out), every
pool leaf but the scratch page (the target of dropped writes), the cached
lengths and the block table, and the wrappers' launches the replay credited
against those the eager call made."""
import torch

from repro_torch import kernels
from repro_torch.models import transformer


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def launches():
    return {name: w.launches for name, w in kernels.wrappers().items()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _leaves(eng, cache):
    """(name, tensor) of every cache leaf, an attention pool's scratch page
    left out."""
    out = [("lengths", cache["lengths"]),
           ("block_table", cache["block_table"])]
    for i, seg in enumerate(transformer.attention_segments(eng.cfg, cache)):
        out += [(f"segment {i} {k}", seg[k][:, :-1]) for k in seg]
    return out


class IngestSpy:
    """Compare each replayed ingest of `eng` with the eager call (bitwise
    with `exact`, else within float32 rounding) and record its rows."""

    def __init__(self, eng, exact: bool):
        self.eng, self.exact = eng, exact
        self.calls = []

    def _same(self, what, got, want):
        if self.exact:
            assert torch.equal(got, want), f"{what} differs from eager"
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                       msg=f"{what} differs from eager")

    def __enter__(self):
        eng = self.eng
        replay = eng._replay_ingest

        def checked(graph, toks, slots, offs, lens):
            n = int((slots < eng.max_batch).sum())
            live = eng._chunk_live(int((offs + lens).max()))
            ref = clone(eng.cache)
            before = launches()
            want, ref = transformer.prefill_ragged_paged(
                eng.cfg, eng.params,
                torch.from_numpy(toks).to(eng.device), ref, slots, offs,
                lens, live_pages=live)
            eager = _delta(before, launches())
            for name, w in kernels.wrappers().items():
                w.launches = before[name]
            got = replay(graph, toks, slots, offs, lens)
            replayed = _delta(before, launches())
            self._same("logits", got[:n], want[:n])
            for (name, a), (_, b) in zip(_leaves(eng, eng.cache),
                                         _leaves(eng, ref)):
                self._same(name, a, b)
            assert replayed == eager, (replayed, eager)
            self.calls.append(dict(rows=len(slots), live=n,
                                   offs=offs[:n].tolist(),
                                   lens=lens[:n].tolist(),
                                   launches=replayed))
            return got
        eng._replay_ingest = checked
        return self

    def __exit__(self, *exc):
        # the wrapper closes a reference cycle through the engine, whose
        # graphs the cyclic collector could then free during a later
        # capture, which a capture does not allow
        del self.eng._replay_ingest

    def covered(self, buckets, chunk, page):
        """Every row bucket replayed, and among the rows sentinel padding,
        partial chunks, rows past their first chunk and rows that start
        inside a page (a fork's suffix after its shared prefix)."""
        assert sorted({c["rows"] for c in self.calls}) == sorted(buckets)
        assert any(c["live"] < c["rows"] for c in self.calls)
        lens = [n for c in self.calls for n in c["lens"]]
        offs = [o for c in self.calls for o in c["offs"]]
        assert any(0 < n < chunk for n in lens)
        assert any(o >= chunk for o in offs)
        assert any(o % page for o in offs)


def drive(eng):
    """Six prompts at once, then a five-way fan-out of a 21-token prefix:
    on a 6-slot engine with chunks of 16 the ingest calls carry 6, 4, 3,
    2 and 1 rows, and 5 fork suffixes at offset 21. -> their outputs."""
    prompts = [[(11 * i + j) % 97 + 1 for j in range(n)]
               for i, n in enumerate((5, 16, 40, 70, 23, 100))]
    out = eng.generate(prompts, max_new=6)
    prefix = [3 + j % 50 for j in range(21)]
    suffixes = [[7] * 9, [8] * 17, [9] * 3, [10] * 30, [11]]
    return out + eng.generate_fanout(prefix, suffixes, max_new=6)
