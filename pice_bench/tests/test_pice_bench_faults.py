"""Planted faults in the timed path, at a tiny size on the CPU: each
makes the reference's comparison fail and `correct` come out false."""
import pytest

from pice_bench.tests import tiny


def _judged_and_failed(out, run):
    """The run judged a sample, and a judged number broke its limit."""
    assert run.notes["sampled"] > 0, (run.notes, out["attempted"],
                                      out["failed"])
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("kind", ["dense", "hybrid"])
def test_altered_token_is_not_correct(kind, monkeypatch):
    from repro_torch.serving.engine import InferenceEngine
    commit = InferenceEngine._commit

    def altered(self, slot, tok, lp):
        commit(self, slot, (tok + 1) % self.cfg.vocab_size or 1, lp)

    monkeypatch.setattr(InferenceEngine, "_commit", altered)
    _judged_and_failed(*tiny.run(kind))


def test_dense_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.models import paged_cache
    monkeypatch.setattr(paged_cache, "apply_write",
                        lambda pages, dest, new: None)
    _judged_and_failed(*tiny.run("dense"))


def test_hybrid_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.models import ssm
    decode = ssm.mamba2_decode

    def frozen(cfg, params, u, conv_state, ssd_state, active=None):
        out, _, _ = decode(cfg, params, u, conv_state.clone(),
                           ssd_state.clone(), active)
        return out, conv_state, ssd_state

    monkeypatch.setattr(ssm, "mamba2_decode", frozen)
    _judged_and_failed(*tiny.run("hybrid"))
