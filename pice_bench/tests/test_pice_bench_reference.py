"""The plain reference against the program's own forward pass at tiny
sizes on the CPU (float32): the weights worked out again from the seed,
the dense stacks (qwen3's q/k norm, qwen2's biases and tied embedding) and
the Mamba2 hybrid."""
import pytest
import torch

from pice_bench.reference import dense, hybrid
from pice_bench.tests import tiny  # noqa: F401  (sys.path)

KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
        "d_ff", "vocab_size", "qk_norm", "qkv_bias", "rope_theta", "norm_eps",
        "tie_embeddings", "ssm_state", "ssm_expand", "ssm_heads", "ssm_conv",
        "shared_attn_every", "dtype")


@pytest.mark.parametrize("name,tied", [("qwen3-8b", False),
                                       ("qwen2-1.5b", True),
                                       ("zamba2-2.7b", True)])
def test_reference_matches_the_program_forward(name, tied):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = get_config(name).reduced(vocab_size=300, dtype="float32",
                                   tie_embeddings=tied)
    seed = 2_147_483_659
    params = transformer.init_params(cfg, seed=seed, device="cpu")
    toks = torch.randint(1, 256, (1, 90), generator=torch.Generator()
                         .manual_seed(0))
    logits, _ = transformer.forward(cfg, params, toks)
    rows = list(range(70, 90))
    lp = torch.log_softmax(logits[0, rows].float(), -1)
    served = lp.argmax(-1)
    seq = {"tokens": toks[0].tolist(), "rows": rows,
           "served": served.tolist(),
           "lps": lp.gather(1, served[:, None])[:, 0].tolist()}
    spec = {k: getattr(cfg, k) for k in KEYS}
    mod = hybrid if cfg.family == "hybrid" else dense
    (r,) = mod.run(spec, seed, [seq], "cpu", control=True)
    assert r["gap"] < 1e-4 and r["lp"] < 1e-4
    assert r["control_gap"] > 100 * max(r["gap"], 1e-5) or \
        r["control_lp"] > 100 * max(r["lp"], 1e-5)
