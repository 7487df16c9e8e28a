"""The port's dry-run (`configs/registry.input_specs`, `distributed/roofline`,
`distributed/cost_analysis`, `launch/dryrun`, `launch/inspect_step`)
against the JAX package's: input specs of 10 architectures x 4 shapes, the
analytic model flops, the shape rules; on a TINY dense config the counted
decode flops equal the analytic matmul count exactly and the argument bytes
the inputs' bytes; a full-width qwen3-8b x decode_32k dry-run on one card
(about 10 s) that does not fit and that `row_from_record` reads."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as ref_registry
from repro.distributed import roofline as ref_roofline
from repro_torch.configs import registry
from repro_torch.configs.pice_cloud_edge import TINY_CLOUD, TINY_EDGE_A
from repro_torch.distributed import cost_analysis, roofline
from repro_torch.launch import dryrun, inspect_step
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.training import tree as tree_lib

PAIRS = list(itertools.product(sorted(registry.ALIASES), registry.SHAPES))


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", None))


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_shape_rules_input_specs_and_model_flops(arch, shape_name):
    shape, ref_shape = registry.SHAPES[shape_name], \
        ref_registry.SHAPES[shape_name]
    assert dataclasses.astuple(shape) == dataclasses.astuple(ref_shape)
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    assert registry.shape_supported(cfg, shape) == \
        ref_registry.shape_supported(ref_cfg, ref_shape)
    cfg = registry.adapt_for_shape(cfg, shape)
    ref_cfg = ref_registry.adapt_for_shape(ref_cfg, ref_shape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert roofline.model_flops(cfg, shape) == \
        ref_roofline.model_flops(ref_cfg, ref_shape)
    specs = registry.input_specs(cfg, shape, device="meta")
    ref_specs = ref_registry.input_specs(ref_cfg, ref_shape)
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_lib.leaves_with_path(specs)]
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_specs)
    want = [(tuple(_key(e) for e in p), tuple(s.shape), str(s.dtype))
            for p, s in flat]
    assert got == want


def test_decode_lengths_read_the_whole_cache():
    shape = registry.SHAPES["decode_32k"].with_batch(2)
    specs = registry.input_specs(TINY_EDGE_A, shape, device="cpu")
    assert specs["cache"]["lengths"].tolist() == [shape.seq_len - 1] * 2
    pre = registry.input_specs(TINY_EDGE_A, registry.SHAPES["prefill_32k"]
                               .with_batch(3), device="meta")
    assert pre["prompt_lengths"].shape == (3,)


def _decode_matmul_flops(cfg, B, S):
    """2 * (multiply-adds) of every matmul of one decode step over an
    S-row cache: q/k/v/o projections, the SwiGLU MLP, the plain attention's
    two products over all S rows, the unembedding."""
    d, hd, hq, hkv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, \
        cfg.n_kv_heads
    layer = (d * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * cfg.d_ff
             + 2 * hq * hd * S)
    return 2 * B * (cfg.n_layers * layer + d * cfg.vocab_size)


@pytest.mark.parametrize("cfg", [TINY_CLOUD, TINY_EDGE_A],
                         ids=lambda c: c.name)
def test_counted_decode_flops_and_argument_bytes(cfg):
    B, S = 3, 64
    shape = registry.InputShape("tiny_decode", S, B, "decode")
    with FakeTensorMode():
        fn, args = dryrun.build_step(cfg, shape)
        _, cost = cost_analysis.measure(fn, args)
        inputs = sum(t.numel() * t.element_size()
                     for t in tree_lib.leaves(list(args)))
    assert cost.flops == _decode_matmul_flops(cfg, B, S)
    assert cost.argument_bytes == inputs
    assert cost.unique_bytes == inputs + B * cfg.vocab_size * 2   # bf16
    assert cost.peak_bytes >= cost.unique_bytes
    assert cost.bytes_accessed > cost.argument_bytes


def test_measure_counts_bytes_and_peak_on_real_tensors():
    """On plain CPU tensors: a matmul's flops and bytes, an in-place row
    write counted as the row, and the peak of two live temporaries."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    cache = torch.zeros(1000, 16)

    def step(a, b, cache):
        x = a @ b                       # 64x16 out, 2*64*32*16 flops
        y = x * 2                       # a second 64x16 live with x
        cache[:64].copy_(y)             # writes 64 rows, not 1000
        return y.sum()
    out, cost = cost_analysis.measure(step, (a, b, cache), by_op=True)
    assert out.item() == 64 * 16 * 32 * 2
    assert cost.flops == 2 * 64 * 32 * 16
    args = 4 * (64 * 32 + 32 * 16 + 1000 * 16)
    assert cost.argument_bytes == args and cost.output_bytes == 4
    assert cost.peak_bytes >= args + 2 * 64 * 16 * 4
    mm = [v for k, v in cost.by_op.items() if k.startswith("mm.")]
    assert mm == [(1, 2 * 64 * 32 * 16, 4 * (64 * 32 + 32 * 16 + 64 * 16))]
    copy = [v for k, v in cost.by_op.items() if k.startswith("copy_")]
    assert copy == [(1, 0, 2 * 4 * 64 * 16)]


def test_full_width_decode_record_and_roofline(tmp_path):
    rec = dryrun.run_one("qwen3-8b", "decode_32k", "h100x1", tmp_path)
    assert rec["status"] == "ok" and rec["fits"] is False
    cfg = registry.get_config("qwen3-8b")
    # the cache alone: 36 layers x 128 rows x 32,768 x 8 kv heads x 128
    cache = 2 * 36 * 128 * 32768 * 8 * 128 * 2
    assert rec["memory"]["argument_bytes"] > cache
    assert rec["memory"]["peak_bytes"] > 80e9
    assert rec["flops"] > roofline.model_flops(
        cfg, registry.SHAPES["decode_32k"])
    rows = roofline.load_rows(str(tmp_path), mesh="h100x1")
    assert len(rows) == 1
    row = rows[0]
    assert row.status == "ok" and row.dominant == "memory"
    assert row.memory_s == rec["bytes_accessed"] / roofline.HBM_BW
    assert row.collective_s == 0 and row.scan_undercount is False
    assert 0 < row.useful_ratio < 1
    assert "KV-bound" in roofline.suggestion(row)
    lines = roofline.table(str(tmp_path), "h100x1").splitlines()
    assert len(lines) == 3 and lines[2].startswith(
        "| qwen3-8b | decode_32k | ok |")
    assert "| False |" in lines[2]


def test_pod_rules_and_skips(tmp_path):
    rec = dryrun.run_one("qwen2-1.5b", "decode_32k", "pod16x16", tmp_path,
                         fsdp=True, tag="t")
    assert rec["status"] == "rules_only"
    card = dryrun.run_one("qwen2-1.5b", "decode_32k", "h100x1")
    total = card["memory"]["argument_bytes"]
    assert total / 256 <= rec["memory"]["argument_bytes"] < total / 8
    row = roofline.row_from_record(rec)
    assert row.status == "rules_only" and "SPMD" in row.note
    skip = dryrun.run_one("whisper-tiny", "long_500k", "h100x1")
    assert skip["status"] == "skipped"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                        "--mesh", "pod16x16", "--fsdp", "--tag", "t",
                        "--out", str(tmp_path), "--skip-existing"]) == 0
    # the pod meshes' rule flags change nothing on a card mesh: they raise
    for flags in ({"fsdp": True}, {"kv_hd_shard": True}, {"moe_ep": True},
                  {"kv_policy": "seq_model"}):
        with pytest.raises(ValueError, match="pod meshes"):
            dryrun.run_one("qwen2-1.5b", "decode_32k", "h100x4", **flags)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                     "--mesh", "h100x1", "--moe-ep"])


def test_four_cards_split_the_batch_and_all_reduce_gradients():
    shape = registry.SHAPES["train_4k"]
    assert dryrun.card_batch(shape, 4) == 64
    assert dryrun.card_batch(registry.SHAPES["long_500k"], 4) == 1
    cfg = TINY_EDGE_A
    tiny = registry.InputShape("train_4k", 32, 8, "train")
    one = dryrun._card_record(cfg, tiny, "h100x1")
    four = dryrun._card_record(cfg, tiny, "h100x4")
    assert four["card_batch"] == 2 and one["collective_bytes"]["total"] == 0
    assert four["flops"] * 4 == one["flops"]
    with FakeTensorMode():
        n = sum(t.numel() for t in tree_lib.leaves(
            transformer.init_params(cfg, 0, device="cpu", master=True)))
    assert four["collective_bytes"]["total"] == int(2 * 3 / 4 * 4 * n)


def test_reference_record_reads_with_h100_rates():
    rec = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "pod16x16",
           "status": "ok", "flops": 2e15, "bytes_accessed": 1e12,
           "collective_bytes": {"total": 2e12},
           "memory": {"temp_bytes": 123}}
    row = roofline.row_from_record(rec)
    ref = ref_roofline.row_from_record(rec)
    assert row.dominant == "collective" and ref.dominant == "collective"
    assert np.isclose(row.compute_s, 2e15 / 989e12)
    assert row.model_flops == ref.model_flops
    assert row.useful_ratio == ref.useful_ratio
    # XLA counts a q-blocked attention loop body once; the port every pass
    assert ref.scan_undercount is True and row.scan_undercount is False


def test_inspect_step_groups_ops():
    cost, by_bytes, by_flops = inspect_step.top_ops("qwen2-1.5b", "long_500k",
                                                    top=5)
    assert len(by_bytes) == 5 and len(by_flops) == 5
    assert sum(r[2] for r in by_flops) <= cost.flops
    assert by_flops[0][0].startswith("mm.")
    assert inspect_step.main(["--arch", "qwen2-1.5b", "--shape",
                              "long_500k", "--top", "3"]) == 0


def test_train_step_counts_forward_and_backward():
    """A TINY training step counts about 3x the forward's matmul flops
    (remat off), and its peak holds the masters, AdamW's moments and the
    activations."""
    cfg = TINY_EDGE_A
    shape = registry.InputShape("t", 16, 2, "train")
    with FakeTensorMode():
        fn, args = dryrun.build_step(cfg, shape)
        _, cost = cost_analysis.measure(fn, args)
        masters = sum(t.numel() * 4 for t in tree_lib.leaves(args[0]))

        def fwd(p, batch):
            return steps_lib.loss_fn(cfg, p, batch)
        _, fcost = cost_analysis.measure(fwd, (args[0], args[2]))
    assert cost.flops == 3 * fcost.flops
    assert cost.argument_bytes >= 3 * masters
    assert cost.peak_bytes > cost.argument_bytes
