"""Dry-run: what one step of each (architecture x input shape) costs on
one or four H100s, and what each device would hold on the reference's pod
meshes, without a card.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh h100x1 [--out DIR]

On `h100x1` and `h100x4` the port's own step runs under `FakeTensorMode`
at full width: the params (bf16 working weights for serving, float32
masters and AdamW's moments for training) and the shape's inputs are fake,
so nothing is allocated, and the step takes the plain PyTorch path (the
tensors lie on the CPU), as the JAX package's dry-run sets
`use_pallas=False`. `distributed/cost_analysis.measure` counts its flops,
bytes accessed, argument bytes and peak memory. On `h100x4` each card takes
the shape's batch divided by 4 (a batch that does not divide runs whole on
each card): serving replicas call no collective, and training adds the
ring all-reduce of the float32 gradients, 2 (n - 1) / n of their bytes a
card, a rule and not a measurement. The record says whether a card's peak
fits in 80 GB; that peak, like the bytes accessed, is the plain path's,
which materializes copies the kernels do not, so `fits` errs on the side
of refusing a pair.

On the pod meshes (`pod16x16`, `pod2x16x16`) the record is `rules_only`:
each device's argument bytes under the ported sharding rules
(`launch/shardings.py`). Partitioning the step itself is XLA's SPMD
partitioner's work, which has no counterpart here.

Records keep the reference's keys where they mean the same thing (`status`,
`flops`, `bytes_accessed`, `collective_bytes`, `memory.argument_bytes`,
`memory.temp_bytes`), so `distributed/roofline.row_from_record` reads both.
`--fsdp`, `--kv-hd-shard`, `--kv-policy` and `--moe-ep` choose the pod
meshes' rules. On the card meshes, where one replica a card holds every
param whole, they would change nothing, so they raise there.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from pathlib import Path
from typing import Optional

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.configs.registry import (SHAPES, InputShape,
                                          adapt_for_shape, input_specs,
                                          shape_supported)
from repro_torch.distributed import cost_analysis
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.roofline import CARD_BYTES
from repro_torch.launch import shardings as sh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import named_mesh
from repro_torch.models import transformer
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree as tree_lib

CARD_MESHES = ("h100x1", "h100x4")
POD_MESHES = ("pod16x16", "pod2x16x16")


def card_mesh_flag_error(mesh_name: str, fsdp: bool, kv_hd_shard: bool,
                         kv_policy: str, moe_ep: bool) -> Optional[str]:
    """Why the pod meshes' rule flags may not be set on a card mesh, or
    None where they are not set or the mesh is a pod's."""
    if mesh_name in CARD_MESHES and (fsdp or kv_hd_shard or moe_ep
                                     or kv_policy != "hd_model"):
        return ("--fsdp, --kv-hd-shard, --kv-policy and --moe-ep choose the "
                f"pod meshes' rules and change nothing on {mesh_name}")
    return None


def dryrun_config(cfg, shape: InputShape):
    """The reference's dry-run adaptations that mean something here: the
    shape's own (`adapt_for_shape`) and 64-row SSD chunks for Mamba2 stacks
    at 4,096 tokens and more (bounding the plain scan's intra-chunk decay
    tensor). Its `scan_layers=False` (count every layer) is the port's
    eager loop already."""
    cfg = adapt_for_shape(cfg, shape)
    if cfg.family in ("ssm", "hybrid") and shape.seq_len >= 4096:
        cfg = cfg.with_(ssm_chunk=64)
    return cfg


def card_batch(shape: InputShape, n_cards: int) -> int:
    """A card's batch: the shape's divided by the cards where it divides,
    else the whole of it on every card."""
    B = shape.global_batch
    return B // n_cards if B % n_cards == 0 else B


def build_step(cfg, shape: InputShape, device="cpu"):
    """(fn, args) of the pair's step on `device` (fake under an active
    FakeTensorMode): training is `steps.make_train_step` on float32
    masters and AdamW's state; prefill and decode run the bf16 working
    params through `steps.make_prefill_step` / `make_decode_step`."""
    train = shape.kind == "train"
    params = transformer.init_params(cfg, seed=0, device=device,
                                     master=train)
    specs = input_specs(cfg, shape, device=device)
    if train:
        step = steps_lib.make_train_step(cfg, opt_lib.AdamWConfig())
        return step, (params, opt_lib.init_opt_state(params), specs)
    if shape.kind == "prefill":
        base = steps_lib.make_prefill_step(cfg)

        def prefill(params, tokens, cache, plens, enc_frames, prefix_embeds):
            return base(params, tokens, cache, prompt_lengths=plens,
                        enc_frames=enc_frames, prefix_embeds=prefix_embeds)
        return prefill, (params, specs["tokens"], specs["cache"],
                         specs["prompt_lengths"], specs.get("enc_frames"),
                         specs.get("prefix_embeds"))
    return (steps_lib.make_decode_step(cfg),
            (params, specs["tokens"], specs["cache"]))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def grad_bytes(params) -> int:
    """The float32 gradients' bytes (one a master leaf)."""
    return sum(4 * t.numel() for t in tree_lib.leaves(params))


def _card_record(cfg, shape: InputShape, mesh_name: str) -> dict:
    n = named_mesh(mesh_name).size
    B = card_batch(shape, n)
    with FakeTensorMode():
        fn, args = build_step(cfg, shape.with_batch(B))
        _, cost = cost_analysis.measure(fn, args)
        grads = grad_bytes(args[0]) if shape.kind == "train" else 0
    coll = {"total": 0}
    if n > 1 and grads:
        ring = int(2 * (n - 1) / n * grads)
        coll = {"all-reduce": ring, "total": ring,
                "rule": "ring all-reduce of the float32 gradients, "
                        "2 (n - 1) / n of their bytes a card"}
    return dict(
        status="ok", card_batch=B, flops=cost.flops,
        bytes_accessed=cost.bytes_accessed, unique_bytes=cost.unique_bytes,
        collective_bytes=coll,
        memory={"argument_bytes": cost.argument_bytes,
                "temp_bytes": cost.temp_bytes,
                "output_bytes": cost.output_bytes,
                "peak_bytes": cost.peak_bytes},
        fits=cost.peak_bytes <= CARD_BYTES)


def _shards(mesh, spec) -> int:
    n = 1
    for a in spec:
        n *= shd.axis_size(mesh, a)
    return n


def _sharded_bytes(mesh, tree, specs_tree, itemsize=None) -> int:
    """Per-device bytes of `tree`'s leaves under the matching specs (each
    leaf at `itemsize` bytes an element when given)."""
    total = 0
    for path, leaf in tree_lib.leaves_with_path(tree):
        spec = specs_tree
        for k in path:
            spec = spec[k]
        size = leaf.numel() * itemsize if itemsize else _nbytes(leaf)
        total += size // _shards(mesh, spec)
    return total


def _pod_record(cfg, shape: InputShape, mesh_name: str, fsdp: bool,
                kv_hd_shard: bool, kv_policy: str, moe_ep: bool) -> dict:
    mesh = named_mesh(mesh_name)
    train = shape.kind == "train"
    with FakeTensorMode():
        params = transformer.init_params(cfg, seed=0, device="cpu",
                                         master=train)
        specs = input_specs(cfg, shape, device="cpu")
    psh = sh_lib.param_shardings(cfg, mesh, params, fsdp=fsdp,
                                 kv_hd_shard=kv_hd_shard, moe_ep=moe_ep)
    per_dev = _sharded_bytes(mesh, params, psh)
    if train:       # AdamW's two float32 moments mirror the params
        per_dev += 2 * _sharded_bytes(mesh, params, psh, itemsize=4)
    ish = sh_lib.input_shardings(mesh, specs, kv_policy=kv_policy)
    for k, v in specs.items():
        per_dev += (_sharded_bytes(mesh, v, ish[k]) if k == "cache"
                    else _nbytes(v) // _shards(mesh, ish[k]))
    return dict(status="rules_only",
                reason="XLA-only: the SPMD partitioner runs a step on a pod "
                       "mesh; the port applies its sharding rules only",
                memory={"argument_bytes": per_dev})


def record_name(arch: str, shape_name: str, mesh_name: str,
                tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return f"{arch.replace('.', 'p')}__{shape_name}__{mesh_name}{suffix}.json"


def run_one(arch: str, shape_name: str, mesh_name: str = "h100x1",
            out_dir: Optional[Path] = None, fsdp: bool = False,
            kv_hd_shard: bool = False, kv_policy: str = "hd_model",
            moe_ep: bool = False, tag: str = "") -> dict:
    err = card_mesh_flag_error(mesh_name, fsdp, kv_hd_shard, kv_policy,
                               moe_ep)
    if err:
        raise ValueError(err)
    shape = SHAPES[shape_name]
    cfg = registry.get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "fsdp": fsdp, "tag": tag}
    skip = shape_supported(cfg, shape)
    t0 = time.time()
    if skip:
        rec.update(status="skipped", reason=skip)
    else:
        cfg = dryrun_config(cfg, shape)
        try:
            if mesh_name in CARD_MESHES:
                rec.update(_card_record(cfg, shape, mesh_name))
                m = rec["memory"]
                print(f"[OK] {arch} x {shape_name} on {mesh_name}: "
                      f"flops/card={rec['flops']:.3e} "
                      f"bytes/card={rec['bytes_accessed']:.3e} "
                      f"unique={rec['unique_bytes']:.3e} "
                      f"coll={rec['collective_bytes']['total']:.3e}B "
                      f"peak={m['peak_bytes'] / 1e9:.2f} GB "
                      f"fits={rec['fits']} ({time.time() - t0:.1f} s)")
            else:
                rec.update(_pod_record(cfg, shape, mesh_name, fsdp,
                                       kv_hd_shard, kv_policy, moe_ep))
                print(f"[RULES] {arch} x {shape_name} on {mesh_name}: "
                      f"argument bytes/device="
                      f"{rec['memory']['argument_bytes'] / 1e9:.2f} GB")
        except Exception as e:  # noqa: BLE001 — record it, keep sweeping
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            print(f"[FAIL] {arch} x {shape_name} on {mesh_name}: "
                  f"{rec['error']}")
        finally:
            gc.collect()
    rec["seconds"] = round(time.time() - t0, 2)
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / record_name(arch, shape_name, mesh_name, tag)).write_text(
            json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="h100x1",
                    choices=list(CARD_MESHES + POD_MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--kv-hd-shard", action="store_true")
    ap.add_argument("--kv-policy", default="hd_model",
                    choices=["hd_model", "replicate", "seq_model"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    err = card_mesh_flag_error(args.mesh, args.fsdp, args.kv_hd_shard,
                               args.kv_policy, args.moe_ep)
    if err:
        ap.error(err)
    out_dir = Path(args.out)

    if args.all:
        pairs = [(a, s) for a in registry.ALIASES for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]
    n_ok = n_fail = 0
    for arch, sname in pairs:
        path = out_dir / record_name(arch, sname, args.mesh, args.tag)
        if args.skip_existing and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "skipped", "rules_only"):
                print(f"[SKIP existing] {arch} x {sname}")
                continue
        rec = run_one(arch, sname, args.mesh, out_dir, fsdp=args.fsdp,
                      kv_hd_shard=args.kv_hd_shard,
                      kv_policy=args.kv_policy, moe_ep=args.moe_ep,
                      tag=args.tag)
        n_ok += rec["status"] in ("ok", "skipped", "rules_only")
        n_fail += rec["status"] == "error"
    print(f"dry-run sweep done: {n_ok} ok/skipped/rules_only, "
          f"{n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
