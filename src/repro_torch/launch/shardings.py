"""Parameter / input / cache sharding rules (the JAX package's
`launch/shardings.py`) over the port's trees.

Baseline policy (Megatron-style TP over `model`, DP over `pod` + `data`):
  - attention q/o shard heads over `model`; k/v shard kv-heads when they
    divide (else replicated: standard GQA TP);
  - MLP and expert FFN shard d_ff over `model` (experts stay whole a
    shard);
  - the embedding shards vocab over `model`;
  - decode caches shard batch over `pod` + `data` when it divides, else
    the cache length (a sequence-parallel cache for batch-1 long context);
  - optimizer state mirrors the param tree.

`fsdp=True` also shards the largest param dim over `data` (ZeRO-3 style),
`kv_hd_shard` shards k/v's head_dim where their kv heads do not divide
`model`, `moe_ep` shards the experts over `model`.

The port's trees differ from the reference's in two ways, and the rules
undo both, so that a port leaf's spec is the reference's with the
layer-stack entry dropped:
  - the port keeps one dict a layer where the reference stacks a segment's
    layers (and the encoder's blocks) on a leading axis (`convert._unstack`).
    A stacked leaf's rule runs on the stacked shape, as the reference's
    does (fsdp picks its dim among all of them), and the layer entry is
    then dropped. Where fsdp shards the layer axis itself (a stacked leaf
    whose largest dim is its layer count), the port's per-layer leaf is
    whole on every device;
  - the port flattens attention's heads: wq / wk / wv (d, H*hd), wo
    (H*hd, d), bq / bk / bv (H*hd,). A spec is given on the head-split view
    (`logical_shape`: (d, H, hd), (H, hd, d), (H, hd)), which `Tensor.view`
    gives without a copy.

Specs are tuples (`distributed/sharding.py`); `sharding.placements` turns
one into DTensor placements.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import enc_cfg_as_model, segments_of

# Per-param-name templates for UNSTACKED leaves (a leading layer-stack dim
# gets None prepended).
_BY_NAME = {
    "tok": ("model", None),
    "unembed": (None, "model"),
    "wq": (None, "model", None),
    "wk": (None, "model", None),
    "wv": (None, "model", None),
    "wo": ("model", None, None),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    "w_gate": {2: (None, "model"), 3: (None, None, "model")},
    "w_up": {2: (None, "model"), 3: (None, None, "model")},
    "w_down": {2: ("model", None), 3: (None, "model", None)},
    "b_up": ("model",),
    "b_down": (None,),
    "router": (None, None),
    "w_in": (None, "model"),
    "w_out": ("model", None),
    "w_ff_gate": (None, "model"),
    "w_ff_up": (None, "model"),
    "w_ff_down": ("model", None),
    # replicated small / recurrent tensors
    "w_if": (None, None),
    "w_gates": (None, None),
    "r_gates": (None, None),
}

_FSDP_SKIP = {"tok", "unembed"}  # keep embeddings TP-only
_HEAD_SPLIT_IN = ("wq", "wk", "wv")       # (d, H*hd) -> (d, H, hd)
_HEAD_SPLIT_OUT = ("wo",)                 # (H*hd, d) -> (H, hd, d)
_HEAD_SPLIT_BIAS = ("bq", "bk", "bv")     # (H*hd,) -> (H, hd)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def stack_count(cfg: ModelConfig, path) -> Optional[int]:
    """The layer count the reference stacks this leaf's segment on, or None
    for an unstacked leaf (embeddings, the shared block, norms outside the
    layers, the encoder's positions)."""
    if len(path) > 2 and path[0] == "segments":
        return segments_of(cfg)[path[1]][1]
    if len(path) > 2 and path[:2] == ("encoder", "blocks"):
        return cfg.encoder.n_layers
    return None


def logical_shape(cfg: ModelConfig, path, shape: Sequence[int]
                  ) -> Tuple[int, ...]:
    """A port leaf's shape in the reference's layout: attention's heads
    split out of the port's flattened projections (under "attn" and
    "xattn"), every other leaf as it is."""
    name = _leaf_name(path)
    shape = tuple(shape)
    if "attn" not in path and "xattn" not in path:
        return shape
    acfg = enc_cfg_as_model(cfg) if path[:1] == ("encoder",) else cfg
    hd = acfg.resolved_head_dim
    if name in _HEAD_SPLIT_IN and len(shape) == 2:
        return (shape[0], shape[1] // hd, hd)
    if name in _HEAD_SPLIT_OUT and len(shape) == 2:
        return (shape[0] // hd, hd, shape[1])
    if name in _HEAD_SPLIT_BIAS and len(shape) == 1:
        return (shape[0] // hd, hd)
    return shape


def _pspec_stacked(mesh, name: str, in_moe: bool, shape, fsdp: bool,
                   kv_hd_shard: bool, moe_ep: bool) -> list:
    """The reference's `param_pspec` on a leaf of the reference's shape
    (stacked where the reference stacks it)."""
    template = _BY_NAME.get(name)
    if moe_ep and in_moe and name in ("w_gate", "w_up", "w_down") \
            and len(shape) >= 3:
        # expert-parallel: experts over `model` (dim -3)
        t = [None] * len(shape)
        t[-3] = "model"
        spec = [shd.shardable(mesh, d, a) for d, a in zip(shape, t)]
        if spec[-3] is not None:
            return spec
    if kv_hd_shard and name in ("wk", "wv"):
        # GQA with n_kv < model axis: shard the head_dim instead, matching
        # the decode cache layout
        nkv = shape[-2]
        if shd.shardable(mesh, nkv, "model") is None:
            t = [None] * (len(shape) - 1) + ["model"]
            return [shd.shardable(mesh, d, a) for d, a in zip(shape, t)]
    if template is None:
        spec = [None] * len(shape)
    elif isinstance(template, dict):
        t = template.get(len(shape)) or template.get(len(shape) - 1)
        if t is None:
            spec = [None] * len(shape)
        else:
            t = list(t)
            if len(t) == len(shape) - 1:
                t = [None] + t
            spec = t
    else:
        t = list(template)
        if len(t) == len(shape) - 1:          # stacked on a layer axis
            t = [None] + t
        elif len(t) != len(shape):
            t = [None] * len(shape)
        spec = t
    spec = [shd.shardable(mesh, d, a) for d, a in zip(shape, spec)]
    if fsdp and name not in _FSDP_SKIP:
        # shard the largest still-unsharded dim over data
        free = [i for i, a in enumerate(spec) if a is None]
        if free:
            i = max(free, key=lambda j: shape[j])
            if shape[i] % shd.axis_size(mesh, "data") == 0:
                spec[i] = "data"
    return spec


def param_pspec(cfg: ModelConfig, mesh, path, leaf, fsdp: bool = False,
                kv_hd_shard: bool = False, moe_ep: bool = False
                ) -> shd.Spec:
    """The spec of the port's param leaf at `path` (over
    `logical_shape`)."""
    name = _leaf_name(path)
    shape = logical_shape(cfg, path, leaf.shape)
    count = stack_count(cfg, path)
    if count is not None:
        shape = (count,) + shape
    spec = _pspec_stacked(mesh, name, "moe" in path, shape, fsdp,
                          kv_hd_shard, moe_ep)
    return tuple(spec[1:] if count is not None else spec)


def param_shardings(cfg: ModelConfig, mesh, params, fsdp: bool = False,
                    kv_hd_shard: bool = False, moe_ep: bool = False):
    """A tree like `params` of specs."""
    return shd.tree_shardings(
        mesh, params,
        lambda path, leaf: param_pspec(cfg, mesh, path, leaf, fsdp=fsdp,
                                       kv_hd_shard=kv_hd_shard,
                                       moe_ep=moe_ep))


# ---------------------------------------------------------------------------
# Batch / cache shardings (the port's dense cache has the reference's
# stacked leaves: (count, B, ...) a segment)
# ---------------------------------------------------------------------------

def batch_pspec(mesh, shape) -> shd.Spec:
    b = shd.batch_axes(mesh)
    return shd.pspec(mesh, shape, [b] + [None] * (len(shape) - 1))


def cache_leaf_pspec(mesh, name: str, shape,
                     kv_policy: str = "hd_model") -> shd.Spec:
    b = shd.batch_axes(mesh)
    if name == "lengths":
        return shd.pspec(mesh, shape, [b])
    if name in ("k", "v", "cross_k", "cross_v"):
        # (L, B, S, n_kv, hd)
        L, B, S, nkv, hd = shape
        batch_ok = shd.shardable(mesh, B, b) is not None
        seq_axis = None if batch_ok else b
        kv_axis = "model" if shd.shardable(mesh, nkv, "model") else None
        if kv_policy == "replicate":
            hd_axis = None
        elif kv_policy == "seq_model":
            # the cache length over `model`: QK contracts hd locally, PV
            # partial sums are (B, 1, Nq, hd) all-reduces
            return shd.pspec(mesh, shape, [None, b if batch_ok else None,
                                           "model" if batch_ok else b,
                                           None, None])
        else:
            hd_axis = None if kv_axis else "model"
        return shd.pspec(mesh, shape, [None, b if batch_ok else None,
                                       seq_axis, kv_axis, hd_axis])
    if name == "conv":      # (L, B, K-1, inner)
        return shd.pspec(mesh, shape, [None, b, None, "model"])
    if name == "ssd":       # (L, B, H, P, N)
        return shd.pspec(mesh, shape, [None, b, "model", None, None])
    if name == "C":         # mlstm (L, B, H, hd, hd)
        return shd.pspec(mesh, shape, [None, b, "model", None, None])
    if name == "n":         # (L, B, H, hd) or slstm (L, B, d)
        if len(shape) == 4:
            return shd.pspec(mesh, shape, [None, b, "model", None])
        return shd.pspec(mesh, shape, [None, b, "model"])
    if name in ("m", "h", "c"):
        spec = [None, b] + [None] * (len(shape) - 2)
        if len(shape) == 3:
            spec[2] = "model"
        return shd.pspec(mesh, shape, spec)
    return (None,) * len(shape)


def cache_shardings(mesh, cache, kv_policy: str = "hd_model"):
    def spec_fn(path, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        return cache_leaf_pspec(mesh, _leaf_name(path), tuple(leaf.shape),
                                kv_policy=kv_policy)
    return shd.tree_shardings(mesh, cache, spec_fn)


def input_shardings(mesh, specs: dict, kv_policy: str = "hd_model") -> dict:
    """Specs for the `configs.registry.input_specs` dict of a step."""
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_shardings(mesh, v, kv_policy=kv_policy)
        elif hasattr(v, "shape"):
            out[k] = batch_pspec(mesh, tuple(v.shape))
        else:
            out[k] = v
    return out
