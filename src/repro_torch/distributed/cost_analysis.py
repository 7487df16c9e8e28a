"""What a step costs, counted while it runs under fake tensors: the
counterpart of XLA's `compiled.cost_analysis()` and `memory_analysis()`.

`measure(fn, args)` runs fn(*args) under `FlopCounterMode` and `CostMode`
(a `TorchDispatchMode`). Run it inside a `FakeTensorMode` with fake args:
nothing is allocated and no device is needed, and every op of the step
still runs, so eager loops count every iteration. It returns:

  flops            `FlopCounterMode`'s total (matmuls, convolutions,
                   attention calls; elementwise ops count none, as in
                   XLA's count of the dots);
  bytes_accessed   each aten op's tensor operands and outputs, summed,
                   as XLA's "bytes accessed" sums each HLO op's (views,
                   allocations, detaches and metadata queries move
                   nothing and count none); an in-place op counts its
                   other operands and as many bytes written, at most the
                   mutated tensor's (its whole size when it has no other
                   operand), so that a one-row cache write counts the
                   row, as XLA's in-place dynamic-update-slice does; a
                   gather (an embedding lookup) reads what it writes and
                   its indices, not the whole table, as XLA's gather;
  argument_bytes   the arguments' storages, each once;
  output_bytes     the storages the outputs hold that no argument holds;
  peak_bytes       the high-water mark of live storages: the arguments
                   plus whatever the step holds at once (autograd's saved
                   tensors included);
  temp_bytes       peak_bytes - argument_bytes;
  unique_bytes     argument_bytes + output_bytes: the bytes a step must
                   move if it reads each argument once and writes each
                   output once, the "bound, by bytes" of PERF.md's kernel
                   tables (an in-place update of an argument counts in
                   the argument's bytes only).

The per-op table (`by_op=True`) groups flops and bytes by (op, operand
shapes), as the JAX package's `launch/inspect_hlo.py` groups HLO ops by
(opcode, shape). Collective bytes are not counted here: the port's step
runs on one card and calls no collective (the dry-run adds the
data-parallel all-reduce by rule). Parsing HLO text is XLA's alone.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

aten = torch.ops.aten
# ops that allocate, alias or read metadata: no bytes move
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.detach.default, aten.lift_fresh.default, aten.alias.default,
         aten._unsafe_view.default, aten._local_scalar_dense.default,
         aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default}


# gathers: the rows read are the rows written
_GATHERS = {aten.index.Tensor, aten.embedding.default,
            aten.index_select.default, aten.gather.default}


def _moves_bytes(func) -> bool:
    return (func.namespace == "aten" and func not in _FREE
            and not func.is_view)


def _op_bytes(func, args, kwargs, outs) -> int:
    """The bytes an op reads and writes (see the module's docstring)."""
    if func in _GATHERS:
        index = [t for t in _tensors((args, kwargs))
                 if not t.is_floating_point()]
        return 2 * sum(map(_nbytes, outs)) + sum(map(_nbytes, index))
    schema = func._schema.arguments
    mutated = []
    for i, a in enumerate(schema):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            mutated.extend(_tensors(v))
    if not mutated:
        return sum(map(_nbytes, _tensors((args, kwargs)) + outs))
    ids = {id(t) for t in mutated}
    others = sum(_nbytes(t) for t in _tensors((args, kwargs))
                 if id(t) not in ids)
    size = sum(map(_nbytes, mutated))
    return others + (min(size, others) if others else size)


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _signature(func, args) -> str:
    shapes = ", ".join(
        "x".join(map(str, t.shape)) + f" {str(t.dtype).replace('torch.', '')}"
        for t in _tensors(args))
    return f"{func.__name__} ({shapes})"


class CostMode(TorchDispatchMode):
    """Counts operand and output bytes of every aten op, tracks live
    storages for the peak, and with `by_op` groups flops and bytes by
    (op, operand shapes)."""

    def __init__(self, by_op: bool = False):
        super().__init__()
        self.bytes_accessed = 0
        self.live: Dict[int, weakref.ref] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.by_op = defaultdict(lambda: [0, 0, 0]) if by_op else None

    def track(self, t: torch.Tensor) -> None:
        """Count `t`'s storage live until it is freed: a storage keeps its
        Python object while any tensor, view or autograd record holds it,
        and the weak reference's callback runs when it goes."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self.live.pop(key, None)
            self.live_bytes -= n
        self.live[key] = weakref.ref(st, freed)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        nbytes = _op_bytes(func, args, kwargs, outs) \
            if _moves_bytes(func) else 0
        self.bytes_accessed += nbytes
        for t in outs:
            self.track(t)
        if self.by_op is not None:
            flops = 0
            packet = func._overloadpacket
            if packet in flop_registry:
                flops = flop_registry[packet](*args, **kwargs, out_val=out)
            row = self.by_op[_signature(func, (args, kwargs))]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out


@dataclasses.dataclass
class StepCost:
    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    temp_bytes: int
    unique_bytes: int
    by_op: Dict[str, Tuple[int, float, int]] = dataclasses.field(
        default_factory=dict)    # signature -> (calls, flops, bytes)


def _storages(tree) -> Dict[int, int]:
    """key -> nbytes of the storages the tensors of `tree` hold."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def measure(fn: Callable, args: tuple, by_op: bool = False):
    """fn(*args) counted (see the module's docstring) -> (its outputs,
    StepCost)."""
    arg_st = _storages(args)
    mode = CostMode(by_op=by_op)
    for t in _tensors(args):
        mode.track(t)
    with FlopCounterMode(display=False) as flop_mode, mode:
        out = fn(*args)
    argument_bytes = sum(arg_st.values())
    output_bytes = sum(n for k, n in _storages(out).items()
                       if k not in arg_st)
    peak = max(mode.peak_bytes, argument_bytes + output_bytes)
    return out, StepCost(
        flops=float(flop_mode.get_total_flops()),
        bytes_accessed=float(mode.bytes_accessed),
        argument_bytes=argument_bytes, output_bytes=output_bytes,
        peak_bytes=peak, temp_bytes=peak - argument_bytes,
        unique_bytes=argument_bytes + output_bytes,
        by_op={k: tuple(v) for k, v in (mode.by_op or {}).items()})
