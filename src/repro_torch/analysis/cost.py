"""The cost of one step as the port runs it: the counterpart of
``repro/analysis/hlo.py``.

The reference derives a step's cost from the HLO text XLA compiles, with
trip counts to multiply each ``while`` body by its layers.  The port runs
its step eagerly, every layer in turn, so there is no program text and
no loop to multiply: ``CostCounter`` counts what the step actually
dispatches while it runs on meta tensors (the dry run,
``launch/dryrun.py``); an op that makes a tensor with elements off the
meta device raises (``torch.utils.checkpoint`` makes an empty one on
the CPU to hook into autograd, which allocates nothing).  Its
``StepCost`` keeps
``HloCost``'s fields where they mean the same:

  * **flops** - the operations of every dispatched aten op that
    ``torch.utils.flop_counter``'s registry (``FlopCounterMode``'s
    formulas: mm, bmm, addmm, convolutions, attention) has a formula for,
    by the rate of its operands' dtype (``flops_by_rate``), plus each
    kernel's own report (``kernels/meta.py``, from ``kernels/work.py``);
  * **bytes** - each dispatched aten op's distinct operands and outputs,
    views and metadata ops counted as zero (the reference's
    ``_FREE_OPS``), plus each kernel's own bytes: what an eager step
    moves through HBM, where no two ops are fused;
  * **wire_bytes**, **collective_bytes**, **collective_count** - every
    collective where the port issues it (``models/sharding.py``:
    ``_gather0``, which ``all_gather_dim`` uses; ``max_over`` and
    ``sum_of_one``; ``_a2a``; a rank-order sum is an ``_a2a`` and a
    ``_gather0``), costed by the reference's ring model (``ring_wire``);
    what the port sends, not what GSPMD would;

and adds

  * **kernel_calls** - calls of each hand-written kernel, by name;
  * **argument_bytes** - the distinct storages of the step's arguments:
    the rank's parameters, optimizer state, cache and batch;
  * **peak_bytes** - ``argument_bytes`` plus the highest sum of the
    storages the step allocated that were alive at once.

A collective or a kernel reports to the active counter (``active()``):
one ``is None`` test when no counter is active.
"""
from __future__ import annotations

import traceback
import weakref
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ACTIVE: Optional["CostCounter"] = None


def active() -> Optional["CostCounter"]:
    """The counter in effect, or None."""
    return _ACTIVE


def ring_wire(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one rank puts on the wire for a collective over `n` ranks
    whose output is `out_bytes`, by the reference's ring model
    (``repro/analysis/roofline.py:76-110``)."""
    if kind == "all-gather":
        return out_bytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * (n - 1) / max(n, 1)
    if kind == "all-to-all":
        return out_bytes * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class StepCost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    flops_by_rate: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0

    def add_flops(self, rate: str, f: float) -> None:
        self.flops += f
        self.flops_by_rate[rate] = self.flops_by_rate.get(rate, 0.0) + f

    def add_collective(self, kind: str, b: float, n: int = 1) -> None:
        self.wire_bytes += b
        self.collective_bytes[kind] = \
            self.collective_bytes.get(kind, 0.0) + b
        self.collective_count[kind] = \
            self.collective_count.get(kind, 0) + n

    def to_json(self) -> Dict:
        return asdict(self)


#: aten ops that move no bytes: metadata, allocation without a fill, and
#: the ops whose output aliases an input (``OpOverload.is_view``)
_FREE = {"detach", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
         "set_", "resize_", "_local_scalar_dense", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type"}

_RATES = {torch.bfloat16: "bfloat16", torch.float16: "bfloat16",
          torch.int8: "int8"}


def _storage_key(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


def tensors_of(tree: Any) -> Iterable[torch.Tensor]:
    """The tensors of a nested tree of dicts, lists, tuples (named ones
    too) and modules (their parameters and buffers)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
        return
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            yield leaf
        elif isinstance(leaf, torch.nn.Module):
            yield from tensors_of(leaf)
        elif isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            yield from tensors_of(list(leaf))


def storage_bytes(tree: Any) -> int:
    """Bytes of the distinct storages of the tensors of `tree`."""
    seen: Dict[int, int] = {}
    for t in tensors_of(tree):
        key, n = _storage_key(t)
        seen[key] = n
    return sum(seen.values())


class _Dispatch(TorchDispatchMode):
    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter._op(func, args, kwargs, out)
        return out


class CostCounter:
    """Counts the cost of what runs inside it (see the module doc):

        with CostCounter(arguments=(state, batch)) as c:
            step(state, batch)
        c.cost                      # a StepCost

    `arguments`: the trees (``tensors_of``) whose storages the step is
    given; they make ``argument_bytes``, and an op writing into them
    allocates nothing.  An op that makes a tensor with elements off the
    meta device raises: the dry run allocates nothing."""

    def __init__(self, arguments: Any = ()):
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.cost = StepCost()
        self._args = set()
        arg_bytes: Dict[int, int] = {}
        for t in tensors_of(arguments):
            key, n = _storage_key(t)
            self._args.add(key)
            arg_bytes[key] = n
        self.cost.argument_bytes = sum(arg_bytes.values())
        self._live_bytes = 0
        self._peak_live = 0
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._mode = None
        self._prev = None

    @property
    def live_bytes(self) -> int:
        """Bytes of the storages the step allocated that are alive now."""
        return self._live_bytes

    # -- reports ------------------------------------------------------------
    def collective(self, kind: str, out: torch.Tensor, n: int) -> None:
        """A collective over `n` ranks with output `out`: its ring-model
        wire bytes, and its output's bytes through HBM (as the
        reference's ``analyze_hlo`` counts a collective's output)."""
        b = out.numel() * out.element_size()
        self.cost.add_collective(kind, ring_wire(kind, b, n))
        self.cost.bytes += b

    def kernel(self, name: str, flops: Dict[str, int], nbytes: int) -> None:
        """One call of kernel `name`: {rate: operations} and its bytes."""
        c = self.cost
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1
        for rate, f in flops.items():
            c.add_flops(rate, f)
        c.bytes += nbytes

    # -- dispatch -----------------------------------------------------------
    def _op(self, func, args, kwargs, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(not t.is_meta and t.numel() for t in outs):
            where = [f"{f.filename}:{f.lineno} {f.name}"
                     for f in traceback.extract_stack()[:-3]
                     if "repro_torch" in f.filename][-4:]
            raise RuntimeError(f"{func} made a tensor off the meta device "
                               f"in a step that allocates nothing, at "
                               f"{' <- '.join(reversed(where))}")
        if func.namespace != "aten":
            return
        packet = func._overloadpacket
        for t in outs:
            self._track(t)
        name = packet.__name__
        if func.is_view or name in _FREE:
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        formula = self._flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            dtype = ins[0].dtype if ins else torch.float32
            self.cost.add_flops(_RATES.get(dtype, "float32"), f)
        seen = set()
        b = 0
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                b += t.numel() * t.element_size()
        self.cost.bytes += b

    def _track(self, t: torch.Tensor) -> None:
        key, n = _storage_key(t)
        if key in self._args:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._size[key] = n
            self._live_bytes += n
            if self._live_bytes > self._peak_live:
                self._peak_live = self._live_bytes
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self._live_bytes -= self._size.pop(key)

    # -- context ------------------------------------------------------------
    def __enter__(self) -> "CostCounter":
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        self._mode = _Dispatch(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        self._mode.__exit__(*exc)
        _ACTIVE = self._prev
        self.cost.peak_bytes = self.cost.argument_bytes + self._peak_live
