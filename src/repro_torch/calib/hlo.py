"""Static cost walker of the step one rank runs — the port of
``repro.calib.hlo``.

Part of ``repro_torch.calib``: where ``replay`` MEASURES a candidate launch
on the card, this module prices a whole step without running it.  The
reference walks ``compiled.as_text()``, the optimized HLO of the jitted
step after the partitioner; the port's counterpart of that text is
``trace(step, *args)``: the step run once under ``FakeTensorMode`` (shapes
and dtypes, no storage, no device work) with a dispatch mode that writes
one line per operation this rank dispatches:

    %17 = bf16[4,7680] kernel.mvm(bf16[4,2560], bf16[2560,7680]), \\
        flops=157286400, bytes=39403520, transcendentals=0, live=81920

* an ATen operation (``aten.mm.default(...)``), each one kernel in eager
  PyTorch: the counterpart of a fusion boundary;
* a hand-written kernel's entry point (``kernel.<name>``), recorded as ONE
  op by the hook in ``kernels.common.counted`` with its ``Cost`` (the
  counterpart of a ``custom-call``, which the reference prices at zero;
  the port's decode step runs all its projections through ``mvm``, so its
  kernels are priced by what they compute).  The operations of the plain
  version beneath it are not run: the entry point allocates the outputs
  its CUDA wrapper allocates;
* a collective: DTensor's (``_c10d_functional.*``), c10d's own
  (``c10d.*_``, ``sharding.local``), and DTensor's shard-to-shard
  all-to-all where a ``"cpu"`` mesh issues an all-gather and a chunk for
  it (``_dtensor.shard_dim_alltoall``).

A token ``dtype[dims]`` names a tensor by the reference's dtype names;
``{dims}`` after it gives the elements the operation touches where they
are fewer (a broadcast operand's distinct elements, the rows a gather
reads, the region an in-place write covers); ``!`` marks an operand the
operation writes in place.  Attributes: ``free`` (a view or a metadata
query), ``rmw`` (an in-place write that also reads the old values),
``flops`` (``torch.utils.flop_counter``'s registry for ATen products, the
kernel's ``Cost``), ``transcendentals`` (elements of the reference's
TRANSCENDENTAL kinds), ``bytes`` (a kernel's), ``weight`` (the trips a
loop body's line stands for), ``live`` (bytes of this
rank's storages made during the step and alive after the operation, each
rounded up to 512 as the CUDA caching allocator counts it).  The last
lines give the rank's memory: arguments, outputs, aliases (outputs written
into a donated argument), temporaries and the peak.

``analyze(text)`` returns the reference's keys: ``flops``, ``bytes`` (an
HBM-traffic proxy: each operation's operands plus results; views free; an
in-place write counts the region written), ``transcendental_elems``,
``collective_bytes`` and ``collectives`` by kind, with the reference's
link-traffic conventions (all-gather / all-to-all / permute: result bytes;
all-reduce: twice its bytes; reduce-scatter: input bytes).  Eager PyTorch
unrolls its loops; the model's loops of like trips (a scan's steps, the
blockwise attention's key blocks, gradient accumulation's microbatches:
``kernels.common.trips``) run one trip under the trace, whose lines carry
``weight=<trips>``, as the reference weights a while body by its trip
count.  All numbers are this rank's.  CLI: ``python -m repro_torch.calib.hlo
<trace.txt[.gz]>`` prints the same JSON as the reference's.
"""
from __future__ import annotations

import gzip
import re
import sys
import weakref
from collections import Counter, defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.kernels import common as kc

#: the reference's dtype names and their bytes
DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1, "token": 0, "opaque": 0,
}
#: the reference's transcendental HLO kinds
TRANSCENDENTAL = {"exponential", "tanh", "log", "rsqrt", "sqrt", "power",
                  "logistic", "exponential-minus-one", "log-plus-one",
                  "cosine", "sine", "erf"}

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _DTYPE_NAMES[getattr(torch, _name)] = "u" + _name[4:]

#: ATen ops that make no kernel and move no bytes (the counterpart of the
#: reference's FREE_OPS): allocations and metadata; every view is free too
FREE_OPS = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "wait_tensor", "device", "sym_size",
            "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
            "detach", "alias", "lift_fresh", "_unsafe_view", "view",
            "permute", "expand", "slice", "select", "as_strided", "t",
            "transpose", "unsqueeze", "squeeze", "split", "unbind",
            "split_with_sizes", "chunk", "narrow", "diagonal", "unfold",
            "view_as_real", "view_as_complex", "_reshape_alias",
            "set_", "resize_", "record_stream"}

#: ATen ops -> the TRANSCENDENTAL kind that each element of their result
#: costs (composites: the kind XLA lowers them to)
_ELEMENTWISE_TRANS = {
    "exp": "exponential", "tanh": "tanh", "log": "log", "log2": "log",
    "log10": "log", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "sigmoid": "logistic", "expm1": "exponential-minus-one",
    "log1p": "log-plus-one", "cos": "cosine", "sin": "sine", "erf": "erf",
    "silu": "logistic", "silu_backward": "logistic",
    "_softmax": "exponential", "_safe_softmax": "exponential",
    "_log_softmax_backward_data": "exponential",
}

#: collective ops (the name's last part) -> kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: in-place ops that write without reading the old values (the others,
#: ``add_`` and the like, read and write the region)
_OVERWRITE = {"copy_", "fill_", "zero_", "index_put_", "index_copy_",
              "index_fill_", "scatter_", "masked_scatter_",
              "_allgather_base_", "allgather_",
              "allgather_into_tensor_coalesced_", "_reduce_scatter_base_",
              "reduce_scatter_", "reduce_scatter_tensor_coalesced_",
              "alltoall_base_", "alltoall_", "uniform_", "normal_",
              "random_", "bernoulli_", "exponential_"}

#: ops that read only the rows they gather from their first operand
_GATHERS = {"index", "index_select", "embedding", "gather", "take"}

#: the CUDA caching allocator's rounding of an allocation
ALLOC_ROUND = 512


def alloc_bytes(n: int) -> int:
    """Bytes the caching allocator counts for an allocation of ``n``."""
    return 0 if n <= 0 else -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _dims(shape) -> str:
    return ",".join(str(int(d)) for d in shape)


def _token(t, region=None, written=False) -> str:
    text = f"{_DTYPE_NAMES.get(t.dtype, 'opaque')}[{_dims(t.shape)}]"
    if region is None and t.dim() and 0 in t.stride():
        region = [d if s else 1 for d, s in zip(t.shape, t.stride())]
    if region is not None and list(region) != list(t.shape):
        text += "{" + _dims(region) + "}"
    return text + ("!" if written else "")


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _base(name: str) -> str:
    """``aten.index_put_.default`` -> ``index_put_``."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else parts[0]


def _written_args(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes in place, from its schema."""
    out = []
    schema = func._schema
    for i, a in enumerate(schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += _tensors(v)
    return out


def _is_view(func) -> bool:
    rets = func._schema.returns
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in rets)


def _index_region(shape, indices):
    idx = [i for i in indices if i is not None]
    if (len(idx) != len(indices)
            or any(i.dtype in (torch.bool, torch.uint8) for i in idx)):
        return None
    lead = torch.broadcast_shapes(*[i.shape for i in idx])
    return list(lead) + list(shape[len(idx):])


def _region(base: str, args, written):
    """The elements an in-place op writes, where fewer than its target's."""
    if base == "index_put_":
        return _index_region(written.shape, args[1])
    if base in ("index_copy_", "index_add_"):
        return list(args[3].shape)
    if base in ("scatter_", "scatter_add_", "scatter_reduce_"):
        return list(args[2].shape)
    if base == "index_fill_":
        shape = list(written.shape)
        shape[args[1]] = args[2].numel()
        return shape
    return None


def _transcendental_kinds(base: str, args, kwargs, outs) -> Dict[str, int]:
    """The elements of each HLO kind an ATen op costs (a composite: the
    kinds XLA lowers it to)."""
    name = base[:-1] if base.endswith("_") and base[:-1] else base
    n = sum(o.numel() for o in outs)
    if name in _ELEMENTWISE_TRANS:
        return {_ELEMENTWISE_TRANS[name]: n}
    if name == "pow":  # an integer exponent is multiplies
        e = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(e, torch.Tensor) or (
                isinstance(e, float) and not float(e).is_integer()):
            return {"power": n}
    if name in ("gelu", "gelu_backward"):
        approx = kwargs.get("approximate", "none") == "tanh"
        return {"tanh" if approx else "erf": n}
    if name == "_log_softmax":  # exp of every element, log of each row
        x, dim = args[0], args[1]
        return {"exponential": x.numel(),
                "log": x.numel() // max(1, x.shape[dim])}
    if name == "logsumexp":
        return {"exponential": args[0].numel(), "log": n}
    if name in ("softplus", "log_sigmoid_forward"):  # log1p(exp(+-x))
        m = outs[0].numel()
        return {"exponential": m, "log-plus-one": m}
    return {}


def _transcendentals(base: str, args, kwargs, outs) -> int:
    """Elements of the reference's TRANSCENDENTAL kinds an ATen op costs."""
    return sum(n for kind, n in _transcendental_kinds(
        base, args, kwargs, outs).items() if kind in TRANSCENDENTAL)


@dataclass
class Memory:
    """One rank's memory over a traced step, in bytes (the reference's
    ``memory_analysis`` names): its arguments and outputs, the outputs
    that alias an argument, the temporaries (the high-water mark of the
    storages the step made, less the outputs among them), and the peak,
    arguments + outputs + temporaries - aliases.  ``high_water`` is the
    most bytes of the step's own storages alive at once, in the caching
    allocator's rounding: what ``torch.cuda.max_memory_allocated`` grows
    by over the step."""

    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    high_water: int = 0

    @property
    def peak_bytes(self) -> int:
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)


class Trace(TorchDispatchMode):
    """Record the operations this rank dispatches (see the module
    docstring).  Used as ``with fake_mode, Trace() as t: out =
    step(*args)`` after ``t.arguments(args)``; then ``t.finish(out)`` and
    ``t.text()``.  ``trace`` does all of it."""

    #: the entry points compute nothing under it (``kernels.common.tracing``)
    fake = True

    def __init__(self, rank: int = 0, world: int = 1, label: str = "step",
                 card: bool = False):
        super().__init__()
        self.rank, self.world, self.label = rank, world, label
        #: take the card's path on any device (``kernels.common.card_path``)
        self.card = card
        self.lines: List[str] = []
        self.kernels: Counter = Counter()
        self.memory = Memory()
        #: the trip count a loop body's records stand for (``trips``)
        self.weight = 1
        self._suppress = 0
        self._args: Dict[int, int] = {}
        self._live: Dict[int, tuple] = {}
        self._now = 0
        self._prev_trace = None
        self._patches: list = []

    # -- storages ----------------------------------------------------------

    @staticmethod
    def _storage(t):
        st = t.untyped_storage()
        return st._cdata, st

    def arguments(self, args) -> None:
        """Note the step's arguments (their storages are not the step's)."""
        for t in _local_tensors(args):
            key, st = self._storage(t)
            if key not in self._args:
                self._args[key] = st.nbytes()
        self.memory.argument_bytes = sum(self._args.values())

    def _freed(self, key, _ref=None) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self._now -= entry[1]

    def _made(self, outs) -> None:
        for t in outs:
            key, st = self._storage(t)
            if key in self._args or key in self._live:
                continue
            n = alloc_bytes(st.nbytes())
            ref = weakref.ref(st, lambda r, k=key: self._freed(k))
            self._live[key] = (ref, n)
            self._now += n
        self.memory.high_water = max(self.memory.high_water, self._now)

    def finish(self, outputs) -> Memory:
        """Account the step's outputs and write the memory lines."""
        m = self.memory
        seen, new = set(), 0
        for t in _local_tensors(outputs):
            key, st = self._storage(t)
            if key in seen:
                continue
            seen.add(key)
            n = st.nbytes()
            m.output_bytes += n
            if key in self._args:
                m.alias_bytes += n
            else:
                new += alloc_bytes(n)
        m.temp_bytes = max(0, m.high_water - new)
        self.lines.append(
            f"# memory: argument_bytes={m.argument_bytes} "
            f"output_bytes={m.output_bytes} alias_bytes={m.alias_bytes} "
            f"temp_bytes={m.temp_bytes} peak_bytes={m.peak_bytes} "
            f"high_water={m.high_water}")
        return m

    # -- recording -----------------------------------------------------------

    def _line(self, name, results, operands, attrs) -> None:
        res = [r if isinstance(r, str) else _token(r) for r in results]
        res_text = res[0] if len(res) == 1 else "(" + ", ".join(res) + ")"
        ops = ", ".join(operands)
        if self.weight > 1:
            attrs = list(attrs) + [f"weight={self.weight}"]
        tail = "".join(f", {a}" for a in attrs)
        self.lines.append(f"%{len(self.lines)} = {res_text} {name}({ops})"
                          f"{tail}, live={self._now}")

    def trips(self, n: int):
        """One trip of a loop of n like trips (``kernels.common.trips``):
        what it records is weighted by n.  The memory is the one trip's: a
        scan's outputs collected over its trips count once."""
        self.weight *= n
        try:
            yield 0
        finally:
            self.weight //= n

    @contextmanager
    def suppressed(self):
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1

    def kernel(self, entry, fn, args, kwargs):
        """A kernel entry point's call (``kernels.common.counted``): one op
        with its operands, outputs and ``Cost``."""
        if self._suppress:
            return fn(*args, **kwargs)
        cost = entry.cost(*args, **kwargs)
        with self.suppressed():
            out = fn(*args, **kwargs)
        outs = _tensors(out)
        self._made(outs)
        self.kernels[entry.__name__] += 1
        self._line(f"kernel.{entry.__name__}", outs,
                   [_token(t) for t in _tensors((args, kwargs))],
                   [f"flops={cost.flops}", f"bytes={cost.bytes}",
                    f"transcendentals={cost.transcendentals}"])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            # let DTensor run and desugar into the local operations (and
            # collectives) of this rank, which come back through this mode
            return NotImplemented
        if self._suppress:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._record(func, str(func), args, kwargs, out)
        return out

    def _record(self, func, name, args, kwargs, out) -> None:
        base = _base(name)
        written = _written_args(func, args, kwargs)
        flat = _tensors((args, kwargs))
        if name.startswith("c10d."):
            # c10d's collectives return the tensors they wrote, unannotated
            written += [t for t in _tensors(out)
                        if any(t is a for a in flat)
                        and not any(t is w for w in written)]
        outs = [t for t in _tensors(out)
                if not any(t is w for w in written)]
        if not outs and not written:  # a metadata query (prim.device, ...)
            return
        attrs = []
        if not written and _is_view(func):
            attrs.append("free")
        region = {}
        if written:
            r = _region(base, args, written[0])
            if r is not None:
                region[id(written[0])] = r
            if base not in _OVERWRITE and not (
                    base == "index_put_"
                    and (len(args) > 3 and args[3]
                         or kwargs.get("accumulate"))):
                attrs.append("rmw")
        elif base in _GATHERS and flat:
            src = args[1] if base == "embedding" else args[0]
            region[id(src)] = list(outs[0].shape)
        operands = [_token(t, region.get(id(t)),
                           any(t is w for w in written)) for t in flat]
        packet = func._overloadpacket
        formula = _flop_registry().get(packet)
        if formula is not None:
            # an ``out_dtype`` overload's dtype is no shape (bmm.dtype)
            flops = formula(*(a for a in args
                              if not isinstance(a, torch.dtype)),
                            **kwargs, out_val=out)
            if flops:
                attrs.append(f"flops={int(flops)}")
        trans = _transcendentals(base, args, kwargs, outs)
        if trans:
            attrs.append(f"transcendentals={trans}")
        self._made(outs)
        self._line(name, outs if outs or not written else written,
                   operands, attrs)

    # -- entering / leaving ------------------------------------------------

    def __enter__(self):
        self._prev_trace = kc.set_trace(self)
        self._patch_dtensor()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kc.set_trace(self._prev_trace)
            for obj, attr, old in reversed(self._patches):
                setattr(obj, attr, old)
            self._patches.clear()

    def _patch(self, obj, attr, wrap) -> None:
        old = getattr(obj, attr, None)
        if old is None:
            return
        self._patches.append((obj, attr, old))
        setattr(obj, attr, wrap(old))

    def _patch_dtensor(self) -> None:
        """Where DTensor is in use: its sharding propagation runs each new
        operation on global-shape fakes to learn the output's metadata (not
        this rank's work), so that runs unrecorded; and a ``"cpu"`` mesh's
        all-to-all, which DTensor issues as an all-gather and a chunk, is
        recorded as the all-to-all a ``"cuda"`` mesh issues."""
        if "torch.distributed.tensor" not in sys.modules:
            return
        from torch.distributed.tensor import _sharding_prop, placement_types

        def quiet(fn):
            def run(*a, **k):
                with self.suppressed():
                    return fn(*a, **k)
            return run

        for attr in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            self._patch(_sharding_prop.ShardingPropagator, attr, quiet)

        def on_host(fn):
            # a strided shard's size is worked out on a real index tensor
            def run(*a, **k):
                from torch._subclasses.fake_tensor import \
                    unset_fake_temporarily
                with self.suppressed(), unset_fake_temporarily():
                    return fn(*a, **k)
            return run

        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None:
            self._patch(strided, "local_shard_size_and_offset", on_host)

        def as_alltoall(fn):
            def run(input, gather_dim, shard_dim, mesh, mesh_dim):
                if mesh.device_type != "cpu" or self._suppress:
                    return fn(input, gather_dim, shard_dim, mesh, mesh_dim)
                with self.suppressed():
                    out = fn(input, gather_dim, shard_dim, mesh, mesh_dim)
                self._made([out])
                self._line("_dtensor.shard_dim_alltoall.default", [out],
                           [_token(input)], [])
                return out
            return run

        self._patch(placement_types, "shard_dim_alltoall", as_alltoall)

    def text(self) -> str:
        head = [f"# repro_torch.calib.hlo trace of {self.label}: rank "
                f"{self.rank} of {self.world}, one line per operation",
                f"# kernels: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(self.kernels.items()))]
        return "\n".join(head + self.lines) + "\n"


class Meter:
    """The kernel entry points' calls in a real run (on the card), each
    priced by its ``Cost``: ``with Meter() as m: step(*args)``, then
    ``m.calls`` (by entry point) and ``m.flops`` / ``m.bytes`` /
    ``m.transcendentals`` summed over them.  The calls compute as they
    always do."""

    fake = False
    card = False

    def __init__(self):
        self.calls: Counter = Counter()
        self.flops = self.bytes = self.transcendentals = 0
        self._prev = None

    def kernel(self, entry, fn, args, kwargs):
        c = entry.cost(*args, **kwargs)
        self.calls[entry.__name__] += 1
        self.flops += c.flops
        self.bytes += c.bytes
        self.transcendentals += c.transcendentals
        return fn(*args, **kwargs)

    def __enter__(self):
        self._prev = kc.set_trace(self)
        return self

    def __exit__(self, *exc):
        kc.set_trace(self._prev)


def _is_dtensor_type(t) -> bool:
    return t.__name__ == "DTensor" and t.__module__.startswith(
        "torch.distributed.tensor")


def _local_tensors(tree) -> list:
    """The tensors of ``tree``, DTensors as this rank's local shard."""
    out = []
    for t in _tensors(tree):
        local = getattr(t, "_local_tensor", None)
        out.append(t if local is None else local)
    return out


_FLOPS = None


def _flop_registry():
    global _FLOPS
    if _FLOPS is None:
        from torch.utils.flop_counter import flop_registry
        _FLOPS = flop_registry
    return _FLOPS


# ---------------------------------------------------------------------------
# tracing a step
# ---------------------------------------------------------------------------


def fake_args(tree, mode, device=None):
    """``tree`` with each tensor leaf made anew as a fake tensor of
    ``mode`` with its shape and dtype, on ``device`` (default: the leaf's
    own; a ``meta`` leaf goes to the CPU).  Fakes of ``mode`` and DTensors
    pass through."""
    from torch._subclasses.fake_tensor import FakeTensor

    def one(t):
        if not isinstance(t, torch.Tensor) or _is_dtensor_type(type(t)):
            return t
        if isinstance(t, FakeTensor) and t.fake_mode is mode:
            return t
        dev = device or (t.device if t.device.type != "meta" else "cpu")
        with mode:
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=dev)

    leaves, spec = tree_flatten(tree)
    return tree_unflatten([one(x) for x in leaves], spec)


def _mode_of(tree):
    from torch._subclasses.fake_tensor import FakeTensor
    for t in _local_tensors(tree):
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return None


def run(step, *args, device=None, rank: int = 0, world: int = 1,
        label: str = "step", card: bool = False):
    """(the trace, the step's outputs): ``step(*args)`` run once on fake
    tensors under a ``Trace``.  Arguments that are not fake yet are made
    anew as fakes (``fake_args``; their values are not used).  ``card``:
    the step takes the card's path whatever the tensors' device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = _mode_of(args) or FakeTensorMode()
    args = fake_args(args, mode, device)
    t = Trace(rank, world, label, card)
    t.arguments(args)
    with mode, t:
        out = step(*args)
    t.finish(out)
    return t, out


def trace(step, *args, device=None, label: str = "step",
          card: bool = False) -> str:
    """The text of ``step(*args)`` as this rank runs it (see the module
    docstring): the port's counterpart of ``compiled.as_text()``."""
    return run(step, *args, device=device, label=label,
               card=card)[0].text()


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\](\{[0-9,]*\})?(!)?")
_LINE_RE = re.compile(r"^%(\d+) = (\(.*?\)|\S+) ([\w.\-:]+)\(([^)]*)\)(.*)$")


@dataclass
class Tok:
    dtype: str
    shape: List[int]
    region: Optional[List[int]] = None
    written: bool = False

    @property
    def bytes(self) -> int:
        n = 1
        for d in (self.shape if self.region is None else self.region):
            n *= d
        return n * DTYPE_BYTES.get(self.dtype, 0)


@dataclass
class Op:
    name: str
    results: List[Tok]
    operands: List[Tok]
    attrs: Dict[str, str] = field(default_factory=dict)

    @property
    def base(self) -> str:
        return _base(self.name)


def _toks(text: str) -> List[Tok]:
    def ints(dims):
        return [int(d) for d in dims.split(",") if d]

    return [Tok(dt, ints(dims), ints(region[1:-1]) if region else None,
                bool(w)) for dt, dims, region, w in _TOKEN_RE.findall(text)]


def parse(text: str) -> List[Op]:
    ops = []
    for line in text.splitlines():
        m = _LINE_RE.match(line)
        if not m:
            continue
        _, res, name, operands, tail = m.groups()
        attrs = {}
        for a in tail.split(","):
            a = a.strip()
            if a:
                k, _, v = a.partition("=")
                attrs[k] = v
        ops.append(Op(name, _toks(res), _toks(operands), attrs))
    return ops


def _collective_kind(op: Op) -> Optional[str]:
    if not (op.name.startswith("_c10d_functional.")
            or op.name.startswith("c10d.")
            or op.name.startswith("_dtensor.")):
        return None
    return _COLLECTIVE_OPS.get(op.base)


def _collective_bytes(kind: str, op: Op) -> float:
    res = sum(t.bytes for t in op.results)
    if kind == "all-reduce":
        return 2.0 * res
    if kind == "reduce-scatter":
        return float(sum(t.bytes for t in op.operands if not t.written)
                     or res)
    return float(res)


def _op_bytes(op: Op) -> int:
    if op.name.startswith("kernel."):
        return int(op.attrs.get("bytes", 0))
    if "free" in op.attrs or op.base in FREE_OPS:
        return 0
    written = [t for t in op.operands if t.written]
    if written:
        reads = sum(t.bytes for t in op.operands if not t.written)
        region = sum(t.bytes for t in written)
        return reads + region * (2 if "rmw" in op.attrs else 1)
    return (sum(t.bytes for t in op.operands)
            + sum(t.bytes for t in op.results))


def analyze(text: str) -> Dict[str, float]:
    """The reference's keys for a ``trace`` text: flops, bytes,
    transcendental_elems, collective_bytes and collectives by kind."""
    flops = byte_traffic = trans = 0.0
    coll: Dict[str, float] = defaultdict(float)
    for op in parse(text):
        w = float(op.attrs.get("weight", 1))
        flops += w * float(op.attrs.get("flops", 0))
        trans += w * float(op.attrs.get("transcendentals", 0))
        byte_traffic += w * _op_bytes(op)
        kind = _collective_kind(op)
        if kind is not None:
            coll[kind] += w * _collective_bytes(kind, op)
    return {
        "flops": flops,
        "bytes": byte_traffic,
        "transcendental_elems": trans,
        "collective_bytes": float(sum(coll.values())),
        "collectives": dict(coll),
    }


def analyze_file(path: str) -> Dict[str, float]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return analyze(f.read())


__all__ = ["DTYPE_BYTES", "TRANSCENDENTAL", "FREE_OPS",
           "Trace", "Meter", "Memory", "run", "trace", "fake_args", "parse",
           "analyze", "analyze_file", "alloc_bytes"]


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(analyze_file(sys.argv[1]), indent=1))
