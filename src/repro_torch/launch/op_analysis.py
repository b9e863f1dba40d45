"""Op-level cost analysis of one eager step: FLOPs, bytes, collectives
and peak live memory, per chip.

The port's counterpart of ``repro.launch.hlo_analysis`` (the reference
walks the compiled, partitioned HLO text) and of
``repro.launch.dryrun.parse_collectives`` / ``_type_bytes``. The port has
no HLO: it runs the step eagerly, op by op, and `OpCounter` — a
``TorchDispatchMode`` — sees every op that reaches a kernel:

* with DTensor arguments it steps aside (returns ``NotImplemented``) so
  that DTensor's sharding propagation runs first and the mode then sees
  the per-chip local ops and the collectives DTensor inserts, as the
  reference's analysis reads post-partitioning shapes;
* FLOPs come from ``torch.utils.flop_counter``'s formulas (matrix
  products, attention, convolutions) on the local shapes;
* `eager_op_bytes_per_chip` (the counterpart of the reference's
  ``hbm_bytes_per_chip``) is each op's operand plus result bytes: every
  op of an eager step is a kernel boundary, so this is the traffic the
  eager step moves; a view (and an uninitialised allocation) counts 0.
  It is not a bound: a fusion that removes a copy lowers it;
* `bound_bytes` is the least the step must move: each argument's
  storage read once, each argument storage that the step writes in
  place written once (as many of its bytes as the step writes, at most
  the whole), and each output that is a new storage written once. With
  the FLOPs it gives the step's roofline;
* collectives by kind with the reference's ring estimates: all-reduce
  moves 2x its operand, all-gather its result, reduce-scatter,
  all-to-all and permutes their operand;
* live bytes follow each storage from the op that makes it to its free
  (``weakref.finalize`` on the storage), so `peak_bytes` is the most
  that the step held at once, arguments included.

Under a fake mode only the step's own ops are counted: those whose
results (or, for an op without tensor results, operands) are fake
tensors of the arguments' fake mode. DTensor's own bookkeeping — shard
sizes on small real host tensors, and the global-shape op it runs once
per new signature on a fake mode of its own to learn the result's
shape — is not the step's work, and counting it would make a cell's
numbers depend on what its process traced before.

In eager mode every layer executes, so there is no trip count to
correct for. On fake tensors nothing is allocated anywhere; on real
tensors the same counts describe the run itself. FLOPs come from shapes
on both, so traced FLOPs equal to a real run's show that the traced op
stream is the real one, not a measurement of the card.

Where DTensor cannot lower a view of a sharded tensor (it asks for a
redistribution where GSPMD would reshard by itself), the counter
replicates the mesh axes the error names and retries: each such forced
reshard is recorded (`reshards`: op, global shape, mesh axes, count),
and its all-gather is counted with the other collectives.
"""
from __future__ import annotations

import contextlib
import re
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

# collective op name (both c10d namespaces) -> (kind, operand arg, result
# arg); None means the op's return value
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 0, None),
    "all_reduce_": ("all-reduce", 0, None),
    "all_reduce_coalesced": ("all-reduce", 0, None),
    "allreduce_": ("all-reduce", 0, 0),
    "all_gather_into_tensor": ("all-gather", 0, None),
    "all_gather_into_tensor_coalesced": ("all-gather", 0, None),
    "all_gather_into_tensor_out": ("all-gather", 0, None),
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0, None),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0, None),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "all_to_all_single": ("all-to-all", 0, None),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "broadcast": ("collective-permute", 0, None),
    "broadcast_": ("collective-permute", 0, 0),
    "send": ("collective-permute", 0, 0),
    "recv_": ("collective-permute", 0, 0),
}
_C10D = ("_c10d_functional", "c10d")
# allocations that write nothing, and wrappers: no traffic
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "wait_tensor",
               "_wrap_tensor_autograd"}
_VIEW_ERROR = re.compile(r"unevenly sharded|Attempted to (flatten|split)")


def _reshard_for_view(x, msg: str):
    """(`x` with the mesh axes replicated that a failed view's message
    names — "mesh dimension N", else the tensor "dimension N" that they
    shard —, those axes' names), or None when the message is not a
    view's."""
    if not _VIEW_ERROR.search(msg) or not hasattr(x, "placements"):
        return None
    from torch.distributed.tensor import Replicate
    m = re.search(r"mesh dimension (\d+)", msg)
    if m:
        axes = [int(m.group(1))]
    else:
        m = re.search(r"dimension (\d+)", msg)
        dim = int(m.group(1)) if m else -1
        axes = [i for i, p in enumerate(x.placements)
                if getattr(p, "dim", None) == dim]
    pl = list(x.placements)
    if not axes or all(pl[i].is_replicate() for i in axes):
        return None
    for i in axes:
        pl[i] = Replicate()
    names = x.device_mesh.mesh_dim_names or tuple(range(x.device_mesh.ndim))
    return (x.redistribute(x.device_mesh, pl),
            tuple(str(names[i]) for i in axes))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _local(t):
    """A DTensor's local shard, or the tensor."""
    return getattr(t, "_local_tensor", t)


def tensor_bytes(x) -> int:
    """Bytes of the tensors of a tree (a DTensor's local shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(x))


def storage_bytes(x) -> int:
    """Bytes of the distinct storages of the tensors of a tree (a
    DTensor's local shard): what holding the tree costs."""
    seen, total = set(), 0
    for t in _tensors(x):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live storage of the ops run
    under it (see the module docstring). Under a fake mode, a DTensor op
    is lowered with the fake mode set aside (see `__torch_dispatch__`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.eager_op_bytes = 0
        self.ops = defaultdict(lambda: [0, 0, 0])   # name -> [n, flops, B]
        # (op, global shape, mesh axes) -> count of forced reshards
        self.reshards = defaultdict(int)
        # argument storage -> [bytes, bytes written in place]
        self._args = WeakIdKeyDictionary()
        self.collectives = defaultdict(lambda: {"count": 0, "wire_bytes": 0,
                                                "payload_bytes": 0})
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self.last_op = None          # the op a failed trace stopped at
        self._lowering = False
        # the fake mode of the step's tensors (`analyze` sets it); None
        # counts every op
        self.fake_mode = None

    # ------------------------------------------------------------ memory
    def _free(self, nbytes: int):
        self.live -= nbytes

    def hold(self, tree) -> int:
        """Count the storages of `tree` as live (the step's arguments);
        returns the bytes newly counted."""
        added = 0
        for t in _tensors(tree):
            n = self._track(_local(t))
            if n:
                self._args[_local(t).untyped_storage()] = [n, 0]
            added += n
        return added

    def _note_writes(self, func, args, kwargs):
        """Add the bytes an in-place op writes into an argument's
        storage to that storage's written bytes."""
        schema = getattr(func, "_schema", None)
        if schema is None or not schema.is_mutable:
            return
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            for t in _tensors(v):
                rec = self._args.get(t.untyped_storage())
                if rec is not None:
                    rec[1] += t.numel() * t.element_size()

    def bound_bytes(self, out) -> int:
        """The least the step moves (module docstring): its argument
        storages read once, the argument bytes it writes in place (at
        most each storage) and its new output storages written once."""
        seen, new = set(), 0
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            if st in self._args or id(st) in seen:
                continue
            seen.add(id(st))
            new += st.nbytes()
        return sum(n + min(n, w) for n, w in self._args.values()) + new

    def _track(self, t) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = True
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last_op = func
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            if self._lowering:
                self._lowering = False
                return NotImplemented  # DTensor lowers it to local ops
            # DTensor's bookkeeping (shard sizes and offsets) computes on
            # small host tensors, so lower with the fake mode set aside;
            # the local shards stay fake and their ops come back here
            with unset_fake_temporarily(), self:
                return self._lower(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._is_step_op(args, kwargs, out):
            self._count(func, args, kwargs, out)
        return out

    def _is_step_op(self, args, kwargs, out) -> bool:
        if self.fake_mode is None:
            return True
        ts = list(_tensors(out)) or list(_tensors((args, kwargs)))
        return any(getattr(t, "fake_mode", None) is self.fake_mode
                   for t in ts)

    def _lower(self, func, args, kwargs):
        """DTensor's lowering of `func`. Where a view would split or merge
        a sharded dimension that its sharding does not allow (DTensor
        raises and asks for a redistribution, where GSPMD reshards by
        itself), the mesh axes sharding that dimension are replicated on
        the view's input — an all-gather the analysis counts — and the
        view is tried again."""
        for _ in range(8):
            self._lowering = True
            try:
                return func(*args, **kwargs)
            except RuntimeError as e:
                got = _reshard_for_view(args[0], str(e)) if args else None
                if got is None:
                    raise
                self.reshards[(str(func), tuple(args[0].shape), got[1])] += 1
                args = (got[0],) + tuple(args[1:])
        return func(*args, **kwargs)

    def _count(self, func, args, kwargs, out):
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", str(func))
        ns = getattr(func, "namespace", "")
        full = f"{ns}.{name}"
        rec = self.ops[full]
        rec[0] += 1
        self._note_writes(func, args, kwargs)
        for t in _tensors(out):
            self._track(t)
        if ns in _C10D and name in _COLLECTIVES:
            self._collective(name, args, out)
            return
        fl = 0
        if packet in flop_registry:
            fl = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if not (getattr(func, "is_view", False) or name in _NO_TRAFFIC
                or ns == "prim"):
            nbytes = tensor_bytes((args, kwargs)) + tensor_bytes(out)
        self.flops += fl
        self.eager_op_bytes += nbytes
        rec[1] += fl
        rec[2] += nbytes

    def _collective(self, name, args, out):
        kind, opnd, res = _COLLECTIVES[name]
        operand_b = tensor_bytes(args[opnd])
        result_b = tensor_bytes(out if res is None else args[res])
        if kind == "all-reduce":
            wire = 2 * operand_b
        elif kind == "all-gather":
            wire = result_b
        else:
            wire = operand_b
        c = self.collectives[kind]
        c["count"] += 1
        c["wire_bytes"] += wire
        c["payload_bytes"] += max(operand_b, result_b)
        # the reference's HBM proxy adds 2x a collective's result
        self.eager_op_bytes += 2 * result_b

    # ------------------------------------------------------------ report
    def summary(self) -> dict:
        top = sorted(((n, r[1]) for n, r in self.ops.items() if r[1]),
                     key=lambda kv: -kv[1])[:8]
        return {
            "flops_per_chip": self.flops,
            "eager_op_bytes_per_chip": self.eager_op_bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "wire_bytes_per_chip": sum(v["wire_bytes"]
                                       for v in self.collectives.values()),
            "top_flop_computations": [{"computation": n, "flops": f}
                                      for n, f in top],
            "num_ops": sum(r[0] for r in self.ops.values()),
            "peak_bytes": self.peak,
            "reshards": [{"op": op, "shape": list(shape),
                          "mesh_axes": list(axes), "count": n}
                         for (op, shape, axes), n in self.reshards.items()],
        }

    def op_list(self) -> list:
        """[{op, count, flops, bytes}] by op name, most bytes first."""
        return [{"op": n, "count": r[0], "flops": r[1], "bytes": r[2]}
                for n, r in sorted(self.ops.items(), key=lambda kv: -kv[1][2])]


@contextlib.contextmanager
def _real_shard_bookkeeping():
    """DTensor computes a strided shard's size and offsets on a small
    host ``arange`` (also inside a redistribution's backward); under a
    fake mode that arange would be fake and its values unreadable, so it
    runs with the fake mode set aside while this context is open."""
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def analyze(fn, *args, counter: OpCounter = None) -> dict:
    """Run `fn(*args)` under an `OpCounter` whose live bytes start with
    the arguments' storages. Returns its summary plus "argument_bytes"
    and "output_bytes" (storage bytes of the arguments and of fn's
    result) and "bound_bytes" (`OpCounter.bound_bytes`); pass `counter`
    to keep its op list, and fn's result, which it holds as
    `counter.result`."""
    counter = counter or OpCounter()
    counter.fake_mode = next((t.fake_mode for t in map(_local, _tensors(args))
                              if hasattr(t, "fake_mode")), None)
    arg_bytes = counter.hold(args)
    with _real_shard_bookkeeping(), counter:
        out = fn(*args)
    rec = counter.summary()
    rec["argument_bytes"] = arg_bytes
    rec["output_bytes"] = storage_bytes(out)
    rec["bound_bytes"] = counter.bound_bytes(out)
    counter.result = out
    return rec
