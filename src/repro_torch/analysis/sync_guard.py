"""Runtime host-sync tripwire: count device -> host waits inside a scope
(the port's counterpart of ``repro.analysis.compile_guard``).

The reference pays for a recompile; the eager port pays for a host sync:
each one stops the host until the card has run every kernel queued before
it, so the host cannot queue the next tick's work ahead. The linter (rule
R001) flags the syncs it can see in the per-forward code; this guard
counts the ones a run really makes, and a test pins them with a budget.

What ``SyncGuard`` counts inside its scope:

  * ``syncs`` — host syncs, each read counted once:
      - scalar reads, seen by a ``TorchDispatchMode`` as
        ``aten._local_scalar_dense`` (``.item()`` and ``int()``/
        ``float()``/``bool()``/``complex()``/``operator.index`` of a
        tensor, also where an op reads one inside, as ``one_hot`` without
        ``num_classes`` does), and the ops that read their inputs on the
        host inside the op: ``equal``, ``allclose``, ``bincount``;
      - device -> host copies: ``Tensor.tolist``, ``.cpu`` and ``.to`` of
        the CPU, wrapped, and on the card the dispatched blocking
        ``_to_copy`` and ``copy_`` from the card into a host tensor. A
        read of what a counted copy returned (``x.cpu().tolist()``) is
        not counted again (on the CPU, where ``.cpu()`` returns the tensor
        itself, the wrapper returns an alias of it to mark). ``.numpy()``
        is not a read: on the card it refuses a device tensor. On the CPU
        a move to the host cannot be told from a move to the device, so
        there ``.to`` counts only where the code names the host by the
        string ``"cpu"``, and ``copy_`` into a host tensor not at all:
        the card's gate (``chip_smoke.py``) sees the rest;
      - ops whose output shape depends on the data: ``nonzero``,
        ``masked_select``, ``unique``, boolean-mask indexing and index
        writes, ``repeat_interleave`` by a tensor of repeats.

    The Tensor methods are wrapped, and not read off the dispatcher alone,
    so that both devices count the same operations: on the CPU ``.cpu()``
    of a CPU tensor dispatches nothing, while on the card it is a copy that
    waits. ``by_kind`` counts each kind of sync apart.
  * ``ops`` — every aten op dispatched, the CPU's proxy for the eager
    kernels a forward launches on the card.
  * ``launches`` — how far each hand-written kernel's ``launches`` counter
    (``repro_torch.kernels.*``; ``flash_attention.bwd_launches`` as
    ``flash_attention_bwd``) moved.

Every patch is restored on exit; nested guards each count everything in
their scope.

pytest integration (``repro_torch.testing``; the marker is registered in
``pytest.ini``)::

    from repro_torch.testing import sync_budget_guard  # noqa: F401

    @pytest.mark.sync_budget(2)
    def test_one_tick(engine):
        engine.step()

fails with ``SyncBudgetExceeded`` if the test body syncs more than twice.
The test's other fixtures are set up before the guard starts, so an
engine built by a fixture is not charged. Tests without the marker are
unaffected.
"""
from __future__ import annotations

import collections
import sys
import threading
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COPIES = ("tolist", "cpu", "to")
_KERNELS = ("paged_attention", "int8_matmul", "flash_attention", "fake_quant",
            "rg_lru")
# ops that read a scalar, or their inputs, on the host
_SCALAR_READS = {"_local_scalar_dense", "equal", "allclose", "bincount"}
# ops whose output size needs the data on the host
_DATA_SHAPED = {"nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
                "unique_consecutive", "unique_dim_consecutive"}
_MASK_INDEXED = {"index", "index_put", "index_put_", "_index_put_impl_"}

# The serving tick's host syncs today, per forward of a model whose
# attention layers write one kind of cache (all paged, or all rings): the
# write targets' nonzero (models/transformer.py, _paged_targets or
# _row_targets) and the .cpu() that brings the sampled tokens to the
# scheduler (serving/scheduler.py). Temperature sampling adds PRNGKey's
# range check (random.py). tests/test_torch_sync_guard.py pins these on
# the CPU, chip_smoke.py on the card.
TICK_SYNCS_PER_FORWARD = 2
SAMPLED_TICK_SYNCS_PER_FORWARD = 3

_active: List["SyncGuard"] = []
_saved: Dict[str, object] = {}
_state = threading.local()


class SyncBudgetExceeded(AssertionError):
    pass


def _busy() -> bool:
    return getattr(_state, "depth", 0) > 0


def _to_host(t: torch.Tensor, args, kwargs) -> bool:
    """``t.to(*args, **kwargs)`` is a blocking move to the host. On the
    CPU only a host named by a string counts: a move to the engine's
    device (a ``torch.device``) looks the same there."""
    device, _, non_blocking, _ = torch._C._nn._parse_to(*args, **kwargs)
    if device is None or device.type != "cpu" or non_blocking:
        return False
    return t.device.type != "cpu" or \
        isinstance(kwargs.get("device", args[0] if args else None), str)


def _wrap(name: str, fn):
    kind = f"Tensor.{name}"

    def counted(self, *args, **kwargs):
        if _busy() or not _active or \
                (name == "to" and not _to_host(self, args, kwargs)):
            return fn(self, *args, **kwargs)
        _state.depth = 1
        try:
            out = fn(self, *args, **kwargs)
        finally:
            _state.depth = 0
        for g in _active:
            if g._counts(self):
                g._add(kind)
        if isinstance(out, torch.Tensor):
            if out is self:
                # on the CPU a move to the host returns the tensor itself:
                # hand back an alias, as the card hands back a copy, so
                # that marking the copy leaves the device tensor's later
                # reads counted
                out = self.view_as(self)
            for g in _active:
                g._mark_host_copy(out)
        return out

    counted.__name__ = name
    counted.__doc__ = getattr(fn, "__doc__", None)
    return counted


def _install() -> None:
    for name in _COPIES:
        # None: the method is inherited from TensorBase, and restored by
        # deleting the wrapper
        _saved[name] = torch.Tensor.__dict__.get(name)
        setattr(torch.Tensor, name, _wrap(name, getattr(torch.Tensor, name)))


def _uninstall() -> None:
    for name, orig in _saved.items():
        if orig is None:
            delattr(torch.Tensor, name)
        else:
            setattr(torch.Tensor, name, orig)
    _saved.clear()


def _bool_index(args) -> bool:
    idx = args[1] if len(args) > 1 else None
    if not isinstance(idx, (list, tuple)):
        return False
    return any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
               for t in idx)


def _read(name: str, func, args, kwargs) -> Optional[torch.Tensor]:
    """The tensor whose data the dispatched op waits for on the host, or
    None."""
    if name in _SCALAR_READS or name in _DATA_SHAPED or \
            (name in _MASK_INDEXED and _bool_index(args)) or \
            (name == "repeat_interleave" and func._overloadname == "Tensor" and
             kwargs.get("output_size") is None):
        return args[0]
    # a blocking copy from another device into a host tensor (on the CPU
    # source and target are one device: never counted here)
    if name == "_to_copy":
        dst, src = kwargs.get("device"), args[0]
        blocking = not kwargs.get("non_blocking", False)
    elif name == "copy_":
        dst, src = args[0].device, args[1]
        blocking = not (args[2] if len(args) > 2 else kwargs.get("non_blocking", False))
    else:
        return None
    if dst is not None and torch.device(dst).type == "cpu" and blocking and \
            isinstance(src, torch.Tensor) and src.device.type != "cpu":
        return src
    return None


class _Counter(TorchDispatchMode):
    def __init__(self, guard: "SyncGuard"):
        super().__init__()
        self.guard = guard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        g = self.guard
        g.ops += 1
        if not _busy():
            name = func.overloadpacket.__name__
            src = _read(name, func, args, kwargs)
            if src is not None and g._counts(src):
                g._add(f"aten.{name}")
        return func(*args, **kwargs)


class SyncGuard:
    """Context manager counting host syncs, dispatched aten ops and kernel
    launches within its scope; raises ``SyncBudgetExceeded`` on exit if
    ``syncs`` exceeds ``budget`` or ``ops`` exceeds ``op_budget``.

    Reads of tensors on the card count when there is one, else reads of
    tensors on the CPU, where the tests hold the same counts; a read of a
    tensor elsewhere waits on nothing.

    >>> with SyncGuard(budget=2) as guard:
    ...     engine.step()
    >>> guard.syncs, dict(guard.by_kind)
    (2, {'aten.nonzero': 1, 'Tensor.cpu': 1})
    """

    def __init__(self, budget: Optional[int] = None,
                 op_budget: Optional[int] = None) -> None:
        self.budget = budget
        self.op_budget = op_budget
        self.device_type = "cuda" if torch.cuda.is_available() else "cpu"
        self.syncs = 0
        self.ops = 0
        self.by_kind: collections.Counter = collections.Counter()
        self.launches: Dict[str, int] = {}
        self._host: Dict[int, weakref.ref] = {}
        self._mode: Optional[_Counter] = None
        self._start: Dict[str, int] = {}

    def _add(self, kind: str) -> None:
        self.syncs += 1
        self.by_kind[kind] += 1

    def _counts(self, t) -> bool:
        """A read of ``t`` waits on the device: ``t`` lives on the guarded
        device and is not what a counted ``.cpu()`` returned."""
        if not isinstance(t, torch.Tensor) or t.device.type != self.device_type:
            return False
        ref = self._host.get(id(t))
        return ref is None or ref() is not t

    def _mark_host_copy(self, t: torch.Tensor) -> None:
        self._host[id(t)] = weakref.ref(t)

    @staticmethod
    def _launch_counts() -> Dict[str, int]:
        out = {}
        for name in _KERNELS:
            mod = sys.modules.get(f"repro_torch.kernels.{name}")
            out[name] = 0 if mod is None else mod.launches
        fa = sys.modules.get("repro_torch.kernels.flash_attention")
        out["flash_attention_bwd"] = 0 if fa is None else fa.bwd_launches
        return out

    def __enter__(self) -> "SyncGuard":
        if not _active:
            _install()
        _active.append(self)
        self._start = self._launch_counts()
        self._mode = _Counter(self)
        self._mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._mode.__exit__(exc_type, exc, tb)
        _active.remove(self)
        if not _active:
            _uninstall()
        end = self._launch_counts()
        self.launches = {k: end[k] - self._start[k] for k in end}
        self._host.clear()
        if exc_type is not None:
            return
        if self.budget is not None and self.syncs > self.budget:
            raise SyncBudgetExceeded(
                f"{self.syncs} host syncs, budget is {self.budget}: "
                f"{dict(self.by_kind)} — a device -> host read was added to "
                f"the counted path")
        if self.op_budget is not None and self.ops > self.op_budget:
            raise SyncBudgetExceeded(
                f"{self.ops} dispatched aten ops, budget is {self.op_budget}")


def make_autouse_fixture(pytest):
    """Build the autouse fixture enforcing ``sync_budget`` markers; the
    port's tests take it from ``repro_torch.testing``."""

    @pytest.fixture(autouse=True)
    def sync_budget_guard(request):
        marker = request.node.get_closest_marker("sync_budget")
        if marker is None:
            yield
            return
        # the test's other fixtures first: only the body is charged
        for name in request.fixturenames:
            if name != request.fixturename:
                request.getfixturevalue(name)
        with SyncGuard(budget=marker.args[0]) as guard:
            yield
        request.node.user_properties.append(("host_syncs", guard.syncs))

    return sync_budget_guard


__all__ = ["SAMPLED_TICK_SYNCS_PER_FORWARD", "SyncBudgetExceeded", "SyncGuard",
           "TICK_SYNCS_PER_FORWARD", "make_autouse_fixture"]
