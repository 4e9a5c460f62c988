"""Roofline terms of one traced step (port of ``repro.launch.roofline``).

Hardware model: one NVIDIA H100 SXM5 80GB (700 W), datasheet peaks, not
measurements:
    peak bf16 dense compute : 989 TFLOP/s  (H100 SXM5 datasheet)
    HBM3 bandwidth          : 3.35 TB/s    (H100 SXM5 datasheet)
    NVLink 4 bandwidth      : 450 GB/s per direction (datasheet: 900 GB/s
                              total, both directions)

The reference reads XLA's ``cost_analysis`` of a compiled, partitioned
module. The port has no compiled executable: ``StepCounter`` is a
``TorchDispatchMode`` entered around one eager step on DTensors and
reads what each device runs:

  * flops: torch's flop formulas (``torch.utils.flop_counter``) applied
    to the LOCAL tensors of every aten op. The counter returns
    ``NotImplemented`` for an op on DTensors, so DTensor runs first and
    desugars it into ops on local shards and collectives, which the
    counter then sees. Only ops on the step's device type count: DTensor's
    shape propagation runs on ``FakeTensor``s and its redistribution
    planner on small host tensors. Per-device numbers, as XLA's are.
  * bytes: the sum of every non-view aten op's input and output tensor
    bytes on one device: what an eager step reads and writes, the
    analogue of XLA's ``bytes accessed`` (an eager step fuses nothing,
    so it reads more than XLA's fused module does).
  * collectives: every ``_c10d_functional`` op with its result bytes and
    its group's size, priced with the reference's ring multipliers:
        all-reduce        2 (S-1)/S x buffer
        all-gather          (S-1)/S x gathered result
        reduce-scatter      (S-1)/S x input   (= result x S x (S-1)/S)
        all-to-all          (S-1)/S x buffer
        broadcast           1       x buffer  (the reference's permute)

The reference's HLO-text parsing (``parse_collectives``,
``_shape_bytes``) reads XLA's textual module and has no torch meaning;
it is not ported. ``Roofline``, ``CollectiveStats``,
``model_flops_train`` and ``model_flops_infer`` are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s (H100 SXM5 datasheet)
HBM_BW = 3.35e12           # bytes/s (H100 SXM5 datasheet)
NVLINK_BW = 450e9          # bytes/s per direction (H100 SXM5 datasheet, NVLink 4)

_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    buffer_bytes: Dict[str, float]   # per-device buffer bytes by op kind
    wire_bytes: float                # ring-model bytes on the wire / device

    def as_dict(self):
        return {"counts": self.counts, "buffer_bytes": self.buffer_bytes,
                "wire_bytes": self.wire_bytes}


@dataclasses.dataclass
class StepCounts:
    """One traced step's per-device counts (what ``analyze`` reads)."""
    flops: float
    bytes: float
    collectives: CollectiveStats
    n_ops: int


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None       # 6*N*D (per device share)
    useful_flops_ratio: Optional[float] = None
    collectives: Optional[dict] = None
    memory_stats: Optional[dict] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = kwargs.get("group_name")
    if name is None:
        name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


class StepCounter(TorchDispatchMode):
    """Counts flops, bytes and collectives of the local ops of whatever
    runs inside it on ``device_type`` (see the module docstring). Ops on
    other devices are DTensor's own bookkeeping (its redistribution
    planner computes on small host tensors) and are not counted."""

    def __init__(self, device_type: str = "meta"):
        super().__init__()
        self.device_type = device_type
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.coll_counts: Dict[str, int] = {}
        self.coll_buffer: Dict[str, float] = {}
        self.wire = 0.0
        self.last_op: Optional[str] = None      # names the op an error came from

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.last_op = str(func)
            return NotImplemented              # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out                         # DTensor's shape propagation
        outs = _tensors(out)
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        ns = getattr(func, "namespace", "")
        name = func._overloadpacket.__name__
        if ns in _COLL_NAMESPACES:
            kind = _COLL_KIND.get(name)
            if kind is not None:
                self._collective(kind, _nbytes(outs), _group_size(args, kwargs))
            return out
        if getattr(func, "is_view", False) or not outs:
            return out
        self.n_ops += 1
        self.bytes += _nbytes(ins) + _nbytes(outs)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        return out

    def _collective(self, kind: str, nbytes: int, s: int) -> None:
        frac = (s - 1) / max(s, 1)
        if kind == "all-reduce":
            w = 2.0 * frac * nbytes
        elif kind == "all-gather":
            w = frac * nbytes                  # result is the gathered size
        elif kind == "reduce-scatter":
            w = frac * nbytes * s              # input = result x S
        elif kind == "all-to-all":
            w = frac * nbytes
        else:                                  # broadcast
            w = float(nbytes)
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_buffer[kind] = self.coll_buffer.get(kind, 0.0) + nbytes
        self.wire += w

    def counts(self) -> StepCounts:
        return StepCounts(self.flops, self.bytes,
                          CollectiveStats(dict(self.coll_counts), dict(self.coll_buffer),
                                          self.wire), self.n_ops)


def analyze(counts: StepCounts, n_chips: int,
            model_flops_total: Optional[float] = None,
            memory_stats: Optional[dict] = None) -> Roofline:
    """Build the three-term roofline from one traced step's counts."""
    flops, hbm = counts.flops, counts.bytes
    colls = counts.collectives
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    collective_s = colls.wire_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    r = Roofline(
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        wire_bytes_per_device=colls.wire_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        collectives=colls.as_dict(),
        memory_stats=memory_stats,
    )
    if model_flops_total:
        per_dev = model_flops_total / n_chips
        r.model_flops = per_dev
        r.useful_flops_ratio = per_dev / flops if flops else None
    return r


def model_flops_train(n_params_active: int, n_tokens: int) -> float:
    """6*N*D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_infer(n_params_active: int, n_tokens: int) -> float:
    return 2.0 * n_params_active * n_tokens
