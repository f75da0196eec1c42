"""State carried across from the JAX package.

`from_numpy_workload` takes a compiled workload's three pytrees — statics,
per-pod xs and the initial carry — as the JAX package builds them
(kube_scheduler_simulator_tpu/state/compile.py:87), with array leaves that
numpy can read, and returns the port's own NamedTuples of torch tensors.
It is the counterpart of a model port's weight conversion: the tests feed
identical state, seeded random carries included, into the JAX functions
and their ports through it.  Nothing here imports JAX: a NamedTuple is
read through `_fields` and a dict through its keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..plugins.affinity import NodeAffinityStatic, NodeAffinityXS
from ..plugins.base import CoreCarry, to_tensor
from ..plugins.imagelocality import ImageXS
from ..plugins.interpod import InterPodCarry, InterPodStatic, InterPodXS
from ..plugins.noderesources import FitPodXS, FitStatic
from ..plugins.nodevolumelimits import LimitsCarry, LimitsStatic, LimitsXS
from ..plugins.ports import PortsCarry, PortsStatic, PortsXS
from ..plugins.taints import NodeNameXS, TaintXS, UnschedXS
from ..plugins.topologyspread import SpreadStatic, SpreadXS
from ..plugins.volumebinding import BindingCarry, BindingStatic, BindingXS
from ..plugins.volumerestrictions import (RestrictionsCarry, RestrictionsStatic,
                                          RestrictionsXS)
from ..plugins.volumezone import VolumeZoneXS

_STATICS = {
    "core": FitStatic,
    "NodeAffinity": NodeAffinityStatic,
    "PodTopologySpread": SpreadStatic,
    "InterPodAffinity": InterPodStatic,
    "NodePorts": PortsStatic,
    "NodeVolumeLimits": LimitsStatic,
    "VolumeRestrictions": RestrictionsStatic,
    "VolumeBinding": BindingStatic,
}
_XS = {
    "core": FitPodXS,
    "NodeAffinity": NodeAffinityXS,
    "TaintToleration": TaintXS,
    "PodTopologySpread": SpreadXS,
    "InterPodAffinity": InterPodXS,
    "NodeUnschedulable": UnschedXS,
    "NodeName": NodeNameXS,
    "NodePorts": PortsXS,
    "ImageLocality": ImageXS,
    "NodeVolumeLimits": LimitsXS,
    "VolumeRestrictions": RestrictionsXS,
    "VolumeBinding": BindingXS,
    "VolumeZone": VolumeZoneXS,
    "force_unsched": None,  # a bare [P] bool tensor
}
_CARRY = {
    "core": CoreCarry,
    "PodTopologySpread": None,  # a bare [G, N] int32 tensor
    "InterPodAffinity": InterPodCarry,
    "NodePorts": PortsCarry,
    "NodeVolumeLimits": LimitsCarry,
    "VolumeRestrictions": RestrictionsCarry,
    "VolumeBinding": BindingCarry,
}


# fields that are Python ints, not tensors, in the port's NamedTuples
_INT_FIELDS = {"n_groups"}


def _leaf(field: str, v, device):
    if field in _INT_FIELDS:
        return int(np.asarray(v))
    return to_tensor(np.asarray(v), device)


def _fields(tree) -> dict:
    if hasattr(tree, "_fields"):
        return {f: getattr(tree, f) for f in tree._fields}
    if isinstance(tree, dict):
        return dict(tree)
    raise TypeError(f"expected a NamedTuple or a dict, got {type(tree).__name__}")


def _convert(tree: dict, classes: dict, device) -> dict:
    out = {}
    for name, sub in tree.items():
        if name not in classes:
            raise KeyError(f"no port counterpart for {name!r}")
        cls = classes[name]
        if cls is None:
            out[name] = _leaf(name, sub, device)
            continue
        fields = _fields(sub)
        if set(fields) != set(cls._fields):
            raise ValueError(
                f"{name}: fields {sorted(fields)} do not match "
                f"{cls.__name__} {sorted(cls._fields)}")
        out[name] = cls(**{f: _leaf(f, fields[f], device) for f in cls._fields})
    return out


def from_numpy_workload(statics: dict, xs: dict, init_carry: dict,
                        device="cpu") -> tuple[dict, dict, dict]:
    """-> (statics, xs, carry) of the port on `device`, dtypes kept."""
    device = torch.device(device)
    return (_convert(statics, _STATICS, device),
            _convert(xs, _XS, device),
            _convert(init_carry, _CARRY, device))
