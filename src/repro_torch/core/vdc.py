"""Virtual Data Centers — just-in-time composition of device slices (paper §3).

"JITA-4DS can build a VDC that can meet the application SLO, such as
execution performance and energy consumption ... The selected VDC, then, is
mapped to a set of heterogeneous computing nodes."

A VDC is a named mesh carved out of the device pool for one workload. The
:class:`VDCManager` owns the pool (the host's CUDA devices by default, or
any list of ``torch.device`` — the tests pass duplicated CPU devices),
composes :class:`VirtualDataCenter` instances on demand, tracks allocation,
and releases them when a pipeline finishes. A mesh is a numpy object array
of devices plus axis names.

Sizing uses the VoS-style trade-off of the schedulers: the smallest slice
whose roofline step time (H100 constants, repro_torch.core.cost_model)
meets the SLO deadline, weighing energy (cards × power limit) against value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import RooflineTerms, roofline_time


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of the host; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass VDCManager(devices=[torch.device('cpu')]) "
            "to compose on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objective for one pipeline (paper: performance,
    availability, energy)."""

    step_deadline_s: Optional[float] = None  # max seconds per train/serve step
    energy_budget_w: Optional[float] = None  # max sustained Watts
    min_availability: float = 0.0  # fraction of spare capacity kept


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices laid out on named axes: ``devices.shape`` per ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]


@dataclasses.dataclass
class VirtualDataCenter:
    """One composed VDC: a named mesh over an exclusive device subset."""

    name: str
    mesh: DeviceMesh
    devices: Tuple[torch.device, ...]
    slo: SLO
    predicted: Optional[RooflineTerms] = None

    @property
    def n_chips(self) -> int:
        return len(self.devices)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape, strict=True))


class AllocationError(RuntimeError):
    pass


@dataclasses.dataclass
class FederatedVDC:
    """A VDC composed *across* sites: one named mesh part per site, each an
    ordinary :class:`VirtualDataCenter` registered as ``"{name}@{site}"``,
    composed atomically with a per-site availability reserve."""

    name: str
    parts: Dict[str, VirtualDataCenter]

    @property
    def n_chips(self) -> int:
        return sum(p.n_chips for p in self.parts.values())  # det: ok integer chip counts; sum order-free

    @property
    def sites(self) -> Tuple[str, ...]:
        return tuple(self.parts)


def _mesh(take: Sequence[torch.device], axis_shape: Mapping[str, int]) -> DeviceMesh:
    arr = np.empty(len(take), dtype=object)
    arr[:] = list(take)
    return DeviceMesh(arr.reshape(tuple(axis_shape.values())), tuple(axis_shape))


class VDCManager:
    """Owns the device pool; composes/releases/resizes VDCs.

    ``sites`` registers a federated pool (site name → its devices, in
    site order) and unlocks :meth:`compose_federated`; plain ``devices``
    keeps the flat single-site behaviour."""

    #: per-card power (W) for the energy term of the SLO check: the H100
    #: SXM's 700 W power limit (NVIDIA H100 data sheet)
    CHIP_POWER_W = 700.0

    def __init__(
        self,
        devices: Optional[Sequence[torch.device]] = None,
        sites: Optional[Mapping[str, Sequence[torch.device]]] = None,
    ) -> None:
        if sites is not None:
            if devices is not None:
                raise ValueError("pass devices or sites, not both")
            self._site_devices: Dict[str, List[torch.device]] = {
                s: list(ds) for s, ds in sites.items()  # det: ok caller's site order is the device-pool order contract
            }
            devices = [d for ds in self._site_devices.values() for d in ds]  # det: ok caller's site order is the device-pool order contract
        else:
            self._site_devices = {}
        self._pool: List[torch.device] = list(
            devices if devices is not None else cuda_devices()
        )
        self._free: List[torch.device] = list(self._pool)
        # site tag per free-list slot, parallel to _free (None when flat).
        # Tags track *slots*, not identities: test pools duplicate the same
        # device many times, so identity-based membership would alias.
        self._free_tag: List[Optional[str]] = (
            [s for s, ds in self._site_devices.items() for _ in ds]  # det: ok caller's site order is the device-pool order contract
            if self._site_devices
            else [None] * len(self._pool)
        )
        self._vdc_tags: Dict[str, List[Optional[str]]] = {}
        self._vdcs: Dict[str, VirtualDataCenter] = {}
        self._federated: Dict[str, FederatedVDC] = {}

    # -- introspection --------------------------------------------------------
    @property
    def total_chips(self) -> int:
        return len(self._pool)

    @property
    def free_chips(self) -> int:
        return len(self._free)

    def vdc(self, name: str) -> VirtualDataCenter:
        return self._vdcs[name]

    @property
    def vdcs(self) -> List[VirtualDataCenter]:
        return list(self._vdcs.values())

    # -- sizing ---------------------------------------------------------------
    def size_for_slo(
        self,
        slo: SLO,
        step_flops: float,
        step_hbm_bytes: float,
        coll_bytes_per_chip: float = 0.0,
        candidates: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
    ) -> Tuple[int, RooflineTerms]:
        """Smallest card count whose roofline step time meets the deadline
        and whose power fits the energy budget (paper's VoS trade-off)."""
        best: Optional[Tuple[int, RooflineTerms]] = None
        for c in candidates:
            if c > self.free_chips:
                break
            terms = roofline_time(
                step_flops, step_hbm_bytes, coll_bytes_per_chip, chips=c
            )
            ok_t = (
                slo.step_deadline_s is None or terms.step_time <= slo.step_deadline_s
            )
            ok_e = (
                slo.energy_budget_w is None
                or c * self.CHIP_POWER_W <= slo.energy_budget_w
            )
            if not ok_e:
                break  # more cards only raise power
            best = (c, terms)
            if ok_t:
                return c, terms
        if best is None:
            raise AllocationError("no candidate size fits the free pool")
        return best  # deadline-infeasible: return largest tried (best effort)

    # -- composition ----------------------------------------------------------
    def compose(
        self,
        name: str,
        axis_shape: Mapping[str, int],
        slo: Optional[SLO] = None,
        predicted: Optional[RooflineTerms] = None,
    ) -> VirtualDataCenter:
        """Carve a mesh of ``axis_shape`` (e.g. {"data": 4, "model": 2}).

        Atomic: the pool is mutated only after every construction step has
        succeeded, so a failed compose leaves ``free_chips`` and the VDC
        table untouched. The availability reserve is
        ``ceil(total_chips · min_availability)`` devices that must remain
        *free after* this allocation; devices allocated to other VDCs never
        count toward it.
        """
        if name in self._vdcs or name in self._federated:
            raise AllocationError(f"VDC {name!r} already exists")
        n = int(np.prod(list(axis_shape.values())))
        avail = len(self._free)
        slo = slo or SLO()
        reserve = int(math.ceil(self.total_chips * slo.min_availability))
        if avail - n < reserve:
            raise AllocationError(
                f"need {n} chips, only {avail} free of {self.total_chips} "
                f"(availability reserve {reserve} must stay free)"
            )
        take = self._free[:n]
        mesh = _mesh(take, axis_shape)
        vdc = VirtualDataCenter(name, mesh, tuple(take), slo, predicted)
        self._vdc_tags[name] = self._free_tag[:n]
        self._free = self._free[n:]
        self._free_tag = self._free_tag[n:]
        self._vdcs[name] = vdc
        return vdc

    def compose_for_job(
        self,
        name: str,
        step_flops: float,
        step_hbm_bytes: float,
        slo: SLO,
        model_axis: int = 1,
    ) -> VirtualDataCenter:
        """SLO-driven composition: size via roofline, shape (data, model)."""
        chips, terms = self.size_for_slo(slo, step_flops, step_hbm_bytes)
        chips = max(chips, model_axis)
        data = max(chips // model_axis, 1)
        return self.compose(
            name, {"data": data, "model": model_axis}, slo=slo, predicted=terms
        )

    def compose_federated(
        self,
        name: str,
        site_shapes: Mapping[str, Mapping[str, int]],
        slo: Optional[SLO] = None,
    ) -> FederatedVDC:
        """Compose one VDC across sites: ``site_shapes`` maps site name →
        that site's mesh axis shape.

        Atomic with rollback semantics: every part is checked and built
        against a working copy of the free list, and the pool/VDC tables
        are mutated only after all parts succeeded. The availability
        reserve is enforced **per site**: ``ceil(site_chips ·
        min_availability)`` of each site's own devices must stay free.
        """
        if name in self._vdcs or name in self._federated:
            raise AllocationError(f"VDC {name!r} already exists")
        if not self._site_devices:
            raise AllocationError(
                "compose_federated needs a site registry — construct the "
                "manager with VDCManager(sites={...})"
            )
        slo = slo or SLO()
        new_free = list(self._free)
        new_tags = list(self._free_tag)
        parts: Dict[str, VirtualDataCenter] = {}
        for site, axis_shape in site_shapes.items():  # det: ok allocation follows caller's site order
            if site not in self._site_devices:
                raise AllocationError(f"unknown site {site!r}")
            part_name = f"{name}@{site}"
            if part_name in self._vdcs:
                raise AllocationError(f"VDC {part_name!r} already exists")
            n = int(np.prod(list(axis_shape.values())))
            here = [i for i, tg in enumerate(new_tags) if tg == site]
            site_total = len(self._site_devices[site])
            reserve = int(math.ceil(site_total * slo.min_availability))
            if len(here) - n < reserve:
                raise AllocationError(
                    f"site {site!r}: need {n} chips, only {len(here)} "
                    f"free of {site_total} (per-site availability reserve "
                    f"{reserve} must stay free)"
                )
            take_idx = here[:n]
            take = [new_free[i] for i in take_idx]
            parts[site] = VirtualDataCenter(
                part_name, _mesh(take, axis_shape), tuple(take), slo
            )
            for i in reversed(take_idx):
                del new_free[i]
                del new_tags[i]
        self._free = new_free
        self._free_tag = new_tags
        fed = FederatedVDC(name, parts)
        self._federated[name] = fed
        for site, part in parts.items():  # det: ok key-addressed bookkeeping
            self._vdc_tags[part.name] = [site] * part.n_chips
            self._vdcs[part.name] = part
        return fed

    def federated(self, name: str) -> FederatedVDC:
        return self._federated[name]

    def release_federated(self, name: str) -> None:
        fed = self._federated.pop(name)
        for part in fed.parts.values():  # det: ok release order = compose order (deterministic)
            self.release(part.name)

    def release(self, name: str) -> None:
        vdc = self._vdcs.pop(name)
        self._free.extend(vdc.devices)
        self._free_tag.extend(self._vdc_tags.pop(name, [None] * len(vdc.devices)))

    def resize(self, name: str, axis_shape: Mapping[str, int]) -> VirtualDataCenter:
        """Re-mesh a VDC to a new shape (elastic scale up/down).

        Releases then re-composes, so a resize may reuse the VDC's own
        devices. Atomic: if the re-composition fails, the original VDC (its
        allocation and mesh) is restored before the error propagates.
        """
        old = self._vdcs[name]
        old_tags = self._vdc_tags.get(name)
        self.release(name)  # appends old.devices at the tail of the free list
        try:
            return self.compose(name, axis_shape, slo=old.slo)
        except Exception:
            # compose is atomic, so the free list still ends with exactly
            # old.devices — pop them back off and restore the original VDC
            del self._free[len(self._free) - len(old.devices) :]
            del self._free_tag[len(self._free_tag) - len(old.devices) :]
            self._vdcs[name] = old
            if old_tags is not None:
                self._vdc_tags[name] = old_tags
            raise
