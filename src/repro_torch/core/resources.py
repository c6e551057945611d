# fmt: off
# A copy of src/repro/core/resources.py, kept in its hand-aligned layout so the
# two stay diffable line for line; the imports name repro_torch and the
# TPU pool factory is replaced by :func:`gpu_pool`.
"""Hierarchical resource pool (paper §4.1).

The paper models a two-layer pool: a *frontend* of low-power edge PEs (ARM
cores, an Nvidia Volta GPU) and a *backend* of DC PEs (Xeon cores, a Tesla
V100, a Xilinx Alveo FPGA), joined by a slow link (12 Mbps in the paper's
experiments). A :class:`ProcessingElement` is anything the workload manager
can place a task on; a :class:`ResourcePool` is the set of PEs plus the
:class:`Link` matrix between *locations*.

The PyTorch port schedules over :func:`paper_pool` or :func:`gpu_pool`; host
PEs run the numpy backend and the other PEs the torch device backend on the
VDC's card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

FRONTEND = "frontend"
BACKEND = "backend"


@dataclasses.dataclass(frozen=True)
class ProcessingElement:
    """One schedulable compute resource.

    Attributes:
      name: unique id, e.g. ``"arm0"`` / ``"xeon2"``.
      kind: device family key into the cost model's throughput table
        (``"arm"``, ``"volta"``, ``"xeon"``, ``"v100"``, ``"alveo"``,
        ``"host_cpu"``).
      location: ``"frontend"`` (edge) or ``"backend"`` (DC) — or a site
        name in a multi-site pool.
      speed: relative throughput multiplier on top of the kind's base rate.
      power_busy / power_idle: Watts, for the energy term of VoS.
      chips: number of chips aggregated by this PE (mesh slices > 1).
    """

    name: str
    kind: str
    location: str = BACKEND
    speed: float = 1.0
    power_busy: float = 100.0
    power_idle: float = 10.0
    chips: int = 1

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name}({self.kind}@{self.location})"


@dataclasses.dataclass(frozen=True)
class Link:
    """Directed link between two locations.

    ``bandwidth`` is bytes/second, ``latency`` seconds. The paper charges
    12 Mbps (1.5e6 B/s) between edge and DC; intra-location transfers are
    free (same memory space / rack-local).
    """

    src: str
    dst: str
    bandwidth: float
    latency: float = 0.0

    def transfer_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.latency + nbytes / self.bandwidth


@dataclasses.dataclass(frozen=True)
class PoolIndex:
    """Immutable int-id view of a :class:`ResourcePool`.

    ``pes[j]`` is PE with id ``j`` (pool order — the order every policy scans
    PEs in, so id order doubles as the deterministic tie-break order),
    ``pe_location[j]`` its location string, ``loc_id`` maps location name →
    dense location id, and ``links[(src_loc, dst_loc)]`` the directed Link.
    """

    pes: Tuple[ProcessingElement, ...]
    idx_of: Dict[str, int]
    pe_location: Tuple[str, ...]
    pe_loc_id: Tuple[int, ...]
    locations: Tuple[str, ...]
    loc_id: Dict[str, int]
    links: Dict[Tuple[str, str], Link]
    #: PE ids grouped by location id — ``loc_pes[loc_id]`` is the tuple of
    #: ``pj`` at that location (pool order). The scheduling engine uses this
    #: to dirty exactly the PEs whose transfer horizons a link booking moved.
    loc_pes: Tuple[Tuple[int, ...], ...] = ()


class DirtyHorizons:
    """Per-PE staleness epochs for incremental schedulers.

    A scheduler placement moves at most (a) one PE's ``pe_free`` horizon and
    (b) the link horizons into the placed PE's *location*. Candidate keys
    cached against PE ``pj`` stay exact until one of those moves; this
    helper tracks that with a monotonically increasing epoch per PE — a
    cached value tagged with ``epoch(pj)`` is still valid iff the epoch is
    unchanged. O(1) per bump (location bumps are O(PEs at location)).
    """

    __slots__ = ("_epoch", "_loc_pes")

    def __init__(self, index: PoolIndex) -> None:
        self._epoch = [0] * len(index.pes)
        self._loc_pes = index.loc_pes

    def epoch(self, pj: int) -> int:
        return self._epoch[pj]

    def bump_pe(self, pj: int) -> None:
        self._epoch[pj] += 1

    def bump_location(self, loc_id: int) -> None:
        ep = self._epoch
        for pj in self._loc_pes[loc_id]:
            ep[pj] += 1


class ResourcePool:
    """A set of PEs + location-to-location links (one JITA-4DS VDC view).

    ``site_of`` is optional federation metadata mapping location name →
    site name (see :mod:`repro.core.federation`). It rides along through
    :meth:`subset` / :meth:`without` / :meth:`union` but is *not* part of
    :class:`PoolIndex` — the scheduling engine never reads it, so flat
    pools and flattened federations index (and therefore schedule)
    identically.
    """

    def __init__(self, pes: Sequence[ProcessingElement],
                 links: Sequence[Link] = (),
                 intra_location_bandwidth: float = math.inf,
                 site_of: Optional[Dict[str, str]] = None) -> None:
        names = [p.name for p in pes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate PE names")
        self.pes: List[ProcessingElement] = list(pes)
        self._by_name = {p.name: p for p in pes}
        self._links: Dict[Tuple[str, str], Link] = {}
        for l in links:
            self._links[(l.src, l.dst)] = l
        self.intra_location_bandwidth = intra_location_bandwidth
        self.site_of: Optional[Dict[str, str]] = (
            dict(site_of) if site_of is not None else None)
        self._index: Optional[PoolIndex] = None

    # -- lookups --------------------------------------------------------------
    def pe(self, name: str) -> ProcessingElement:
        return self._by_name[name]

    def pe_or_none(self, name: str) -> Optional[ProcessingElement]:
        """Like :meth:`pe` but ``None`` for unknown names — schedules that
        outlive an elastic pool change reference PEs no longer present."""
        return self._by_name.get(name)

    def by_location(self, location: str) -> List[ProcessingElement]:
        return [p for p in self.pes if p.location == location]

    def by_kind(self, kind: str) -> List[ProcessingElement]:
        return [p for p in self.pes if p.kind == kind]

    @property
    def locations(self) -> List[str]:
        seen: List[str] = []
        for p in self.pes:
            if p.location not in seen:
                seen.append(p.location)
        return seen

    def link(self, src: str, dst: str) -> Optional[Link]:
        if src == dst:
            return None
        return self._links.get((src, dst))

    def transfer_time(self, src: str, dst: str, nbytes: float) -> float:
        """Seconds to move ``nbytes`` from location src to dst."""
        if nbytes <= 0:
            return 0.0
        if src == dst:
            if self.intra_location_bandwidth == float("inf"):
                return 0.0
            return nbytes / self.intra_location_bandwidth
        link = self.link(src, dst)
        if link is None:
            raise KeyError(f"no link {src!r}->{dst!r}")
        return link.transfer_time(nbytes)

    def validate(self) -> None:
        """Structural invariants: unique PE names, positive speeds, sane
        link parameters. Raises :class:`ValueError` — the sanitizer
        (:func:`repro.core.sanitize.validate_pool`) wraps this into its
        typed error; callers building pools by hand can use it directly."""
        seen: set = set()
        for p in self.pes:
            if p.name in seen:
                raise ValueError(f"duplicate PE name {p.name!r} in pool")
            seen.add(p.name)
            if p.speed <= 0:
                raise ValueError(f"PE {p.name!r} has speed {p.speed}")
        for key in sorted(self._links):
            link = self._links[key]
            if link.bandwidth <= 0:
                raise ValueError(f"link {key} has bandwidth {link.bandwidth}")
            if link.latency < 0:
                raise ValueError(f"link {key} has latency {link.latency}")

    def index(self) -> PoolIndex:
        """Int-id snapshot for the scheduling engine (cached; the PE list and
        link matrix are effectively immutable after construction)."""
        if self._index is None:
            locations = tuple(self.locations)
            loc_id = {loc: i for i, loc in enumerate(locations)}
            pe_loc_id = tuple(loc_id[p.location] for p in self.pes)
            loc_pes = tuple(
                tuple(j for j, li_of in enumerate(pe_loc_id) if li_of == li)
                for li in range(len(locations)))
            self._index = PoolIndex(
                pes=tuple(self.pes),
                idx_of={p.name: j for j, p in enumerate(self.pes)},
                pe_location=tuple(p.location for p in self.pes),
                pe_loc_id=pe_loc_id,
                locations=locations,
                loc_id=loc_id,
                links=dict(self._links),
                loc_pes=loc_pes,
            )
        return self._index

    # -- composition ----------------------------------------------------------
    def subset(self, names: Iterable[str]) -> "ResourcePool":
        keep = set(names)
        return ResourcePool([p for p in self.pes if p.name in keep],
                            list(self._links.values()),
                            self.intra_location_bandwidth,
                            site_of=self.site_of)

    def without(self, names: Iterable[str]) -> "ResourcePool":
        """Complement of :meth:`subset`: the pool minus the named PEs (the
        elastic shrink primitive — drop dead/straggler PEs, keep links)."""
        drop = set(names)
        return ResourcePool([p for p in self.pes if p.name not in drop],
                            list(self._links.values()),
                            self.intra_location_bandwidth,
                            site_of=self.site_of)

    def without_links(self, keys: Iterable[Tuple[str, str]]) -> "ResourcePool":
        """The pool minus the named directed links (the WAN-partition shrink
        primitive — PEs untouched, cross-site channels removed)."""
        drop = set(keys)
        return ResourcePool(self.pes,
                            [l for k, l in self._links.items() if k not in drop],  # det: ok links keep pool construction order
                            self.intra_location_bandwidth,
                            site_of=self.site_of)

    def union(self, other: "ResourcePool") -> "ResourcePool":
        links = {**self._links, **other._links}
        site_of = None
        if self.site_of is not None or other.site_of is not None:
            site_of = {**(self.site_of or {}), **(other.site_of or {})}
        return ResourcePool(self.pes + other.pes, list(links.values()),
                            min(self.intra_location_bandwidth,
                                other.intra_location_bandwidth),
                            site_of=site_of)

    def __len__(self) -> int:
        return len(self.pes)

    def describe(self) -> str:
        parts = []
        for loc in self.locations:
            kinds = [p.kind for p in self.by_location(loc)]
            counts = {k: kinds.count(k) for k in dict.fromkeys(kinds)}
            parts.append(f"{loc}[" + ",".join(f"{v}x{k}" for k, v in counts.items()) + "]")  # det: ok repr only
        return "+".join(parts)


# ---------------------------------------------------------------------------
# Pool factories
# ---------------------------------------------------------------------------

def paper_pool(n_arm: int = 3, n_volta: int = 1, n_xeon: int = 3,
               n_v100: int = 1, n_alveo: int = 1,
               edge_link_bps: float = 12e6 / 8) -> ResourcePool:
    """The paper's hierarchical pool (Fig. 4).

    Defaults are the optimal configuration found by the paper's experiment 1:
    3 ARM + 1 Volta on the frontend, 3 Xeon + 1 V100 + 1 Alveo on the
    backend, with a 12 Mbps (= 1.5e6 B/s) edge↔DC channel [paper §4.2,
    citing an average 4G LTE data rate].
    Power numbers are public TDP-class constants (ARM A72 ~5 W, Volta ~30 W
    for Jetson-class, Xeon ~150 W, V100 ~300 W, Alveo ~100 W).
    """
    pes: List[ProcessingElement] = []
    for i in range(n_arm):
        pes.append(ProcessingElement(f"arm{i}", "arm", FRONTEND, power_busy=5, power_idle=1))
    for i in range(n_volta):
        pes.append(ProcessingElement(f"volta{i}", "volta", FRONTEND, power_busy=30, power_idle=5))
    for i in range(n_xeon):
        pes.append(ProcessingElement(f"xeon{i}", "xeon", BACKEND, power_busy=150, power_idle=30))
    for i in range(n_v100):
        pes.append(ProcessingElement(f"v100_{i}", "v100", BACKEND, power_busy=300, power_idle=50))
    for i in range(n_alveo):
        pes.append(ProcessingElement(f"alveo{i}", "alveo", BACKEND, power_busy=100, power_idle=20))
    links = [
        Link(FRONTEND, BACKEND, edge_link_bps),
        Link(BACKEND, FRONTEND, edge_link_bps),
    ]
    return ResourcePool(pes, links)


def gpu_pool(n_host_cores: int = 8, group_sizes: Sequence[int] = (1, 2, 4, 8),
             nodes: int = 1, pcie_bw: Optional[float] = None,
             net_bw: Optional[float] = None,
             power_limit_w: float = 700.0) -> ResourcePool:
    """H100 hierarchical pool: host CPUs ("edge") + groups of cards ("VDC").

    The port's counterpart of the reference's ``tpu_pool``. Each group PE
    aggregates ``cards`` H100s of one node (``speed`` = its card count;
    the per-card rate of kind ``"gpu"`` comes from the cost model's table,
    which the caller fills from measurements, e.g.
    :func:`repro_torch.core.cost_model.rate_table_with`). Host↔card traffic
    is priced at PCIe Gen5 bandwidth and node↔node traffic at the H100
    network bandwidth of :mod:`repro_torch.core.cost_model`. A card's busy
    power is its power limit (``nvidia-smi``'s ``power.limit``); its idle
    power is a tenth of that, an assumption, not a measurement.
    """
    from repro_torch.core.cost_model import H100_NET_BW, H100_PCIE_BW

    pcie_bw = H100_PCIE_BW if pcie_bw is None else pcie_bw
    net_bw = H100_NET_BW if net_bw is None else net_bw
    pes: List[ProcessingElement] = []
    for i in range(n_host_cores):
        pes.append(ProcessingElement(
            f"host{i}", "host_cpu", FRONTEND, power_busy=15, power_idle=3))
    links: List[Link] = []
    for node in range(nodes):
        loc = f"node{node}"
        for g in group_sizes:
            pes.append(ProcessingElement(
                f"gpu_n{node}_g{g}", "gpu", loc, speed=float(g),
                power_busy=power_limit_w * g, power_idle=0.1 * power_limit_w * g,
                chips=g))
        links.append(Link(FRONTEND, loc, pcie_bw))
        links.append(Link(loc, FRONTEND, pcie_bw))
        for other in range(nodes):
            if other != node:
                links.append(Link(loc, f"node{other}", net_bw))
    return ResourcePool(pes, links)
