# fmt: off
# A copy of src/repro/core/federation.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Edge↔DC federation: site-level topology over the flat scheduling engine.

The paper's deployment is *disaggregated*: a frontend edge box (weak PEs,
holds the raw data) and a backend data centre (strong PEs), joined by a
WAN channel orders of magnitude slower than anything rack-local. The
fault domain of that architecture is the **site** — a whole edge box
loses power, a WAN uplink partitions — not the individual PE.

This module adds the topology layer only. A :class:`Site` groups PEs
with their intra-site links; a :class:`WANLink` joins two sites with a
named :class:`WANLinkClass`; a :class:`FederatedPool` is the federation.
Crucially the engine is *extended, not forked*: :meth:`FederatedPool.flatten`
produces a plain :class:`~repro.core.resources.ResourcePool` whose link
matrix contains the WAN links expanded per cross-site location pair, plus
``site_of`` metadata (location → site) that the engine never reads — so a
flattened federation schedules byte-identically to the equivalent flat
pool, and all the offset-sub-heap machinery (which already keys on
(PE, link)) prices WAN crossings with zero new engine code.

Data gravity rides the same rails: :attr:`FederatedPool.data_home` names
the location holding raw inputs; handing it to
``CostModel(data_home=...)`` makes the engine charge every SOURCE task
placed off-site the WAN upload of its ``in_bytes`` — which pins early
pipeline stages to the edge site exactly as the paper describes.

Site-granularity *failure* semantics (``fail_site`` / ``partition`` /
``heal``) live in :mod:`repro.core.online`; :func:`wan_traffic` is the
observability half (WAN bytes/crossings of a finished schedule).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from .resources import BACKEND, FRONTEND, Link, ProcessingElement, ResourcePool


@dataclasses.dataclass(frozen=True)
class WANLinkClass:
    """A named class of inter-site channel (bytes/second, seconds).

    The classes below span the orders of magnitude the federation is
    about: the paper's measured 4G LTE edge uplink up to intra-DC fabric.
    """

    name: str
    bandwidth: float
    latency: float = 0.0


#: Named WAN classes. ``lte_4g`` is the paper's experimental channel
#: (12 Mbps, §4.2) with zero modelled latency so a federation flattened
#: over it is byte-identical to :func:`~repro.core.resources.paper_pool`.
WAN_CLASSES: Dict[str, WANLinkClass] = {
    "lte_4g": WANLinkClass("lte_4g", 12e6 / 8),
    "broadband": WANLinkClass("broadband", 100e6 / 8, latency=0.02),
    "metro_fiber": WANLinkClass("metro_fiber", 1e9 / 8, latency=0.005),
    "dcn": WANLinkClass("dcn", 25e9, latency=0.0),
}


@dataclasses.dataclass(frozen=True)
class Site:
    """A co-located group of PEs: one fault domain of the federation.

    ``links`` are the site's *intra*-site links (between its own
    locations); most sites have a single location and need none.
    """

    name: str
    pes: Tuple[ProcessingElement, ...]
    links: Tuple[Link, ...] = ()

    def __init__(self, name: str, pes: Sequence[ProcessingElement],
                 links: Sequence[Link] = ()) -> None:
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "pes", tuple(pes))
        object.__setattr__(self, "links", tuple(links))

    @property
    def locations(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for p in self.pes:
            if p.location not in seen:
                seen.append(p.location)
        return tuple(seen)

    @property
    def pe_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.pes)


@dataclasses.dataclass(frozen=True)
class WANLink:
    """A bidirectional WAN attachment between two sites.

    Flattening expands it to directed :class:`Link` rows for every
    cross-site location pair, in both directions — the engine's
    per-(PE, link) offset heaps then price each direction independently,
    exactly as they do for the flat paper pool's edge↔DC channel.
    """

    a: str
    b: str
    cls: WANLinkClass

    @property
    def pair(self) -> FrozenSet[str]:
        return frozenset((self.a, self.b))


class FederatedPool:
    """An ordered set of :class:`Site`\\ s joined by :class:`WANLink`\\ s.

    ``home`` names the site holding the raw data *and* the driver's
    control plane (default: the first site). Reachability — and therefore
    which work a partition defers — is computed from ``home``: when a WAN
    cut isolates a site, the sites still reachable from home keep
    executing (degraded mode) while work bound for the far side is
    deferred.
    """

    def __init__(self, sites: Sequence[Site], wan: Sequence[WANLink] = (),
                 intra_location_bandwidth: float = math.inf,
                 home: Optional[str] = None) -> None:
        names = [s.name for s in sites]
        if len(set(names)) != len(names):
            raise ValueError("duplicate site names")
        if not sites:
            raise ValueError("a federation needs at least one site")
        self.sites: Tuple[Site, ...] = tuple(sites)
        self._site_by_name: Dict[str, Site] = {s.name: s for s in sites}
        locs_seen: Dict[str, str] = {}
        for s in sites:
            for loc in s.locations:
                if loc in locs_seen and locs_seen[loc] != s.name:
                    raise ValueError(
                        f"location {loc!r} appears in sites "
                        f"{locs_seen[loc]!r} and {s.name!r}")
                locs_seen[loc] = s.name
        for w in wan:
            for end in (w.a, w.b):
                if end not in self._site_by_name:
                    raise ValueError(f"WAN link references unknown site {end!r}")
        self.wan: Tuple[WANLink, ...] = tuple(wan)
        self.intra_location_bandwidth = intra_location_bandwidth
        self.home: str = home if home is not None else self.sites[0].name
        if self.home not in self._site_by_name:
            raise ValueError(f"unknown home site {self.home!r}")
        self._flat: Optional[ResourcePool] = None

    # -- lookups -----------------------------------------------------------
    def site(self, name: str) -> Site:
        return self._site_by_name[name]

    @property
    def site_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.sites)

    @property
    def data_home(self) -> str:
        """The location raw inputs live at — hand to ``CostModel(data_home=)``
        so the engine prices edge uploads (data gravity)."""
        locs = self.site(self.home).locations
        if not locs:
            raise ValueError(f"home site {self.home!r} has no PEs")
        return locs[0]

    def site_of_pe(self, pe_name: str) -> Optional[str]:
        for s in self.sites:
            if pe_name in s.pe_names:
                return s.name
        return None

    # -- flattening --------------------------------------------------------
    def flatten(self) -> ResourcePool:
        """The equivalent flat :class:`ResourcePool` (cached).

        PEs in site order; links = every site's intra-site links plus each
        WAN link expanded to directed rows for all cross-site location
        pairs; ``site_of`` metadata (location → site) attached for the
        site-aware layers (driver, elastic pruning) — the engine's
        :class:`~repro.core.resources.PoolIndex` ignores it.
        """
        if self._flat is None:
            pes: List[ProcessingElement] = []
            links: List[Link] = []
            site_of: Dict[str, str] = {}
            for s in self.sites:
                pes.extend(s.pes)
                links.extend(s.links)
                for loc in s.locations:
                    site_of[loc] = s.name
            for w in self.wan:
                links.extend(self._expand_wan(w))
            self._flat = ResourcePool(
                pes, links, self.intra_location_bandwidth, site_of=site_of)
            from repro_torch.core import sanitize
            if sanitize.enabled():
                sanitize.validate_pool(self._flat)
        return self._flat

    def _expand_wan(self, w: WANLink) -> List[Link]:
        out: List[Link] = []
        for la in self.site(w.a).locations:
            for lb in self.site(w.b).locations:
                out.append(Link(la, lb, w.cls.bandwidth, w.cls.latency))
                out.append(Link(lb, la, w.cls.bandwidth, w.cls.latency))
        return out

    def wan_keys(self, a: str, b: str) -> List[Tuple[str, str]]:
        """Directed flat-link keys between sites ``a`` and ``b`` (both
        directions) — the link set a partition of that WAN pair cuts."""
        keys: List[Tuple[str, str]] = []
        for w in self.wan:
            if w.pair == frozenset((a, b)):
                for link in self._expand_wan(w):
                    keys.append((link.src, link.dst))
        return keys

    def wan_keys_touching(self, site: str) -> List[Tuple[str, str]]:
        """Directed flat-link keys of every WAN link with ``site`` at
        either end — the link set isolating the site cuts."""
        keys: List[Tuple[str, str]] = []
        for w in self.wan:
            if site in w.pair:
                for link in self._expand_wan(w):
                    keys.append((link.src, link.dst))
        return keys

    def wan_pairs_touching(self, site: str) -> Set[FrozenSet[str]]:
        return {w.pair for w in self.wan if site in w.pair}

    # -- reachability ------------------------------------------------------
    def reachable(self, cut: Iterable[FrozenSet[str]] = (),
                  down: Iterable[str] = ()) -> Set[str]:
        """Site names reachable from ``home`` over WAN links not in ``cut``
        (unordered site pairs), skipping sites in ``down`` entirely."""
        cut_set = set(cut)
        down_set = set(down)
        if self.home in down_set:
            return set()
        adj: Dict[str, Set[str]] = {s.name: set() for s in self.sites}
        for w in self.wan:
            if w.pair in cut_set:
                continue
            if w.a in down_set or w.b in down_set:
                continue
            adj[w.a].add(w.b)
            adj[w.b].add(w.a)
        seen = {self.home}
        frontier = [self.home]
        while frontier:
            cur = frontier.pop()
            for nxt in adj[cur]:
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    def sub_pool(self, site_names: Iterable[str]) -> ResourcePool:
        """Flat pool of just the named sites: their PEs, intra-site links,
        and the WAN links *between included sites* — the reachable
        sub-topology a post-site-loss restart re-plans against."""
        keep = set(site_names)
        pes: List[ProcessingElement] = []
        links: List[Link] = []
        site_of: Dict[str, str] = {}
        for s in self.sites:
            if s.name not in keep:
                continue
            pes.extend(s.pes)
            links.extend(s.links)
            for loc in s.locations:
                site_of[loc] = s.name
        for w in self.wan:
            if w.a in keep and w.b in keep:
                links.extend(self._expand_wan(w))
        return ResourcePool(pes, links, self.intra_location_bandwidth,
                            site_of=site_of)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------

def paper_federation(n_arm: int = 3, n_volta: int = 1, n_xeon: int = 3,
                     n_v100: int = 1, n_alveo: int = 1,
                     wan: str = "lte_4g") -> FederatedPool:
    """The paper's deployment as a two-site federation.

    Site ``edge`` (frontend: ARM + Volta, holds the raw data — it is the
    federation ``home``) and site ``dc`` (backend: Xeon + V100 + Alveo),
    joined by the named WAN class (default the paper's 12 Mbps 4G LTE
    channel). ``flatten()`` is byte-identical to
    :func:`~repro.core.resources.paper_pool` with default arguments —
    pinned by tests/test_federation.py.
    """
    edge_pes: List[ProcessingElement] = []
    for i in range(n_arm):
        edge_pes.append(ProcessingElement(
            f"arm{i}", "arm", FRONTEND, power_busy=5, power_idle=1))
    for i in range(n_volta):
        edge_pes.append(ProcessingElement(
            f"volta{i}", "volta", FRONTEND, power_busy=30, power_idle=5))
    dc_pes: List[ProcessingElement] = []
    for i in range(n_xeon):
        dc_pes.append(ProcessingElement(
            f"xeon{i}", "xeon", BACKEND, power_busy=150, power_idle=30))
    for i in range(n_v100):
        dc_pes.append(ProcessingElement(
            f"v100_{i}", "v100", BACKEND, power_busy=300, power_idle=50))
    for i in range(n_alveo):
        dc_pes.append(ProcessingElement(
            f"alveo{i}", "alveo", BACKEND, power_busy=100, power_idle=20))
    return FederatedPool(
        [Site("edge", edge_pes), Site("dc", dc_pes)],
        wan=[WANLink("edge", "dc", WAN_CLASSES[wan])],
        home="edge",
    )


# ---------------------------------------------------------------------------
# Observability: WAN traffic of a finished schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WANTraffic:
    """WAN bytes moved / crossings of a schedule over a federation."""

    bytes_moved: float = 0.0
    crossings: int = 0
    upload_bytes: float = 0.0  # raw-input (in_bytes) share of bytes_moved


def wan_traffic(assignments, dags, pool: ResourcePool,
                data_home: Optional[str] = None) -> WANTraffic:
    """Tally cross-site traffic implied by ``assignments``.

    A predecessor pull whose producer sits on a different site than the
    consumer charges the edge's ``out_bytes``; a SOURCE task with
    ``in_bytes`` placed off the data-home site charges the upload.
    ``pool`` must carry ``site_of`` metadata (a flattened federation);
    tasks on PEs no longer in the pool are skipped.
    """
    site_of = pool.site_of or {}

    def _site(loc: Optional[str]) -> Optional[str]:
        return site_of.get(loc) if loc is not None else None

    loc_of: Dict[str, Optional[str]] = {}
    for a in assignments:
        pe = pool.pe_or_none(a.pe)
        loc_of[a.task] = pe.location if pe is not None else None

    out = WANTraffic()
    home_site = _site(data_home)
    for dag in dags:
        for t in dag.tasks:
            loc = loc_of.get(t.name)
            if loc is None:
                continue
            s = _site(loc)
            if t.in_bytes > 0 and home_site is not None and s != home_site:
                out.bytes_moved += t.in_bytes
                out.upload_bytes += t.in_bytes
                out.crossings += 1
            for p in dag.predecessors(t.name):
                ploc = loc_of.get(p.name)
                if ploc is None:
                    continue
                if _site(ploc) != s and p.out_bytes > 0:
                    out.bytes_moved += p.out_bytes
                    out.crossings += 1
    return out
