# fmt: off
# A copy of src/repro/core/vos.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Value-of-Service (VoS) curves and metrics (paper §3, §4.2.3; refs [20–23]).

JITA-4DS assigns resources to VDCs so as to maximise a *time-dependent*
system-wide value: each pipeline (or pipeline instance) earns a value that
decays with completion time and is discounted by the energy consumed. The
paper defers the full study to its companion report [12]; here we implement
the standard value-curve family from its cited scheduler line of work
(Machovec et al. / Kumbhare et al.) as a first-class, *structured* type:

:class:`ValueCurve` — a piecewise-linear, non-increasing curve (breakpoints
+ per-segment slopes, optional per-curve energy weight) with constructors
for the three canonical SLO shapes:

  * :meth:`ValueCurve.step` — all-or-nothing hard deadline;
  * :meth:`ValueCurve.linear_decay` — flat until a *soft* deadline, linear
    decay to zero at a *hard* deadline (the default curve of the VoS
    scheduling policy);
  * :meth:`ValueCurve.exponential` — a segmented chord approximation of
    ``value·exp(-f/tau)`` (piecewise-linear, so it still qualifies for the
    scheduler's exact per-segment offset fast path).

Because every segment is *affine in finish time*, the scheduling engine
(:class:`repro.core.schedulers._VosRun`) can keep candidates in exact
per-segment offset sub-heaps — key = slope·(base + static offset) +
intercept, order invariant under horizon advances — instead of falling
back to an opaque-callable slow path. Instances carry their *own* curve
through admission, merge and elastic re-planning (see
``schedule_vos(curves=...)`` and ``OnlineDriver.submit(curve=...)``).

Float-exactness contract
------------------------
Curve evaluation is *anchored*: on segment ``i`` (spanning
``[breaks[i-1], breaks[i])``), ``value(f) = values[i] + (f - b) * slopes[i]``
with ``b`` the segment's left breakpoint, clamped from below at
``values[i+1]``. With ``slopes[i] <= 0`` and ``values`` non-increasing this
evaluation is monotone non-increasing *as computed in floats* (rounding is
monotone, ``(f - b) * slope <= 0``, and the clamp absorbs the last-ulp dip
near a breakpoint) — the property the incremental engine's monotone-key
invariant and the online driver's admission-floor gate both rely on, and
the reason the curve is evaluated here rather than by ad-hoc callables.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, TYPE_CHECKING

if TYPE_CHECKING:  # avoid the schedulers <-> vos import cycle at runtime
    from repro_torch.core.schedulers import Schedule
    from repro_torch.core.dag import Task

_INF = float("inf")


def instance_id(task_name: str) -> str:
    """Pipeline-instance id of a task, per the ``name#idx`` convention of
    :meth:`repro.core.dag.PipelineDAG.instance` (tasks without a ``#``
    suffix all belong to the implicit instance ``"0"``)."""
    return task_name.split("#", 1)[1] if "#" in task_name else "0"


def step_value(finish: float, deadline: float, value: float = 1.0) -> float:
    """All-or-nothing deadline value."""
    return value if finish <= deadline else 0.0


def linear_decay(finish: float, soft: float, hard: float,
                 value: float = 1.0) -> float:
    """Flat until ``soft``, linearly decaying to 0 at ``hard``."""
    if finish <= soft:
        return value
    if finish >= hard:
        return 0.0
    return value * (hard - finish) / (hard - soft)


def exponential_decay(finish: float, tau: float, value: float = 1.0) -> float:
    return value * math.exp(-finish / max(tau, 1e-12))


@dataclasses.dataclass(frozen=True)
class ValueCurve:
    """Piecewise-linear, non-increasing value-of-service curve.

    ``breaks`` are the segment boundaries (strictly increasing); segment
    ``i`` spans ``[breaks[i-1], breaks[i])`` (segment 0 is anchored at 0.0,
    the last segment extends to +inf). ``values[i]`` is the curve value at
    segment ``i``'s left boundary and ``slopes[i]`` its (non-positive)
    slope, so there are ``len(breaks) + 1`` of each.

    ``energy_weight`` (value lost per Joule) rides along so a curve fully
    specifies one instance's SLO economics; ``None`` defers to the
    scheduling policy's global weight.

    Instances are hashable (frozen, tuple fields) — the scheduling engine
    folds tasks of *equal* curves into shared candidate classes, so a
    thousand instances with three distinct SLO classes cost three classes,
    not a thousand.
    """

    breaks: Tuple[float, ...]
    values: Tuple[float, ...]
    slopes: Tuple[float, ...]
    energy_weight: Optional[float] = None

    def __post_init__(self) -> None:
        nb, nv, ns = len(self.breaks), len(self.values), len(self.slopes)
        if nv != nb + 1 or ns != nb + 1:
            raise ValueError(
                f"need len(values) == len(slopes) == len(breaks) + 1; got "
                f"{nv}/{ns} for {nb} breaks")
        prev = 0.0
        for b in self.breaks:
            if not (b > prev) or not math.isfinite(b):
                raise ValueError(
                    f"breaks must be finite, positive and strictly "
                    f"increasing; got {self.breaks}")
            prev = b
        for s in self.slopes:
            if not s <= 0.0:  # also rejects NaN
                raise ValueError(
                    f"slopes must be <= 0 (a value curve never grows with "
                    f"finish time); got {self.slopes}")
        for i in range(nv):
            if not math.isfinite(self.values[i]):
                raise ValueError(f"non-finite value in {self.values}")
            if i and not self.values[i] <= self.values[i - 1]:
                raise ValueError(
                    f"segment anchor values must be non-increasing; got "
                    f"{self.values}")

    # -- evaluation -----------------------------------------------------------
    def value(self, finish: float) -> float:
        """Curve value at ``finish`` (monotone non-increasing, also as
        computed in floats — see the module docstring's contract)."""
        breaks = self.breaks
        i = bisect.bisect_right(breaks, finish)
        v = self.values[i]
        s = self.slopes[i]
        if s != 0.0:
            b = breaks[i - 1] if i else 0.0
            v = v + (finish - b) * s
            if i < len(breaks):
                nxt = self.values[i + 1]
                if v < nxt:  # absorb the last-ulp dip below the next anchor
                    v = nxt
        return v

    def value_batch(self, finishes) -> "object":
        """Vectorised :meth:`value` over an array of finish times.

        Returns a float64 ``numpy.ndarray``, bitwise-identical per element
        to the scalar method (``searchsorted(side="right")`` is the array
        form of ``bisect_right``, and the affine evaluation + clamp run
        the same float expressions elementwise) — pinned in
        tests/test_vos_curves.py. Used for floor/telemetry sweeps over
        whole pending sets (e.g. value accounting in
        benchmarks/bench_online.py) where per-finish Python calls
        dominate."""
        import numpy as np
        f = np.asarray(finishes, dtype=np.float64)
        breaks = np.asarray(self.breaks, dtype=np.float64)
        values = np.asarray(self.values, dtype=np.float64)
        slopes = np.asarray(self.slopes, dtype=np.float64)
        i = np.searchsorted(breaks, f, side="right")
        v = values[i]
        s = slopes[i]
        sloped = s != 0.0
        if sloped.any():
            # anchor of segment i is breaks[i-1], 0.0 for the first
            anchors = np.concatenate(([0.0], breaks))
            b = anchors[i]
            v = np.where(sloped, v + (f - b) * s, v)
            # absorb the last-ulp dip below the next anchor (same clamp
            # as the scalar path; the last segment has no next anchor)
            inner = sloped & (i < len(breaks))
            if inner.any():
                nxt = np.concatenate((values[1:], [-_INF]))[i]
                v = np.where(inner & (v < nxt), nxt, v)
        return v

    def segment(self, finish: float
                ) -> Tuple[float, float, float, float, Optional[float]]:
        """``(anchor, value_at_anchor, slope, end, clamp)`` of the segment
        holding ``finish`` — the scheduling engine's offset-form hook
        (:meth:`repro.core.schedulers._VosRun._selector_parts` derives the
        scaled-offset coefficients from it). ``end`` is ``inf`` for the
        last segment; ``clamp`` is the next segment's anchor value (the
        floor :meth:`value` clamps the affine evaluation at), ``None`` on
        the last segment."""
        breaks = self.breaks
        i = bisect.bisect_right(breaks, finish)
        b = breaks[i - 1] if i else 0.0
        if i < len(breaks):
            return b, self.values[i], self.slopes[i], breaks[i], \
                self.values[i + 1]
        return b, self.values[i], self.slopes[i], _INF, None

    def of(self, finish: float, energy: float = 0.0) -> float:
        """Energy-discounted value (``energy_weight=None`` counts as 0 —
        the discount then lives in the policy, not the curve)."""
        ew = self.energy_weight or 0.0
        return self.value(finish) - ew * energy

    def hard_deadline(self) -> float:
        """Earliest finish at which the curve's value has reached 0 —
        ``+inf`` for curves that never do (e.g. :meth:`constant`). The
        deadline the serving engine's ``edf`` rule orders by: a curve is
        piecewise-linear non-increasing, so once zero it stays zero, and
        the last breakpoint is exactly where the terminal flat-0 tail
        starts."""
        if not self.breaks or self.values[-1] > 0.0:
            return _INF
        return self.breaks[-1]

    def as_value_fn(self) -> Callable[["Task", float], float]:
        """Adapt to the legacy ``value_fn(task, finish)`` callable shape."""
        return lambda task, finish: self.value(finish)

    # -- transforms -----------------------------------------------------------
    def shifted(self, dt: float) -> "ValueCurve":
        """The same SLO expressed ``dt >= 0`` seconds later — for
        arrival-relative deadlines (``curve.shifted(arrival_t)``)."""
        if dt < 0:
            raise ValueError("shifted() only moves curves forward in time")
        if dt == 0:
            return self
        # segment 0's anchor stays at 0.0: extend its line backwards
        v0 = self.values[0] - dt * self.slopes[0]
        return ValueCurve(tuple(b + dt for b in self.breaks),
                          (v0,) + self.values[1:], self.slopes,
                          self.energy_weight)

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def constant(value: float = 1.0,
                 energy_weight: Optional[float] = None) -> "ValueCurve":
        """Deadline-free flat value (energy-only VoS trade-off)."""
        return ValueCurve((), (float(value),), (0.0,), energy_weight)

    @staticmethod
    def step(deadline: float, value: float = 1.0,
             energy_weight: Optional[float] = None) -> "ValueCurve":
        """All-or-nothing: ``value`` until ``deadline``, 0 after."""
        return ValueCurve((float(deadline),), (float(value), 0.0),
                          (0.0, 0.0), energy_weight)

    @staticmethod
    def linear_decay(soft: float, hard: float, value: float = 1.0,
                     energy_weight: Optional[float] = None) -> "ValueCurve":
        """Flat until ``soft``, linear decay to 0 at ``hard`` — the curve
        family of the VoS policy's default (Machovec-style soft/hard
        deadline)."""
        soft = float(soft)
        hard = float(hard)
        if not (0.0 < soft < hard):
            raise ValueError(f"need 0 < soft < hard; got {soft}, {hard}")
        return ValueCurve((soft, hard), (float(value), float(value), 0.0),
                          (0.0, -value / (hard - soft), 0.0), energy_weight)

    @staticmethod
    def exponential(tau: float, value: float = 1.0,
                    horizon: Optional[float] = None, segments: int = 8,
                    energy_weight: Optional[float] = None) -> "ValueCurve":
        """Chord approximation of ``value * exp(-finish / tau)``.

        Piecewise-linear over ``segments`` equal spans of ``[0, horizon]``
        (default horizon ``4 * tau``, i.e. down to ~1.8 % of the initial
        value), flat at the terminal chord value beyond — so the curve
        stays non-increasing *and* every region is affine, which keeps
        exponential-SLO instances on the scheduler's offset fast path."""
        if tau <= 0 or segments < 1:
            raise ValueError("need tau > 0 and segments >= 1")
        if horizon is None:
            horizon = 4.0 * tau
        if horizon <= 0:
            raise ValueError("need horizon > 0")
        anchors = [horizon * j / segments for j in range(segments + 1)]
        vals = [value * math.exp(-t / tau) for t in anchors]
        slopes = [(vals[j + 1] - vals[j]) / (anchors[j + 1] - anchors[j])
                  for j in range(segments)] + [0.0]
        return ValueCurve(tuple(anchors[1:]), tuple(vals), tuple(slopes),
                          energy_weight)

    @staticmethod
    def from_spec(spec: "VoSSpec") -> "ValueCurve":
        """The curve equivalent of a :class:`VoSSpec`."""
        return ValueCurve.linear_decay(spec.soft_deadline, spec.hard_deadline,
                                       spec.value, spec.energy_weight)


@dataclasses.dataclass(frozen=True)
class VoSSpec:
    """Per-pipeline value specification (aggregate-metric counterpart of
    :class:`ValueCurve`; ``ValueCurve.from_spec`` converts)."""

    soft_deadline: float
    hard_deadline: float
    value: float = 1.0
    energy_weight: float = 0.0  # value lost per Joule

    def of(self, finish: float, energy: float = 0.0) -> float:
        v = linear_decay(finish, self.soft_deadline, self.hard_deadline, self.value)
        return v - self.energy_weight * energy


def system_vos(schedule: "Schedule", specs: Mapping[str, object],
               instance_of: Optional[Dict[str, str]] = None,
               strict: bool = False) -> float:
    """System-wide VoS of a schedule.

    ``specs`` maps pipeline-instance id → :class:`VoSSpec` or
    :class:`ValueCurve` (anything with ``.of(finish, energy)``);
    ``instance_of`` maps task name → instance id (defaults to the
    ``name#idx`` convention of :meth:`repro.core.dag.PipelineDAG.instance`).
    ``strict=True`` raises on an instance with no spec instead of silently
    scoring it zero — pass it whenever ``specs`` is meant to be total, so a
    key mismatch (e.g. instance names vs ids) fails loud.
    """
    # completion time and energy per instance
    finish: Dict[str, float] = {}
    energy: Dict[str, float] = {}
    for a in schedule.assignments:
        inst = (instance_of or {}).get(a.task)
        if inst is None:
            inst = instance_id(a.task)
        finish[inst] = max(finish.get(inst, 0.0), a.finish)
        energy[inst] = energy.get(inst, 0.0) + a.energy
    total = 0.0
    for inst, f in finish.items():  # det: ok finish dict in assignment order; fixed operand order
        spec = specs.get(inst)
        if spec is None:
            if strict:
                raise KeyError(
                    f"no VoS spec for instance {inst!r} (strict=True); "
                    f"specs cover {sorted(specs)[:5]}...")
            continue
        total += spec.of(f, energy.get(inst, 0.0))
    return total


def uniform_specs(n_instances: int, soft: float, hard: float,
                  value: float = 1.0, energy_weight: float = 0.0) -> Dict[str, VoSSpec]:
    return {str(i): VoSSpec(soft, hard, value, energy_weight)
            for i in range(n_instances)}


def instance_curves(curves: Iterable[ValueCurve]) -> Dict[str, ValueCurve]:
    """Key a per-instance curve sequence by instance id (``"0"``, ``"1"``,
    ... — the ids :func:`instance_id` derives from ``name#idx`` tasks)."""
    return {str(i): c for i, c in enumerate(curves)}


def slo_mix(n_instances: int, horizon: float,
            value: float = 1.0) -> Dict[str, ValueCurve]:
    """Deterministic heterogeneous SLO mix for benchmarks and tests.

    Instance ``i`` cycles through the three canonical shapes — soft/hard
    linear decay, hard step deadline, segmented exponential — with
    deadlines spread over ``[horizon/2, 2*horizon]`` so that at realistic
    loads some instances sit in their flat region, some mid-decay and some
    past their hard deadline. Shared by ``benchmarks/bench_sched.py``
    (``vos_hetero``), ``benchmarks/capture_golden.py`` and the golden /
    differential tests, so all three see the same mix.
    """
    out: Dict[str, ValueCurve] = {}
    for i in range(n_instances):
        stretch = 0.5 + 1.5 * ((i * 7) % n_instances) / max(n_instances, 1)
        h = horizon * stretch
        k = i % 3
        if k == 0:
            out[str(i)] = ValueCurve.linear_decay(h / 2, 2 * h, value)
        elif k == 1:
            out[str(i)] = ValueCurve.step(h, value)
        else:
            out[str(i)] = ValueCurve.exponential(h / 2, value, horizon=2 * h,
                                                 segments=6)
    return out


#: Canonical serving tiers, strongest SLO first. The serving gateway
#: (:mod:`repro.serve.gateway`) maps every request to one of these; the
#: tier's curve (:func:`tier_curve`) is what flows through the online
#: driver's admission gate, load shedding and preemption.
TIERS: Tuple[str, ...] = ("interactive", "batch", "best_effort")


def tier_curve(tier: str, unit: float = 1.0,
               energy_weight: Optional[float] = None) -> ValueCurve:
    """Canonical :class:`ValueCurve` of a serving tier.

    ``unit`` is the latency-budget unit in simulated seconds — tier shapes
    are expressed in multiples of it so one knob rescales the whole SLO
    ladder to a deployment's service-time scale:

    * ``interactive`` — value 8, flat to ``1*unit``, zero at ``4*unit``
      (tight soft/hard window, 8x the value of a batch request — an
      interactive arrival outranks whole groups of batch work at the
      admission gate and can justify preempting it);
    * ``batch`` — value 1, flat to ``8*unit``, zero at ``32*unit``;
    * ``best_effort`` — constant value 0.1, no deadline: it never expires,
      always floors *below* the dated tiers, and is the first thing
      ``shed_pending`` drops under overload.
    """
    if tier == "interactive":
        return ValueCurve.linear_decay(1.0 * unit, 4.0 * unit, 8.0,
                                       energy_weight)
    if tier == "batch":
        return ValueCurve.linear_decay(8.0 * unit, 32.0 * unit, 1.0,
                                       energy_weight)
    if tier == "best_effort":
        return ValueCurve.constant(0.1, energy_weight)
    raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")


def tier_mix(n_instances: int, unit: float = 1.0,
             shares: Tuple[int, ...] = (2, 5, 3)) -> Dict[str, ValueCurve]:
    """Deterministic tiered-SLO mix (the serving analogue of
    :func:`slo_mix`): instance ``i`` takes the tier of a cyclic pattern
    with the given integer ``shares`` per cycle — default 2 interactive :
    5 batch : 3 best-effort per 10 instances."""
    pattern = [t for t, k in zip(TIERS, shares, strict=True)
               for _ in range(k)]
    return {str(i): tier_curve(pattern[i % len(pattern)], unit)
            for i in range(n_instances)}


def normalize_curves(curves: object, n_instances: Optional[int] = None
                     ) -> Optional[Dict[str, ValueCurve]]:
    """Normalise a ``curves=`` argument to an instance-id-keyed dict.

    The one spelling every run-level entry point (``schedule_vos``,
    ``run_instances``, ``run_online``, ``sweep_policies``) accepts:

    * ``None`` — passed through (policy default curve applies);
    * a mapping ``instance id -> ValueCurve`` — copied;
    * a sequence of curves — keyed ``"0"``, ``"1"``, ... by position;
    * a callable ``i -> ValueCurve`` — enumerated over ``n_instances``
      (an error when the instance count is not known at the call site).

    A single :class:`ValueCurve` is rejected with a pointer to
    ``default_curve=`` / ``submit(curve=...)`` — silently enumerating its
    fields would be a miserable bug to chase.
    """
    if curves is None:
        return None
    if isinstance(curves, ValueCurve):
        raise TypeError(
            "curves= takes a per-instance collection; pass a single curve "
            "as default_curve= (or curve= on OnlineDriver.submit)")
    if isinstance(curves, Mapping):
        return dict(curves)
    if callable(curves):
        if n_instances is None:
            raise TypeError(
                "curves=<callable> needs the instance count; pass a "
                "mapping or sequence here, or use a run-level API that "
                "knows n_instances")
        return {str(i): curves(i) for i in range(n_instances)}
    return {str(i): c for i, c in enumerate(curves)}
