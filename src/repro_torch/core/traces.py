"""Volunteer session traces: diurnal churn, heavy tails, device mixtures.

The paper's deployment observation is that volunteers are *people*: JSDoop's
users were online about 6.5 h/day, their browsers span phones to desktops,
and sessions end whenever a tab closes — seconds to hours, with a heavy
tail. A believable 100k–1M volunteer sweep (``benchmarks/browser_scale.py``)
therefore needs fleets shaped like that, not N identical always-on workers.

``generate_sessions`` turns a ``TraceParams`` into ``VolunteerSpec``s for
the Simulator — one spec per SESSION (vid ``d<i>s<j>``), because a device
that reconnects is, to the protocol, a fresh volunteer with the same
identity pattern the gateway's reconnect path exercises. The generative
model, per device:

- **device class** drawn from a speed mixture (mobile / laptop / desktop);
- **sessions** alternate with offline gaps. Gap lengths are exponential,
  scaled so the long-run duty cycle matches ``online_frac`` (the paper's
  6.5/24), and modulated by a sinusoidal **diurnal intensity**: gaps drawn
  at the trough of the day run ~``(1+amp)/(1-amp)`` times longer than at
  the peak, so arrivals bunch into "evening" hours;
- **session lengths** are lognormal (median ``session_median``, shape
  ``session_sigma``) — most sessions are short, a few run very long;
- **warm start**: each device's renewal process is simulated from a burn-in
  period BEFORE t=0 and only the [0, horizon) intersection is emitted (a
  session straddling 0 joins at 0), so the fleet opens in steady state —
  ~``online_frac`` of devices already online — instead of an empty cold
  start no real deployment snapshot would show.

Everything is seeded and pure: the same ``TraceParams`` yields the
bit-identical trace on every call (``random.Random`` per device, keyed on
``(seed, device)``), which the benchmark's determinism and the tests rely
on. The ``day`` period is compressible — benchmarks shrink a "day" to
minutes of virtual time so multi-day availability patterns fit in a run.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.simulator import VolunteerSpec


@dataclass(frozen=True)
class DeviceClass:
    name: str
    speed: float                     # relative to CostModel.flops_per_sec
    weight: float                    # mixture probability (normalized)


# JSDoop Table 3's fleet in miniature: slow phones are the most common
# volunteer, desktops the fastest and rarest.
DEVICE_MIX: Tuple[DeviceClass, ...] = (
    DeviceClass("mobile", 0.3, 0.45),
    DeviceClass("laptop", 1.0, 0.35),
    DeviceClass("desktop", 2.2, 0.20),
)


@dataclass(frozen=True)
class TraceParams:
    n_devices: int                   # people, not sessions
    horizon: float                   # trace length (virtual seconds)
    day: float = 86_400.0            # diurnal period (compress for sims)
    online_frac: float = 6.5 / 24.0  # paper: users online ~6.5 h/day
    diurnal_amplitude: float = 0.6   # 0 = flat arrivals, ->1 = all at peak
    session_median: float = 1800.0   # median session length (s)
    session_sigma: float = 1.2       # lognormal shape: the heavy tail
    device_mix: Tuple[DeviceClass, ...] = DEVICE_MIX
    seed: int = 0


def _intensity(t: float, p: TraceParams, phase: float) -> float:
    """Arrival intensity at time ``t``: 1 +- amplitude over one day."""
    return 1.0 + p.diurnal_amplitude * math.sin(
        2.0 * math.pi * t / p.day + phase)


def _pick_device(rng: random.Random,
                 mix: Tuple[DeviceClass, ...]) -> DeviceClass:
    total = sum(d.weight for d in mix)
    x = rng.random() * total
    for d in mix:
        x -= d.weight
        if x <= 0:
            return d
    return mix[-1]


def generate_sessions(p: TraceParams) -> List[VolunteerSpec]:
    """The full fleet's sessions as simulator specs, sorted by join time."""
    if p.n_devices <= 0:
        raise ValueError("n_devices must be positive")
    if not 0.0 < p.online_frac < 1.0:
        raise ValueError("online_frac must be in (0, 1)")
    if not 0.0 <= p.diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1)")
    mu = math.log(p.session_median)
    mean_session = math.exp(mu + 0.5 * p.session_sigma ** 2)
    # long-run duty cycle f = mean_session / (mean_session + mean_gap)
    mean_gap = mean_session * (1.0 - p.online_frac) / p.online_frac
    specs: List[VolunteerSpec] = []
    for i in range(p.n_devices):
        # int seeding, not the tuple form: tuple seeds go through the
        # deprecated hash-based path (a warning per device at 1M devices)
        rng = random.Random((p.seed << 32) | i)
        device = _pick_device(rng, p.device_mix)
        # small per-device phase jitter: the population shares one "day"
        # (the diurnal signal is correlated) but people aren't synchronized
        # to the minute
        phase = rng.gauss(0.0, 0.35)
        # burn-in: run the renewal process from before t=0 so the window
        # opens in steady state (~online_frac of the fleet mid-session)
        burn = 3.0 * (mean_session + mean_gap)
        t = -burn + rng.random() * mean_gap   # stagger first arrivals
        j = 0
        while t < p.horizon:
            # thinning-style modulation: the mean gap stretches at the
            # trough of the day and shrinks at the peak
            gap = rng.expovariate(1.0 / mean_gap) / _intensity(t, p, phase)
            join = t + gap
            if join >= p.horizon:
                break
            length = rng.lognormvariate(mu, p.session_sigma)
            leave = min(join + length, p.horizon)
            t = join + length
            join = max(join, 0.0)             # clip the straddling session
            if leave > join:
                specs.append(VolunteerSpec(f"d{i}s{j}", speed=device.speed,
                                           join_time=join, leave_time=leave))
                j += 1
    specs.sort(key=lambda s: (s.join_time, s.vid))
    return specs


@dataclass
class TraceStats:
    n_devices: int
    n_sessions: int
    duty_cycle: float                # achieved online fraction of the fleet
    median_session: float
    p95_session: float
    peak_to_trough: float            # hourly join-rate max/min over the day
    speed_counts: Dict[float, int] = field(default_factory=dict)


def trace_stats(specs: List[VolunteerSpec], p: TraceParams) -> TraceStats:
    """Sanity metrics the tests (and benchmark logs) assert against."""
    if not specs:
        raise ValueError("empty trace")
    lengths = sorted(s.leave_time - s.join_time for s in specs)
    online = sum(lengths)
    devices = {s.vid.split("s")[0] for s in specs}
    # hourly (day/24 bucket) join counts, folded onto one day; sessions
    # clipped to the warm-start boundary (join 0.0) aren't real arrivals
    buckets = [0] * 24
    for s in specs:
        if s.join_time > 0.0:
            buckets[int((s.join_time % p.day) / p.day * 24)] += 1
    trough = max(min(buckets), 1)
    speed_counts: Dict[float, int] = {}
    for s in specs:
        speed_counts[s.speed] = speed_counts.get(s.speed, 0) + 1
    return TraceStats(
        n_devices=len(devices),
        n_sessions=len(specs),
        duty_cycle=online / (p.n_devices * p.horizon),
        median_session=lengths[len(lengths) // 2],
        p95_session=lengths[int(len(lengths) * 0.95)],
        peak_to_trough=max(buckets) / trough,
        speed_counts=speed_counts)
