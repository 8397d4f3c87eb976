"""Seeded, declarative fault injection for the serving stack.

Port of ``repro/launch/faults.py``, verbatim: the module is numpy only,
and with the same plan and blocks its chunk lists (NaN positions and Inf
signs included) and action logs equal the reference's bit for bit.

An always-on KWS deployment runs unattended for months against audio it
does not control: ADC glitches hand the pipeline NaN/Inf samples, a
failing microphone bias injects DC, AGC bugs clip at full scale, DMA
descriptors drop or duplicate chunks, and the host scheduler stalls the
serve loop.  This module makes every one of those a *replayable input*:
a ``FaultPlan`` is a seed plus a tuple of declarative ``FaultSpec``s,
and a ``FaultInjector`` built from it corrupts a stream of audio blocks
BIT-EXACTLY the same way every time — each step's randomness is derived
from ``(seed, step, spec_index)`` alone, never from consumption history,
so a failing soak run replays from two integers.

Fault taxonomy (``FaultSpec.kind``):

  Sample-domain (corrupt the block in place, per victim slot):
    ``nan_burst``   — ``burst_samples`` NaNs at a random offset.
    ``inf_burst``   — ±Inf burst (sign per sample, seeded).
    ``dc_offset``   — add ``magnitude`` to every sample of the chunk.
    ``clip``        — drive the chunk ``1 + magnitude``× past full scale
                      and hard-clip it at the 12-bit rails.

  Chunk-structure (reshape the step's chunk list):
    ``zero_chunk``       — prepend a zero-length (B, 0) chunk.
    ``one_sample_chunk`` — split off a 1-sample sliver first.
    ``drop_chunk``       — the whole block is lost upstream.
    ``dup_chunk``        — the block is delivered twice.

  Driver directives (returned as ``FaultAction``s for the serve loop —
  the injector cannot reach the scheduler or the clock itself):
    ``churn_storm`` — reset/readmit ``count`` seeded victim slots.
    ``stall``       — sleep ``magnitude`` seconds before the next step
                      (exercises the step-latency watchdog).

Every spec fires independently per step with probability ``rate``;
``slots`` pins the victims, otherwise one victim is drawn per firing.
``adversarial_plan`` composes a plan from all of these (the soak phase
of ``chip_smoke.py`` drives it); ``tests/test_torch_faults.py`` holds
the port to the reference's chunk lists and action logs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# The closed set of fault kinds — ``FaultSpec`` validates against it so a
# typo'd plan fails at construction, not silently never-fires.
SAMPLE_KINDS = ("nan_burst", "inf_burst", "dc_offset", "clip")
STRUCTURE_KINDS = ("zero_chunk", "one_sample_chunk", "drop_chunk",
                   "dup_chunk")
DRIVER_KINDS = ("churn_storm", "stall")
KINDS = SAMPLE_KINDS + STRUCTURE_KINDS + DRIVER_KINDS

_CLIP_HI = 1.0 - 2.0 ** -11           # 12-bit full-scale rails


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault source.

    kind: one of ``KINDS`` (see module docstring for the taxonomy).
    rate: independent per-step firing probability in [0, 1].
    slots: victim slot ids; ``None`` draws one victim per firing (seeded).
    magnitude: DC level / clip overdrive / stall seconds (kind-specific).
    burst_samples: corrupted samples per ``nan_burst``/``inf_burst``.
    count: victim slots per ``churn_storm``.
    """

    kind: str
    rate: float
    slots: tuple[int, ...] | None = None
    magnitude: float = 0.5
    burst_samples: int = 64
    count: int = 2

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {KINDS})")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")
        if self.burst_samples < 1:
            raise ValueError("burst_samples must be >= 1")
        if self.count < 1:
            raise ValueError("count must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One fault that actually fired (the replay log / driver directive)."""

    step: int
    kind: str
    slots: tuple[int, ...]
    detail: float = 0.0       # burst offset / DC level / stall seconds


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus declarative fault sources — the whole campaign.

    Replay contract: everything an injector does at step ``t`` is a pure
    function of ``(plan.seed, t, spec_index)``.  Two injectors built from
    equal plans and fed equal blocks emit bit-identical chunk lists and
    action logs, regardless of what happened on earlier steps.
    """

    seed: int
    specs: tuple[FaultSpec, ...]

    def rng(self, step: int, spec_index: int) -> np.random.Generator:
        """The derived generator for one (step, spec) cell."""
        return np.random.default_rng([self.seed, step, spec_index])


def adversarial_plan(seed: int, *, nan_rate: float = 0.04,
                     structure_rate: float = 0.03,
                     churn_rate: float = 0.05,
                     stall_rate: float = 0.01,
                     stall_s: float = 0.05) -> FaultPlan:
    """The kitchen-sink campaign the soak harness drives: every fault
    kind armed at once (NaN/Inf bursts, DC, clipping, all four chunk
    deliveries, churn storms, latency stalls)."""
    return FaultPlan(seed=seed, specs=(
        FaultSpec("nan_burst", nan_rate),
        FaultSpec("inf_burst", nan_rate / 2),
        FaultSpec("dc_offset", structure_rate, magnitude=0.4),
        FaultSpec("clip", structure_rate, magnitude=1.0),
        FaultSpec("zero_chunk", structure_rate),
        FaultSpec("one_sample_chunk", structure_rate),
        FaultSpec("drop_chunk", structure_rate),
        FaultSpec("dup_chunk", structure_rate),
        FaultSpec("churn_storm", churn_rate, count=2),
        FaultSpec("stall", stall_rate, magnitude=stall_s),
    ))


def parse_fault_specs(text: str) -> tuple[FaultSpec, ...]:
    """CLI syntax → specs: ``"nan_burst:0.05,clip:0.1"`` (kind:rate
    pairs, comma-separated; empty string = no faults)."""
    specs = []
    for item in filter(None, (s.strip() for s in text.split(","))):
        kind, _, rate = item.partition(":")
        if not rate:
            raise ValueError(f"fault spec {item!r} must be kind:rate")
        specs.append(FaultSpec(kind, float(rate)))
    return tuple(specs)


class FaultInjector:
    """Applies a ``FaultPlan`` to a stream of audio blocks, one serve
    step at a time.

    ``inject`` consumes the step's clean ``(n_slots, samples)`` block and
    returns the possibly-corrupted CHUNK LIST to feed the engine in order
    (structural faults split, drop, or duplicate the block) plus the
    ``FaultAction`` log — including driver directives (churn storms,
    stalls) the caller must execute itself.  The input block is never
    mutated.
    """

    def __init__(self, plan: FaultPlan, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        for spec in plan.specs:
            if spec.slots and max(spec.slots) >= n_slots:
                raise ValueError(f"{spec.kind} targets slot "
                                 f"{max(spec.slots)}, injector has "
                                 f"{n_slots} slots")
        self.plan = plan
        self.n_slots = n_slots
        self.step = 0

    def _victims(self, spec: FaultSpec, rng, k: int = 1) -> tuple[int, ...]:
        if spec.slots is not None:
            return spec.slots
        k = min(k, self.n_slots)
        return tuple(int(s) for s in
                     rng.choice(self.n_slots, size=k, replace=False))

    def inject(self, block: np.ndarray
               ) -> tuple[list[np.ndarray], list[FaultAction]]:
        """Run one step of the campaign over ``block`` (n_slots, S)."""
        block = np.array(block, np.float32, copy=True)
        if block.ndim != 2 or block.shape[0] != self.n_slots:
            raise ValueError(f"block must be ({self.n_slots}, S), got "
                             f"{block.shape}")
        step, n = self.step, block.shape[1]
        self.step += 1
        actions: list[FaultAction] = []
        chunks = [block]
        for i, spec in enumerate(self.plan.specs):
            rng = self.plan.rng(step, i)
            if rng.random() >= spec.rate:
                continue
            if spec.kind in SAMPLE_KINDS and n == 0:
                continue
            if spec.kind in ("nan_burst", "inf_burst"):
                victims = self._victims(spec, rng)
                burst = min(spec.burst_samples, n)
                off = int(rng.integers(0, n - burst + 1))
                for s in victims:
                    if spec.kind == "nan_burst":
                        block[s, off:off + burst] = np.nan
                    else:
                        sign = rng.choice([-1.0, 1.0], size=burst)
                        block[s, off:off + burst] = np.inf * sign
                actions.append(FaultAction(step, spec.kind, victims,
                                           float(off)))
            elif spec.kind == "dc_offset":
                victims = self._victims(spec, rng)
                for s in victims:
                    block[s] += spec.magnitude
                actions.append(FaultAction(step, spec.kind, victims,
                                           spec.magnitude))
            elif spec.kind == "clip":
                victims = self._victims(spec, rng)
                for s in victims:
                    np.clip(block[s] * (1.0 + spec.magnitude) * 4.0,
                            -1.0, _CLIP_HI, out=block[s])
                actions.append(FaultAction(step, spec.kind, victims,
                                           spec.magnitude))
            elif spec.kind == "zero_chunk":
                chunks.insert(0, block[:, :0])
                actions.append(FaultAction(step, spec.kind, ()))
            elif spec.kind == "one_sample_chunk":
                if n >= 2:
                    chunks = [c for piece in chunks for c in
                              ((piece[:, :1], piece[:, 1:])
                               if piece.shape[1] >= 2 else (piece,))]
                    actions.append(FaultAction(step, spec.kind, ()))
            elif spec.kind == "drop_chunk":
                chunks = []
                actions.append(FaultAction(step, spec.kind, ()))
            elif spec.kind == "dup_chunk":
                chunks = chunks + [c.copy() for c in chunks]
                actions.append(FaultAction(step, spec.kind, ()))
            elif spec.kind == "churn_storm":
                victims = self._victims(spec, rng, k=spec.count)
                actions.append(FaultAction(step, spec.kind, victims))
            elif spec.kind == "stall":
                actions.append(FaultAction(step, spec.kind, (),
                                           spec.magnitude))
        return chunks, actions
