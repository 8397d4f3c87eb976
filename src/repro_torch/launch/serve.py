"""Serve CLI of the port: ``python -m repro_torch.launch.serve``.

``--mode lm`` (default): greedy decoding with one of the LM stacks
(``--arch``, default ``qwen2-0.5b``, its smoke config with the port's
seeded init), as the reference serves them: ``--requests`` random
prompts of ``--prompt-len`` tokens over ``--slots`` slots, each slot a
batch-of-one cache of ``--cache-len`` positions (admission stays
independent per slot); a prompt is prefilled, then ``--max-new`` tokens
are decoded by argmax over the padded vocabulary; a finished slot admits
the next request.  It prints ``served N requests, T tokens in …``.

``--mode kws-audio``: continuous batching of synthesized 1 s
utterances over ``--slots`` stream slots: each step runs one
``--chunk-samples`` chunk per slot through the FEx and ΔGRU kernels,
finished utterances are decided by majority vote and their slots
re-admitted.

``--mode kws-detect``: always-on detection.  Every slot listens to one
continuous synthesized stream (``--stream-seconds`` long, keywords at
``--events-per-min`` in a noise bed at ``--snr-db``, from ``--seed``,
the reference's stream-synthesis seed); each step runs FEx → VAD gate → ΔGRU → FC → the
detection head kernel, and the fires are scored against the streams'
ground-truth events: hits, misses, false alarms per hour, VAD duty.

``--mode kws-cascade``: the same always-on detection through the
two-stage wake cascade.  An always-on stage-0 micro-ΔGRU (16 units over
the leading ``--s0-channels`` FEx channels, a binary head, Δ_TH
``--s0-threshold``) scores every frame; the wake machine
(``--wake-threshold`` / ``--sleep-threshold`` / ``--hangover-frames``)
keeps stage 1 awake around candidate events, and stage 1 runs only on
awake frames.  The report adds the stage-1 duty and the per-stage energy
split.  Stage 0 starts from the seeded init (seed 7, as the reference
seeds it).

Weights come from ``--params`` (a checkpoint's ``arrays.npz``, as
either package writes it) or, without it, from ``models.kws.init_kws``
seeded by the port-only ``--init-seed`` (default 0, which also seeds the
quick training and, plus one, the kws-audio requests: the reference's
fixed seeds); ``--train-steps N`` (default 120, the reference's) then
quick-trains them on the device before serving, as the reference's serve
does (``--train-steps 0`` serves them as they are): utterance-level
(``kws.loss_fn`` on ``synth_batch``) for kws-audio, frame-level
(``kws.frame_loss_fn`` on ``synth_frame_batch`` streams) for kws-detect
and kws-cascade, whose stage 0 is trained too (binary head, labels
keyword vs background, its own seed 7), QAT when serving int8.  Runs on
``--device`` (default ``cuda``; raises without a GPU).

``--numerics int8`` serves the deployed integer datapath (integer FEx →
int8-weight ΔGRU → integer FC, one launch of each integer kernel per
step): the float weights are promoted into the integer bundle at session
creation, or ``--bundle X.npz`` serves a promoted bundle as
``train.promote.save_bundle`` writes it (one the JAX package wrote loads
unchanged), implies ``--numerics int8`` and skips stage 1's training.

Every mode serves through the pipelined engine (``launch.engine``):
while one step computes on the card the host assembles the next block
and drains an earlier step's results, keeping ``--inflight-depth`` steps
in flight (default 2; ``--sync-loop`` is depth 1).  Decisions and
counters are equal at every depth.

Fault tolerance: ``--faults "nan_burst:0.05,clip:0.1"`` arms a seeded
``launch.faults`` campaign (replay it from ``--fault-seed``), the session
runs with the self-healing supervisor unless ``--no-supervisor``, and
``--input-policy`` picks what ``process_audio`` does with hostile
samples (forced to ``trust`` while faults are armed, so injected NaNs
reach the card).  ``AdmissionController`` is the overload half: a
bounded request queue (``--max-queue``) that sheds when full, a Δ_TH
ladder (``--degrade-thresholds``) stepped up under sustained queue
pressure and back down with hysteresis, and a step-latency watchdog
(``--watchdog-ms``) whose breaches count as pressure.

``--devices N`` shards the slot axis of kws-audio, kws-detect and
kws-cascade over a slot mesh (``launch.mesh``): on the card
``make_slot_mesh(N)``, one shard per card, each on its own CUDA stream
(it raises when fewer than N cards are visible); with ``--device cpu``,
N shards on the CPU, the counterpart of the reference's ``XLA_FLAGS``
host split.  ``--slots`` must divide by N.  The scheduler balances
admissions across the shards, and decisions are those of ``--devices 1``
bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Graceful-degradation policy for ``AdmissionController``.

    thresholds: the Δ_TH ladder, base operating point FIRST, ascending —
      each escalation moves one rung up (cheaper, less accurate), each
      release one rung down.
    max_queue: bounded-queue depth; ``submit`` beyond it is SHED.
    high_water / low_water: queue-pressure fractions that count a step
      toward escalation / release.  The dead band between them is the
      hysteresis that keeps the controller from flapping.
    up_after / down_after: consecutive high- (low-) pressure steps
      before the ladder moves.  ``down_after > up_after`` by default:
      degrade fast, recover deliberately.
    watchdog_ms: step-latency budget; a breach counts as a high-pressure
      observation even with an empty queue (None disables).
    """

    thresholds: tuple = (0.1,)
    max_queue: int = 64
    high_water: float = 0.75
    low_water: float = 0.25
    up_after: int = 3
    down_after: int = 8
    watchdog_ms: float | None = None

    def __post_init__(self):
        if not self.thresholds:
            raise ValueError("need at least one (base) Δ_TH rung")
        if list(self.thresholds) != sorted(set(self.thresholds)):
            raise ValueError(f"Δ_TH ladder must be strictly ascending, "
                             f"got {self.thresholds}")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not (0.0 <= self.low_water < self.high_water <= 1.0):
            raise ValueError(
                f"need 0 <= low_water < high_water <= 1, got "
                f"low={self.low_water} high={self.high_water}")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after / down_after must be >= 1")


class AdmissionController:
    """Bounded admission + graceful degradation for a KWS serve loop.

    Host-side only.  The loop calls ``submit(payload)`` instead of
    enqueueing directly (False = queue full, request shed) and
    ``observe(step_s)`` once per serve step; the controller tracks queue
    pressure against the ``OverloadPolicy`` watermarks and drives the
    session's ``set_threshold`` up and down the Δ_TH ladder with
    hysteresis.  ``level`` is the current rung (0 = base operating
    point); ``stats()`` reports sheds, escalations, releases and
    watchdog breaches.
    """

    def __init__(self, session, scheduler, policy: OverloadPolicy):
        self._sess = session
        self._sched = scheduler
        self.policy = policy
        self.level = 0
        self.shed = 0
        self.escalations = 0
        self.releases = 0
        self.watchdog_breaches = 0
        self._hi_streak = 0
        self._lo_streak = 0
        session.set_threshold(policy.thresholds[0])

    def submit(self, payload) -> bool:
        """Admit one request into the bounded queue; False = shed."""
        if len(self._sched) >= self.policy.max_queue:
            self.shed += 1
            return False
        self._sched.submit(payload)
        return True

    @property
    def threshold(self) -> float:
        return self.policy.thresholds[self.level]

    def observe(self, step_s: float):
        """One per-step pressure observation (queue depth + latency)."""
        p = self.policy
        pressure = len(self._sched) / p.max_queue
        slow = p.watchdog_ms is not None and step_s * 1e3 > p.watchdog_ms
        if slow:
            self.watchdog_breaches += 1
        if pressure >= p.high_water or slow:
            self._hi_streak += 1
            self._lo_streak = 0
            if self._hi_streak >= p.up_after and \
                    self.level < len(p.thresholds) - 1:
                self.level += 1
                self.escalations += 1
                self._hi_streak = 0
                self._sess.set_threshold(p.thresholds[self.level])
        elif pressure <= p.low_water:
            self._lo_streak += 1
            self._hi_streak = 0
            if self._lo_streak >= p.down_after and self.level > 0:
                self.level -= 1
                self.releases += 1
                self._lo_streak = 0
                self._sess.set_threshold(p.thresholds[self.level])
        else:                       # dead band: hold level, reset streaks
            self._hi_streak = 0
            self._lo_streak = 0

    def stats(self) -> dict:
        return {"level": self.level, "threshold": self.threshold,
                "shed": self.shed, "escalations": self.escalations,
                "releases": self.releases,
                "watchdog_breaches": self.watchdog_breaches}


def _parse_ladder(text: str, base: float) -> tuple:
    """CLI Δ_TH ladder: ``--degrade-thresholds "0.2,0.4"`` lists the
    degraded rungs ABOVE the base operating point (empty = no
    degradation, base rung only)."""
    rungs = tuple(float(x) for x in
                  filter(None, (s.strip() for s in text.split(","))))
    return (base,) + rungs


def _session_extras(args):
    """Fault-tolerance wiring shared by the modes: (supervisor,
    input_policy, injector) from the flags."""
    from repro_torch.launch.faults import (FaultInjector, FaultPlan,
                                           parse_fault_specs)
    from repro_torch.launch.streaming import SupervisorConfig

    supervisor = None if args.no_supervisor else SupervisorConfig()
    injector = None
    if args.faults:
        plan = FaultPlan(seed=args.fault_seed,
                         specs=parse_fault_specs(args.faults))
        injector = FaultInjector(plan, args.slots)
    # Injected NaN/Inf must REACH the device for self-healing to have
    # anything to heal: rejecting them at the host boundary would test
    # the validator, not the supervisor.
    policy = args.input_policy
    if injector is not None and policy == "reject":
        policy = "trust"
    return supervisor, policy, injector


def _depth(args) -> int:
    return 1 if args.sync_loop else args.inflight_depth


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--mode", choices=["lm", "kws-audio", "kws-detect",
                                       "kws-cascade"],
                    default="lm",
                    help="lm: greedy decoding with an LM stack (--arch); "
                         "kws-audio: utterances by majority vote; "
                         "kws-detect: always-on detection on continuous "
                         "streams; kws-cascade: the same through the "
                         "two-stage wake cascade.  Weights come from "
                         "--params, --bundle or the seeded random init, "
                         "then --train-steps of training")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="lm: the architecture served (its smoke config)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="lm: prompt tokens per request")
    ap.add_argument("--max-new", type=int, default=24,
                    help="lm: tokens decoded per request")
    ap.add_argument("--cache-len", type=int, default=64,
                    help="lm: KV-cache positions per slot")
    ap.add_argument("--slots", type=int, default=4,
                    help="stream slots (lm: decode slots) served together "
                         "(must divide by --devices)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the KWS slot axis over this many devices "
                         "(cards; with --device cpu, shards on the CPU)")
    ap.add_argument("--requests", type=int, default=8,
                    help="1 s utterances to serve")
    ap.add_argument("--chunk-samples", type=int, default=4096,
                    help="raw samples per serve step (keep it a multiple "
                         "of the 128-sample frame shift so slot resets "
                         "stay frame-aligned)")
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="delta threshold Δ_TH (the base rung of the "
                         "degradation ladder)")
    # the pipelined engine
    ap.add_argument("--inflight-depth", type=int, default=2,
                    help="steps in flight on the card before the host "
                         "waits for one's results (>= 2 overlaps "
                         "assemble, compute and fetch; ignored under "
                         "--sync-loop)")
    ap.add_argument("--sync-loop", action="store_true",
                    help="serve with pipeline depth 1 (the synchronous "
                         "loop); decisions are equal either way")
    # fault tolerance and overload
    ap.add_argument("--faults", default="",
                    help='seeded fault campaign, "kind:rate,..." pairs '
                         '(e.g. "nan_burst:0.05,clip:0.1"); see '
                         "launch.faults for the kinds")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="replay seed for --faults (same seed = "
                         "bit-identical corruption)")
    ap.add_argument("--input-policy",
                    choices=["reject", "sanitize", "trust"],
                    default="reject",
                    help="process_audio boundary policy for hostile "
                         "samples (forced to 'trust' while --faults is "
                         "armed, so injected NaNs reach the card)")
    ap.add_argument("--no-supervisor", action="store_true",
                    help="disable the self-healing slot supervisor "
                         "(poisoned slots stay poisoned; without it "
                         "process_audio never waits for the card)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded request-queue depth (kws-audio); "
                         "submissions beyond it are shed")
    ap.add_argument("--degrade-thresholds", default="",
                    help='Δ_TH degradation ladder above the base, '
                         'ascending (e.g. "0.2,0.4"); stepped up under '
                         "sustained queue pressure, released with "
                         "hysteresis")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="step-latency watchdog budget in ms (0 = off); "
                         "breaches count as overload pressure")
    ap.add_argument("--seed", type=int, default=100,
                    help="stream-synthesis seed of kws-detect and "
                         "kws-cascade (one stream per slot), as the "
                         "reference's --seed")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the random weights, of the quick "
                         "training's batches and (plus one) of the "
                         "kws-audio requests; port-only (the reference "
                         "fixes these seeds at 0 and 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    ap.add_argument("--params", default="",
                    help="arrays.npz of a KWS checkpoint (default: random "
                         "weights from --init-seed)")
    ap.add_argument("--numerics", choices=["float32", "int8"],
                    default="float32",
                    help="serving datapath: the float kernels or the "
                         "bit-true integer pipeline (weights promoted at "
                         "session creation)")
    ap.add_argument("--bundle", default="",
                    help="a promoted int8 bundle (.npz of "
                         "train.promote.save_bundle, or of the JAX "
                         "package's); implies --numerics int8")
    # kws-detect options
    ap.add_argument("--stream-seconds", type=float, default=30.0,
                    help="continuous-audio stream length per slot")
    ap.add_argument("--snr-db", type=float, default=20.0,
                    help="keyword-over-noise SNR of the synthesized "
                         "streams")
    ap.add_argument("--events-per-min", type=float, default=12.0,
                    help="mean ground-truth keyword rate per stream")
    ap.add_argument("--fire-threshold", type=float, default=0.40,
                    help="smoothed posterior that opens a keyword event")
    ap.add_argument("--release-threshold", type=float, default=0.30,
                    help="smoothed posterior that closes it (hysteresis)")
    ap.add_argument("--vad-threshold", type=float, default=0.02,
                    help="VAD frame-energy (mean |sample|) speech "
                         "threshold; the delta path is clamped below it")
    ap.add_argument("--no-vad", action="store_true",
                    help="disable the VAD gate (always-open features)")
    ap.add_argument("--tol-s", type=float, default=0.5,
                    help="fire-to-event matching tolerance in seconds")
    # kws-cascade options
    ap.add_argument("--wake-threshold", type=float, default=0.5,
                    help="stage-0 posterior that wakes stage 1")
    ap.add_argument("--sleep-threshold", type=float, default=0.25,
                    help="stage-0 posterior below which an awake stage 1 "
                         "starts its hangover countdown (hysteresis)")
    ap.add_argument("--hangover-frames", type=int, default=15,
                    help="frames stage 1 stays awake after stage 0 drops "
                         "below the sleep threshold")
    ap.add_argument("--s0-channels", type=int, default=4,
                    help="leading FEx channels fed to the stage-0 micro "
                         "model (its whole input width)")
    ap.add_argument("--s0-threshold", type=float, default=0.05,
                    help="stage-0 delta threshold")
    # quick training before serving
    ap.add_argument("--train-steps", type=int, default=120,
                    help="AdamW steps of quick training before serving "
                         "(the reference's default; 0 = serve the loaded "
                         "or seeded weights): utterance-level for "
                         "kws-audio, frame-level for kws-detect and "
                         "kws-cascade (stage 0 too, even with --bundle), "
                         "QAT with --numerics int8")
    return ap


def validate_args(args):
    """Reject nonsensical flags with a clear ``ValueError`` before any
    device work starts."""
    for name in ("slots", "devices", "chunk_samples", "inflight_depth",
                 "max_queue", "prompt_len", "max_new", "cache_len"):
        if getattr(args, name) < 1:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 1, "
                             f"got {getattr(args, name)}")
    for name in ("requests", "train_steps"):
        if getattr(args, name) < 0:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 0, "
                             f"got {getattr(args, name)}")
    if not math.isfinite(args.threshold) or args.threshold < 0:
        raise ValueError(f"--threshold must be finite and >= 0, "
                         f"got {args.threshold}")
    if args.slots % args.devices:
        raise ValueError(f"--slots ({args.slots}) must divide by "
                         f"--devices ({args.devices})")
    if args.mode in ("kws-detect", "kws-cascade"):
        if args.fire_threshold <= args.release_threshold:
            raise ValueError(
                f"--fire-threshold ({args.fire_threshold}) must exceed "
                f"--release-threshold ({args.release_threshold}): an "
                f"inverted hysteresis band never latches")
        if args.stream_seconds <= 0 or not math.isfinite(args.stream_seconds):
            raise ValueError(f"--stream-seconds must be positive, "
                             f"got {args.stream_seconds}")
        if args.events_per_min <= 0 or not math.isfinite(args.events_per_min):
            raise ValueError(f"--events-per-min must be positive, "
                             f"got {args.events_per_min}")
        if not math.isfinite(args.snr_db):
            raise ValueError(f"--snr-db must be finite, got {args.snr_db}")
        if args.tol_s < 0:
            raise ValueError(f"--tol-s must be >= 0, got {args.tol_s}")
    if args.mode == "kws-cascade":
        if args.sleep_threshold > args.wake_threshold:
            raise ValueError(
                f"--sleep-threshold ({args.sleep_threshold}) must not "
                f"exceed --wake-threshold ({args.wake_threshold}): an "
                f"inverted wake hysteresis band never sleeps")
        if args.hangover_frames < 0:
            raise ValueError(f"--hangover-frames must be >= 0, "
                             f"got {args.hangover_frames}")
        if args.s0_channels < 1:
            raise ValueError(f"--s0-channels must be >= 1, "
                             f"got {args.s0_channels}")
        if not math.isfinite(args.s0_threshold) or args.s0_threshold < 0:
            raise ValueError(f"--s0-threshold must be finite and >= 0, "
                             f"got {args.s0_threshold}")
    if args.watchdog_ms < 0:
        raise ValueError(f"--watchdog-ms must be >= 0, got {args.watchdog_ms}")
    if args.faults:
        from repro_torch.launch.faults import parse_fault_specs
        parse_fault_specs(args.faults)      # raises on a malformed spec
    if args.degrade_thresholds:
        ladder = _parse_ladder(args.degrade_thresholds, args.threshold)
        OverloadPolicy(thresholds=ladder)   # raises on a bad ladder


# The reference's quick-training batches: 64 one-second utterances, or 32
# continuous streams of TRAIN_SECONDS with frame labels.
TRAIN_BATCH = {False: 64, True: 32}
TRAIN_SECONDS = 2.0


def quick_train(args, fex, params: dict, cfg, *, frame_level: bool,
                seed: int, what: str, channels: int | None = None,
                binary: bool = False) -> dict:
    """The reference's quick training before serving: ``--train-steps``
    AdamW steps (lr 3e-3, weight decay 0.01, 20 warm-up steps) at Δ_TH 0.1
    on batches drawn from ``default_rng(seed)``, on the params' device (the
    features from the FEx kernel on a CUDA device), QAT when serving int8.
    ``channels`` keeps the leading FEx channels, ``binary`` collapses the
    frame labels to keyword vs background (stage 0).  Returns the trained
    params."""
    from repro_torch.data.continuous import synth_frame_batch
    from repro_torch.data.gscd import synth_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.promote import make_kws_step_fn

    int8 = args.numerics == "int8"
    ocfg = opt.AdamWConfig(lr=3e-3, weight_decay=0.01, warmup_steps=20,
                           total_steps=args.train_steps)
    state = opt.init(params)
    step = make_kws_step_fn(cfg, ocfg, 0.1, qat=int8,
                            frame_level=frame_level)
    key = "frame_labels" if frame_level else "labels"
    dev = params["w_x"].device
    rng = np.random.default_rng(seed)
    print(f"training {what} for {args.train_steps} steps "
          f"({'QAT, ' if int8 else ''}"
          f"{'frame-level, ' if frame_level else ''}"
          f"{args.numerics} serving) ...")
    losses = []
    for _ in range(args.train_steps):
        if frame_level:
            audio, labels = synth_frame_batch(
                rng, TRAIN_BATCH[True], duration_s=TRAIN_SECONDS)
        else:
            audio, labels = synth_batch(rng, TRAIN_BATCH[False])
        feats = fex(torch.from_numpy(audio).to(dev))
        if channels is not None:
            feats = feats[..., :channels]
        if binary:
            labels = (labels != 0).astype(np.int32)
        params, state, m = step(params, state, {
            "feats": feats, key: torch.from_numpy(labels).to(dev)})
        losses.append(m["loss"])               # read once, after the loop
    print(f"  loss {losses[0].item():.3f} → {losses[-1].item():.3f}")
    return params


def _load_model(args):
    """(device, FEx, float params or None, int8 bundle or None) from the
    flags: ``--bundle`` (implies int8), ``--params`` or the seeded random
    init at the paper model's width, then ``--train-steps`` of training
    (not of a bundle)."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.frontend.fex import FeatureExtractor
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.models import kws

    device = resolve_device(args.device)
    fex = FeatureExtractor()
    bundle = params = None
    if args.bundle:
        from repro_torch.train.promote import load_bundle
        args.numerics = "int8"                  # a bundle IS int8 weights
        bundle = load_bundle(args.bundle)
    elif args.params:
        params = kws.load_npz_params(args.params, device)
    else:
        gen = torch.Generator().manual_seed(args.init_seed)
        params = kws.init_kws(gen, CONFIG, input_dim=fex.cfg.n_active)
    if params is not None and args.train_steps:
        params = quick_train(args, fex,
                             {k: v.to(device) for k, v in params.items()},
                             CONFIG, frame_level=args.mode != "kws-audio",
                             seed=args.init_seed, what="detector")
    return device, fex, params, bundle


def slot_mesh(args):
    """The slot mesh of ``--devices N``: None at 1; on the card
    ``make_slot_mesh(N)`` (one shard per card; raises beyond the visible
    cards); with ``--device cpu``, N shards on the CPU."""
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.launch.mesh import SlotMesh, make_slot_mesh
    if args.devices == 1:
        return None
    device = resolve_device(args.device)
    if device.type == "cpu":
        return SlotMesh.on(device, args.devices)
    return make_slot_mesh(args.devices)


def serve_kws_audio(args):
    """Build the model and session and serve ``args.requests`` utterances.

    Returns ``(sess, done, labels, stats, seconds)``: the session (for
    its ``summary()``), the [(request, predicted class)] list, the
    requests' true labels, the loop's stats and the wall seconds of the
    serve loop (warm-up included).
    """
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.gscd import T as UTT_SAMPLES
    from repro_torch.data.gscd import synth_batch
    from repro_torch.launch.engine import run_audio_requests
    from repro_torch.launch.streaming import SlotScheduler, StreamingKwsSession

    mesh = slot_mesh(args)
    device, fex, params, bundle = _load_model(args)
    audio_q, label_q = synth_batch(
        np.random.default_rng(args.init_seed + 1), args.requests)
    supervisor, input_policy, injector = _session_extras(args)
    sess = StreamingKwsSession(params, CONFIG, threshold=args.threshold,
                               batch=args.slots, fex=fex, device=device,
                               mesh=mesh, numerics=args.numerics,
                               bundle=bundle, supervisor=supervisor,
                               input_policy=input_policy)
    sched = SlotScheduler(sess)
    ctl = AdmissionController(sess, sched, OverloadPolicy(
        thresholds=_parse_ladder(args.degrade_thresholds, args.threshold),
        max_queue=args.max_queue, watchdog_ms=args.watchdog_ms or None))
    for req in range(args.requests):
        ctl.submit(req)
    chunk = args.chunk_samples
    t0 = time.perf_counter()
    done, stats = run_audio_requests(
        sess, sched, ctl, audio_q=audio_q, chunk=chunk,
        chunks_per_utt=-(-UTT_SAMPLES // chunk),
        real_frames=UTT_SAMPLES // fex.cfg.frame_shift,
        injector=injector, depth=_depth(args))
    stats["controller"] = ctl.stats()
    return sess, done, label_q, stats, time.perf_counter() - t0


def stage0_params(args, fex=None, device="cpu"):
    """The stage-0 micro model of kws-cascade: ``init_kws`` at 16 units
    with a binary head over ``--s0-channels`` inputs, from a generator
    seeded 7 (the reference's stage-0 seed).  With ``fex`` and
    ``--train-steps``, trained frame-level on ``device`` against keyword
    vs background labels (batches from ``default_rng(7)``, as the
    reference draws them); else the init, on the CPU (the session moves
    it)."""
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.models import kws
    cfg0 = dataclasses.replace(CONFIG, vocab_size=2, d_model=16)
    params0 = kws.init_kws(torch.Generator().manual_seed(7), cfg0,
                           input_dim=args.s0_channels)
    if fex is None or not args.train_steps:
        return params0
    return quick_train(args, fex,
                       {k: v.to(device) for k, v in params0.items()},
                       cfg0, frame_level=True, seed=7,
                       what=f"stage-0 wake model (16 units, "
                            f"{args.s0_channels} channels, binary head)",
                       channels=args.s0_channels, binary=True)


def serve_kws_detect(args):
    """Build the model, the detect-mode session (with ``--mode
    kws-cascade``, the cascade session and its stage-0 model) and one
    continuous stream per slot, run the always-on loop over the streams
    and score the fires.

    Returns ``(sess, point, stats, seconds, n_samples)``: the session (for
    its ``summary()``), the pooled ``DetPoint``, the loop's stats (with the
    per-slot ``fires`` and the ``frames`` per slot), the wall seconds of
    the loop (warm-up included) and the samples per stream.
    """
    from repro_torch.configs.deltakws import CONFIG
    from repro_torch.data.continuous import make_streams
    from repro_torch.data.gscd import FS
    from repro_torch.frontend.vad import VAD_OFF, VADConfig
    from repro_torch.launch.engine import run_continuous_detect
    from repro_torch.launch.streaming import (CascadeConfig,
                                              StreamingKwsSession)
    from repro_torch.models.detector import (DetectorConfig, det_point,
                                             pool_points)

    mesh = slot_mesh(args)
    device, fex, params, bundle = _load_model(args)
    if bundle is not None:
        print("WARNING: serving a promoted bundle through the detection "
              "head — unless it was QAT-trained with frame-level labels, "
              "expect a poor (miscalibrated) operating point")
    cascade = params0 = None
    if args.mode == "kws-cascade":
        cascade = CascadeConfig(wake_threshold=args.wake_threshold,
                                sleep_threshold=args.sleep_threshold,
                                hangover_frames=args.hangover_frames,
                                s0_threshold=args.s0_threshold,
                                s0_channels=args.s0_channels)
        params0 = stage0_params(args, fex, device)
    shift = fex.cfg.frame_shift
    streams = make_streams(args.seed, args.slots,
                           duration_s=args.stream_seconds,
                           snr_db=args.snr_db,
                           events_per_min=args.events_per_min)
    n_samples = min(len(s.audio) for s in streams)
    n_samples -= n_samples % shift
    det = DetectorConfig(fire_threshold=args.fire_threshold,
                         release_threshold=args.release_threshold)
    vad = (VAD_OFF if args.no_vad
           else VADConfig(energy_threshold=args.vad_threshold))
    supervisor, input_policy, injector = _session_extras(args)
    sess = StreamingKwsSession(params, CONFIG, threshold=args.threshold,
                               batch=args.slots, fex=fex, device=device,
                               mesh=mesh, numerics=args.numerics,
                               bundle=bundle, detector=det, vad=vad,
                               cascade=cascade,
                               stage0_params=params0, supervisor=supervisor,
                               input_policy=input_policy)
    chunk = args.chunk_samples - args.chunk_samples % shift or shift
    t0 = time.perf_counter()
    fires, frame_base, stats = run_continuous_detect(
        sess, [s.audio for s in streams], chunk=chunk, n_samples=n_samples,
        injector=injector, depth=_depth(args))
    dt = time.perf_counter() - t0
    stats.update(fires=fires, frames=frame_base)
    tol = int(round(args.tol_s * FS / shift))
    point = pool_points([
        det_point(fires[slot], streams[slot].truth_frames(shift),
                  frame_base, tol_frames=tol, frame_s=shift / FS)
        for slot in range(args.slots)])
    return sess, point, stats, dt, n_samples


def _host_blocked_line(slo: dict) -> str:
    hb = slo["host_blocked_ms_per_step"]
    return (f"host-blocked/step {hb['total']:.2f} ms (assemble "
            f"{hb['assemble']:.2f}, dispatch {hb['dispatch']:.2f}, fetch "
            f"{hb['fetch']:.2f}), e2e decision latency p50 "
            f"{slo['e2e_ms']['p50']:.2f} / p99.9 {slo['e2e_ms']['p999']:.2f}"
            f" ms")


def _robustness_line(sess, summ, cst: dict | None = None) -> str:
    line = (f"robustness: {summ.recoveries} slot recoveries "
            f"{summ.recovery_reasons or '{}'}, "
            f"{len(sess.unhealthy_slots())} unhealthy")
    if cst is not None:
        line += (f", controller level {cst['level']} "
                 f"(Δ_TH={cst['threshold']}), {cst['shed']} shed, "
                 f"{cst['escalations']} escalations / {cst['releases']} "
                 f"releases, {cst['watchdog_breaches']} watchdog breaches")
    return line + (", counters overflowed" if summ.overflowed else "")


def _device_name(dev) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain PyTorch versions of the kernels)")


def _on_devices(sess) -> str:
    """``N device(s) (name)``: the session's shards and its device."""
    return f"{sess.n_shards} device(s) ({_device_name(sess.device)})"


def _detect_main(args) -> int:
    from repro_torch.data.gscd import FS
    sess, point, stats, dt, n_samples = serve_kws_detect(args)
    summ = sess.summary()
    slo = stats["slo"]
    steady_s = max(slo["steady_state_s"], 1e-9)
    audio_s = args.slots * n_samples / FS
    print(f"detect: {args.slots} stream(s) x {n_samples / FS:.0f} s "
          f"({point.hours:.3f} h audio) in {dt:.2f} s end-to-end (warm-up "
          f"{stats['warmup_s']:.2f} s) on {_on_devices(sess)} "
          f"[{sess.numerics}, depth {slo['depth']}] — "
          f"{audio_s / dt:.1f}x realtime")
    print(f"steady-state: {audio_s / steady_s:.1f}x realtime, "
          f"{slo['decisions'] / steady_s:.0f} decisions/s, step latency "
          f"p50 {slo['step_ms']['p50']:.2f} / p99 "
          f"{slo['step_ms']['p99']:.2f} ms ({stats['steps']} steps)")
    print(_host_blocked_line(slo))
    print(f"operating point Δ_TH={sess.threshold} "
          f"fire={args.fire_threshold} release={args.release_threshold}: "
          f"{point.n_events} events, {point.hits} hits, "
          f"{point.misses} misses (miss rate {point.miss_rate:.2f}), "
          f"{point.false_alarms} false alarms "
          f"({point.fa_per_hour:.1f} FA/hr)")
    print(f"vad duty {summ.vad_duty:.3f}, "
          f"stream sparsity {summ.sparsity:.3f}, "
          f"{summ.energy_nj_per_decision:.1f} nJ/decision "
          f"(FEx {summ.fex_energy_nj_per_decision:.1f} nJ, "
          f"VAD {summ.vad_energy_nj_per_decision:.2f} nJ), "
          f"modeled latency {summ.latency_ms:.2f} ms")
    print(_robustness_line(sess, summ))
    return 0


def _cascade_main(args) -> int:
    """The reference's cascade report: the detect metrics, the stage-1
    duty and the per-stage energy split."""
    from repro_torch.data.gscd import FS
    sess, point, stats, dt, n_samples = serve_kws_detect(args)
    summ = sess.summary()
    slo = stats["slo"]
    steady_s = max(slo["steady_state_s"], 1e-9)
    audio_s = args.slots * n_samples / FS
    print(f"cascade: {args.slots} stream(s) x {n_samples / FS:.0f} s "
          f"({point.hours:.3f} h audio) in {dt:.2f} s end-to-end (warm-up "
          f"{stats['warmup_s']:.2f} s) on {_on_devices(sess)} "
          f"[{sess.numerics}, depth {slo['depth']}] — "
          f"{audio_s / dt:.1f}x realtime")
    print(f"steady-state: {audio_s / steady_s:.1f}x realtime, "
          f"{slo['decisions'] / steady_s:.0f} decisions/s, step latency "
          f"p50 {slo['step_ms']['p50']:.2f} / p99 "
          f"{slo['step_ms']['p99']:.2f} ms ({stats['steps']} steps)")
    print(_host_blocked_line(slo))
    print(f"operating point Δ_TH={sess.threshold} "
          f"wake={args.wake_threshold} sleep={args.sleep_threshold} "
          f"hang={args.hangover_frames} "
          f"fire={args.fire_threshold} release={args.release_threshold}: "
          f"{point.n_events} events, {point.hits} hits, "
          f"{point.misses} misses (miss rate {point.miss_rate:.2f}), "
          f"{point.false_alarms} false alarms "
          f"({point.fa_per_hour:.1f} FA/hr)")
    print(f"stage-1 duty {summ.stage1_duty:.3f} "
          f"({summ.frames_entered_stage1}/{summ.frames} frames awake), "
          f"vad duty {summ.vad_duty:.3f}, "
          f"stream sparsity {summ.sparsity:.3f}")
    print(f"{summ.energy_nj_per_decision:.1f} nJ/decision "
          f"(stage-0 {summ.s0_energy_nj_per_decision:.2f} nJ, "
          f"FEx {summ.fex_energy_nj_per_decision:.1f} nJ, "
          f"VAD {summ.vad_energy_nj_per_decision:.2f} nJ), "
          f"modeled latency {summ.latency_ms:.2f} ms")
    print(_robustness_line(sess, summ))
    return 0


def serve_lm(args) -> dict:
    """``--mode lm``: the reference's LM serve loop on ``args.device``.
    Returns ``done`` (finished requests: prompt, out tokens), ``tokens``
    decoded, ``seconds`` of the decode loop, ``device`` and ``cfg``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.models import get_api

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    api = get_api(cfg, device=device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(
        args.init_seed))

    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
             for _ in range(args.requests)]
    done = []
    # Batch-of-one caches per slot keep admission independent.
    slots = {i: None for i in range(args.slots)}

    def tok(t):
        return torch.tensor([[t]], dtype=torch.int32, device=device)

    def admit(slot):
        if not queue:
            slots[slot] = None
            return
        prompt = queue.pop(0)
        cache = api.init_cache(1, args.cache_len)
        if api.prefill is not None:
            cache, logits = api.prefill(
                params, torch.from_numpy(prompt[None]).to(device), cache)
        else:   # decode the prompt token by token
            for t in prompt:
                logits, cache = api.decode_step(params, cache, tok(int(t)))
        slots[slot] = {"cache": cache, "out": [], "prompt": prompt,
                       "last": int(torch.argmax(logits[0, -1]))}

    for s in range(args.slots):
        admit(s)
    t0 = time.perf_counter()
    tokens = 0
    while any(v is not None for v in slots.values()):
        for s, st in list(slots.items()):
            if st is None:
                continue
            logits, st["cache"] = api.decode_step(params, st["cache"],
                                                  tok(st["last"]))
            st["last"] = int(torch.argmax(logits[0, -1]))
            st["out"].append(st["last"])
            tokens += 1
            if len(st["out"]) >= args.max_new:
                done.append(st)
                admit(s)
    return {"done": done, "tokens": tokens,
            "seconds": time.perf_counter() - t0, "device": device,
            "cfg": cfg}


def _lm_main(args) -> int:
    run = serve_lm(args)
    dt = max(run["seconds"], 1e-9)
    dev = run["device"]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {len(run['done'])} requests, {run['tokens']} tokens in "
          f"{dt:.1f}s ({run['tokens'] / dt:.1f} tok/s, {args.arch} smoke "
          f"config on {name})")
    for i, st in enumerate(run["done"][:3]):
        print(f"  req{i}: prompt[:4]={st['prompt'][:4].tolist()} "
              f"out[:8]={st['out'][:8]}")
    return 0


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        validate_args(args)
    except ValueError as e:
        ap.error(str(e))
    if args.mode == "lm":
        return _lm_main(args)
    if args.mode == "kws-detect":
        return _detect_main(args)
    if args.mode == "kws-cascade":
        return _cascade_main(args)
    sess, done, labels, stats, dt = serve_kws_audio(args)
    correct = sum(1 for req, pred in done if pred == int(labels[req]))
    summ = sess.summary()
    slo = stats["slo"]
    audio_s = len(done) * 1.0
    steady_s = max(slo["steady_state_s"], 1e-9)
    print(f"served {len(done)} utterances ({audio_s:.0f} s audio) on "
          f"{args.slots} slots in {dt:.2f} s end-to-end (warm-up "
          f"{stats['warmup_s']:.2f} s) on {_on_devices(sess)} "
          f"[{sess.numerics}, Δ_TH "
          f"{sess.threshold}], pipeline depth {slo['depth']}: "
          f"{correct}/{len(done)} correct")
    print(f"steady-state: {audio_s / steady_s:.1f}x realtime, "
          f"{stats['frames_served'] / steady_s:.0f} decisions/s, step "
          f"latency p50 {slo['step_ms']['p50']:.2f} / p99 "
          f"{slo['step_ms']['p99']:.2f} ms ({stats['steps']} steps)")
    print(_host_blocked_line(slo))
    print(f"stream sparsity {summ.sparsity:.3f}, "
          f"{summ.energy_nj_per_decision:.1f} nJ/decision modeled "
          f"(FEx {summ.fex_energy_nj_per_decision:.1f} nJ)")
    print(_robustness_line(sess, summ, stats["controller"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
