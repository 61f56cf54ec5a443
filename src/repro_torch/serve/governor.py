"""``PowerGovernor`` — energy-aware scheduling policy for the serve
engine: the control half of the measurement -> control loop.  A copy of
the JAX package's ``serve/governor.py`` (same decisions, thresholds,
slot model, fail modes and ``stats()`` keys) over this package's
``core.export.RegionRecord``.

The engine measures J/token per request; the governor *acts* on it.  It
reads smoothed power from a :class:`~repro_torch.telemetry.PowerRecorder`
window and holds the engine under a configured watts cap (and per-tenant
joules quotas) by modulating, in escalating order:

  1. **admission rate** — new requests are admitted only while smoothed
     power sits below ``admit_frac * cap_watts``, and at most one
     admission per ``admit_hold_s`` so each admission's power step is
     *observed* before the next one lands (no multi-slot overshoot
     through the smoothing lag);
  2. **prefill chunk pacing** — the interleaved chunk queue drains 0
     chunks per decode step while power is above the admission
     threshold (and up to ``max_chunks_per_step`` when there is lots of
     headroom), trading time-to-first-token for cap headroom while
     in-flight decodes proceed untouched;
  3. **decode idling (last resort)** — when power exceeds
     ``cap_watts * (1 + hard_over_frac)`` the governor duty-cycles the
     decode loop with ``pause_s`` sleeps, stretching wall-clock to pull
     average watts down.  Decode never stops outright, so no request
     starves.

Liveness guarantee: every lever only *defers* work — admission resumes
as soon as the window drops, a paused chunk queue is force-drained when
nothing is decoding (the engine calls :meth:`note_forced_chunk`), and
pauses are bounded sleeps between decode steps.  A governor with
``cap_watts=None`` is a pure observer (every lever wide open).

Tenant quotas are *soft priorities*, not hard kills: a tenant whose
accumulated request joules (fed back from the recorder's resolved
``serve/req<N>`` records) exceed its quota is deprioritised behind
other tenants at admission, but is still served when nothing else is
waiting — quota pressure cannot deadlock the queue.

Every throttle decision (state transitions and each decode pause) is
recorded in :attr:`decisions` *and* as a flat ``serve/governor/<action>``
session span, so the control actions themselves show up in the energy
export stream next to the requests they shaped.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

from repro_torch.core.export import RegionRecord

_REQ = "serve/req"


@dataclasses.dataclass(frozen=True)
class ThrottleDecision:
    """One governor action: what, when, and on which power reading."""

    t: float                      # governor-clock timestamp
    action: str                   # admit_block/admit_resume/chunk_pause/
                                  # chunk_resume/chunk_force/decode_pause/
                                  # tenant_defer/tenant_resume/pool_block/
                                  # pool_resume/pool_wait/pool_ready/
                                  # preempt/preempt_resume/quarantine/
                                  # shed_request
    watts: Optional[float]        # smoothed window power at decision time
    cap: Optional[float]
    detail: str = ""


class PowerGovernor:
    """Energy-aware admission/pacing policy consulted by ``ServeEngine``.

    Args:
      recorder: the :class:`~repro_torch.telemetry.PowerRecorder` whose watts
        window is the control signal (and whose resolved ``serve/req<N>``
        records feed tenant quota accounting).
      cap_watts: power budget; ``None`` disables power capping (the
        governor still tracks tenants and records nothing).
      window_s: trailing smoothing window for the control signal.
      admit_frac: admissions (and chunk drains) allowed only below
        ``admit_frac * cap_watts`` — the hysteresis band that absorbs
        the one-slot power step an admission causes.
      hard_over_frac: decode pauses engage above
        ``cap_watts * (1 + hard_over_frac)``.
      admit_hold_s: minimum spacing between admissions near the cap
        (defaults to ``window_s`` so each admission is visible in the
        window before the next); ignored while power is below
        ``boost_frac * cap_watts``.
      pause_s: duration of one decode-idle sleep.
      max_chunks_per_step: chunk-drain budget when power sits below
        ``boost_frac * cap_watts`` (ample headroom).
      tenant_quota_j: per-tenant joules quota — a single float applied
        to every tenant, or a ``{tenant: quota}`` dict (missing tenants
        unlimited).
      pool_reserve_frac: paged-KV pool pressure veto.  When the engine
        passes its pool's free-page fraction to
        :meth:`admission_allowed` and it sits below this reserve, the
        admission is vetoed (``pool_block``/``pool_resume`` decisions)
        regardless of power headroom — an admission that would leave the
        pool unable to absorb in-flight decode growth or the next
        prefix-cache insert is worse than a deferred one.  ``0.0``
        (default) disables the veto; contiguous mode never passes the
        signal.
      backend: restrict the control signal to one backend's watts
        (default: sum over all backends the recorder sees).
      signal_ttl_s: maximum age of the newest watts sample before the
        control signal is declared *stale* (sensor blackout / dead
        sampler).  ``None`` (default) trusts the signal forever — the
        pre-fault-tolerance behaviour.
      fail_mode: what a stale signal means.  ``"closed"`` (default, the
        conservative choice): stop admitting and pause chunk drains
        until the signal recovers — a power-capped fleet must not go
        uncapped just because its meter died; liveness is preserved by
        the engine's existing forced-admit/forced-chunk overrides.
        ``"open"``: keep serving as if uncapped (availability over the
        cap).  Decode is never paused on a stale signal in either mode
        (pausing blind only burns wall-clock).
      clock: injectable time source for deterministic tests.
    """

    def __init__(self, recorder, cap_watts: Optional[float] = None,
                 window_s: float = 0.25, admit_frac: float = 0.9,
                 hard_over_frac: float = 0.10,
                 admit_hold_s: Optional[float] = None,
                 pause_s: float = 0.005, max_chunks_per_step: int = 2,
                 tenant_quota_j: Union[None, float, Dict[str, float]] = None,
                 pool_reserve_frac: float = 0.0,
                 backend: Optional[str] = None,
                 signal_ttl_s: Optional[float] = None,
                 fail_mode: str = "closed",
                 clock: Callable[[], float] = time.monotonic):
        if cap_watts is not None and cap_watts <= 0:
            raise ValueError(f"cap_watts must be > 0, got {cap_watts}")
        if not 0.0 < admit_frac <= 1.0:
            raise ValueError(f"admit_frac must be in (0, 1], got {admit_frac}")
        if max_chunks_per_step < 1:
            raise ValueError("max_chunks_per_step must be >= 1")
        if signal_ttl_s is not None and signal_ttl_s <= 0:
            raise ValueError(f"signal_ttl_s must be > 0, got {signal_ttl_s}")
        if fail_mode not in ("open", "closed"):
            raise ValueError(
                f"fail_mode must be 'open' or 'closed', got {fail_mode!r}")
        if not 0.0 <= pool_reserve_frac < 1.0:
            raise ValueError(f"pool_reserve_frac must be in [0, 1), "
                             f"got {pool_reserve_frac}")
        self.recorder = recorder
        self.cap_watts = cap_watts
        self.window_s = float(window_s)
        self.admit_frac = float(admit_frac)
        self.hard_over_frac = float(hard_over_frac)
        self.admit_hold_s = (window_s if admit_hold_s is None
                             else float(admit_hold_s))
        self.pause_s = float(pause_s)
        self.max_chunks_per_step = int(max_chunks_per_step)
        self.boost_frac = 0.5 * self.admit_frac
        self.backend = backend
        self.signal_ttl_s = (None if signal_ttl_s is None
                             else float(signal_ttl_s))
        self.fail_mode = fail_mode
        self._stale_blocked = False
        self._clock = clock
        self._quota = tenant_quota_j
        self._lock = threading.Lock()
        self._tenant_joules: Dict[str, float] = {}
        self._rid_tenant: Dict[int, str] = {}
        self._tenant_blocked: Dict[str, bool] = {}
        self._last_admit_t = float("-inf")
        self._admit_blocked = False
        self._hold_blocked = False
        self._chunk_blocked = False
        # Learned per-admission power step (EWMA, biased high): each
        # settled admission updates it from the observed window delta,
        # so the admission gate can *predict* whether one more slot
        # still fits under the cap instead of discovering the overshoot
        # after the fact.
        self._step_w: Optional[float] = None
        self._pending_step: Optional[Tuple[Optional[float], float]] = None
        self.pool_reserve_frac = float(pool_reserve_frac)
        self._pool_blocked = False
        self._pool_waiting = False
        self._shed_requested = False
        # Linear watts-vs-live-slots model fitted from admission
        # history: each settled admission contributes one
        # (live_slots, window watts) sample, and the least-squares slope
        # is the marginal watts of one more slot — a *per-configuration*
        # estimate that, unlike the EWMA step, interpolates across
        # occupancies it has seen instead of trusting the last delta.
        # The EWMA remains the cold-start fallback until the fit has
        # enough spread to be trustworthy.
        self._engine = None           # bound by begin()
        self._slot_obs: collections.deque = collections.deque(maxlen=64)
        self._slot_model: Optional[Tuple[float, float, int]] = None
        self.decisions: collections.deque = collections.deque(maxlen=4096)
        self.throttle_count = 0       # total decisions ever (ring-proof)
        self.pause_total_s = 0.0
        self._session = None          # bound by begin()
        self._unsub: Optional[Callable[[], None]] = None
        if recorder is not None:
            self._unsub = recorder.subscribe(self._on_record)

    # -- engine binding -----------------------------------------------------
    def begin(self, engine) -> None:
        """Called by the engine at the top of each ``generate()``: binds
        the session used for ``serve/governor`` spans and re-arms the
        admission hold."""
        session = engine.session
        if session is None and engine.monitor is not None:
            session = engine.monitor.session
        self._session = session
        self._engine = engine
        self._last_admit_t = float("-inf")

    def close(self) -> None:
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    # -- control signal -----------------------------------------------------
    def window_watts(self) -> Optional[float]:
        """Smoothed power over the trailing window (``None`` = no data
        yet, every lever stays open)."""
        if self.recorder is None:
            return None
        return self.recorder.mean_watts(self.window_s, backend=self.backend)

    def signal_stale(self) -> bool:
        """Whether the watts signal has outlived ``signal_ttl_s``.

        Stale means: at least one watts sample was ever recorded *and*
        the newest one is older than the TTL on the governor clock.  A
        cold start (no samples yet) is not stale — that is the existing
        "no signal yet" regime, handled by the admission hold.
        """
        if self.signal_ttl_s is None or self.recorder is None:
            return False
        last = self.recorder.last_watts_ts(backend=self.backend)
        if last is None:
            return False
        return self._clock() - last > self.signal_ttl_s

    def _signal(self) -> Tuple[Optional[float], bool]:
        """Control signal + freshness: ``(window watts, stale?)``.

        Records the stale/fresh transition once per episode (shared
        ``_stale_blocked`` state across all levers).  ``mean_watts``
        anchors its window at the newest *sample* — a frozen trace keeps
        reporting its last smoothed value forever — so a stale signal
        must be checked here, not inferred from ``window_watts()``.
        """
        w = self.window_watts()
        stale = self.signal_stale()
        self._transition("_stale_blocked", stale,
                         "signal_stale" if stale else "signal_fresh", w)
        return w, stale

    # -- levers (consulted by ServeEngine's continuous and paged loops) -----
    def admission_allowed(
            self, pool_free_frac: Optional[float] = None) -> bool:
        """Whether a new request may be admitted right now.

        ``pool_free_frac`` (paged mode only) is the engine's KV pool
        free-page fraction; below ``pool_reserve_frac`` it vetoes the
        admission even when power headroom exists — this veto is
        independent of ``cap_watts`` and works for uncapped governors.
        """
        if pool_free_frac is not None and self.pool_reserve_frac > 0.0:
            low = pool_free_frac < self.pool_reserve_frac
            self._transition("_pool_blocked", low,
                             "pool_block" if low else "pool_resume",
                             self.window_watts() if low else None)
            if low:
                return False
        if self.cap_watts is None:
            return True
        w, stale = self._signal()
        if stale:
            if self.fail_mode == "closed":
                return False
            w = None          # fail_open: ignore the frozen window value
        if w is not None:
            self._settle_step(w)
            # Predictive gate: one more slot costs ~the learned step, so
            # block unless current + step still fits under the cap.  The
            # admit_frac threshold alone is not enough — when a slot's
            # power step exceeds the (1 - admit_frac) headroom band, a
            # transient dip below the threshold would admit a slot whose
            # settled load overshoots the cap.
            # Per-slot step: fitted slope when the admission history
            # supports it, EWMA (then a headroom-band guess) otherwise.
            step = self._fitted_step()
            if step is None:
                step = self._step_w if self._step_w is not None \
                    else self.cap_watts * (1.0 - self.admit_frac)
            if w >= self.cap_watts * self.admit_frac \
                    or w + step > self.cap_watts:
                self._transition("_admit_blocked", True, "admit_block", w)
                return False
            self._transition("_admit_blocked", False, "admit_resume", w)
        if (w is None or w >= self.cap_watts * self.boost_frac) and \
                self._clock() - self._last_admit_t < self.admit_hold_s:
            # Near the cap — or with no signal yet (recorder hasn't
            # polled): space admissions out so each one's power step is
            # observed in the window before the next lands.  An unknown
            # signal must be treated as near-cap, or the first scheduler
            # pass fills every slot before the first sample arrives.
            # One admit_hold decision per hold episode, not per attempt.
            self._transition("_hold_blocked", True, "admit_hold", w)
            return False
        self._hold_blocked = False       # episode over; no resume span
        return True

    def prefill_chunk_budget(self, decode_live: bool) -> int:
        """Chunks to drain alongside this decode step (0 pauses the
        queue).  The engine force-drains one chunk anyway when nothing
        is decoding (see :meth:`note_forced_chunk`) so a paused queue
        cannot starve."""
        if self.cap_watts is None:
            return 1
        w, stale = self._signal()
        if stale:
            # fail_closed: no chunk drains on a dead meter (the engine's
            # forced-chunk override keeps an otherwise-idle engine live);
            # fail_open: drain at the conservative 1/step rate.
            return 0 if self.fail_mode == "closed" else 1
        if w is None:
            return 1
        if w >= self.cap_watts * self.admit_frac:
            self._transition("_chunk_blocked", True, "chunk_pause", w)
            return 0
        self._transition("_chunk_blocked", False, "chunk_resume", w)
        if w < self.cap_watts * self.boost_frac:
            return self.max_chunks_per_step
        return 1

    def maybe_pause_decode(self) -> float:
        """Last-resort duty cycling: sleep ``pause_s`` when smoothed
        power exceeds the hard-over threshold.  Returns the seconds
        slept (0.0 when no pause was needed).  The sleep itself runs
        inside a ``serve/governor/decode_pause`` span, so idling shows
        up in the energy export like any other scheduled activity."""
        if self.cap_watts is None:
            return 0.0
        w, stale = self._signal()
        if stale:
            return 0.0       # never duty-cycle decode on a dead meter
        if w is None or w <= self.cap_watts * (1.0 + self.hard_over_frac):
            return 0.0
        self._decide("decode_pause", w, detail=f"sleep {self.pause_s}s",
                     span_sleep_s=self.pause_s)
        with self._lock:
            self.pause_total_s += self.pause_s
        return self.pause_s

    def note_forced_chunk(self) -> None:
        """The engine drained a chunk despite a 0 budget (nothing was
        decoding, so pausing prefill would have idled the engine)."""
        self._decide("chunk_force", self.window_watts(),
                     detail="no live decode; liveness override")

    def note_pool_wait(self, free_pages: int, need_pages: int) -> None:
        """The engine's paged admission could not cover the next request
        even after radix eviction: it leaves the request queued and
        relies on retirements to free pages.  Recorded as one
        ``pool_wait`` decision per wait episode (not per scheduler pass)
        so pool exhaustion shows up in the decision stream instead of
        the engine silently spinning at admission checkpoints."""
        if self._pool_waiting:
            return
        self._pool_waiting = True
        self._decide("pool_wait", self.window_watts(),
                     detail=f"pool short: {free_pages} free < "
                            f"{need_pages} needed pages")

    def note_pool_ready(self) -> None:
        """Admission succeeded after a ``pool_wait`` episode: close it."""
        if not self._pool_waiting:
            return
        self._pool_waiting = False
        self._decide("pool_ready", self.window_watts())

    # -- preemption plane ----------------------------------------------------
    def note_preempt(self, rid: Optional[int], pages: int,
                     dest: str) -> None:
        """The engine preempted live request ``rid`` page-aligned,
        parking ``pages`` pages to ``dest`` (``swap``/``tree``/
        ``dropped``/``none``) — memory pressure or a shed request."""
        self._decide("preempt", self.window_watts(),
                     detail=f"req{rid}: {pages} pages -> {dest}")

    def note_preempt_resume(self, rid: Optional[int],
                            recovered_tokens: int,
                            rerun_tokens: int) -> None:
        """A preempted/drained request re-entered prefill:
        ``recovered_tokens`` came back from its checkpoint,
        ``rerun_tokens`` are honest recompute."""
        self._decide("preempt_resume", self.window_watts(),
                     detail=f"req{rid}: recovered {recovered_tokens}, "
                            f"rerun {rerun_tokens} tokens")

    def note_quarantine(self, rid: Optional[int]) -> None:
        """The engine retired (or restarted) request ``rid`` after a
        step produced non-finite logits; its pages were discarded
        without ever seeding the prefix tree."""
        self._decide("quarantine", self.window_watts(),
                     detail=f"req{rid}: non-finite logits")

    def request_shed(self) -> None:
        """Ask the engine to preempt one live request at its next
        scheduler checkpoint (load shedding under sustained overload).
        The engine *preempts* — checkpoints and requeues — rather than
        dropping; consumed by ``consume_shed_request``."""
        with self._lock:
            if self._shed_requested:
                return
            self._shed_requested = True
        self._decide("shed_request", self.window_watts(),
                     detail="governor requested one preemption")

    def consume_shed_request(self) -> bool:
        """Engine-side: claim a pending shed request (True at most once
        per ``request_shed``)."""
        with self._lock:
            if not self._shed_requested:
                return False
            self._shed_requested = False
            return True

    def note_forced_admit(self) -> None:
        """The engine admitted despite a blocked gate: it was completely
        idle (no live decode, no pending prefill) with work waiting, so
        the measured power can only be idle draw — if *that* exceeds the
        cap the cap is unholdable and liveness wins."""
        self._decide("admit_force", self.window_watts(),
                     detail="engine idle with work waiting; liveness override")

    # -- tenant quotas ------------------------------------------------------
    def _quota_for(self, tenant: str) -> Optional[float]:
        if self._quota is None:
            return None
        if isinstance(self._quota, dict):
            return self._quota.get(tenant)
        return float(self._quota)

    def tenant_allowed(self, tenant: Optional[str]) -> bool:
        """Whether ``tenant`` is inside its joules quota.  The engine
        uses this as a *priority* hint: over-quota tenants yield to
        others at admission but are still served when alone."""
        if tenant is None:
            return True
        quota = self._quota_for(tenant)
        if quota is None:
            return True
        with self._lock:
            spent = self._tenant_joules.get(tenant, 0.0)
        over = spent >= quota
        self._tenant_transition(tenant, over, spent, quota)
        return not over

    def tenant_joules(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._tenant_joules)

    def _settle_step(self, w_now: float) -> None:
        """Fold a settled admission's observed power delta into the
        learned per-slot step (biased high: a step estimate that decays
        too eagerly re-opens the overshoot the gate exists to prevent)."""
        if self._pending_step is None:
            self._observe_slots(w_now)
            return
        pre, t_adm = self._pending_step
        if self._clock() - t_adm < self.admit_hold_s:
            return
        self._pending_step = None
        if pre is not None:
            obs = max(0.0, w_now - pre)
            self._step_w = obs if self._step_w is None \
                else max(0.5 * (self._step_w + obs), obs)
        self._observe_slots(w_now)

    def _observe_slots(self, w_now: float) -> None:
        """Record one (live_slots, watts) sample for the linear model —
        only while no admission is mid-settle, so the samples pair the
        window power with the occupancy that actually produced it."""
        eng = self._engine
        if eng is not None:
            self._slot_obs.append((float(eng.live_slots), float(w_now)))

    def _fitted_step(self) -> Optional[float]:
        """Marginal watts per slot from the least-squares line over the
        admission-history samples.  ``None`` (fall back to the EWMA)
        until there are >= 4 samples spanning more than one occupancy —
        a vertical-stack of samples at a single slot count has no slope
        information."""
        obs = list(self._slot_obs)
        if len(obs) < 4:
            return None
        n = float(len(obs))
        sx = sum(x for x, _ in obs)
        sy = sum(y for _, y in obs)
        sxx = sum(x * x for x, _ in obs)
        sxy = sum(x * y for x, y in obs)
        var = sxx - sx * sx / n
        if var < 1e-9:
            return None
        slope = max(0.0, (sxy - sx * sy / n) / var)
        self._slot_model = (slope, (sy - slope * sx) / n, len(obs))
        return slope

    def note_admitted(self, request) -> None:
        """Engine callback at admission: arms the admission hold,
        snapshots pre-admission power for step learning, and registers
        the request's tenant for quota attribution."""
        self._pending_step = (self.window_watts(), self._clock())
        self._last_admit_t = self._clock()
        tenant = getattr(request, "tenant", None)
        if tenant is not None and request.id is not None:
            with self._lock:
                self._rid_tenant[request.id] = tenant

    def _on_record(self, rec: RegionRecord) -> None:
        """Recorder subscriber: fold resolved whole-request spans into
        per-tenant joules accounting."""
        path = rec.path
        if not path.startswith(_REQ) or "/" in path[len(_REQ):]:
            return
        try:
            rid = int(path[len(_REQ):])
        except ValueError:
            return
        with self._lock:
            tenant = self._rid_tenant.get(rid)
            if tenant is not None:
                self._tenant_joules[tenant] = \
                    self._tenant_joules.get(tenant, 0.0) + rec.joules

    # -- decision recording -------------------------------------------------
    def _transition(self, attr: str, blocked: bool, action: str,
                    watts: Optional[float]) -> None:
        """Record a lever state *transition* (not every consultation —
        a long over-cap episode is one block + one resume, not a span
        flood)."""
        if getattr(self, attr) == blocked:
            return
        setattr(self, attr, blocked)
        self._decide(action, watts)

    def _tenant_transition(self, tenant: str, over: bool, spent: float,
                           quota: float) -> None:
        with self._lock:
            was = self._tenant_blocked.get(tenant, False)
            if was == over:
                return
            self._tenant_blocked[tenant] = over
        self._decide("tenant_defer" if over else "tenant_resume",
                     None, detail=f"{tenant}: {spent:.3f}/{quota:.3f} J")

    def _decide(self, action: str, watts: Optional[float],
                detail: str = "", span_sleep_s: float = 0.0) -> None:
        d = ThrottleDecision(t=self._clock(), action=action, watts=watts,
                             cap=self.cap_watts, detail=detail)
        with self._lock:
            self.decisions.append(d)
            self.throttle_count += 1
            n = self.throttle_count
        session = self._session
        if session is not None:
            # Flat span (depth 0, no nesting stack) so governor actions
            # are energy-attributed like request spans.  The pause's
            # sleep runs inside its span; transition spans are instants.
            try:
                with session.region(f"serve/governor/{action}{n}",
                                    nested=False):
                    if span_sleep_s > 0.0:
                        time.sleep(span_sleep_s)
            except Exception:
                pass          # session closed mid-run: keep governing
        elif span_sleep_s > 0.0:
            time.sleep(span_sleep_s)

    # -- reporting ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            actions: Dict[str, int] = {}
            for d in self.decisions:
                actions[d.action] = actions.get(d.action, 0) + 1
            return {
                "cap_watts": self.cap_watts,
                "window_s": self.window_s,
                "throttle_decisions": self.throttle_count,
                "throttle_actions": actions,
                "pause_total_s": self.pause_total_s,
                "tenant_joules": dict(self._tenant_joules),
                "signal_ttl_s": self.signal_ttl_s,
                "fail_mode": self.fail_mode,
                "signal_stale": self.signal_stale(),
                "pool_reserve_frac": self.pool_reserve_frac,
                "slot_watts_model": (
                    None if self._slot_model is None else {
                        "slope_w_per_slot": self._slot_model[0],
                        "intercept_w": self._slot_model[1],
                        "samples": self._slot_model[2],
                    }),
            }

    def __repr__(self):
        return (f"<PowerGovernor cap={self.cap_watts} "
                f"window={self.window_s}s decisions={self.throttle_count}>")
