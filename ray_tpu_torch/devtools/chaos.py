"""Deterministic fault-injection plane for the control-plane transport.

The chaos suite we had before this module (tests/test_chaos.py) only
exercises crash-stop failures: a SIGKILLed daemon closes its sockets, so
``ConnectionLost`` fires and recovery kicks in. Real fleets mostly die of
*gray* failures — black-holed links, silently dropped / delayed /
duplicated / reordered messages, slow peers (Huang et al., "Gray
Failure: The Achilles' Heel of Cloud-Scale Systems", HotOS'17). This
module injects exactly those, deterministically:

- A :class:`FaultPlan` is a seed plus an ordered list of
  :class:`FaultRule`\\ s, each matching frames by src/dst process role
  (``driver``/``gcs``/``nodelet``/``worker``, fnmatch patterns), method
  pattern, evaluation side, frame kind, and a time window — mapping
  matches to ``drop`` / ``delay`` / ``duplicate`` / ``reorder`` /
  ``blackhole`` / ``reset`` with probability ``p``.
- The plan rides ``Config.chaos_plan`` (JSON), which every spawned
  daemon and worker inherits through the ``--config`` chain — one plan
  governs the whole cluster. :func:`maybe_install` builds an
  :class:`Interposer` and hands it to ``core.rpc.set_chaos``; the
  transport consults it on its four frame edges (client egress/ingress,
  server ingress/egress — each frame crosses exactly two).
- Determinism: the decision for the *n*-th frame of a given method
  reaching rule *i* is a pure function of
  ``(plan.seed, role, i, method, n)`` — a fresh ``random.Random``
  seeded with that tuple per decision. Keying the stream by method (not
  one stream per rule) matters: wall-clock-driven frames (keepalive
  pings, telemetry reports) interleave nondeterministically with the
  workload's frames, and a shared stream would let a ping steal the
  draw an ``add_job`` got last run. Per-method indices make every
  workload decision identical across same-seed runs regardless of
  interleaving. Every injected fault is appended to a bounded in-memory
  log (:meth:`Interposer.injection_log`); :meth:`Interposer.sequence`
  is its order-independent projection for cross-run comparison.

Side semantics: a rule fires in the process whose edge evaluates it.
``side="send"`` rules run in the frame's sender (src = that process's
role); ``side="recv"`` in the receiver (dst = that process's role);
``side="*"`` in both. Evaluating each direction once per end keeps a
rule's probability from compounding across edges.
"""

from __future__ import annotations

import json
import random
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from fnmatch import fnmatchcase
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import rpc

ACTIONS = ("drop", "delay", "duplicate", "reorder", "blackhole", "reset")
ROLES = ("driver", "gcs", "nodelet", "worker")

_KIND_NAMES = {rpc.REQUEST: "request", rpc.RESPONSE_OK: "response",
               rpc.RESPONSE_ERR: "response", rpc.ONEWAY: "oneway",
               rpc.PING: "ping", rpc.PONG: "ping"}


@dataclass
class Verdict:
    action: str = "pass"      # pass | drop | delay | duplicate | reset
    delay_s: float = 0.0
    rule: int = -1            # index of the firing rule (-1: none)


_PASS = Verdict()


@dataclass
class FaultRule:
    """One match→action rule. All string fields are fnmatch patterns."""
    src: str = "*"            # sender role
    dst: str = "*"            # receiver role
    method: str = "*"         # rpc method ("__ping__" for keepalive pings)
    side: str = "send"        # evaluation edge: "send" | "recv" | "*"
    action: str = "drop"
    p: float = 1.0            # firing probability per matching frame
    delay_s: float = 0.05     # delay action: fixed; reorder: uniform(0, x)
    after_s: float = 0.0      # window start, relative to interposer install
    for_s: float = -1.0       # window length (-1: unbounded)
    blackhole_s: float = 1.0  # how long a triggered black hole lasts
    max_count: int = -1       # firings before the rule retires (-1: none)
    kinds: Tuple[str, ...] = ("request", "oneway", "response", "ping")

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action: {self.action!r}")
        if self.side not in ("send", "recv", "*"):
            raise ValueError(f"unknown chaos side: {self.side!r}")
        self.kinds = tuple(self.kinds)


@dataclass
class FaultPlan:
    """Seed + ordered rules; JSON round-trips through Config.chaos_plan."""
    seed: int = 0
    rules: List[FaultRule] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [asdict(r) for r in self.rules]})

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        return cls(seed=int(d.get("seed", 0)),
                   rules=[FaultRule(**r) for r in d.get("rules", [])])


class Interposer:
    """Per-process fault decider installed into core.rpc.

    Thread-safety: decisions run on the owning process's event loop
    thread (the transport's frame edges), so no lock is taken; the
    injection log is a plain deque read by tests after quiescence.
    """

    def __init__(self, plan: FaultPlan, role: str):
        self.plan = plan
        self.role = role
        self._t0 = time.monotonic()
        # Per-(rule, method) frame indices: the n-th METHOD frame that
        # rule i evaluates decides via a Random seeded with
        # (seed, role, i, method, n) — a pure function, so workload
        # frames decide identically across runs no matter how pings or
        # telemetry interleave with them (see module docstring). First
        # firing rule wins; earlier matching-but-not-firing rules still
        # consume their index, later rules consume nothing.
        self._method_draws: Dict[Tuple[int, str], int] = {}
        self._fired = [0] * len(plan.rules)
        self._draws = [0] * len(plan.rules)
        # (side, peer_key) -> monotonic expiry; while active, EVERY frame
        # on that edge/peer drops (the link is dark, not one method)
        self._blackholes: Dict[Tuple[str, Any], float] = {}
        self._peer_roles: Dict[Tuple[str, int], str] = {}
        self.log: deque = deque(maxlen=8192)

    # -- wiring ----------------------------------------------------------
    def note_peer(self, addr: Tuple[str, int], role: str) -> None:
        """Teach the interposer a server address's role (dst matching on
        the send side; src matching on the client's response ingress)."""
        self._peer_roles[tuple(addr)] = role

    def peer_role(self, addr: Optional[Tuple[str, int]]) -> str:
        if addr is None:
            return "*"
        return self._peer_roles.get(tuple(addr), "*")

    # -- decision --------------------------------------------------------
    def on_frame(self, side: str, method: str, kind: int,
                 peer: Optional[Tuple[str, int]] = None,
                 peer_role: Optional[str] = None) -> Verdict:
        """Decide the fate of one frame crossing one transport edge."""
        if peer_role is None:
            peer_role = self.peer_role(peer)
        if side == "send":
            src, dst = self.role, peer_role
        else:
            src, dst = peer_role, self.role
        now = time.monotonic()
        key = (side, tuple(peer) if peer is not None else peer_role)
        until = self._blackholes.get(key)
        if until is not None:
            if now < until:
                return Verdict("drop", rule=-1)
            del self._blackholes[key]
        kname = _KIND_NAMES.get(kind, "request")
        rel = now - self._t0
        for i, rule in enumerate(self.plan.rules):
            if rule.side != "*" and rule.side != side:
                continue
            if kname not in rule.kinds:
                continue
            if rel < rule.after_s:
                continue
            if rule.for_s >= 0 and rel >= rule.after_s + rule.for_s:
                continue
            if rule.max_count >= 0 and self._fired[i] >= rule.max_count:
                continue
            if not (fnmatchcase(src, rule.src)
                    and fnmatchcase(dst, rule.dst)
                    and fnmatchcase(method, rule.method)):
                continue
            mk = (i, method)
            n = self._method_draws.get(mk, 0) + 1
            self._method_draws[mk] = n
            self._draws[i] += 1
            rng = random.Random(f"{self.plan.seed}:{self.role}:{i}:{method}:{n}")
            if rule.p < 1.0 and rng.random() >= rule.p:
                continue
            self._fired[i] += 1
            action, delay = rule.action, rule.delay_s
            if action == "reorder":
                # a sampled delay lets later frames overtake this one
                action, delay = "delay", rng.uniform(0.0, rule.delay_s)
            elif action == "blackhole":
                self._blackholes[key] = now + rule.blackhole_s
                action = "drop"
            self.log.append({"n": n, "rule": i,
                             "t": round(rel, 4), "side": side, "src": src,
                             "dst": dst, "method": method, "kind": kname,
                             "action": rule.action})
            return Verdict(action, delay, i)
        return _PASS

    # -- introspection ---------------------------------------------------
    def injection_log(self) -> List[dict]:
        return list(self.log)

    # methods whose frame COUNT is wall-clock-driven (periodic loops),
    # so they're excluded from cross-run sequence comparison by default
    TIMER_METHODS = ("__ping__", "telemetry_report", "heartbeat")

    def sequence(self, ignore_methods: Tuple[str, ...] = TIMER_METHODS
                 ) -> List[Tuple[int, str, int, str, str]]:
        """The determinism-comparable projection of the log: per-(rule,
        method) frame index + action, no wall-clock, sorted so that the
        nondeterministic *interleaving* of independent method streams
        doesn't matter. Wall-clock-driven methods (pings by default) are
        excluded — their frame COUNT is timing-dependent even though
        each decision is deterministic."""
        return sorted((e["rule"], e["method"], e["n"], e["side"], e["action"])
                      for e in self.log if e["method"] not in ignore_methods)

    def stats(self) -> dict:
        return {"role": self.role, "seed": self.plan.seed,
                "fired": list(self._fired), "draws": list(self._draws),
                "active_blackholes": sum(
                    1 for t in self._blackholes.values()
                    if t > time.monotonic())}


def maybe_install(cfg, role: str) -> Optional[Interposer]:
    """Install the session FaultPlan (if any) into this process's
    transport. Called from every process entrypoint; idempotent per
    process — a second call with the same plan JSON reuses the installed
    interposer so runtime + worker init in one process share streams."""
    plan_json = getattr(cfg, "chaos_plan", "") or ""
    if not plan_json:
        return None
    cur = rpc.get_chaos()
    if cur is not None and getattr(cur, "_plan_json", None) == plan_json \
            and cur.role == role:
        return cur
    ip = Interposer(FaultPlan.from_json(plan_json), role)
    ip._plan_json = plan_json
    rpc.set_chaos(ip)
    return ip


def note_peer(addr, role: str) -> None:
    """Register a server address's role with the installed interposer
    (no-op when chaos is off — safe to call unconditionally)."""
    ip = rpc.get_chaos()
    if ip is not None:
        ip.note_peer(tuple(addr), role)


def uninstall() -> None:
    rpc.set_chaos(None)


# --------------------------------------------------------------------------
# Scenario running (chaos pytest fixture)
# --------------------------------------------------------------------------

def canonical_plan(seed: int = 0) -> FaultPlan:
    """The acceptance-criteria mix: drop/delay/duplicate/black-hole on
    control-plane links, duplication aimed at the non-idempotent RPCs
    the dedupe layer protects."""
    return FaultPlan(seed=seed, rules=[
        # gray latency + reordering on everything the driver sends
        FaultRule(src="driver", dst="*", side="send", action="reorder",
                  p=0.15, delay_s=0.05),
        # lossy driver->control-plane requests (retry/deadline pressure)
        FaultRule(src="driver", dst="gcs", side="send", action="drop",
                  p=0.1, kinds=("request",)),
        # duplicated delivery of the classic non-idempotent RPCs,
        # evaluated at the receiving daemon
        FaultRule(src="*", dst="*", method="create_actor", side="recv",
                  action="duplicate", p=0.5, kinds=("request",)),
        FaultRule(src="*", dst="*", method="request_lease", side="recv",
                  action="duplicate", p=0.3, kinds=("request",)),
        FaultRule(src="*", dst="*", method="pin_object*", side="recv",
                  action="duplicate", p=0.5, kinds=("request",)),
        FaultRule(src="*", dst="*", method="report_gang_demand",
                  side="recv", action="duplicate", p=0.5,
                  kinds=("request",)),
        # one 1.5s black hole of the driver->gcs link mid-run: keepalive
        # must convert it to ConnectionLost and gcs_call must ride it out
        FaultRule(src="driver", dst="gcs", side="send", action="blackhole",
                  p=1.0, after_s=3.0, max_count=1, blackhole_s=1.5),
    ])


# system_config every scenario runs under: tight deadlines so injected
# loss surfaces (and bounds) fast, keepalive quick enough to catch the
# black hole inside the test budget
SCENARIO_CONFIG = {
    "rpc_call_timeout_s": 5.0,
    "rpc_keepalive_interval_s": 0.25,
    "rpc_keepalive_timeout_s": 1.5,
    "gcs_reconnect_timeout_s": 20.0,
    "health_check_period_s": 0.2,
}


def run_scenario(plan: Optional[FaultPlan] = None, *, seed: int = 0,
                 num_nodes: int = 1, tasks: int = 8, actors: int = 2,
                 calls: int = 4,
                 system_config: Optional[dict] = None) -> dict:
    """Run the canonical task+actor workload under a FaultPlan and check
    the three scenario invariants:

    1. every operation completes or fails *typed* within its deadline
       bound (no silent hang past rpc_call_timeout_s +
       rpc_keepalive_timeout_s, with retry slack);
    2. no duplicate side effects (every actor saw exactly its own calls;
       post-workload node resources return to their totals — a
       double-created actor or double-granted lease would leak);
    3. no orphaned pins (state.memory_report leak_suspects stays empty
       after every ref is dropped).

    Returns a report dict; report["ok"] is the scenario verdict."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    plan = plan if plan is not None else canonical_plan(seed)
    sc = dict(SCENARIO_CONFIG)
    if system_config:
        sc.update(system_config)
    sc["chaos_plan"] = plan.to_json()
    bound = (sc["rpc_call_timeout_s"] + sc["rpc_keepalive_timeout_s"])
    # per-op budget: deadline bound x retry allowance (task retries and
    # gcs reconnect both legitimately chain a few bounded attempts)
    op_budget = bound * 6
    violations: List[str] = []
    t_start = time.monotonic()
    cluster = Cluster(initialize_head=False, system_config=sc)
    for _ in range(max(1, num_nodes)):
        cluster.add_node(resources={"CPU": 4.0})
    report: Dict[str, Any] = {"seed": plan.seed, "rules": len(plan.rules)}
    try:
        cluster.connect(_system_config=sc)

        def timed(label, fn):
            t0 = time.monotonic()
            try:
                return fn()
            except Exception as e:
                if not isinstance(e, (rpc.RpcError,
                                      ray_tpu_torch.exceptions.RayTpuError,
                                      TimeoutError)):
                    violations.append(
                        f"{label}: untyped failure {type(e).__name__}: {e}")
                return None
            finally:
                el = time.monotonic() - t0
                if el > op_budget:
                    violations.append(
                        f"{label}: took {el:.1f}s > {op_budget:.1f}s bound")

        @ray_tpu_torch.remote(max_retries=5)
        def _square(x):
            return x * x

        @ray_tpu_torch.remote(max_restarts=0)
        class _Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

            def total(self):
                return self.n

        # tasks + puts
        refs = [_square.remote(i) for i in range(tasks)]
        vals = timed("tasks", lambda: ray_tpu_torch.get(refs, timeout=op_budget))
        if vals is not None and vals != [i * i for i in range(tasks)]:
            violations.append(f"tasks: wrong results {vals}")
        put_refs = [ray_tpu_torch.put(bytes(1024) + bytes([i])) for i in range(4)]
        timed("puts", lambda: ray_tpu_torch.get(put_refs, timeout=op_budget))

        # actors: exactly-once side effects under duplicated create/call
        handles = [timed(f"actor{i}", _Counter.remote) for i in range(actors)]
        handles = [h for h in handles if h is not None]
        for i, h in enumerate(handles):
            for _ in range(calls):
                timed(f"bump{i}", lambda h=h: ray_tpu_torch.get(
                    h.bump.remote(), timeout=op_budget))
            n = timed(f"total{i}", lambda h=h: ray_tpu_torch.get(
                h.total.remote(), timeout=op_budget))
            if n is not None and n != calls:
                violations.append(
                    f"actor{i}: {n} side effects for {calls} calls "
                    "(duplicate or lost execution)")
        for h in handles:
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass
        del refs, put_refs, vals, handles

        # settle, then audit pins + resource accounting
        time.sleep(max(1.0, sc["health_check_period_s"] * 5))
        from ray_tpu_torch.util import state as _state
        mem = timed("memory_report", _state.memory_report)
        if mem:
            leaks = mem.get("leak_suspects") or []
            if leaks:
                violations.append(f"orphaned pins: {leaks[:5]}")

        def _accounting():
            # leases return lazily (lease_reuse_grace_s + chaos-delayed
            # return_lease frames): poll up to the op budget
            deadline = time.monotonic() + op_budget
            while True:
                tot = ray_tpu_torch.cluster_resources()
                avail = ray_tpu_torch.available_resources()
                missing = {k: (avail.get(k, 0.0), v) for k, v in tot.items()
                           if abs(avail.get(k, 0.0) - v) > 1e-6}
                if not missing or time.monotonic() > deadline:
                    return missing
                time.sleep(0.25)

        missing = timed("accounting", _accounting)
        if missing:
            violations.append(
                f"resources not returned after workload (leaked "
                f"lease/lane or duplicate grant): {missing}")
        ip = rpc.get_chaos()
        report["injected_driver_side"] = len(ip.log) if ip else 0
        report["sequence"] = ip.sequence() if ip else []
    finally:
        try:
            cluster.shutdown()
        finally:
            uninstall()
            # the driver runtime rebound module transport defaults to the
            # tight scenario values; restore stock defaults so later
            # in-process users (the rest of a pytest session) aren't
            # running with a 5s deadline and 0.25s keepalive
            from ray_tpu_torch.core.config import Config
            rpc.configure(Config())
    report["elapsed_s"] = round(time.monotonic() - t_start, 2)
    report["violations"] = violations
    report["ok"] = not violations
    return report
