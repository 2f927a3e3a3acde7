"""Command-line interface: `python -m ray_tpu_torch.cli <cmd>`.

Reference: python/ray/scripts/scripts.py and the state CLI
(util/state/state_cli.py).

Port of two commands of ray_tpu/cli.py: ``doctor`` (cluster health
triage) and ``blackbox`` (flight-recorder post-mortems). The rest of that
CLI (start, stop, status, list, summary, memory, metrics, stack, top,
timeline, debug, chaos, and the commands over layers not ported yet) is
ROADMAP.md queue 1 item 11.
"""

from __future__ import annotations

import argparse
import json


def _connect(address: str):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


def _mib(n) -> str:
    return f"{(n or 0) / (1 << 20):.2f}MiB"


def _pin_str(rec: dict) -> str:
    pins = rec.get("pins") or {}
    if not pins:
        return "-"
    parts = []
    for reason, p in pins.items():
        extra = ",".join(f"{k}={v}" for k, v in p.items()
                         if k != "count" and v is not None)
        parts.append(f"{reason}x{p.get('count', 1)}"
                     + (f"({extra})" if extra else ""))
    return " ".join(parts)


def cmd_doctor(args):
    """One-shot cluster health triage: nodes alive, progress beacons
    fresh (no active stall), telemetry drop counters zero. Exits
    non-zero when any check fails (observability/health.py)."""
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import state

    summary = state.cluster_summary()
    report = state.health_report()
    checks = []

    dead = summary.get("nodes_dead", 0)
    checks.append(("nodes alive",
                   summary.get("nodes_alive", 0) > 0 and dead == 0,
                   f"{summary.get('nodes_alive', 0)} alive, {dead} dead"))

    beacons = report.get("beacons", [])
    stalled = [b for b in beacons if b.get("stalled")]
    checks.append(("beacons fresh", not stalled,
                   f"{len(beacons)} registered, "
                   + (", ".join(b.get("component", "?") for b in stalled)
                      + " stalled" if stalled else "none stalled")))

    drops = {k: summary.get(k, 0.0)
             for k in ("task_events_dropped", "telemetry_reports_dropped")}
    checks.append(("drop counters zero",
                   all(v == 0 for v in drops.values()),
                   ", ".join(f"{k}={int(v)}" for k, v in drops.items())))

    events = report.get("events", [])
    # remediation events are the health plane ACTING (elastic training
    # quarantine/refill/grow) — context below, not a failed check
    recent = [e for e in events if e.get("kind") in ("stall", "straggler")]
    remediations = [e for e in events if e.get("kind") == "remediation"]
    checks.append(("no recent stall/straggler events", not recent,
                   f"{len(recent)} event(s)"
                   + ("" if not recent else ": " + "; ".join(
                       f"{e.get('kind')}:{e.get('component', '?')}"
                       for e in recent[-3:]))))

    # memory plane (observability/memory.py): leak suspects fail the
    # triage; top holders + spill-candidate bytes print as context
    mem = {}
    try:
        mem = state.memory_report(top_n=50)
    except Exception as e:
        checks.append(("memory report reachable", False, str(e)))
    leaks = mem.get("leak_suspects", [])
    checks.append(("no memory leak suspects", not leaks,
                   f"{len(leaks)} pinned object(s) with a dead owner"
                   + ("" if not leaks else ": " + ", ".join(
                       f"{r.get('key', '?')[:16]}({_pin_str(r)})"
                       for r in leaks[:3]))))

    failed = 0
    for name, ok, detail in checks:
        print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}")
        failed += 0 if ok else 1

    if remediations:
        print(f"remediations: {len(remediations)} self-healing action(s)")
        for e in remediations[-3:]:
            ctx = e.get("context") or {}
            print(f"  {e.get('component', '?')}: {ctx.get('action', '?')} "
                  f"world {ctx.get('world_before', '?')}->"
                  f"{ctx.get('world_after', '?')} "
                  f"suspects={ctx.get('suspects') or {}}")

    if mem:
        total = sum((mem.get("subsystem_bytes") or {}).values())
        print(f"memory: {_mib(total)} attributed "
              f"across {mem.get('records', 0)} record(s); spill-candidate "
              f"{_mib(mem.get('spill_candidate_bytes'))} "
              f"({len(mem.get('spill_candidates', []))} object(s), "
              f"idle>={mem.get('cold_after_s')}s)")
        tier = mem.get("spill_tier") or {}
        if any(tier.values()):
            print(f"  spill tier: {tier.get('spilled_objects', 0)} object(s) "
                  f"on disk ({_mib(tier.get('spilled_bytes'))}), "
                  f"{tier.get('spilled_then_dropped', 0)} spilled-then-"
                  f"dropped from shm; lifetime spill "
                  f"{_mib(tier.get('spill_bytes_total'))} / restore "
                  f"{_mib(tier.get('restore_bytes_total'))} "
                  f"({tier.get('restored_objects', 0)} restore(s))")
        by_node = {}
        for r in mem.get("top_holders", []):
            by_node.setdefault(r.get("node"), []).append(r)
        for node, recs in by_node.items():
            tops = ", ".join(
                f"{r.get('key', '?')[:12]}[{r.get('subsystem')}]"
                f"={_mib(r.get('nbytes'))}" for r in recs[:5])
            print(f"  node {(node or '?')[:12]} top holders: {tops}")
    if args.verbose:
        print(json.dumps(report, indent=2, default=str))
        print(json.dumps(mem, indent=2, default=str))
    if failed:
        raise SystemExit(f"doctor: {failed} check(s) failed")
    print("doctor: all checks passed")


def cmd_blackbox(args):
    """Flight-recorder post-mortems: list the dumps a crashed/stalled
    process left behind, render one, or merge into a chrome trace
    (observability/flight.py)."""
    from ray_tpu_torch.observability import flight

    dumps = flight.list_dumps(args.dir)
    if not dumps:
        print(f"no flight dumps under {args.dir or '(session dir)'}")
        return
    if args.list or (args.index is None and not args.chrome):
        for i, path in enumerate(dumps):
            try:
                doc = flight.load_dump(path)
                print(f"[{i}] {path}  reason={doc.get('reason')} "
                      f"worker={doc.get('worker')} "
                      f"events={len(doc.get('events', []))}")
            except Exception as e:
                print(f"[{i}] {path}  (unreadable: {e})")
        return
    idx = args.index if args.index is not None else len(dumps) - 1
    if not 0 <= idx < len(dumps):
        raise SystemExit(f"no dump [{idx}] ({len(dumps)} found)")
    doc = flight.load_dump(dumps[idx])
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(flight.to_chrome(doc), f)
        print(f"wrote chrome trace to {args.chrome}")
        return
    print(flight.render_summary(doc, tail=args.tail))


def main():
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("doctor", help="cluster health triage: nodes, "
                       "beacons, drop counters (non-zero exit on failure)")
    s.add_argument("--address", required=True)
    s.add_argument("--verbose", action="store_true",
                   help="also print the full health report")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser("blackbox",
                       help="list/render flight-recorder post-mortems")
    s.add_argument("--dir", default=None,
                   help="dump directory (default: the flight default dir)")
    s.add_argument("--list", action="store_true")
    s.add_argument("--index", type=int, default=None,
                   help="which dump to render (default: newest)")
    s.add_argument("--chrome", default=None,
                   help="write the dump as a chrome trace to this path")
    s.add_argument("--tail", type=int, default=20)
    s.set_defaults(fn=cmd_blackbox)

    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
