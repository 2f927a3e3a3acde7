"""Command-line interface: `python -m ray_tpu_torch.cli <cmd>`.

Port of ray_tpu/cli.py over the port's runtime, every command and option
of it. Reference: python/ray/scripts/scripts.py — start/stop (:540,:1004),
status, timeline (:1835), memory (:1900), and the state CLI
(`ray list ...`, util/state/state_cli.py); the cluster launcher's
up/down/exec/submit/attach/cluster-status (autoscaler/launcher.py). ``lint``
runs raylint (``ray_tpu_torch/devtools/lint/``) over the port's tree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _connect(address: str):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


def cmd_start(args):
    """Start a head (gcs + nodelet) that outlives this command."""
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.node import new_session_dir, start_gcs, start_nodelet

    cfg = Config.load(json.loads(args.system_config))
    session_dir = new_session_dir()
    gcs_proc, gcs_addr = start_gcs(session_dir, cfg, host=args.host,
                                   port=args.port)
    resources = json.loads(args.resources)
    nodelet_proc, nodelet_addr, node_id, store = start_nodelet(
        session_dir, cfg, gcs_addr, resources=resources, host=args.host)
    info = {"address": f"{gcs_addr[0]}:{gcs_addr[1]}",
            "session_dir": session_dir,
            "gcs_pid": gcs_proc.pid, "nodelet_pid": nodelet_proc.pid}
    with open(os.path.join(session_dir, "head.json"), "w") as f:
        json.dump(info, f)
    print(json.dumps(info, indent=2))
    print(f"\nConnect with: ray_tpu_torch.init(address='{info['address']}')")


def cmd_stop(args):
    """Stop the daemons of the head `start` made last (ref: ray stop); the
    nodelet goes down with the workers it started. The newest session
    holding a head.json, not ``session_latest``, which every driver that
    connects moves to its own session."""
    import glob

    from ray_tpu_torch.autoscaler.node_provider import terminate_tree
    from ray_tpu_torch.core.node import pid_alive, session_root

    heads = glob.glob(os.path.join(session_root(), "session_*", "head.json"))
    if not heads:
        print("no running head found")
        return
    with open(max(heads, key=os.path.getmtime)) as f:
        info = json.load(f)
    for key in ("nodelet_pid", "gcs_pid"):
        if pid_alive(info[key]):
            terminate_tree(info[key])
            print(f"stopped {key} {info[key]}")


def cmd_status(args):
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import state

    print(json.dumps(state.cluster_summary(), indent=2, default=str))


def cmd_list(args):
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import state

    fn = {"nodes": state.list_nodes, "actors": state.list_actors,
          "tasks": state.list_tasks, "jobs": state.list_jobs,
          "edges": state.edge_stats, "objects": state.list_objects,
          "pgs": state.list_placement_groups}[args.what]
    print(json.dumps(fn(), indent=2, default=str))


def cmd_summary(args):
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import state

    print(json.dumps(state.summarize_tasks(), indent=2, default=str))


def cmd_stack(args):
    """Stack dumps of every worker on every node (ref: ray stack)."""
    ray_tpu_torch = _connect(args.address)
    for node_id, dump in ray_tpu_torch.stack().items():
        print(f"===== node {node_id[:12]} =====")
        if "error" in dump:
            print(f"ERROR: {dump['error']}")
            continue
        for wid, w in dump.get("workers", {}).items():
            print(f"--- worker {wid} pid={w.get('pid')} "
                  f"state={w.get('state')} ---")
            print(w.get("stacks", w.get("error", "")))


def cmd_istats(args):
    """Per-daemon handler stats + event-loop lag (ref: event_stats)."""
    ray_tpu_torch = _connect(args.address)
    print(json.dumps(ray_tpu_torch.internal_stats(), indent=2, default=str))


def cmd_debug(args):
    """List active remote-pdb breakpoints and attach (ref: ray debug)."""
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import rpdb

    sessions = rpdb.list_breakpoints()
    if not sessions:
        print("no active breakpoints")
        return
    for i, s in enumerate(sessions):
        print(f"[{i}] pid={s.get('pid')} {s.get('host')}:{s.get('port')}")
    if args.list:
        return
    if not 0 <= args.index < len(sessions):
        print(f"no breakpoint session [{args.index}] "
              f"({len(sessions)} active)")
        return
    s = sessions[args.index]
    print(f"attaching to {s['host']}:{s['port']} — 'c' to continue, "
          "'q' to quit")
    rpdb.attach(s["host"], s["port"], token=s.get("token", ""))


def cmd_microbenchmark(args):
    from ray_tpu_torch._perf import main as perf_main

    argv = []
    if args.address:
        argv += ["--address", args.address]
    for f in args.filter or []:
        argv += ["--filter", f]
    argv += ["--min-seconds", str(args.min_seconds)]
    perf_main(argv)


def cmd_gateway(args):
    """Serve remote drivers (ref: ray client server / proxier)."""
    import asyncio

    from ray_tpu_torch.client_gateway import serve

    asyncio.run(serve(args.address, args.host, args.port))


def cmd_timeline(args):
    """Chrome-trace export of the unified timeline — task states, user
    spans, collective rounds, data-op spans — with per-worker lanes
    (ref: ray timeline; observability/timeline.py)."""
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.observability import chrome_trace

    events = ray_tpu_torch.timeline(limit=args.limit)
    trace = chrome_trace(events)
    out = args.output or "timeline.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    n = sum(1 for e in trace if e.get("ph") != "M")
    print(f"wrote {n} slices to {out}")


def cmd_memory(args):
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import state

    print(json.dumps(state.memory_summary(), indent=2, default=str))


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


def cmd_top(args):
    """`top mem`: cluster memory attribution (observability/memory.py)
    — per-subsystem bytes, the biggest holders with owner / pin reasons /
    temperature, spill candidates, leak suspects."""
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util import state

    rep = state.memory_report(top_n=args.limit)
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
        return
    print(f"attributed records: {rep.get('records', 0)}"
          f" (+{rep.get('records_overflow', 0)} summarized)")
    sub = rep.get("subsystem_bytes", {})
    store = rep.get("subsystem_store_bytes", {})
    hwm = rep.get("subsystem_hwm_bytes", {})
    print("subsystem        resident      in-store         high-water")
    for name in sorted(set(sub) | set(hwm)):
        print(f"  {name:<12} {_mib(sub.get(name)):>12} "
              f"{_mib(store.get(name)):>12} {_mib(hwm.get(name)):>12}")
    for node, st in (rep.get("nodes") or {}).items():
        print(f"node {node[:12]}: store {_mib(st.get('store_bytes'))} of "
              f"{_mib(st.get('store_capacity'))}, attribution coverage "
              f"{100.0 * (st.get('coverage') or 0):.1f}%")
    print(f"top holders (of {rep.get('records', 0)}):")
    for r in rep.get("top_holders", []):
        print(f"  {r.get('key', '?')[:20]:<20} {r.get('subsystem'):<10} "
              f"{_mib(r.get('nbytes')):>12}  idle={r.get('idle_s')}s "
              f"acc={r.get('access_count')} pins={_pin_str(r)}")
    print(f"spill candidates (unpinned, idle>={rep.get('cold_after_s')}s): "
          f"{len(rep.get('spill_candidates', []))} object(s), "
          f"{_mib(rep.get('spill_candidate_bytes'))}")
    leaks = rep.get("leak_suspects", [])
    if leaks:
        print(f"LEAK SUSPECTS (pinned, owner dead "
              f">={rep.get('leak_suspect_s')}s):")
        for r in leaks:
            print(f"  {r.get('key', '?')[:20]:<20} "
                  f"{_mib(r.get('nbytes')):>12} orphan={r.get('orphan_s')}s "
                  f"pins={_pin_str(r)}")
    else:
        print("leak suspects: none")


def cmd_metrics(args):
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch.util.metrics import prometheus_text

    print(prometheus_text())


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


def cmd_serve(args):
    """serve deploy/status/shutdown (ref: serve/scripts.py CLI)."""
    ray_tpu_torch = _connect(args.address)
    from ray_tpu_torch import serve

    if args.serve_cmd == "deploy":
        from ray_tpu_torch.serve.schema import ServeDeploySchema, apply_config

        if not args.config:
            raise SystemExit("serve deploy requires --config <file>")
        schema = ServeDeploySchema.from_file(args.config)
        info = apply_config(schema)
        print(json.dumps(info, indent=2))
    elif args.serve_cmd == "status":
        print(json.dumps(serve.status(), indent=2, default=str))
    elif args.serve_cmd == "shutdown":
        serve.shutdown()
        print("serve shut down")


def cmd_lint(args):
    """raylint over the tree (no cluster needed). All flags pass through
    to the lint CLI: `ray_tpu_torch lint --changed-only --fail-on error
    ...`"""
    from ray_tpu_torch.devtools.lint.cli import main as lint_main

    rest = args.lint_args
    if rest[:1] == ["--"]:   # `ray_tpu_torch lint -- --flags` form
        rest = rest[1:]
    sys.exit(lint_main(rest))


def cmd_chaos(args):
    """Seeded fault-injection scenario: spin up an ephemeral cluster,
    run the canonical task+actor workload under a FaultPlan, and check
    the invariants (typed-within-deadline, exactly-once side effects,
    clean pin/resource accounting). Same seed ⟹ same injected faults."""
    from ray_tpu_torch.devtools import chaos

    if args.plan:
        with open(args.plan) as f:
            plan = chaos.FaultPlan.from_json(f.read())
        if args.seed is not None:
            plan.seed = args.seed
    else:
        plan = chaos.canonical_plan(args.seed or 0)
    report = chaos.run_scenario(plan, num_nodes=args.nodes,
                                tasks=args.tasks, actors=args.actors,
                                calls=args.calls)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(f"seed={report['seed']} rules={report['rules']} "
              f"injected={report['injected_driver_side']} "
              f"elapsed={report['elapsed_s']}s")
        for v in report["violations"]:
            print(f"  VIOLATION: {v}")
        print("OK" if report["ok"] else "FAILED")
    sys.exit(0 if report["ok"] else 1)


def cmd_dashboard(args):
    """Serve the HTTP dashboard against a running cluster
    (ref: dashboard/head.py)."""
    from ray_tpu_torch.dashboard import DashboardHead

    h, p = args.address.rsplit(":", 1)
    head = DashboardHead((h, int(p)), session_dir=args.session_dir,
                         host=args.http_host, port=args.http_port)
    addr = head.start()
    print(json.dumps({"dashboard_url": f"http://{addr[0]}:{addr[1]}"}),
          flush=True)
    while True:
        time.sleep(3600)


def build_parser() -> argparse.ArgumentParser:
    """The reference's commands and options, word for word."""
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("start", help="start head daemons")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--resources", default="{}")
    s.add_argument("--system-config", default="{}")
    s.set_defaults(fn=cmd_start)

    s = sub.add_parser("stop", help="stop head daemons")
    s.set_defaults(fn=cmd_stop)

    s = sub.add_parser("microbenchmark",
                       help="core task/actor/object throughput suite "
                            "(ref: ray microbenchmark)")
    s.add_argument("--address", default=None)
    s.add_argument("--filter", action="append", default=None)
    s.add_argument("--min-seconds", type=float, default=2.0)
    s.set_defaults(fn=cmd_microbenchmark)

    for name, fn in [("status", cmd_status), ("summary", cmd_summary),
                     ("memory", cmd_memory), ("metrics", cmd_metrics),
                     ("stack", cmd_stack), ("internal-stats", cmd_istats)]:
        s = sub.add_parser(name)
        s.add_argument("--address", required=True)
        s.set_defaults(fn=fn)

    s = sub.add_parser("list")
    s.add_argument("what", choices=["nodes", "actors", "tasks", "jobs",
                                    "edges", "objects", "pgs"])
    s.add_argument("--address", required=True)
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("top", help="cluster resource hogs; `top mem` = "
                       "attributed memory by subsystem/holder "
                       "(observability/memory.py)")
    s.add_argument("what", choices=["mem"])
    s.add_argument("--address", required=True)
    s.add_argument("--limit", type=int, default=20)
    s.add_argument("--json", action="store_true",
                   help="raw memory_report() JSON")
    s.set_defaults(fn=cmd_top)

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

    s = sub.add_parser("timeline")
    s.add_argument("--address", required=True)
    s.add_argument("--limit", type=int, default=10000)
    s.add_argument("--output", default=None)
    s.set_defaults(fn=cmd_timeline)

    s = sub.add_parser("debug", help="attach to a remote-pdb breakpoint")
    s.add_argument("--address", required=True)
    s.add_argument("--index", type=int, default=0)
    s.add_argument("--list", action="store_true")
    s.set_defaults(fn=cmd_debug)

    s = sub.add_parser("gateway", help="run a client gateway "
                       "(remote drivers: python thin client + C++ API)")
    s.add_argument("--address", required=True, help="GCS host:port")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=10001)
    s.set_defaults(fn=cmd_gateway)

    s = sub.add_parser("dashboard", help="run the HTTP dashboard")
    s.add_argument("--address", required=True, help="GCS host:port")
    s.add_argument("--session-dir", default="")
    s.add_argument("--http-host", default="127.0.0.1")
    s.add_argument("--http-port", type=int, default=8265)
    s.set_defaults(fn=cmd_dashboard)

    s = sub.add_parser("serve", help="serve deploy/status/shutdown")
    s.add_argument("serve_cmd", choices=["deploy", "status", "shutdown"])
    s.add_argument("--address", required=True)
    s.add_argument("--config", default=None, help="config file for deploy")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("lint", help="raylint static analysis "
                       "(`ray_tpu_torch lint -- --help` for its flags)")
    s.add_argument("lint_args", nargs=argparse.REMAINDER,
                   help="passed through to python -m "
                        "ray_tpu_torch.devtools.lint (paths, "
                        "--changed-only, --fail-on, --json, ...)")
    s.set_defaults(fn=cmd_lint)

    s = sub.add_parser("chaos", help="run the seeded fault-injection "
                       "scenario (devtools.chaos) on an ephemeral cluster")
    s.add_argument("--seed", type=int, default=None,
                   help="FaultPlan seed (same seed ⟹ same fault sequence)")
    s.add_argument("--plan", default=None,
                   help="FaultPlan JSON file (default: the canonical "
                        "drop/reorder/duplicate/black-hole mix)")
    s.add_argument("--nodes", type=int, default=1)
    s.add_argument("--tasks", type=int, default=8)
    s.add_argument("--actors", type=int, default=2)
    s.add_argument("--calls", type=int, default=4)
    s.add_argument("--json", action="store_true",
                   help="print the full report (incl. the injected-fault "
                        "sequence) as JSON")
    s.set_defaults(fn=cmd_chaos)

    # cluster launcher (ref: scripts.py:1238,1314,1398,1696 up/down/
    # attach/exec over the NodeProvider API)
    s = sub.add_parser("up", help="bring a cluster up from a YAML config")
    s.add_argument("cluster_yaml")
    s.add_argument("--restart", action="store_true")
    s.set_defaults(fn=lambda a: _launcher().up(a.cluster_yaml,
                                               restart=a.restart))

    s = sub.add_parser("down", help="tear a cluster down")
    s.add_argument("cluster_yaml")
    s.set_defaults(fn=lambda a: _launcher().down(a.cluster_yaml))

    s = sub.add_parser("exec", help="run a shell command on the cluster")
    s.add_argument("cluster_yaml")
    s.add_argument("command")
    s.set_defaults(fn=lambda a: sys.exit(
        _launcher().exec_cmd(a.cluster_yaml, a.command)))

    s = sub.add_parser("submit", help="run a python script on the cluster")
    s.add_argument("cluster_yaml")
    s.add_argument("script")
    s.add_argument("script_args", nargs="*")
    s.set_defaults(fn=lambda a: sys.exit(
        _launcher().submit(a.cluster_yaml, a.script, *a.script_args)))

    s = sub.add_parser("attach",
                       help="shell with the cluster address exported")
    s.add_argument("cluster_yaml")
    s.set_defaults(fn=lambda a: sys.exit(_launcher().attach(a.cluster_yaml)))

    s = sub.add_parser("cluster-status", help="launcher-level status")
    s.add_argument("cluster_yaml")
    s.set_defaults(fn=lambda a: _launcher().status(a.cluster_yaml))

    return p


def main():
    # `lint` routes before argparse, as in the reference (REMAINDER
    # refuses leading optionals, bpo-17050)
    if sys.argv[1:2] == ["lint"]:
        cmd_lint(argparse.Namespace(lint_args=sys.argv[2:]))
    args = build_parser().parse_args()
    args.fn(args)


def _launcher():
    from ray_tpu_torch.autoscaler import launcher

    return launcher


if __name__ == "__main__":
    main()
