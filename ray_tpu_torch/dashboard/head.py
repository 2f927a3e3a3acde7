"""Dashboard head server.

Port of ray_tpu/dashboard/head.py over the port's runtime. Reference:
dashboard/head.py — an aiohttp server on the head node serving pluggable
modules (dashboard/utils.py:40 DashboardHeadModule); the state/metrics/
jobs/logs modules are folded into route groups on one server. Talks to
the GCS directly over the RPC layer (no driver Runtime required), like
the reference head's GcsClient; only the job routes connect a driver.

The port serves through the standard library's ``ThreadingHTTPServer``
(as ``serve/http_proxy.py`` does), not aiohttp, which a machine may lack:
each request runs on its own thread, and GCS calls cross to one asyncio
loop thread. Routes, payloads and the ``raytpu_*`` series names are the
reference's (``grafana.py``'s panels query those series).
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch.core.rpc import ClientPool, EventLoopThread

Address = Tuple[str, int]


def _jsonable(v: Any):
    """Best-effort conversion of dataclasses / ids / bytes for JSON."""
    if isinstance(v, dict):
        return {_jsonable_key(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, bytes):
        return v.hex()
    if hasattr(v, "hex") and not isinstance(v, (int, float)):
        try:
            return v.hex()
        except TypeError:
            pass
    if hasattr(v, "__dataclass_fields__"):
        return {f: _jsonable(getattr(v, f)) for f in v.__dataclass_fields__}
    if hasattr(v, "quantities"):
        return _jsonable(v.quantities)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def _jsonable_key(k: Any):
    if isinstance(k, bytes):
        return k.hex()
    if isinstance(k, (str, int, float, bool)):
        return k
    return str(k)


# Single-file UI (ref: dashboard/client — a React SPA there; here a
# dependency-free vanilla-JS app served inline, the right weight for a
# TPU fleet console: summary cards, node/actor/job tables, auto-refresh,
# raw API links). No build step, no npm, served as one string.
_INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu dashboard</title><style>
body{font-family:ui-monospace,Menlo,monospace;margin:1.2rem;background:#101418;color:#d6dde4}
h2{margin:0 0 .8rem}  a{color:#6ab0f3}
.cards{display:flex;gap:.8rem;flex-wrap:wrap;margin-bottom:1rem}
.card{background:#1a2129;border:1px solid #2a333d;border-radius:6px;padding:.7rem 1rem;min-width:8.5rem}
.card b{display:block;font-size:1.4rem}  .card span{color:#8b98a5;font-size:.8rem}
table{border-collapse:collapse;width:100%;margin-bottom:1.2rem;font-size:.85rem}
th,td{border-bottom:1px solid #2a333d;padding:.3rem .6rem;text-align:left}
th{color:#8b98a5;font-weight:600}  .dead{color:#e66}  .alive{color:#7c6}
#err{color:#e66}  footer{color:#8b98a5;font-size:.8rem}
</style></head><body>
<h2>ray_tpu dashboard</h2>
<div class="cards" id="cards"></div>
<h3>nodes</h3><table id="nodes"><thead><tr>
<th>node</th><th>state</th><th>resources</th><th>store</th><th>load</th><th>mem free</th><th>workers</th></tr></thead><tbody></tbody></table>
<h3>actors</h3><table id="actors"><thead><tr>
<th>actor</th><th>class</th><th>state</th><th>name</th><th>restarts</th></tr></thead><tbody></tbody></table>
<h3>jobs</h3><table id="jobs"><thead><tr>
<th>job</th><th>started</th><th>ended</th></tr></thead><tbody></tbody></table>
<h3>tasks</h3><table id="tasks"><thead><tr>
<th>task</th><th>name</th><th>state</th><th>worker</th><th>duration</th></tr></thead><tbody></tbody></table>
<h3>timeline <span style="color:#8b98a5;font-size:.8rem">(one lane per worker, last 60 s window of finished tasks + spans)</span></h3>
<canvas id="tl" width="1100" height="160" style="background:#1a2129;border:1px solid #2a333d;border-radius:6px"></canvas>
<div id="err"></div>
<footer>raw: <a href="/api/v0/summary">summary</a> · <a href="/api/v0/nodes">nodes</a>
· <a href="/api/v0/actors">actors</a> · <a href="/api/v0/tasks">tasks</a>
· <a href="/api/v0/jobs">jobs</a> · <a href="/api/v0/node_stats">node stats</a>
· <a href="/metrics">prometheus</a> · <a href="/api/v0/logs">logs</a>
&nbsp;|&nbsp; refreshes every 5 s</footer>
<script>
const fmtB=(b)=>b>1<<30?(b/2**30).toFixed(1)+"G":b>1<<20?(b/2**20).toFixed(0)+"M":b+"B";
const cell=(t)=>{const td=document.createElement("td");td.textContent=t??"";return td};
async function j(u){const r=await fetch(u);if(!r.ok)throw new Error(u+": "+r.status);return r.json()}
async function tick(){
 try{
  const [sum,nodes,actors,jobs,stats]=await Promise.all([
    j("/api/v0/summary"),j("/api/v0/nodes"),j("/api/v0/actors"),
    j("/api/v0/jobs"),j("/api/v0/node_stats")]);
  const cards=[["nodes alive",sum.nodes_alive],["nodes dead",sum.nodes_dead],
    ["actors alive",sum.actors_alive+"/"+sum.actors_total],
    ...Object.entries(sum.total_resources||{}).map(([k,v])=>[k,v])];
  document.getElementById("cards").replaceChildren(...cards.map(([k,v])=>{
    const d=document.createElement("div");d.className="card";
    const b=document.createElement("b");b.textContent=v;
    const s=document.createElement("span");s.textContent=k;
    d.append(b,s);return d}));
  const nb=document.querySelector("#nodes tbody");nb.replaceChildren();
  for(const n of nodes){const st=stats[n.node_id]||{};const h=st.host||{};
    const tr=document.createElement("tr");
    const state=cell(n.alive?"ALIVE":"DEAD");state.className=n.alive?"alive":"dead";
    tr.append(cell(n.node_id.slice(0,12)),state,
      cell(Object.entries(n.resources).map(([k,v])=>k+":"+v).join(" ")),
      cell(st.store_bytes!=null?fmtB(st.store_bytes)+" / "+(st.store_objects??"?")+" obj":"-"),
      cell(h.load_1m!=null?h.load_1m.toFixed(2):"-"),
      cell(h.mem_available!=null?fmtB(h.mem_available):"-"),
      cell(st.workers?Object.keys(st.workers).length:"-"));
    nb.append(tr)}
  const ab=document.querySelector("#actors tbody");ab.replaceChildren();
  for(const a of actors.slice(0,200)){const tr=document.createElement("tr");
    const state=cell(a.state);state.className=a.state==="ALIVE"?"alive":(a.state==="DEAD"?"dead":"");
    tr.append(cell((a.actor_id||"").slice(0,12)),cell(a.class_name),state,
      cell(a.name||""),cell(a.num_restarts));ab.append(tr)}
  const jb=document.querySelector("#jobs tbody");jb.replaceChildren();
  for(const job of jobs.slice(0,100)){const tr=document.createElement("tr");
    tr.append(cell((job.job_id||"").slice(0,12)),
      cell(job.start?new Date(job.start*1000).toLocaleTimeString():""),
      cell(job.end?new Date(job.end*1000).toLocaleTimeString():"running"));
    jb.append(tr)}
  const tsum=await j("/api/v0/task_summary?limit=2000");
  const tb=document.querySelector("#tasks tbody");tb.replaceChildren();
  for(const t of tsum.tasks.slice(0,200)){const tr=document.createElement("tr");
    const st=cell(t.state);st.className=t.state==="FINISHED"?"alive":(t.state==="FAILED"?"dead":"");
    tr.append(cell((t.task_id||"").slice(0,12)),cell(t.name),st,
      cell(t.worker||"-"),
      cell(t.duration_s!=null?(t.duration_s*1000).toFixed(1)+" ms":"-"));
    tb.append(tr)}
  drawTimeline(tsum);
  document.getElementById("err").textContent="";
 }catch(e){document.getElementById("err").textContent=String(e)}
}
function drawTimeline(tsum){
 // bars come straight from the summary rows (start/end/worker already
 // paired server-side) + tracing spans; one lane per worker
 const cv=document.getElementById("tl"),ctx=cv.getContext("2d");
 ctx.clearRect(0,0,cv.width,cv.height);
 const now=Date.now()/1000,w0=now-60;
 const bars=[];
 for(const ev of tsum.spans||[]){
  if(ev.ts>w0)bars.push({lane:"span:"+String(ev.trace_id).slice(0,6),
    t0:ev.ts,t1:ev.ts+(ev.dur||0),name:ev.name,span:true})}
 for(const t of tsum.tasks||[]){
  if(t.start_ts!=null&&t.end_ts!=null&&t.end_ts>w0)
   bars.push({lane:t.worker||"?",t0:t.start_ts,t1:t.end_ts,
     name:t.name,fail:t.state==="FAILED"})}
 const lanes=[...new Set(bars.map(b=>b.lane))].sort();
 const lh=Math.min(26,Math.max(14,(cv.height-18)/Math.max(lanes.length,1)));
 ctx.font="10px ui-monospace";
 lanes.forEach((ln,i)=>{ctx.fillStyle="#8b98a5";
   ctx.fillText(ln,4,14+i*lh)});
 const x=(t)=>90+(t-w0)/60*(cv.width-100);
 for(const b of bars){const i=lanes.indexOf(b.lane);
  ctx.fillStyle=b.span?"#c9a227":(b.fail?"#e66":"#4f9d69");
  const x0=Math.max(90,x(b.t0));
  ctx.fillRect(x0,6+i*lh,Math.max(x(b.t1)-x0,2),lh-6)}
 ctx.fillStyle="#8b98a5";
 ctx.fillText("-60s",92,cv.height-4);ctx.fillText("now",cv.width-30,cv.height-4);
}
tick();setInterval(tick,5000);
</script></body></html>"""


class _Reply(Exception):
    """A handler's non-200 answer: a dict goes out as JSON, a str as
    text."""

    def __init__(self, status: int, payload):
        super().__init__(payload)
        self.status = status
        self.payload = payload


class DashboardHead:
    def __init__(self, gcs_addr: Address, session_dir: str = "",
                 host: str = "127.0.0.1", port: int = 8265):
        self.gcs_addr = tuple(gcs_addr)
        self.session_dir = session_dir
        self.host = host
        self.port = port
        self._io: Optional[EventLoopThread] = None
        self.pool: Optional[ClientPool] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._jobs = None
        self._jobs_lock = threading.Lock()
        self._task_rows: Dict[str, dict] = {}
        self._task_rows_lock = threading.Lock()
        # (method, path pattern, handler); a handler takes the query dict,
        # the pattern's groups and the request body, and returns
        # (content type, body bytes) or raises _Reply
        self._routes = [
            ("GET", "/", self._h_index),
            ("GET", "/api/v0/nodes", self._h_nodes),
            ("GET", "/api/v0/actors", self._h_actors),
            ("GET", "/api/v0/tasks", self._h_tasks),
            ("GET", "/api/v0/task_summary", self._h_task_summary),
            ("GET", "/api/v0/jobs", self._h_jobs),
            ("POST", "/api/jobs/", self._h_job_submit),
            ("GET", "/api/jobs/", self._h_job_list),
            ("GET", "/api/jobs/{job_id}", self._h_job_info),
            ("GET", "/api/jobs/{job_id}/logs", self._h_job_logs),
            ("POST", "/api/jobs/{job_id}/stop", self._h_job_stop),
            ("GET", "/api/v0/summary", self._h_summary),
            ("GET", "/api/v0/node_stats", self._h_node_stats),
            ("GET", "/api/v0/edge_stats", self._h_edge_stats),
            ("GET", "/api/v0/health", self._h_health),
            ("GET", "/api/v0/memory", self._h_memory),
            ("GET", "/metrics", self._h_metrics),
            ("GET", "/api/v0/logs", self._h_logs),
        ]
        self._compiled = [
            (m, re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)",
                                        path) + "$"), fn)
            for m, path, fn in self._routes]

    # ---------------------------------------------------------- GCS access

    def _run(self, coro, timeout: float = 15.0):
        return self._io.run(coro, timeout=timeout)

    async def _acall(self, method: str, **kw):
        return await self.pool.get(self.gcs_addr).call(method, timeout=10.0,
                                                       **kw)

    def _gcs(self, method: str, **kw):
        return self._run(self._acall(method, **kw))

    # ------------------------------------------------------------- handlers

    def _h_index(self, query, groups, body):
        return "text/html", _INDEX_HTML.encode()

    @staticmethod
    def _json(payload):
        return "application/json", json.dumps(_jsonable(payload)).encode()

    def _h_nodes(self, query, groups, body):
        nodes = self._gcs("get_nodes")
        return self._json([{
            "node_id": n.node_id.hex(), "alive": n.alive,
            "address": list(n.nodelet_addr),
            "resources": n.resources_total.quantities,
            "labels": n.labels, "store_name": n.store_name,
        } for n in nodes])

    def _h_actors(self, query, groups, body):
        return self._json(self._gcs("list_actors"))

    def _h_edge_stats(self, query, groups, body):
        """Measured per-edge transfer model (EWMA latency/bandwidth per
        src->dst node pair), fed by batched telemetry reports."""
        return self._json(self._gcs("edge_stats"))

    def _h_health(self, query, groups, body):
        """Health plane: progress beacons with freshness, recent stall /
        straggler events, drop counters (observability/health.py)."""
        return self._json(self._gcs("health_report"))

    def _h_memory(self, query, groups, body):
        """Memory plane: per-subsystem attribution, top holders, spill
        candidates, leak suspects (observability/memory.py)."""
        top_n = int(query.get("top_n", 20))
        return self._json(self._gcs("memory_report", top_n=top_n))

    def _h_tasks(self, query, groups, body):
        limit = int(query.get("limit", 1000))
        return self._json(self._gcs("list_task_events", limit=limit))

    def _h_task_summary(self, query, groups, body):
        """Per-task drill-down rows + tracing spans (ref: dashboard task
        table, dashboard/modules/state/state_head.py): latest state,
        start time, duration, worker — aggregated from the GCS
        task-event store. One payload feeds both the UI's task table and
        its timeline (a single GCS read per refresh tick)."""
        limit = int(query.get("limit", 2000))
        events = self._gcs("list_task_events", limit=limit)
        spans = [ev for ev in events if ev.get("kind") == "span"]
        with self._task_rows_lock:
            out = self._fold_task_rows(events, limit)
        return self._json({"tasks": out, "spans": spans})

    def _fold_task_rows(self, events, limit):
        # Fold into a PERSISTENT per-task cache: the GCS store keeps only
        # the newest `limit` events, so a long-running task's RUNNING
        # event can age out while its FINISHED remains — folding only the
        # current window would then yield FINISHED rows with null
        # start_ts/duration. Re-folding the same event is idempotent, so
        # the cache just accumulates the newest window each tick.
        tasks = self._task_rows
        # events from different processes flush independently and
        # interleave out of order in the GCS — fold by timestamp, or a
        # late-arriving PENDING overwrites a FINISHED forever
        for ev in sorted((ev for ev in events if ev.get("kind") != "span"),
                         key=lambda ev: ev["ts"]):
            t = tasks.setdefault(ev["task_id"], {
                "task_id": ev["task_id"], "name": ev.get("name"),
                "actor_id": ev.get("actor_id"), "worker": None,
                "state": None, "start_ts": None, "end_ts": None,
                "duration_s": None, "_last_ts": 0.0})
            if ev["ts"] < t["_last_ts"]:
                continue   # older than what's already folded for this task
            t["_last_ts"] = ev["ts"]
            t["state"] = ev.get("state")
            if ev.get("worker"):
                t["worker"] = ev["worker"]
            if ev.get("state") == "RUNNING":
                t["start_ts"] = ev["ts"]
            elif ev.get("state") in ("FINISHED", "FAILED"):
                t["end_ts"] = ev["ts"]
                if t["start_ts"] is not None:
                    t["duration_s"] = ev["ts"] - t["start_ts"]
        # bound the cache: evict oldest FINISHED/FAILED first, then (if a
        # churning cluster left terminal-less rows — e.g. a SIGKILLed
        # worker never flushed its FINISHED span) oldest rows of ANY
        # state, so the cache cannot grow without bound
        cap = 10000
        if len(tasks) > cap:
            by_age = sorted(tasks.values(), key=lambda t: t["_last_ts"])
            terminal = [t for t in by_age
                        if t["state"] in ("FINISHED", "FAILED")]
            rest = [t for t in by_age
                    if t["state"] not in ("FINISHED", "FAILED")]
            for t in (terminal + rest)[:len(tasks) - cap]:
                tasks.pop(t["task_id"], None)
        out = sorted(tasks.values(),
                     key=lambda t: t.get("start_ts") or 0, reverse=True)
        return [{k: v for k, v in t.items() if k != "_last_ts"}
                for t in out[:limit]]   # honor ?limit= on the response too

    def _h_jobs(self, query, groups, body):
        return self._json(self._gcs("list_jobs"))

    # ------------------------------------------------ job submission REST
    # (ref: dashboard/modules/job/job_head.py — POST /api/jobs/,
    # GET /api/jobs/{id}, logs, stop; the SDK's http mode targets these)

    def _job_client(self):
        """Lazy driver connection for actor-backed job supervision (the
        reference job head holds a JobManager the same way); a process
        that is already a driver of this cluster reuses its runtime."""
        with self._jobs_lock:
            if self._jobs is None:
                import ray_tpu_torch
                from ray_tpu_torch.job.manager import JobSubmissionClient

                if not ray_tpu_torch.is_initialized():
                    ray_tpu_torch.init(
                        address=f"{self.gcs_addr[0]}:{self.gcs_addr[1]}")
                self._jobs = JobSubmissionClient()
            return self._jobs

    def _job_call(self, status: int, method: str, *args, **kw):
        try:
            return getattr(self._job_client(), method)(*args, **kw)
        except Exception as e:
            raise _Reply(status, {"error": str(e)}) from None

    def _h_job_submit(self, query, groups, body):
        try:
            req = json.loads(body or b"null")
        except ValueError:
            raise _Reply(400, {"error": "body is not JSON"}) from None
        if not isinstance(req, dict) or "entrypoint" not in req:
            raise _Reply(400, {"error": "missing 'entrypoint'"})
        job_id = self._job_call(
            500, "submit_job", entrypoint=req["entrypoint"],
            runtime_env=req.get("runtime_env"),
            working_dir=req.get("working_dir"),
            submission_id=req.get("submission_id"))
        return self._json({"job_id": job_id, "submission_id": job_id})

    def _h_job_list(self, query, groups, body):
        """Submission-API jobs (KV-backed), distinct from the cluster
        driver-jobs table at /api/v0/jobs (ref: job_head.py list)."""
        return self._json(self._job_call(500, "list_jobs"))

    def _h_job_info(self, query, groups, body):
        return self._json(self._job_call(404, "get_job_info",
                                         groups["job_id"]))

    def _h_job_logs(self, query, groups, body):
        return self._json({"logs": self._job_call(404, "get_job_logs",
                                                  groups["job_id"])})

    def _h_job_stop(self, query, groups, body):
        stopped = self._job_call(404, "stop_job", groups["job_id"])
        return self._json({"stopped": bool(stopped)})

    def _h_summary(self, query, groups, body):
        nodes = self._gcs("get_nodes")
        actors = self._gcs("list_actors")
        total: dict = {}
        for n in nodes:
            if not n.alive:
                continue
            for k, v in n.resources_total.quantities.items():
                total[k] = total.get(k, 0) + v
        return self._json({
            "time": time.time(),
            "nodes_alive": sum(1 for n in nodes if n.alive),
            "nodes_dead": sum(1 for n in nodes if not n.alive),
            "total_resources": total,
            "actors_total": len(actors),
            "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
        })

    def _h_node_stats(self, query, groups, body):
        """Aggregated from the per-node agents' pushes (GCS KV
        ns=node_stats) — ONE KV scan regardless of cluster size, instead
        of a live RPC fan-out to every nodelet (ref: reporter agents
        pushing to the head). `?live=1` forces the old direct fan-out for
        debugging a wedged agent."""
        if query.get("live") == "1":
            nodes = [n for n in self._gcs("get_nodes") if n.alive]

            async def one(n):
                try:
                    return await self.pool.get(tuple(n.nodelet_addr)).call(
                        "node_stats", timeout=5.0)
                except Exception as e:  # noqa: BLE001 — best effort
                    return {"error": str(e)}

            async def fan_out():
                return await asyncio.gather(*(one(n) for n in nodes))

            stats = self._run(fan_out())
            return self._json({n.node_id.hex(): st
                               for n, st in zip(nodes, stats)})
        try:
            out = self._scan_node_stats()
        except Exception as e:   # noqa: BLE001
            out = {"error": str(e)}
        return self._json(out)

    def _scan_node_stats(self) -> dict:
        """node_id hex -> last agent sample, concurrent kv_gets (one
        round-trip wave, not N serial), dead nodes filtered out."""
        async def scan():
            alive = {n.node_id.binary()
                     for n in await self._acall("get_nodes") if n.alive}
            keys = [k for k in await self._acall("kv_keys", ns="node_stats")
                    if k in alive]
            raws = await asyncio.gather(
                *(self._acall("kv_get", ns="node_stats", key=k)
                  for k in keys))
            return {k.hex(): json.loads(raw)
                    for k, raw in zip(keys, raws) if raw}

        return self._run(scan())

    def _h_metrics(self, query, groups, body):
        """Prometheus exposition (ref: dashboard/modules/metrics/ +
        metrics_agent.py exposition)."""
        from ray_tpu_torch.util.metrics import render_prometheus

        async def collect():
            keys = await self._acall("kv_keys", ns="metrics")
            raws = await asyncio.gather(
                *(self._acall("kv_get", ns="metrics", key=k) for k in keys))
            return list(zip(keys, raws))

        lines = []
        try:
            for key, raw in self._run(collect()):
                if raw is None:
                    continue
                lines.extend(render_prometheus(key.decode(), json.loads(raw)))
        except Exception as e:  # noqa: BLE001
            lines.append(f"# metrics collection error: {e}")
        try:
            lines.extend(self._system_series())
        except Exception as e:  # noqa: BLE001
            lines.append(f"# system series error: {e}")
        return "text/plain", ("\n".join(lines) + "\n").encode()

    def _system_series(self) -> list:
        """System metrics derived from the per-node agent pushes + GCS
        state (ref: metric_defs.h system gauges flowing through the
        metrics agent). These are the series the generated Grafana
        dashboard (dashboard/grafana.py) graphs."""
        out = []

        def g(name, help_, pairs):
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} gauge")
            for tags, v in pairs:
                label = ",".join(f'{k}="{v2}"' for k, v2 in
                                 sorted(tags.items()))
                out.append(f"{name}{{{label}}} {v}" if label
                           else f"{name} {v}")

        stats = {nid[:12]: s
                 for nid, s in self._scan_node_stats().items()}
        g("raytpu_object_store_bytes_in_use", "shm store bytes per node",
          [({"node": n}, s.get("store_bytes", 0))
           for n, s in stats.items()])
        g("raytpu_object_store_num_objects", "store objects per node",
          [({"node": n}, s.get("store_objects", 0))
           for n, s in stats.items()])
        g("raytpu_spilled_bytes_total", "bytes spilled per node",
          [({"node": n}, s.get("spilled_bytes", 0))
           for n, s in stats.items()])
        g("raytpu_workers_alive", "workers per node",
          [({"node": n}, len(s.get("workers", {})))
           for n, s in stats.items()])
        g("raytpu_pending_leases", "queued lease requests per node",
          [({"node": n}, s.get("pending_leases", 0))
           for n, s in stats.items()])
        g("raytpu_oom_kills_total", "OOM kills per node",
          [({"node": n}, s.get("oom_kills", 0)) for n, s in stats.items()])
        g("raytpu_node_load_1m", "host 1m load per node",
          [({"node": n}, s.get("host", {}).get("load_1m", 0))
           for n, s in stats.items()])
        g("raytpu_node_mem_available_bytes", "host available memory",
          [({"node": n}, s.get("host", {}).get("mem_available", 0))
           for n, s in stats.items()])
        actors = self._gcs("list_actors")
        g("raytpu_actors_alive", "actors in ALIVE state",
          [({}, sum(1 for a in actors if a["state"] == "ALIVE"))])
        nodes = self._gcs("get_nodes")
        g("raytpu_nodes_alive", "cluster nodes alive",
          [({}, sum(1 for n in nodes if n.alive))])
        return out

    def _h_logs(self, query, groups, body):
        """List/serve session log files (ref: dashboard log module)."""
        logs_dir = os.path.join(self.session_dir, "logs")
        name = query.get("file")
        if not os.path.isdir(logs_dir):
            return self._json([])
        if name is None:
            return self._json(sorted(os.listdir(logs_dir)))
        path = os.path.realpath(os.path.join(logs_dir, name))
        root = os.path.realpath(logs_dir)
        if os.path.commonpath([path, root]) != root \
                or not os.path.isfile(path):
            raise _Reply(404, "no such log")
        tail = int(query.get("tail", 1000))
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()[-tail:]
        return "text/plain", "".join(lines).encode()

    # ------------------------------------------------------------ serving

    def _dispatch(self, method: str, raw_path: str, body: bytes):
        """(status, content type, body) of one request."""
        parsed = urlparse(raw_path)
        query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        other_method = False
        for m, pattern, fn in self._compiled:
            match = pattern.match(parsed.path)
            if match is None:
                continue
            if m != method:
                other_method = True
                continue
            try:
                ctype, out = fn(query, match.groupdict(), body)
            except _Reply as r:
                if isinstance(r.payload, dict):
                    return (r.status,) + self._json(r.payload)
                return r.status, "text/plain", r.payload.encode()
            except Exception as e:  # noqa: BLE001 — a handler's fault
                return 500, "text/plain", f"{type(e).__name__}: {e}".encode()
            return 200, ctype, out
        if other_method:
            return 405, "text/plain", b"405: Method Not Allowed"
        return 404, "text/plain", b"404: Not Found"

    def start(self) -> Address:
        """Bind (port 0 picks a free one) and serve on a daemon thread;
        returns (host, port)."""
        head = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):   # quiet, like aiohttp's default
                pass

            def _serve(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                status, ctype, out = head._dispatch(self.command, self.path,
                                                    body)
                self.send_response(status)
                self.send_header("Content-Type", f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            do_GET = do_POST = do_PUT = do_DELETE = _serve

        self._io = EventLoopThread(name="ray_tpu_torch-dashboard-io")
        self.pool = ClientPool()
        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="ray_tpu_torch-dashboard").start()
        return (self.host, self.port)

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._io is not None:
            self._io.run(self.pool.close_all(), timeout=5.0)
            self._io.stop()
            self._io = None


def start_dashboard(gcs_addr: Address, session_dir: str = "",
                    host: str = "127.0.0.1", port: int = 8265
                    ) -> "DashboardHead":
    """Start a dashboard serving on its own threads. Returns once the
    server is bound (so `head.port` is resolved even for port=0); a
    startup failure raises here."""
    head = DashboardHead(gcs_addr, session_dir, host, port)
    head.start()
    return head


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs-address", required=True, help="host:port")
    ap.add_argument("--session-dir", default="")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8265)
    args = ap.parse_args()
    host, port = args.gcs_address.rsplit(":", 1)
    head = DashboardHead((host, int(port)), args.session_dir, args.host,
                         args.port)
    addr = head.start()
    print(json.dumps({"dashboard_url": f"http://{addr[0]}:{addr[1]}"}),
          flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
